"""Weights into the port: ``tpuseg`` variable trees and reference ``.pth``
files.

The port's parameter names are the NVIDIA reference's torch state-dict
names, so ``tpuseg``'s own key map
``tools/convert_torch_ckpt.py::flax_to_torch_key`` (reference -> flax) is
used unchanged, as the JAX -> port map. That module's top level imports
only numpy; it is loaded by file path so the port needs no ``tools``
package.
"""
from __future__ import annotations

import importlib.util
from functools import lru_cache
from pathlib import Path
from typing import Dict

import numpy as np
import torch

CONVERTER = Path(__file__).resolve().parents[1] / "tools" / \
    "convert_torch_ckpt.py"


@lru_cache(maxsize=1)
def _converter():
    spec = importlib.util.spec_from_file_location("_tpuseg_convert_torch_ckpt",
                                                  CONVERTER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_PARAM_SUFFIX = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_SUFFIX = {"mean": "running_mean", "var": "running_var"}


def state_dict_from_flax(params: dict, batch_stats: dict
                         ) -> Dict[str, torch.Tensor]:
    """``tpuseg`` ``params`` / ``batch_stats`` trees (numpy leaves) -> the
    port's state dict. Conv kernels go HWIO -> OIHW; every BN gets
    ``num_batches_tracked = 0``. Raises on a path the key map cannot name."""
    conv = _converter()
    out: Dict[str, torch.Tensor] = {}
    for tree, suffixes in ((params, _PARAM_SUFFIX),
                           (batch_stats, _STAT_SUFFIX)):
        for flat, val in conv._flatten(tree).items():
            parts = flat.split("/")
            leaf, mod = parts[-1], parts[:-1]
            # flax BN lives in a module named 'bn' inside Norm: strip that
            # innermost component only (convert_state_dict does the same)
            if mod and mod[-1] == "bn" and leaf in ("scale", "bias", "mean",
                                                    "var"):
                mod = mod[:-1]
            prefix = conv.flax_to_torch_key("/".join(mod))
            if prefix is None or leaf not in suffixes:
                raise KeyError(f"no torch name for tpuseg leaf {flat!r}")
            arr = np.asarray(val, np.float32)
            if leaf == "kernel":
                arr = arr.transpose(3, 2, 0, 1)
            out[f"{prefix}.{suffixes[leaf]}"] = torch.from_numpy(
                np.array(arr, np.float32, order="C"))
            if leaf == "mean":
                out[f"{prefix}.num_batches_tracked"] = torch.zeros(
                    (), dtype=torch.long)
    return out


def load_reference_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load a reference-format torch checkpoint (``{'state_dict': ...}`` or a
    bare state dict) into ``model`` with ``strict=True``, after the
    reference's own prefix cleanups (``module.``, ``model.``,
    ``last_layer`` -> ``aux_head``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("state_dict", ckpt)
    model.load_state_dict(strip_reference_prefixes(state), strict=True)


def strip_reference_prefixes(state: dict) -> dict:
    """The reference's own state-dict cleanups: a leading ``module.`` or
    ``model.``, and ``last_layer`` -> ``aux_head``."""
    return _converter()._strip_prefixes(state)
