"""Weights into the port: ``tpuseg`` variable trees and reference ``.pth``
files.

The port's parameter names are the NVIDIA reference's torch state-dict
names, so the key map from ``tpuseg``'s flax paths to reference names
(``tpuseg_torch/keymap.py``, the port's own copy of
``tools/convert_torch_ckpt.py``'s) is also the JAX -> port map.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from tpuseg_torch.keymap import (
    HEADS,
    PLAIN_SCALE_ATTN,
    deepv3_key_fn,
    flatten,
    flax_to_torch_key,
    seg_key_fn,
    strip_prefixes,
)
from tpuseg_torch.models import attnscale, basic, deeper, mscale, mscale2
from tpuseg_torch.models.deepv3 import TRUNKS as DEEPV3_TRUNKS

# each attention-scale module's factories: name -> (class, trunk, ...)
_FAMILY = {"mscale": mscale.FACTORIES, "mscale2": mscale2.FACTORIES,
           "attnscale": attnscale.FACTORIES, "basic": basic.FACTORIES,
           "deeper": deeper.FACTORIES}

_PARAM_SUFFIX = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_SUFFIX = {"mean": "running_mean", "var": "running_var"}


def arch_key_fn(arch: Optional[str], bn_head: Optional[bool] = None
                ) -> Callable[[str], Optional[str]]:
    """The key map of ``arch`` ("module.Factory"): ``flax_to_torch_key``
    for the ``ocrnet`` archs (and for ``None``), ``seg_key_fn`` of the
    factory's trunk and class otherwise. ``bn_head`` picks attnscale's
    attention head where the config does (``model.attnscale_bn_head``;
    None: the factory's default)."""
    if arch is None or arch.startswith("ocrnet."):
        return flax_to_torch_key
    module, factory = arch.split(".")
    if module == "deepv3" and factory in DEEPV3_TRUNKS:
        return deepv3_key_fn(DEEPV3_TRUNKS[factory])
    if factory not in _FAMILY.get(module, {}):
        raise KeyError(f"no key map for arch {arch!r}")
    cls, trunk = _FAMILY[module][factory][:2]
    heads = HEADS[cls.__name__]
    if bn_head is None:
        bn_head = factory in ("DeepV3R50B", "DeepV3R50BP")
    if module == "attnscale" and not bn_head:
        heads = {**heads, **PLAIN_SCALE_ATTN}
    return seg_key_fn(trunk, heads)


def state_dict_from_flax(params: dict, batch_stats: dict,
                         arch: Optional[str] = None,
                         key_fn: Optional[Callable] = None
                         ) -> Dict[str, torch.Tensor]:
    """``tpuseg`` ``params`` / ``batch_stats`` trees (numpy leaves) of
    ``arch`` -> the port's state dict (``key_fn`` overrides the arch's map).
    Conv kernels go HWIO -> OIHW (grouped and depthwise kernels too); every
    BN gets ``num_batches_tracked = 0``. Raises on a path the map cannot
    name."""
    if key_fn is None:
        # attnscale's head is the config's: the BN head has BN statistics
        key_fn = arch_key_fn(arch, bn_head="scale_attn" in batch_stats
                             or "conv" in params.get("scale_attn", {})
                             .get("conv0", {}))
    out: Dict[str, torch.Tensor] = {}
    for tree, suffixes in ((params, _PARAM_SUFFIX),
                           (batch_stats, _STAT_SUFFIX)):
        for flat, val in flatten(tree).items():
            parts = flat.split("/")
            leaf, mod = parts[-1], parts[:-1]
            # flax BN lives in a module named 'bn' inside Norm: strip that
            # innermost component only (a Norm may itself be named 'bn')
            if mod and mod[-1] == "bn" and leaf in ("scale", "bias", "mean",
                                                    "var"):
                mod = mod[:-1]
            prefix = key_fn("/".join(mod))
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
    return strip_prefixes(state)
