"""Checkpoints: save / restore, forgiving partial loads, best-by-metric
retention, auto-resume (port of ``tpuseg/train/checkpoint.py``; reference
behaviours SURVEY §5.4).

A checkpoint is one ``torch.save`` file, ``ckpt_<step>.pt``, holding
``{"model": state dict, "optimizer": state dict, "meta": {"epoch", "step",
"mean_iu", ...}}`` (reference save_dict: utils/misc.py:147-155), written to
a temporary name and renamed, so a reader never sees a partial file. The
meta also goes to ``ckpt_<step>.json`` for retention without loading the
weights. Saves are synchronous; ``wait_until_finished`` is kept for
``tpuseg``'s interface. A ``tpuseg`` orbax checkpoint needs JAX to read
and is not read here.
"""
from __future__ import annotations

import json
import os
import re
from typing import Callable, Optional

import torch

from tpuseg_torch.convert import strip_reference_prefixes

_NAME = re.compile(r"ckpt_(\d+)\.pt$")


def forgiving_merge(target: dict, loaded: dict, log: Callable = print
                    ) -> dict:
    """``target`` state dict with each entry replaced by ``loaded``'s where
    that has the key with the same shape; the others are kept and logged
    (reference forgiving_state_restore: loss/optimizer.py:137-154), e.g.
    a 65-class Mapillary classifier into a 19-class Cityscapes model."""
    merged = {}
    for k, v in target.items():
        got = loaded.get(k)
        if got is not None and tuple(got.shape) == tuple(v.shape):
            merged[k] = got
        else:
            merged[k] = v
            log(f"Skipped loading parameter {k}")
    return merged


class CheckpointManager:
    """Checkpoints of one run in ``directory``: keeps the latest and the best
    by ``mean_iu``, ``keep`` files in all."""

    def __init__(self, directory: str, keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.keep = max(1, keep)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int, ext: str = "pt") -> str:
        return os.path.join(self.directory, f"ckpt_{step}.{ext}")

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _NAME.match(f)))

    def save(self, step: int, model: torch.nn.Module,
             optimizer: Optional[torch.optim.Optimizer], epoch: int,
             mean_iu: float, extra: Optional[dict] = None) -> str:
        meta = {"epoch": int(epoch), "step": int(step),
                "mean_iu": float(mean_iu), **(extra or {})}
        payload = {"model": model.state_dict(),
                   "optimizer": optimizer.state_dict() if optimizer else None,
                   "meta": meta}
        path = self._path(step)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        with open(self._path(step, "json.tmp"), "w") as f:
            json.dump(meta, f)
        os.replace(self._path(step, "json.tmp"), self._path(step, "json"))
        self._retain()
        return path

    def _mean_iu(self, step: int) -> float:
        try:
            with open(self._path(step, "json")) as f:
                return float(json.load(f).get("mean_iu", 0.0))
        except FileNotFoundError:
            return 0.0

    def _retain(self) -> None:
        steps = self.steps()
        keep = {steps[-1]}
        for s in sorted(steps, key=lambda s: (-self._mean_iu(s), -s)):
            if len(keep) >= self.keep:
                break
            keep.add(s)
        for s in steps:
            if s not in keep:
                for ext in ("pt", "json"):
                    if os.path.exists(self._path(s, ext)):
                        os.remove(self._path(s, ext))

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Optional[dict]:
        """The payload of ``step`` (default the latest) with its tensors on
        the CPU, or None when there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)


def load_snapshot(path: str, model: torch.nn.Module, log: Callable = print
                  ) -> None:
    """Weights-only warm start (reference --snapshot: train.py:367-376)
    from a torch file: this package's checkpoint (``{"model": ...}``), a
    reference ``{"state_dict": ...}`` or a bare state dict, in the
    reference's state-dict names, merged with :func:`forgiving_merge`."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("model") or ckpt.get("state_dict") or ckpt
    merged = forgiving_merge(model.state_dict(),
                             strip_reference_prefixes(state), log)
    model.load_state_dict(merged)


class AutoResume:
    """File-based preemption handshake (reference: the cluster AutoResume
    hook, train.py:303-321, 343-358): when the file named by
    ``TPUSEG_TERMINATE_FILE`` exists, training checkpoints and exits; a
    restart resumes from the latest checkpoint."""

    def __init__(self, signal_file: Optional[str] = None):
        self.signal_file = signal_file

    def termination_requested(self) -> bool:
        return bool(self.signal_file) and os.path.exists(self.signal_file)
