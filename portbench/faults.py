"""Faults planted under a cell's timed path, each of which the cell's
comparison has to find; not used by the benchmark's runs.

``plant(kind, name, patch)`` plants fault ``name`` for a cell of traffic
``kind`` through ``patch.setattr(owner, attribute, value)``: pytest's
``monkeypatch`` in the tests, a ``Patch`` in ``control.py --fault`` on the
card. The faults:

- ``state_unchanged``: eval, the confusion matrix never accumulated; train,
  SGD's step returns with nothing changed;
- ``half_batch``: eval, the forward over the first half of a batch, its
  results copied to the second half; train, the loss over the first half,
  the mean taken over it;
- ``answer_altered``: eval, class 0's logit raised by 3 standard
  deviations where the forward produces it; train, the gradient of the
  leaf whose gradient is largest doubled where backward leaves it, before
  SGD reads it.
"""
from __future__ import annotations

import torch

FAULTS = ("state_unchanged", "half_batch", "answer_altered")


class Patch:
    """``setattr`` with every change undone by ``undo``."""

    def __init__(self):
        self._saved = []

    def setattr(self, owner, name: str, value) -> None:
        self._saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self) -> None:
        while self._saved:
            owner, name, value = self._saved.pop()
            setattr(owner, name, value)


def _halve(fn):
    """``fn`` over the first half of a batch, the second half's result a
    copy of the first's."""
    def run(model, x):
        h = x.shape[0] // 2
        out = fn(model, x[:h])
        return {k: torch.cat([v, v], 0) for k, v in out.items()}
    return run


def _eval(name: str, patch) -> None:
    from tpuseg_torch.evaluation import inference
    from tpuseg_torch.models.ocrnet import MscaleOCR

    fwd = MscaleOCR.forward
    if name == "state_unchanged":
        patch.setattr(inference, "fast_hist_torch",
                      lambda p, g, n: torch.zeros(
                          (n, n), dtype=torch.long, device=p.device))
    elif name == "half_batch":
        patch.setattr(MscaleOCR, "forward", _halve(fwd))
    elif name == "answer_altered":
        def altered(model, x):
            out = fwd(model, x)
            pred = out["pred"].clone()
            pred[..., 0] += 3.0 * pred.std()
            return {**out, "pred": pred}
        patch.setattr(MscaleOCR, "forward", altered)
    else:
        raise ValueError(name)


def _train(name: str, patch) -> None:
    from tpuseg_torch.train import step

    sgd_step = torch.optim.SGD.step
    if name == "state_unchanged":
        patch.setattr(torch.optim.SGD, "step",
                      lambda self, closure=None: None)
    elif name == "half_batch":
        make = step.make_loss_fn

        def half(*a, **k):
            fn = make(*a, **k)

            def loss_fn(model, batch):
                h = batch["image"].shape[0] // 2
                return fn(model, {k: v[:h] for k, v in batch.items()})
            return loss_fn
        patch.setattr(step, "make_loss_fn", half)
    elif name == "answer_altered":
        def doubled(self, closure=None):
            grads = [p.grad for g in self.param_groups for p in g["params"]
                     if p.grad is not None]
            norms = torch.stack(torch._foreach_norm(grads))
            grads[int(norms.argmax())].mul_(2.0)
            return sgd_step(self, closure)
        patch.setattr(torch.optim.SGD, "step", doubled)
    else:
        raise ValueError(name)


def plant(kind: str, name: str, patch) -> None:
    {"eval": _eval, "train": _train}[kind](name, patch)
