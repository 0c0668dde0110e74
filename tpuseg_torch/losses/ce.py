"""Cross-entropy (port of ``tpuseg/losses/ce.py:8-29``; reference
loss/utils.py:121-134). Training losses wait for the training slice."""
from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_label: int = 255) -> torch.Tensor:
    """Mean CE over pixels whose label is in [0, C) (so ``ignore_label``
    and every other out-of-range label are dropped, as in ``tpuseg``).
    logits (B, H, W, C) float, labels (B, H, W) int -> f32 scalar."""
    num_classes = logits.shape[-1]
    labels = labels.long()
    valid = (labels >= 0) & (labels < num_classes)
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp_min(1)
