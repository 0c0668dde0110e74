"""Cross-entropy losses (port of ``tpuseg/losses/ce.py``; reference
loss/utils.py:70-134). Logits are NHWC, labels NHW, as in ``tpuseg``.

``tpuseg``'s loss is a function of the global batch. With
``data_parallel`` each rank returns its share of it times the number of
ranks: the denominators and batch histograms are summed across ranks, so
DDP's mean of the ranks' gradients is the gradient of the global loss, and
the mean of the ranks' losses is the global loss. In one process the
result is the same either way. On bands (dp x sp, ``parallel/spatial.py``)
the global sums already cover every pixel once; a per-image histogram or
denominator is summed over the image's bands.
"""
from __future__ import annotations

import torch

from tpuseg_torch.ops import upcast
from tpuseg_torch.parallel import global_sum, process_count, spatial


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_label: int = 255, data_parallel: bool = False
                  ) -> torch.Tensor:
    """Mean CE over pixels whose label is in [0, C) (so ``ignore_label``
    and every other out-of-range label are dropped, as in ``tpuseg``), over
    the global batch with ``data_parallel``.
    logits (B, H, W, C) float, labels (B, H, W) int -> f32 scalar."""
    num_classes = logits.shape[-1]
    labels = labels.long()
    valid = (labels >= 0) & (labels < num_classes)
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(upcast(logits), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    world = process_count() if data_parallel else 1
    count = valid.sum() if world == 1 else global_sum(valid.sum())
    return nll.sum() * world / count.clamp_min(1)


def _class_weights(labels: torch.Tensor, num_classes: int,
                   upper_bound: float, norm: bool,
                   dtype: torch.dtype,
                   data_parallel: bool = False) -> torch.Tensor:
    """Class weights from each image's label histogram (reference
    calculate_weights: loss/utils.py:87-100), the histograms summed across
    ranks with ``data_parallel``. labels (B, H, W) long -> (B, C) in
    ``dtype`` (the log-probabilities'); labels outside [0, C) are left out
    of the histogram."""
    b = labels.shape[0]
    valid = (labels >= 0) & (labels < num_classes)
    idx = torch.where(valid, labels, torch.full_like(labels, num_classes))
    # one bincount over the batch: image i's bins start at i * (C + 1)
    offset = torch.arange(b, device=labels.device)[:, None] * (
        num_classes + 1)
    bins = torch.bincount((idx.reshape(b, -1) + offset).reshape(-1),
                          minlength=b * (num_classes + 1))
    bins = global_sum(bins) if data_parallel else spatial.band_sum(bins)
    bins = bins.reshape(b, num_classes + 1)[:, :num_classes].to(dtype)
    hist_norm = bins / bins.sum(dim=1, keepdim=True).clamp_min(1.0)
    present = (bins != 0).to(dtype)
    if norm:
        return present * upper_bound / hist_norm.clamp_min(1e-12) + 1.0
    return present * upper_bound * (1.0 - hist_norm) + 1.0


def image_weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 ignore_label: int = 255,
                                 upper_bound: float = 1.0, norm: bool = False,
                                 batch_weighting: bool = False,
                                 data_parallel: bool = False
                                 ) -> torch.Tensor:
    """Sum over images of each image's class-weighted mean NLL (reference
    ImageBasedCrossEntropyLoss2d: loss/utils.py:70-118), with torch
    ``NLLLoss(weight)``'s normalisation by the summed pixel weights. The
    weights come from each image's own histogram, or with
    ``batch_weighting`` from the whole (global) batch's
    (loss/utils.py:104-106)."""
    num_classes = logits.shape[-1]
    labels = labels.long()
    b = labels.shape[0]
    valid = (labels >= 0) & (labels < num_classes)
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(upcast(logits), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    world = process_count() if data_parallel else 1
    if batch_weighting:
        weights = _class_weights(labels.reshape(1, -1), num_classes,
                                 upper_bound, norm, logp.dtype,
                                 data_parallel=world > 1).expand(b, -1)
    else:
        weights = _class_weights(labels, num_classes, upper_bound, norm,
                                 logp.dtype)
    pix_w = weights.gather(1, safe.reshape(b, -1)).reshape(safe.shape)
    pix_w = torch.where(valid, pix_w, torch.zeros_like(pix_w))
    per_image = (nll * pix_w).sum(dim=(1, 2)) / spatial.band_sum(
        pix_w.sum(dim=(1, 2))).clamp_min(1e-8)
    return per_image.sum() * world
