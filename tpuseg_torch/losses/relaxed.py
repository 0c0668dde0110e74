"""Boundary-relaxed soft NLL over multi-hot border targets (label
relaxation: Zhu et al., "Improving Semantic Segmentation via Video
Propagation and Label Relaxation", CVPR 2019).

Port of ``tpuseg/losses/relaxed.py:29-87`` (reference: ImgWtLossSoftNLL +
customsoftmax, loss/utils.py:137-231), over NHWC logits and the
(B, H, W, C+1) multi-hot f32 targets of ``data/relaxed_labels.py``. Along
class borders every class of the border window is acceptable;
``customsoftmax`` lets the model put its mass on any of them:

  smax = log(max(softmax(x), multihot * sum(softmax(x) * multihot)))

Each image weights its pixels with its own border weights: the reference
passes the whole batch's weights into every per-image term, which
broadcasts and double-counts at batch > 1 (loss/utils.py:221-228); the two
agree at batch 1. ``invert_border`` is the reference's flip after
REDUCE_BORDER_EPOCH (loss/utils.py:183-186), which the train loop sets.
"""
from __future__ import annotations

import torch

from tpuseg_torch.ops import upcast
from tpuseg_torch.parallel import global_sum, process_count, spatial


def _class_weights(hist_src: torch.Tensor, num_classes: int,
                   upper_bound: float, norm: bool) -> torch.Tensor:
    """(..., C+1) per-class pixel sums -> (..., C) class weights from the
    full histogram: the ignore channel counts in the denominator, then its
    weight is dropped (reference calculate_weights: loss/utils.py:165-177)."""
    hist = hist_src / hist_src.sum(dim=-1, keepdim=True).clamp_min(1.0)
    present = (hist != 0).to(hist.dtype)
    if norm:
        w = present * upper_bound * (1.0 / hist.clamp_min(1e-12)) + 1.0
    else:
        w = present * upper_bound * (1.0 - hist) + 1.0
    return w[..., :num_classes]


def relaxed_soft_nll(logits: torch.Tensor, relaxed_target: torch.Tensor,
                     upper_bound: float = 1.0, norm: bool = False,
                     batch_weighting: bool = False,
                     invert_border: bool = False,
                     data_parallel: bool = False) -> torch.Tensor:
    """Args:
      logits: (B, H, W, C).
      relaxed_target: (B, H, W, C+1) multi-hot float; channel C flags
        ignore.
      invert_border: after REDUCE_BORDER_EPOCH, weight borders up instead
        of down and clip multi-hot targets to 1.
      data_parallel: this rank's share of the global batch's loss times the
        number of ranks, the ``batch_weighting`` histogram summed across
        ranks (``losses/ce.py``).
    Returns the per-image normalised loss summed over the batch (f32)."""
    num_classes = logits.shape[-1]
    full = upcast(relaxed_target)
    target = full[..., :num_classes]

    border_weights = target.sum(dim=-1)                      # (B, H, W)
    ignore_mask = border_weights == 0
    border_weights = torch.where(ignore_mask, 1.0, border_weights)
    if invert_border:
        target = target.clamp(0.0, 1.0)
        border_weights = 1.0 / border_weights

    world = process_count() if data_parallel else 1
    local = full.sum(dim=(1, 2))                              # (B, C+1)
    if batch_weighting:
        hist = local.sum(dim=0)
        if world > 1:
            hist = global_sum(hist)
        wts = _class_weights(hist, num_classes, upper_bound,
                             norm).expand(logits.shape[0], num_classes)
    else:
        # over the image's bands on dp x sp (parallel/spatial.py)
        wts = _class_weights(spatial.band_sum(local), num_classes,
                             upper_bound, norm)

    # customsoftmax in f32 (reference: loss/utils.py:137-147)
    soft = torch.softmax(upcast(logits), dim=-1)
    border_mass = (soft * target).sum(dim=-1, keepdim=True)
    smax = torch.log(torch.maximum(soft, target * border_mass) + 1e-30)

    weighted = (target * wts[:, None, None, :] * smax).sum(dim=-1)
    loss_matrix = (-1.0 / border_weights) * weighted * (~ignore_mask)

    # per-image normalisation by the non-ignored pixel count (+1 against a
    # division by 0, reference: loss/utils.py:200-205), summed over the
    # batch; on bands h counts a band's padding rows, whose targets are
    # empty (ignored), so the count is the image's true one
    h, w = logits.shape[1:3]
    denom = spatial.band_sum(h * w - ignore_mask.sum(dim=(1, 2))) + 1.0
    return (loss_matrix.sum(dim=(1, 2)) / denom).sum() * world
