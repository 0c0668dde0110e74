"""Confusion-matrix metrics: mIoU, accuracies, per-class tables.

Port of ``tpuseg/evaluation/metrics.py``. The device confusion matrix is a
``torch.bincount``; the host helpers are copies of ``tpuseg``'s numpy code
(that module imports ``jax.numpy``), pinned to print identical tables by
tests/test_torch_ops.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def fast_hist_torch(pred: torch.Tensor, gt: torch.Tensor,
                    num_classes: int) -> torch.Tensor:
    """Confusion matrix on the tensors' device (tpuseg ``fast_hist_jax``).

    ``hist[i, j]`` = pixels of ground-truth class i predicted as j
    (reference: utils/misc.py:50-67). Pixels whose gt is outside
    [0, num_classes) (e.g. ignore = 255) go to an overflow bin that is
    dropped; predictions are clipped to [0, num_classes). Returns an int64
    (num_classes, num_classes) tensor."""
    n = num_classes
    pred = pred.reshape(-1).long()
    gt = gt.reshape(-1).long()
    valid = (gt >= 0) & (gt < n)
    idx = torch.where(valid, gt * n + pred.clamp(0, n - 1),
                      torch.full_like(gt, n * n))
    counts = torch.bincount(idx, minlength=n * n + 1)
    return counts[:-1].reshape(n, n)


def fast_hist(pred: np.ndarray, gt: np.ndarray, num_classes: int) -> np.ndarray:
    """Host (numpy) confusion matrix, same semantics as :func:`fast_hist_torch`."""
    pred = np.asarray(pred).reshape(-1).astype(np.int64)
    gt = np.asarray(gt).reshape(-1).astype(np.int64)
    valid = (gt >= 0) & (gt < num_classes)
    return np.bincount(
        num_classes * gt[valid] + np.clip(pred[valid], 0, num_classes - 1),
        minlength=num_classes ** 2,
    ).reshape(num_classes, num_classes)


@dataclass
class IoUMetrics:
    iou: np.ndarray          # per-class IoU
    mean_iou: float
    acc: float               # pixel accuracy
    acc_cls: float           # mean per-class accuracy
    fwavacc: float           # frequency-weighted IoU
    hist: np.ndarray


def eval_metrics_from_hist(hist: np.ndarray) -> IoUMetrics:
    """IoU / accuracy family from a confusion matrix
    (reference: utils/misc.py:78-114)."""
    hist = np.asarray(hist, dtype=np.float64)
    tp = np.diag(hist)
    gt_per_class = hist.sum(axis=1)
    pred_per_class = hist.sum(axis=0)
    denom = gt_per_class + pred_per_class - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        iu = tp / denom
        acc_cls_per = tp / gt_per_class
    acc = tp.sum() / max(hist.sum(), 1)
    acc_cls = float(np.nanmean(acc_cls_per))
    mean_iou = float(np.nanmean(iu))
    freq = gt_per_class / max(hist.sum(), 1)
    fwavacc = float((freq[denom > 0] * iu[denom > 0]).sum())
    return IoUMetrics(iou=iu, mean_iou=mean_iou, acc=float(acc),
                      acc_cls=acc_cls, fwavacc=fwavacc, hist=hist)


def format_evaluate_results(hist: np.ndarray, class_names: list[str] | None = None,
                            epoch: int = 0,
                            iou_per_scale: dict | None = None) -> str:
    """Per-class IoU/precision/recall table (reference: utils/misc.py:420-473);
    ``iou_per_scale`` maps an outer scale to its confusion matrix."""
    hist = np.asarray(hist, dtype=np.float64)
    n = hist.shape[0]
    if class_names is None:
        class_names = [str(i) for i in range(n)]
    tp = np.diag(hist)
    fp = hist.sum(axis=0) - tp
    fn = hist.sum(axis=1) - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        iu = tp / (tp + fp + fn)
        precision = tp / (tp + fp)
        recall = tp / (tp + fn)
        scale_ius = {}
        for scale, shist in (iou_per_scale or {}).items():
            shist = np.asarray(shist, dtype=np.float64)
            stp = np.diag(shist)
            scale_ius[scale] = stp / (shist.sum(axis=0) + shist.sum(axis=1)
                                      - stp)
    scale_hdr = "".join(f" {'iU_' + str(s):>9}" for s in scale_ius)
    lines = [f"IoU results (epoch {epoch}):",
             f"{'id':>3} {'class':<16} {'iou':>7} {'precision':>10} "
             f"{'recall':>8} {'tp':>12} {'fp':>12} {'fn':>12}" + scale_hdr]
    for i in range(n):
        scale_cols = "".join(f" {siu[i] * 100:>8.2f}%"
                             for siu in scale_ius.values())
        lines.append(
            f"{i:>3} {class_names[i]:<16} {iu[i] * 100:>6.2f}% "
            f"{precision[i]:>10.4f} {recall[i]:>8.4f} "
            f"{tp[i]:>12.0f} {fp[i]:>12.0f} {fn[i]:>12.0f}" + scale_cols)
    lines.append(f"mean iou: {np.nanmean(iu) * 100:.2f}%")
    for scale, siu in scale_ius.items():
        lines.append(f"mean iou @{scale}x: {np.nanmean(siu) * 100:.2f}%")
    return "\n".join(lines)


def fmt_scale(prefix: str, scale: float) -> str:
    """'pred_0.5x'-style asset keys (reference: utils/misc.py:504-513; the
    reference's keys keep the dot)."""
    return f"{prefix}_{float(scale)}x"
