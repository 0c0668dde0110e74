"""The train step (port of ``tpuseg/train/step.py:20-86``; loss composition
per reference ocrnet.py:300-319).

``tpuseg``'s loss is a pure function of ``(params, batch_stats, batch,
rng)``; a torch module carries its own weights and BN statistics, so here
the loss takes the module: ``loss_fn(model, batch)``, with ``model`` in
train mode. Dropout draws from torch's default generator of the device.
"""
from __future__ import annotations

from typing import Callable

import torch

from tpuseg_torch.ops import device_label, device_normalize, resize_bilinear
from tpuseg_torch.ops.normalize import IMAGENET_MEAN, IMAGENET_STD
from tpuseg_torch.parallel import spatial
from tpuseg_torch.train.optim import set_lr
from tpuseg_torch.utils.profiling import span


def _scale_as_nhwc(x: torch.Tensor, y: torch.Tensor, align_corners: bool
                   ) -> torch.Tensor:
    """Resize NHWC ``x`` to the spatial size of NHWC ``y``."""
    size = spatial.global_height(y, dim=1), y.shape[2]
    out = resize_bilinear(x.permute(0, 3, 1, 2), size, align_corners)
    return out.permute(0, 2, 3, 1)


def make_loss_fn(criterion: Callable, ocr_alpha: float = 0.4,
                 aux_rmi: bool = False, supervised_mscale_wt: float = 0.0,
                 align_corners: bool = False, mean=IMAGENET_MEAN,
                 std=IMAGENET_STD):
    """-> ``loss_fn(model, batch) -> loss``: the train-mode forward of a
    batch of device tensors (uint8 or f32 NHWC image, NHW label) and the
    loss composition of ``tpuseg`` in its order: main, ``ocr_alpha`` x aux,
    ``supervised_mscale_wt`` x (0.5x + 1.0x) without RMI."""

    def loss_fn(model, batch):
        out = model(device_normalize(batch["image"], mean, std))
        labels = device_label(batch["label"])
        loss = criterion(out["pred"], labels, do_rmi=True)
        # only OCR-family models return an aux head (ocrnet.py:118,300-311)
        if "aux" in out:
            loss = loss + ocr_alpha * criterion(out["aux"], labels,
                                                do_rmi=aux_rmi)
        if supervised_mscale_wt and "pred_05x" in out:
            p05 = _scale_as_nhwc(out["pred_05x"], out["pred"], align_corners)
            loss_lo = criterion(p05, labels, do_rmi=False)
            loss_hi = criterion(out["pred_10x"], labels, do_rmi=False)
            loss = loss + supervised_mscale_wt * (loss_lo + loss_hi)
        return loss

    return loss_fn


def make_train_step(criterion: Callable, schedule: Callable[[int], float],
                    ocr_alpha: float = 0.4, aux_rmi: bool = False,
                    supervised_mscale_wt: float = 0.0,
                    align_corners: bool = False, mean=IMAGENET_MEAN,
                    std=IMAGENET_STD):
    """-> ``train_step(model, optimizer, batch, step) -> {"loss"}``: the LR
    set to ``schedule(step)`` (``step`` = steps taken before this one),
    gradients zeroed, forward, backward, optimizer step. The loss stays on
    the device."""
    loss_fn = make_loss_fn(criterion, ocr_alpha, aux_rmi,
                           supervised_mscale_wt, align_corners, mean, std)

    def train_step(model, optimizer, batch, step: int):
        with span("train.optimizer"):
            set_lr(optimizer, schedule(step))
            optimizer.zero_grad(set_to_none=True)
        with span("train.forward"):
            loss = loss_fn(model, batch)
        with span("train.backward"):
            loss.backward()
        with span("train.optimizer"):
            optimizer.step()
        return {"loss": loss.detach()}

    return train_step
