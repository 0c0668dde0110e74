"""Eval-time inference: outer flip x scale loop around the (in-model
multi-scale) forward, with the metrics accumulated on the device.

Port of ``tpuseg/evaluation/inference.py:49-302`` (reference: eval_minibatch,
utils/trnval_utils.py:82-198). Eager PyTorch under ``torch.inference_mode``:
there is no ``jit``. Images and labels are NHWC / NHW: numpy arrays from
the loader at ``EvalRunner.run_batch``, device tensors at the forward.

The accumulator (confusion matrix, per-outer-scale matrices, val-loss sum)
lives on the device and is updated in place; the host reads it back only at
a ``drain`` (every ``DRAIN_EVERY`` batches in ``evaluate_only``).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from tpuseg_torch.evaluation.metrics import fast_hist_torch, fmt_scale
from tpuseg_torch.ops import device_label, device_normalize, resize_bilinear
from tpuseg_torch.ops.normalize import IMAGENET_MEAN, IMAGENET_STD
from tpuseg_torch.utils.profiling import count, span

# batches between accumulator drains (one small device->host read each)
DRAIN_EVERY = 8


def calc_err_mask_all(pred: np.ndarray, gt: np.ndarray,
                      num_classes: int, ignore_label: int = 255) -> np.ndarray:
    """Class-agnostic error mask (reference: trnval_utils.py:71-79)."""
    mask = (gt >= 0) & (gt != ignore_label)
    return (mask & (pred != gt)).astype(int)


def calc_err_mask(pred, gt, classid, ignore_label: int = 255):
    """Class-specific error mask (reference: trnval_utils.py:58-68)."""
    class_mask = (gt >= 0) & (gt == classid)
    fp = (pred == classid) & ~class_mask & (gt != ignore_label)
    fn = (pred != classid) & class_mask
    return (fp | fn).astype(int)


def _resize_nhwc(x: torch.Tensor, size, align_corners: bool) -> torch.Tensor:
    y = resize_bilinear(x.permute(0, 3, 1, 2), size, align_corners)
    return y.permute(0, 2, 3, 1)


def make_eval_forward(model, num_classes: int, scales=(1.0,),
                      do_flip: bool = False, align_corners: bool = False,
                      is_mscale: bool = True,
                      criterion: Optional[Callable] = None,
                      mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """The full eval forward:
    ``fn(image, label, acc, valid_hw=None) -> (avg_logits f32, pred int32,
    prob f32, assets)``, updating ``acc`` in place.

    ``valid_hw`` marks the un-padded region of a shape-bucketed batch: the
    padded border is masked to 0.0 AFTER on-device normalization, the value
    the f32 wire's host-side zero-pad carries, so padded batches agree
    across wire formats (tpuseg inference.py:85-95)."""

    def forward(image, label, acc, valid_hw=None):
        with span("eval.forward"):
            image = device_normalize(image, mean, std)
            label = device_label(label)
            if valid_hw is not None:
                h, w = image.shape[1:3]
                dev = image.device
                mask = ((torch.arange(h, device=dev) < valid_hw[0])[:, None]
                        & (torch.arange(w, device=dev)
                           < valid_hw[1])[None, :])
                image = image * mask[None, :, :, None].to(image.dtype)
            input_size = tuple(image.shape[1:3])
            flips = (1, 0) if do_flip else (0,)
            output = 0.0
            output_dict = {}
            per_scale = {s: 0.0 for s in scales} if len(scales) > 1 else {}
            for flip in flips:
                for scale in scales:
                    x = torch.flip(image, dims=[2]) if flip else image
                    if scale != 1.0:
                        size = [round(s * scale) for s in input_size]
                        x = _resize_nhwc(x, size, align_corners)
                    odict = model(x)
                    pred = odict["pred"].float()
                    if not is_mscale:
                        output_dict[fmt_scale("pred", scale)] = pred
                    if flip == 0 and scale == scales[0]:
                        # per-scale assets of the canonical orientation
                        for k, v in odict.items():
                            if k.startswith(("pred_", "attn_")):
                                output_dict[k] = v.float()
                    if scale != 1.0:
                        pred = _resize_nhwc(pred, input_size, align_corners)
                    pred = torch.flip(pred, dims=[2]) if flip else pred
                    output = output + pred
                    if per_scale:
                        per_scale[scale] = per_scale[scale] + pred
            output = output / (len(scales) * len(flips))

        with span("eval.score"):
            prob = torch.softmax(output, dim=-1).amax(dim=-1)
            prediction = output.argmax(dim=-1).to(torch.int32)
            acc["hist"] += fast_hist_torch(prediction, label, num_classes)
            for s, v in per_scale.items():
                acc["scale_hists"][s] += fast_hist_torch(
                    v.argmax(dim=-1), label, num_classes)
            if criterion is not None:
                # padded label pixels are ignore: the masked mean is exact
                bs = image.shape[0]
                acc["loss_sum"] += criterion(output, label).float() * bs
                acc["loss_n"] += bs
            assets = {}
            for k, v in output_dict.items():
                if k.startswith("attn_"):
                    assets[k] = v
                elif k.startswith("pred_"):
                    assets[k] = v.argmax(dim=-1).to(torch.int32)
        return output, prediction, prob, assets

    return forward


class EvalRunner:
    """Drives eval batches through ``make_eval_forward`` on ``device`` (the
    card unless the caller names another; tpuseg ``EvalRunner``;
    reference: train.py:536-597).

    ``pad_multiple`` buckets variable-size images by padding H/W up to a
    multiple on the host (labels padded with ignore) and cropping outputs
    back; the padded image border is masked on the device after
    normalization."""

    def __init__(self, model, num_classes: int, scales=(1.0,),
                 do_flip: bool = False, align_corners: bool = False,
                 is_mscale: bool = True, ignore_label: int = 255,
                 criterion: Optional[Callable] = None,
                 pad_multiple: Optional[int] = None,
                 mean=IMAGENET_MEAN, std=IMAGENET_STD, device="cuda"):
        self.model = model
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.pad_multiple = pad_multiple
        self.device = torch.device(device)
        self.scale_hist_scales = tuple(scales) if len(scales) > 1 else ()
        self.has_criterion = criterion is not None
        self.shapes: set = set()  # the (B, H, W) batches run so far
        self.forward = make_eval_forward(model, num_classes, scales, do_flip,
                                         align_corners, is_mscale, criterion,
                                         mean, std)

    def init_acc(self):
        """Fresh device-resident accumulator."""
        c, dev = self.num_classes, self.device
        return {
            "hist": torch.zeros((c, c), dtype=torch.int64, device=dev),
            "scale_hists": {s: torch.zeros((c, c), dtype=torch.int64,
                                           device=dev)
                            for s in self.scale_hist_scales},
            "loss_sum": torch.zeros((), dtype=torch.float32, device=dev),
            "loss_n": torch.zeros((), dtype=torch.float32, device=dev),
        }

    def drain(self, acc):
        """Read an accumulator back to the host (one sync). Returns
        (hist f64, {scale: hist f64}, loss_sum, loss_n)."""
        with span("eval.drain"):
            return (acc["hist"].cpu().numpy().astype(np.float64),
                    {s: v.cpu().numpy().astype(np.float64)
                     for s, v in acc["scale_hists"].items()},
                    float(acc["loss_sum"]), float(acc["loss_n"]))

    def _pad(self, image: np.ndarray, label: np.ndarray):
        m = self.pad_multiple
        h, w = image.shape[1:3]
        ph, pw = (-h) % m, (-w) % m
        if ph == 0 and pw == 0:
            return image, label, (h, w)
        image = np.pad(image, ((0, 0), (0, ph), (0, pw), (0, 0)))
        label = np.pad(label, ((0, 0), (0, ph), (0, pw)), mode="constant",
                       constant_values=self.ignore_label)
        return image, label, (h, w)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.inference_mode()
    def run_batch(self, batch, calc_metrics: bool = True,
                  need_assets: bool = True, acc=None):
        """One eval batch of loader (numpy) arrays.

        With ``acc`` given, accumulates into it on the device and returns
        ``(out, acc)`` with no device->host sync unless ``need_assets``.
        Without, returns ``(out, hist_np, val_loss)`` after a drain."""
        legacy = acc is None
        if legacy:
            acc = self.init_acc()
        image, label = batch["image"], batch["label"]
        orig_hw = None
        if self.pad_multiple:
            image, label, orig_hw = self._pad(np.asarray(image),
                                              np.asarray(label))
        with span("eval.upload"):
            image, label = self._to_device(image), self._to_device(label)
        if tuple(image.shape[:3]) not in self.shapes:
            # a new (B, H, W): cuDNN chooses its algorithms again
            self.shapes.add(tuple(image.shape[:3]))
            count("eval.new_shapes")
        output, pred, prob, assets = self.forward(image, label, acc, orig_hw)
        if orig_hw is not None:
            h, w = orig_hw
            pred, prob = pred[:, :h, :w], prob[:, :h, :w]
            assets = {k: v[:, :h, :w] if v.dim() >= 3 and v.shape[1] >= h
                      and v.shape[2] >= w else v for k, v in assets.items()}
        out = {}
        if need_assets:
            # full-resolution device->host reads (tens of MB an image at
            # 1024x2048): callers ask only for batches the dumper writes
            out["predictions"] = pred.cpu().numpy()
            out["prob_mask"] = prob.cpu().numpy()
            for k, v in assets.items():
                out[k] = v.cpu().numpy()
            if calc_metrics:
                out["err_mask"] = calc_err_mask_all(
                    out["predictions"], np.asarray(batch["label"]),
                    self.num_classes, self.ignore_label)
        if not legacy:
            return out, acc
        hist, scale_hists, loss_sum, loss_n = self.drain(acc)
        if scale_hists:
            out["scale_hists"] = scale_hists
        val_loss = None
        if calc_metrics and self.has_criterion and loss_n:
            val_loss = loss_sum / loss_n
        return out, hist, val_loss
