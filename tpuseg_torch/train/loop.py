"""Eval-only entry (port of ``tpuseg/train/loop.py:414-519``
``evaluate_only``; reference: train.py:406-429 --eval paths).

The ``Trainer`` waits for the training slice (ROADMAP Queue 1 item 9).
Image dumps wait for the dumper port (Queue 1 item 13): every dump option
raises ``NotImplementedError`` instead of being skipped.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from tpuseg_torch.config import Config, eval_model_config, infer_mscale
from tpuseg_torch.convert import load_reference_checkpoint
from tpuseg_torch.data.setup import setup_data
from tpuseg_torch.evaluation.inference import DRAIN_EVERY, EvalRunner
from tpuseg_torch.evaluation.metrics import (
    eval_metrics_from_hist,
    format_evaluate_results,
)
from tpuseg_torch.losses import get_val_loss
from tpuseg_torch.models import get_model
from tpuseg_torch.utils.logging import Logger

_DUMP_OPTIONS = ("dump_assets", "dump_all_images", "dump_for_auto_labelling",
                 "dump_for_submission", "dump_topn")


def resolve_device(device: str) -> torch.device:
    """The eval device; asking for CUDA without a CUDA device raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass --device cpu to run on the CPU")
    return dev


def evaluate_only(cfg: Config, logdir: str = "logs",
                  eval_mode: str = "val", checkpoint: Optional[str] = None,
                  device: str = "cuda"):
    """Score ``cfg``'s model on the val (or train) split. ``checkpoint``
    is a reference-format torch state dict; without it the weights are a
    seeded fresh init (``train.seed``). Returns the IoU metrics."""
    wanted = [o for o in _DUMP_OPTIONS if getattr(cfg.eval, o)]
    if eval_mode == "folder":
        wanted.append("eval_mode=folder (dumps every image)")
    if wanted:
        raise NotImplementedError(
            f"image dumps are not ported to tpuseg_torch yet (ROADMAP.md "
            f"Queue 1 item 13): {', '.join(wanted)}; run with "
            f"--set eval.dump_assets=false")
    dev = resolve_device(device)
    logger = Logger(logdir)

    model = get_model(eval_model_config(cfg), seed=cfg.train.seed)
    if checkpoint:
        load_reference_checkpoint(model, checkpoint)
        logger.msg(f"loaded {checkpoint}")
    model = model.to(device=dev, memory_format=torch.channels_last).eval()

    _, val_loader, _ = setup_data(cfg, eval_mode=eval_mode,
                                  seed=cfg.train.seed)
    runner = EvalRunner(
        model, cfg.dataset.num_classes,
        scales=(cfg.eval.default_scale, *(cfg.eval.extra_scales or ())),
        do_flip=cfg.eval.do_flip, align_corners=cfg.model.align_corners,
        is_mscale=infer_mscale(cfg), ignore_label=cfg.dataset.ignore_label,
        criterion=get_val_loss(cfg), pad_multiple=cfg.eval.pad_multiple,
        mean=cfg.dataset.mean, std=cfg.dataset.std, device=dev)
    calc_metrics = not cfg.eval.no_metrics

    n = cfg.dataset.num_classes
    total_hist = np.zeros((n, n), np.float64)
    scale_hists: dict = {}
    acc = runner.init_acc()

    def _drain():
        nonlocal acc, total_hist
        h, sh, _, _ = runner.drain(acc)
        total_hist += h
        for s, v in sh.items():
            scale_hists[s] = scale_hists.get(s, 0) + v
        acc = runner.init_acc()

    images = pixels = 0
    t_first = None
    for val_idx, batch in enumerate(val_loader):
        if cfg.train.test_mode and val_idx >= 5:
            break
        _, acc = runner.run_batch(batch, calc_metrics, need_assets=False,
                                  acc=acc)
        b, h, w = np.shape(batch["label"])[:3]
        images, pixels = images + b, pixels + b * h * w
        if val_idx == 0:
            # the first batch pays cuDNN's algorithm search: time the rest
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t_first, px_first, im_first = time.perf_counter(), pixels, images
        if (val_idx + 1) % DRAIN_EVERY == 0:
            _drain()
        if val_idx % 20 == 0:
            logger.msg(f"eval [{val_idx}/{len(val_loader)}]")
    _drain()  # reads the accumulator back: synchronizes the device
    if t_first is not None and images > im_first:
        dt = time.perf_counter() - t_first
        logger.msg(f"eval: {images} images on {dev}; after the first: "
                   f"{(images - im_first) / dt:.4f} img/s, "
                   f"{(pixels - px_first) / dt / 1e6:.4f} Mpx/s")
    if not calc_metrics:
        return None
    metrics = eval_metrics_from_hist(total_hist)
    class_names = list(getattr(val_loader.dataset, "trainid_to_name",
                               {}).values()) or None
    logger.msg("\n" + format_evaluate_results(total_hist, class_names,
                                              iou_per_scale=scale_hists))
    logger.msg(f"mean mIoU: {metrics.mean_iou:.4f}")
    return metrics
