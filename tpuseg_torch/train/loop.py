"""Training and eval orchestration (port of ``tpuseg/train/loop.py:56-532``;
reference: train.py:324-597), on one device or as data-parallel ranks.

``tpuseg``'s ``TrainState`` pytree (step, params, batch_stats, opt_state)
becomes the ``Trainer``'s ``model`` (weights and BN statistics),
``optimizer`` and ``step``. One module serves training and validation:
``MscaleOCR`` runs its two-scale forward in train mode and the n-scale
fusion over the eval scales in eval mode, so ``validate`` switches the
same module to ``.eval()`` and back.

Validation and ``evaluate_only`` dump images as ``tpuseg``'s do
(``evaluation/dumper.py``: ``<logdir>/best_images`` and
``<logdir>/eval_images`` or ``eval.result_dir``), with the full-resolution
device reads only for the batches the dumper writes; ``eval.dump_topn``
runs the two-pass failure gallery (``evaluation/topn.py``).

With more than one rank (``tpuseg_torch.parallel``, the CLI's
``--multi-host``), each rank trains on its shard of the global batch
(``train.batch_size`` is global, as in ``tpuseg``) through
``DistributedDataParallel``; batch norm and the losses reduce over the
global batch (``models/layers.py``, ``losses/``). Each rank validates its
shard of the val split, and the confusion matrices are summed across ranks
in the runner's static scale order (``_reduce_scale_hists``), so every rank
holds the same metrics. Rank 0 writes the checkpoints and the primary
logs; a termination request on any rank stops every rank. Dumps and
``eval.dump_topn`` run on each rank's shard, as in ``tpuseg``.

Label relaxation (``loss.loss_type=relaxed`` with
``dataset.jointwtborder``) keeps ``tpuseg``'s border schedule: past
``loss.reduce_border_epoch`` the criterion runs with ``invert_border`` and
the train set's label transform becomes the ``reduce_border`` one.

dp x sp (``mesh.model_parallelism = sp > 1``, ``parallel/mesh.py``): the
ranks form a (dp, sp) grid of ``sp`` consecutive ranks a group; the ranks
of a group load the same images (the train data is sharded over the dp
groups) and each trains on its band of every image's rows
(``shard_batch_spatial``, ``spatial.sharded``), padded where the rows do
not split evenly; DDP still averages over every rank. ``check_spatial``
refuses a crop whose deepest map has fewer rows than the sp group has
ranks, as ``tpuseg``'s guard does.
Validation stays whole-image, the val split sharded over every rank, as
``tpuseg`` validates host-locally.
"""
from __future__ import annotations

import math
import os
import time
from functools import partial
from typing import Optional

import numpy as np
import torch

from tpuseg_torch.config import Config, eval_model_config, infer_mscale
from tpuseg_torch.convert import load_reference_checkpoint
from tpuseg_torch.data.cityscapes_labels import TRAINID_TO_ID
from tpuseg_torch.data.setup import relaxed_label_transform, setup_data
from tpuseg_torch.evaluation.dumper import ImageDumper
from tpuseg_torch.evaluation.inference import DRAIN_EVERY, EvalRunner
from tpuseg_torch.evaluation.metrics import (
    eval_metrics_from_hist,
    format_evaluate_results,
)
from tpuseg_torch.losses import get_loss, get_val_loss
from tpuseg_torch.models import band_geometry, get_model
from tpuseg_torch.parallel import (
    any_rank,
    make_mesh,
    multihost_sum,
    per_rank,
    process_count,
    process_index,
    shard_batch_spatial,
    spatial,
    sync_hosts,
)
from tpuseg_torch.train.checkpoint import (
    AutoResume,
    CheckpointManager,
    load_snapshot,
)
from tpuseg_torch.train.optim import make_optimizer
from tpuseg_torch.train.step import make_train_step
from tpuseg_torch.utils.logging import Logger


def resolve_device(device: str) -> torch.device:
    """The run's device; asking for CUDA without a CUDA device raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass --device cpu to run on the CPU")
    return dev


def check_spatial(cfg: Config, world: int) -> None:
    """Refuse a dp x sp run (``mesh.model_parallelism = sp > 1``) before
    any model or data is built unless its deepest feature map at its
    lowest train scale has at least ``sp`` rows, ``floor(crop_h * s_min /
    stride) >= sp``: the stride of the arch's deepest map (32 on the
    HRNetV2 trunk, 8 on the DeepLab trunks) and the lowest of the scales
    a train step runs (1.0, the two-scale pass's low scale and the arch's
    own) from ``models.band_geometry``. On HRNetV2 at the two-scale pass's
    0.5 this is ``tpuseg``'s own guard, ``crop_h // 2 // 32 >= sp``
    (``tpuseg/train/loop.py:73-86``). Maps need not split evenly: the
    bands are padded (``parallel/spatial.py``). The ranks must form whole
    sp groups."""
    sp = cfg.mesh.model_parallelism
    if sp == 1:
        return
    crop = tuple(int(c) for c in cfg.dataset.crop_size)
    stride, own_scales = band_geometry(cfg)
    scales = {1.0, *(float(s) for s in own_scales)}
    if infer_mscale(cfg):
        scales.add(float(cfg.model.mscale_lo_scale))
    s_min = min(scales)
    rows = math.floor(crop[0] * s_min / stride)
    if rows < sp:
        need = math.ceil(sp * stride / s_min)
        raise ValueError(
            f"dataset.crop_size {crop} is too small for "
            f"mesh.model_parallelism={sp}: {cfg.model.arch}'s {s_min:g}x "
            f"pass's stride-{stride} feature maps have {rows} "
            f"row{'s' * (rows != 1)}, fewer than the {sp} bands; the crop "
            f"height must be at least {need}")
    if world % sp:
        raise ValueError(
            f"mesh.model_parallelism={sp} must divide the number of ranks "
            f"({world}): start the ranks with torch.distributed.run and "
            f"--multi-host")


def _reduce_scale_hists(scale_hists: dict, runner: EvalRunner,
                        num_classes: int) -> dict:
    """The per-scale confusion matrices summed across ranks over the
    runner's STATIC scale set, in sorted order (tpuseg loop.py:41-53): a
    rank whose val shard is empty issues the same collectives as its
    peers, so none waits for another."""
    zeros = np.zeros((num_classes, num_classes), np.float64)
    return {s: multihost_sum(np.asarray(scale_hists.get(s, zeros),
                                        np.float64))
            for s in sorted(runner.scale_hist_scales)}


class Trainer:
    """Training (tpuseg ``Trainer``; reference train.py:324-597) on one
    device, or as one rank of a process group: ``fit`` runs
    ``train_epoch`` and ``validate`` per epoch, checkpointing after each
    validation and resuming from the latest checkpoint of ``logdir`` on a
    restart."""

    def __init__(self, cfg: Config, logdir: str = "logs",
                 device: str = "cuda", is_primary: bool = True):
        check_spatial(cfg, process_count())
        self.cfg = cfg
        self.logdir = logdir
        self.device = resolve_device(device)
        self.is_primary = is_primary
        self.logger = Logger(logdir, is_primary)
        self.criterion, self.val_criterion = get_loss(cfg)

        # the eval config's model: n-scale fusion over the eval scales in
        # eval mode, the two-scale forward in train mode
        model = get_model(eval_model_config(cfg), seed=cfg.train.seed)
        self.model = model.to(device=self.device,
                              memory_format=torch.channels_last).train()
        n_params = sum(p.numel() for p in model.parameters())
        self.logger.msg(f"params: {n_params / 1e6:.2f}M on {self.device}")

        # the (dp, sp) grid; this dp group's shard of the global batch
        # (reference DistributedSampler semantics: datasets/sampler.py:
        # 43-110), the val split sharded over every rank
        self.mesh = make_mesh(cfg.mesh.model_parallelism)
        self.train_loader, self.val_loader, self.train_set = setup_data(
            cfg, eval_mode=None, seed=cfg.train.seed,
            num_shards=self.mesh.dp, shard=self.mesh.dp_index,
            val_shards=process_count(), val_shard=process_index(),
            is_primary=is_primary)
        # the train set's ignore label (what a band's padding rows hold in
        # the label, shard_batch_spatial)
        self.ignore_label = getattr(self.train_set, "ignore_label",
                                    cfg.dataset.ignore_label)
        self.steps_per_epoch = max(1, len(self.train_loader))
        if cfg.train.test_mode:
            self.steps_per_epoch = min(self.steps_per_epoch, 10)
        self.optimizer, self.schedule = make_optimizer(
            cfg, self.model.parameters(), self.steps_per_epoch)
        self.step = 0
        # dropout masks come from the device's default generator, seeded
        # per dp group, so the bands of one image draw the same channel
        # masks (tpuseg draws them from one key over the global batch)
        torch.manual_seed(cfg.train.seed + 1 + self.mesh.dp_index)

        self.ckpt = CheckpointManager(
            os.path.join(logdir, cfg.train.checkpoint_dir),
            keep=cfg.train.keep_checkpoints)
        self.auto_resume = AutoResume(os.environ.get("TPUSEG_TERMINATE_FILE"))
        self.start_epoch = 0
        self.best_miou = 0.0
        self._restore()
        # what the train step runs: the module itself, or DDP around it
        # in a process group (gradients averaged across ranks; BN
        # statistics are already global, so its buffers are not broadcast)
        self.net = self.model
        if torch.distributed.is_initialized():
            self.net = torch.nn.parallel.DistributedDataParallel(
                self.model, broadcast_buffers=False,
                device_ids=([self.device.index]
                            if self.device.type == "cuda" else None))
            self.logger.msg(
                f"DistributedDataParallel: {process_count()} ranks, backend "
                f"{torch.distributed.get_backend()}, rank "
                f"{process_index()} on {self.device}")
        if self.mesh.bands is not None:
            self.logger.msg(
                f"mesh: dp {self.mesh.dp} x sp {self.mesh.sp}, each rank "
                f"training on 1/{self.mesh.sp} of every image's rows")

        self.train_step = self._make_train_step(invert_border=False)
        self.eval_runner = EvalRunner(
            self.model, cfg.dataset.num_classes,
            scales=(cfg.eval.default_scale, *(cfg.eval.extra_scales or ())),
            do_flip=cfg.eval.do_flip, align_corners=cfg.model.align_corners,
            is_mscale=infer_mscale(cfg), ignore_label=cfg.dataset.ignore_label,
            criterion=self.val_criterion, pad_multiple=cfg.eval.pad_multiple,
            mean=cfg.dataset.mean, std=cfg.dataset.std, device=self.device)

    def _restore(self) -> None:
        """Full resume (``train.resume``, else the latest checkpoint of this
        run) or a weights-only warm start (``train.snapshot``)."""
        cfg = self.cfg
        if cfg.train.resume:
            restored = CheckpointManager(cfg.train.resume).restore()
        else:
            restored = self.ckpt.restore()
        if restored is not None:
            self.model.load_state_dict(restored["model"])
            self.optimizer.load_state_dict(restored["optimizer"])
            meta = restored["meta"]
            self.step = int(meta["step"])
            self.start_epoch = int(meta["epoch"]) + 1
            self.best_miou = float(meta.get("mean_iu", 0.0))
            self.logger.msg(f"resumed at epoch {self.start_epoch} "
                            f"(best mIoU {self.best_miou:.4f})")
        elif cfg.train.snapshot:
            load_snapshot(cfg.train.snapshot, self.model, self.logger.msg)
            self.logger.msg(f"loaded snapshot {cfg.train.snapshot}")

    def _make_train_step(self, invert_border: bool):
        """The train step; with the relaxed loss its criterion carries the
        border flip of REDUCE_BORDER_EPOCH (tpuseg loop.py:171-193)."""
        cfg, lc = self.cfg, self.cfg.loss
        crit = self.criterion
        if lc.loss_type == "relaxed":
            crit = partial(crit, invert_border=invert_border)
        return make_train_step(
            crit, self.schedule, ocr_alpha=lc.ocr_alpha,
            aux_rmi=lc.ocr_aux_rmi,
            supervised_mscale_wt=lc.supervised_mscale_wt,
            align_corners=cfg.model.align_corners,
            mean=cfg.dataset.mean, std=cfg.dataset.std)

    def _maybe_reduce_border_labels(self, invert: bool) -> None:
        """The label side of the REDUCE_BORDER_EPOCH flip: the train set's
        label transform becomes the ``reduce_border`` one (half the window,
        border pixels weighted 2; tpuseg loop.py:195-211). The loader's
        threads read the dataset's transform at iteration time."""
        cfg = self.cfg
        if (invert and cfg.dataset.jointwtborder
                and self.train_set is not None
                and hasattr(self.train_set, "label_transform")):
            self.train_set.label_transform = relaxed_label_transform(
                cfg, self.ignore_label, reduce_border=True)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            # from pinned memory the copy runs behind the host
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def train_epoch(self, epoch: int) -> float:
        """One epoch (reference train(): train.py:465-533). The loss sums on
        the device and is read back only at log points. Returns the epoch's
        mean loss."""
        cfg = self.cfg
        invert = (cfg.loss.reduce_border_epoch != -1
                  and epoch > cfg.loss.reduce_border_epoch)
        self._maybe_reduce_border_labels(invert)
        train_step = (self._make_train_step(invert_border=True) if invert
                      else self.train_step)
        if cfg.loss.loss_type == "relaxed" or cfg.dataset.jointwtborder:
            transform = getattr(self.train_set, "label_transform", None)
            self.logger.msg(
                f"epoch {epoch}: relaxed loss invert_border={invert}, label "
                f"transform reduce_border="
                f"{getattr(transform, 'keywords', {}).get('reduce_border')}")
        ts = self.train_set
        if ts is not None and hasattr(ts, "build_epoch"):
            # coarse-sampling epoch schedule (reference: train.py:433-445)
            if cfg.dataset.only_coarse and hasattr(ts, "only_coarse"):
                ts.only_coarse()
            elif (cfg.dataset.class_uniform_pct
                  and epoch >= cfg.train.max_cu_epoch
                  and hasattr(ts, "disable_coarse")):
                ts.disable_coarse()
            ts.build_epoch(epoch)
        self.train_loader.set_epoch(epoch)

        profile_on = (cfg.train.profile_steps > 0 and self.is_primary
                      and epoch == self.start_epoch)
        trace_dir = os.path.join(self.logdir, "trace")
        prof = None
        loss_sum = None
        n_done = 0
        data_s = first_wait = 0.0
        t_start = t_wait = time.perf_counter()
        t_first = None
        for i, batch in enumerate(self.train_loader):
            if cfg.train.test_mode and i >= 10:
                break
            data_s += time.perf_counter() - t_wait
            if i == 0:  # the loader's start
                first_wait = data_s
            if i == 1:
                spatial.reset_counts()
            # on bands through the backward too (remat recomputes there)
            with spatial.sharded(self.mesh.bands):
                band = shard_batch_spatial(self.mesh, batch,
                                           self.ignore_label)
                device_batch = {"image": self._upload(band["image"]),
                                "label": self._upload(band["label"])}
                metrics = train_step(self.net, self.optimizer, device_batch,
                                     self.step)
            self.step += 1
            loss_sum = metrics["loss"] if loss_sum is None \
                else loss_sum + metrics["loss"]
            n_done += 1
            if profile_on and i == 0:
                float(metrics["loss"])  # the first step ends untraced
                prof = self._start_profile()
            elif prof is not None and i >= cfg.train.profile_steps:
                float(metrics["loss"])  # the traced steps end inside
                self._stop_profile(prof, trace_dir)
                prof = None
            if (i + 1) % cfg.train.log_every == 0 or i == 0:
                # the device sync point; the global batch's loss
                loss = _rank_mean(float(metrics["loss"]))
                avg = _rank_mean(float(loss_sum)) / n_done
                lr = float(self.schedule(self.step))
                # batch rows are this dp group's shard: the global rate
                imgs_s = (n_done * batch["image"].shape[0] * self.mesh.dp
                          / max(time.perf_counter() - t_start, 1e-6))
                self.logger.msg(
                    f"epoch {epoch} it {i + 1}/{self.steps_per_epoch} "
                    f"loss {loss:.4f} (avg {avg:.4f}) lr {lr:.6f} "
                    f"{imgs_s:.2f} img/s")
                self.logger.metric("train", {"loss": loss, "lr": lr,
                                             "imgs_per_sec": imgs_s},
                                   self.step)
                if i == 0:
                    t_first = time.perf_counter()
            t_wait = time.perf_counter()
        if prof is not None:  # the epoch was shorter than profile_steps
            self._stop_profile(prof, trace_dir)
        # syncs; the global batch's loss
        mean_loss = (_rank_mean(float(loss_sum)) / n_done if n_done
                     else 0.0)
        self._log_epoch(epoch, n_done, data_s, first_wait, t_first,
                        batch["image"].shape[0] if n_done else 0, mean_loss)
        return mean_loss

    def _log_epoch(self, epoch, n_done, data_s, first_wait, t_first,
                   batch_size, mean_loss) -> None:
        """The epoch's global rate over steps 2..N (the first pays cuDNN's
        algorithm choice and the loader's start) and the host time spent
        waiting for batches, over all steps and over steps 2..N, on each
        rank."""
        rate = steady = ""
        if n_done > 1 and t_first is not None:
            dt = time.perf_counter() - t_first
            rate = (f"steps 2-{n_done}: {dt / (n_done - 1):.4f} s/step, "
                    f"{(n_done - 1) * batch_size * self.mesh.dp / dt:.4f}"
                    f" img/s; ")
        later = (data_s - first_wait) / max(n_done - 1, 1) * 1e3
        if n_done > 1:
            steady = f" (steps 2-{n_done} {later:.1f} ms/step)"
        wait = data_s / max(n_done, 1) * 1e3
        self.logger.msg(f"epoch {epoch}: {n_done} steps on {self.device}, "
                        f"{rate}host data wait {wait:.1f} ms/step{steady}, "
                        f"mean loss {mean_loss:.4f}")
        if self.mesh.bands is not None and n_done > 1:
            steps = n_done - 1
            self.logger.msg(
                f"epoch {epoch}: sp collectives a step (steps 2-{n_done}): "
                + ", ".join(f"{spatial.COUNTS[k] / steps:g} {k} "
                            f"{spatial.SECONDS[k] / steps:.4f} s"
                            for k in spatial.COUNTS) + " of host time")
        if process_count() > 1:
            waits = " ".join(f"{w:.1f}" for w in per_rank(wait))
            laters = " ".join(f"{w:.1f}" for w in per_rank(later))
            self.logger.msg(f"epoch {epoch}: {process_count()} ranks, host "
                            f"data wait by rank {waits} ms/step (steps 2-N "
                            f"{laters})")

    def _start_profile(self):
        """torch.profiler over ``train.profile_steps`` steady-state steps
        (the first step, which pays cuDNN's algorithm choice, is left
        out)."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof, trace_dir: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"train_step{self.step}.json")
        prof.export_chrome_trace(path)
        self.logger.msg(f"device trace -> {path}")

    def validate(self, epoch: int):
        """Score the val split with the model in eval mode (reference
        validate(): train.py:536-597), each rank its shard, dump the
        images the dumper picks into ``<logdir>/best_images``, then
        checkpoint. Returns the IoU metrics of the whole split."""
        cfg = self.cfg
        runner = self.eval_runner
        n = cfg.dataset.num_classes
        dumper = _make_dumper(cfg, self.val_loader,
                              os.path.join(self.logdir, "best_images"))
        total_hist = np.zeros((n, n), np.float64)
        scale_hists: dict = {}
        loss_sum = loss_n = 0.0
        acc = runner.init_acc()

        def drain():  # one device -> host read
            nonlocal acc, total_hist, loss_sum, loss_n
            h, sh, ls, ln = runner.drain(acc)
            total_hist += h
            for s, v in sh.items():
                scale_hists[s] = scale_hists.get(s, 0) + v
            loss_sum, loss_n = loss_sum + ls, loss_n + ln
            acc = runner.init_acc()

        images = 0
        t0 = time.perf_counter()
        self.model.eval()
        try:
            for val_idx, batch in enumerate(self.val_loader):
                if cfg.train.test_mode and val_idx >= 5:
                    break
                need = dumper.wants(val_idx)
                assets, acc = runner.run_batch(batch, need_assets=need,
                                               acc=acc)
                if need:
                    _dump(dumper, batch, assets, val_idx)
                images += len(batch["label"])
                if (val_idx + 1) % DRAIN_EVERY == 0:
                    drain()
                if val_idx % 20 == 0:
                    self.logger.msg(f"validating [{val_idx}/"
                                    f"{len(self.val_loader)}]")
            drain()
        finally:
            self.model.train()
        dt = time.perf_counter() - t0
        self.logger.msg(f"validate: {images} images on {self.device} in "
                        f"{dt:.3f} s, {dt / max(images, 1):.4f} s/image")

        total_hist = multihost_sum(total_hist)
        scale_hists = _reduce_scale_hists(scale_hists, runner, n)
        metrics = eval_metrics_from_hist(total_hist)
        class_names = list(getattr(self.val_loader.dataset,
                                   "trainid_to_name", {}).values()) or None
        self.logger.msg("\n" + format_evaluate_results(
            total_hist, class_names, epoch, iou_per_scale=scale_hists))
        val_scalars = {"loss": loss_sum / loss_n if loss_n else 0.0,
                       "mIoU": metrics.mean_iou, "acc": metrics.acc}
        for s, hs in scale_hists.items():  # reference --log_msinf_to_tb
            val_scalars[f"mIoU_{s}x"] = eval_metrics_from_hist(hs).mean_iou
        self.logger.metric("val", val_scalars, self.step)
        dumper.write_summaries(self.logger, self.step)
        dumper.write_webpage()
        if process_count() > 1:
            self.logger.msg(
                f"validate: {process_count()} ranks, images by rank "
                f"{[int(v) for v in per_rank(images)]}, s/image by rank "
                + " ".join(f"{v:.4f}" for v in per_rank(dt / max(images, 1)))
                + ", mIoU by rank "
                + " ".join(f"{v:.6f}" for v in per_rank(metrics.mean_iou)))
        # every rank: the metrics are the summed matrices', the same on all
        if metrics.mean_iou >= self.best_miou:
            self.best_miou = metrics.mean_iou
        self._save(epoch, metrics.mean_iou)
        return metrics

    def _save(self, epoch: int, mean_iu: float) -> None:
        """Rank 0 writes the checkpoint (the module's own state dict, in the
        reference's names); the other ranks wait for it."""
        if process_index() == 0:
            path = self.ckpt.save(self.step, self.model, self.optimizer,
                                  epoch, mean_iu)
            self.logger.msg(f"checkpoint -> {path}")
        sync_hosts()

    def fit(self) -> None:
        """The epoch loop (reference main(): train.py:431-462); two epochs
        in ``train.test_mode``."""
        cfg = self.cfg
        max_epoch = 2 if cfg.train.test_mode else cfg.train.max_epoch
        for epoch in range(self.start_epoch, max_epoch):
            self.train_epoch(epoch)
            if (epoch + 1) % cfg.train.val_freq == 0 or \
                    epoch == max_epoch - 1:
                self.validate(epoch)
            # one decision for all ranks: a rank leaving alone would leave
            # the others waiting in their next collective
            if any_rank(self.auto_resume.termination_requested()):
                self.logger.msg("termination requested: checkpoint + exit")
                self._save(epoch, self.best_miou)
                return
        self.logger.msg(f"done; best mIoU {self.best_miou:.4f}")


def _rank_mean(value: float) -> float:
    """The mean of ``value`` over the ranks: each rank's train loss is its
    share of the global batch's loss times the number of ranks
    (``losses/ce.py``), so this is the global loss."""
    return float(multihost_sum(np.asarray([value]))[0]) / process_count()


def _make_dumper(cfg: Config, val_loader, dump_dir: str,
                 folder: bool = False) -> ImageDumper:
    """The dumper ``cfg.eval`` asks for (tpuseg loop.py:300-308,
    479-487); ``folder`` mode dumps every image."""
    return ImageDumper(
        val_len=len(val_loader), dump_dir=dump_dir,
        palette=getattr(val_loader.dataset, "palette", None),
        mean=cfg.dataset.mean, std=cfg.dataset.std,
        trainid_to_id=TRAINID_TO_ID,
        dump_all_images=cfg.eval.dump_all_images or folder,
        dump_assets=cfg.eval.dump_assets,
        dump_for_auto_labelling=cfg.eval.dump_for_auto_labelling,
        dump_for_submission=cfg.eval.dump_for_submission)


def _dump(dumper: ImageDumper, batch, assets, val_idx: int) -> None:
    dumper.dump({"input_images": batch["image"],
                 "gt_images": batch["label"],
                 "img_names": batch["name"],
                 "assets": assets}, val_idx)


def evaluate_only(cfg: Config, logdir: str = "logs",
                  eval_mode: str = "val", checkpoint: Optional[str] = None,
                  device: str = "cuda", is_primary: bool = True):
    """Score ``cfg``'s model on the val (or train) split, or run it over a
    folder of images (``eval_mode="folder"``, no labels), dumping what
    ``cfg.eval`` asks for (tpuseg loop.py:414-532). ``checkpoint`` is a
    reference-format torch state dict; without it the weights are a
    seeded fresh init (``train.seed``). With more than one rank each
    scores its shard and the matrices are summed across ranks. Returns
    the IoU metrics, or None when nothing is scored."""
    dev = resolve_device(device)
    logger = Logger(logdir, is_primary)

    model = get_model(eval_model_config(cfg), seed=cfg.train.seed)
    if checkpoint:
        load_reference_checkpoint(model, checkpoint)
        logger.msg(f"loaded {checkpoint}")
    model = model.to(device=dev, memory_format=torch.channels_last).eval()

    _, val_loader, _ = setup_data(cfg, eval_mode=eval_mode,
                                  seed=cfg.train.seed,
                                  num_shards=process_count(),
                                  shard=process_index(),
                                  is_primary=is_primary)
    runner = EvalRunner(
        model, cfg.dataset.num_classes,
        scales=(cfg.eval.default_scale, *(cfg.eval.extra_scales or ())),
        do_flip=cfg.eval.do_flip, align_corners=cfg.model.align_corners,
        is_mscale=infer_mscale(cfg), ignore_label=cfg.dataset.ignore_label,
        criterion=get_val_loss(cfg), pad_multiple=cfg.eval.pad_multiple,
        mean=cfg.dataset.mean, std=cfg.dataset.std, device=dev)
    result_dir = cfg.eval.result_dir or os.path.join(logdir, "eval_images")

    has_labels = eval_mode != "folder" and \
        not cfg.eval.dump_for_auto_labelling and \
        not cfg.eval.dump_for_submission
    if cfg.eval.dump_topn:
        if not has_labels:
            raise ValueError(
                "eval.dump_topn ranks images by ground-truth failures and "
                "needs labels: not available in folder/auto-label/"
                "submission modes (reference --dump_topn: train.py:163-168)")
        from tpuseg_torch.evaluation.topn import validate_topn

        # one sync an image, by design: pass 1 reads each image's matrix
        return validate_topn(
            val_loader, runner, cfg.dataset.num_classes,
            result_dir=result_dir,
            trainid_to_name=getattr(val_loader.dataset, "trainid_to_name",
                                    None),
            dump_topn=cfg.eval.dump_topn,
            dump_topn_all=cfg.eval.dump_topn_all,
            palette=getattr(val_loader.dataset, "palette", None),
            mean=cfg.dataset.mean, std=cfg.dataset.std, log=logger.msg,
            max_images=5 if cfg.train.test_mode else None)

    # reference --no_metrics (train.py:420-421): dump without scoring
    calc_metrics = has_labels and not cfg.eval.no_metrics
    dumper = _make_dumper(cfg, val_loader, result_dir,
                          folder=eval_mode == "folder")

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

    images = pixels = dumped = 0
    dump_s = 0.0
    t_first = None
    for val_idx, batch in enumerate(val_loader):
        if cfg.train.test_mode and val_idx >= 5:
            break
        need = dumper.wants(val_idx)
        assets, acc = runner.run_batch(batch, calc_metrics, need_assets=need,
                                       acc=acc)
        if need:
            t0 = time.perf_counter()
            _dump(dumper, batch, assets, val_idx)
            dump_s += time.perf_counter() - t0
            dumped += 1
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
    logger.msg(f"dumped {dumped} batches to {dumper.dump_dir}: {dump_s:.3f} "
               f"s on the host writing images")
    dumper.write_summaries(logger, 0)
    dumper.write_webpage()
    if not calc_metrics:
        return None
    total_hist = multihost_sum(total_hist)
    scale_hists = _reduce_scale_hists(scale_hists, runner, n)
    metrics = eval_metrics_from_hist(total_hist)
    class_names = list(getattr(val_loader.dataset, "trainid_to_name",
                               {}).values()) or None
    logger.msg("\n" + format_evaluate_results(total_hist, class_names,
                                              iou_per_scale=scale_hists))
    logger.msg(f"mean mIoU: {metrics.mean_iou:.4f}")
    return metrics
