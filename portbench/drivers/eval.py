"""Eval traffic: a closed loop of batches through the program's
``EvalRunner.run_batch(..., need_assets=False, acc=acc)``, as
``evaluate_only`` drives it (the accumulator drained every
``DRAIN_EVERY`` batches and once at the end).

Traffic parameters (``traffic/<mix>.json``): ``batch`` images a batch,
``scenes`` seeded scenes cycled in order (a multiple of ``batch``), ``hw``,
``ignore_share`` and ``block`` of the scenes.

The check: every batch's prediction in the window is kept (a reference to
the tensor the runner returns) and, once the window has closed, held
against the reference's f32 logits of its scenes: the widest gap by which
a predicted class's logit lies below the reference's best
(``logit_gap``), and the drained confusion matrix against the one the
kept predictions and the labels give (``hist_diff``, exact). The share
of pixels whose class differs from the reference's is logged, not
compared: it turns on how close a seed's classes lie, and a control in
float8 reads under sound bf16 runs on some seeds (PERF.md).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import costs
from portbench.core import laps, log, seeds
from portbench.inputs import program_config, scenes
from portbench.reference.common import F32, f32_math, seeded_state, \
    set_precision


class Session:
    def __init__(self, cell, seed: int, device):
        lap = laps("set-up")
        from tpuseg_torch.config import eval_model_config, infer_mscale
        from tpuseg_torch.evaluation.inference import DRAIN_EVERY, EvalRunner
        from tpuseg_torch.losses import get_val_loss
        from tpuseg_torch.models import get_model

        lap("program imports")
        t, m = cell.traffic, cell.config["model"]
        self.cell, self.m, self.b = cell, m, t["batch"]
        self.dev = torch.device(device)
        self.ref = cell.reference()
        if t["scenes"] % self.b:
            raise ValueError("scenes must be a multiple of batch")
        s_scene, s_weight = seeds(seed, 2)
        self.images, self.labels = scenes(
            t["scenes"], t["hw"], s_scene, self.dev, t["ignore_share"],
            t["block"])
        self.batches = [
            {"image": self.images[i:i + self.b],
             "label": self.labels[i:i + self.b]}
            for i in range(0, t["scenes"], self.b)]
        lap("scenes")

        # the weights, and batch-norm statistics the reference takes from
        # the first scene at each scale
        ref = self.ref.build(m).to(self.dev)
        self.state = seeded_state(
            ref, s_weight, self.dev, self.ref.tails(ref),
            cell.config["weights"]["residual_tail_scale"])
        ref.load_state_dict(self.state)
        first = torch.from_numpy(self.images[:1]).to(self.dev)
        with f32_math():
            self.state.update(self.ref.calibrate(ref, first, m))
        del ref, first
        lap("weights and batch-norm statistics")

        cfg = program_config(cell.config, "eval")
        model = get_model(eval_model_config(cfg), seed=cfg.train.seed)
        model = model.to(device=self.dev, memory_format=torch.channels_last)
        model.load_state_dict(self.state)
        self.model = model.eval()
        self.runner = EvalRunner(
            model, cfg.dataset.num_classes,
            scales=(cfg.eval.default_scale, *(cfg.eval.extra_scales or ())),
            do_flip=cfg.eval.do_flip, align_corners=cfg.model.align_corners,
            is_mscale=infer_mscale(cfg),
            ignore_label=cfg.dataset.ignore_label,
            criterion=get_val_loss(cfg), pad_multiple=cfg.eval.pad_multiple,
            mean=cfg.dataset.mean, std=cfg.dataset.std, device=self.dev)
        self.drain_every = DRAIN_EVERY
        self.kept: list = []
        forward = self.runner.forward

        def keep(*args, **kw):
            out = forward(*args, **kw)
            self.kept.append(out[1])
            return out

        self.runner.forward = keep
        lap("program")
        self.hist = np.zeros((m["num_classes"],) * 2, np.float64)
        # warm-up: the one shape the window runs
        self.acc = self.runner.init_acc()
        self.runner.run_batch(self.batches[0], need_assets=False,
                              acc=self.acc)
        self.runner.drain(self.acc)
        self.kept.clear()
        self.acc = self.runner.init_acc()
        self.order: list = []
        lap("warm-up batch")

    def step(self) -> int:
        k = len(self.order) % len(self.batches)
        _, self.acc = self.runner.run_batch(self.batches[k],
                                            need_assets=False, acc=self.acc)
        self.order.append(k)
        if len(self.order) % self.drain_every == 0:
            self._drain()
        return self.b

    def _drain(self):
        self.hist += self.runner.drain(self.acc)[0]
        self.acc = self.runner.init_acc()

    def finish(self):
        self._drain()

    def end_to_end(self, images: int, window_s: float) -> dict:
        return {"eval_img_s": images / window_s}

    def flops_per_image(self) -> float:
        return costs.eval_flops_per_image(self.ref, self.m,
                                          self.cell.traffic["hw"])

    def free_program(self):
        del self.model, self.runner, self.acc
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_logits(self, prec=F32) -> list:
        """The reference's (C, H, W) logits of each scene, one at a time."""
        ref = set_precision(self.ref.build(self.m).to(self.dev), prec)
        ref.load_state_dict(self.state)
        ref.eval()
        out = []
        with f32_math(), torch.no_grad():
            for i in range(len(self.images)):
                img = torch.from_numpy(self.images[i:i + 1]).to(self.dev)
                out.append(self.ref.eval_logits(ref, img, self.m)[0])
        return out

    def compare(self, preds: list, order: list, logits: list) -> dict:
        """Per-image logit gaps and mismatched pixels of predictions
        ``preds`` (one (B, H, W) tensor a batch, batch indices ``order``)
        against the reference's ``logits``, and the confusion matrix they
        give with the labels."""
        c = self.m["num_classes"]
        gaps, mism, hist = [], [], torch.zeros(c * c, dtype=torch.long,
                                               device=self.dev)
        for k, pred in zip(order, preds):
            lab = torch.from_numpy(self.batches[k]["label"]).to(
                self.dev).long()
            for r in range(self.b):
                if r >= pred.shape[0] or pred.shape[1:] != lab.shape[1:]:
                    gaps.append(torch.tensor(float("inf"), device=self.dev))
                    mism.append(torch.tensor(1.0, device=self.dev))
                    continue
                ref = logits[k * self.b + r]
                p = pred[r].long().clamp(0, c - 1)
                best, arg = ref.max(0)
                gaps.append((best - ref.gather(0, p[None])[0]).max())
                mism.append((p != arg).float().mean())
                valid = lab[r] < c
                hist += torch.bincount((lab[r] * c + p)[valid],
                                       minlength=c * c)
        return {"gaps": torch.stack(gaps).cpu().numpy() if gaps else
                np.zeros(0),
                "mismatch": torch.stack(mism).cpu().numpy() if mism else
                np.zeros(0),
                "hist": hist.reshape(c, c).cpu().numpy()}

    def check(self):
        lim = self.cell.limits
        got = self.compare(self.kept, self.order, self.reference_logits())
        n = len(self.order) * self.b
        hist_diff = float(np.abs(got["hist"] - self.hist).sum())
        if len(self.kept) != len(self.order):
            hist_diff = float("inf")
        bad = int((got["gaps"] > lim["logit_gap"]).sum())
        if len(got["mismatch"]):
            log(f"pixels whose class differs from the reference's: "
                f"{100 * float(got['mismatch'].mean()):.4f} %")
        compared = {
            "logit_gap": {"value": float(got["gaps"].max(initial=0.0)),
                          "limit": lim["logit_gap"]},
            "hist_diff": {"value": hist_diff, "limit": lim["hist_diff"]},
        }
        correct = n > 0 and all(v["value"] <= v["limit"]
                                for v in compared.values())
        if hist_diff > lim["hist_diff"] or (not correct and not bad):
            bad = n
        return correct, bad, compared
