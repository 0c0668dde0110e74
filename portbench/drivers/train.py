"""Train traffic: a closed loop of the program's train step
(``train/step.py::make_train_step`` over ``get_loss`` and
``make_optimizer``, as ``Trainer`` builds it), each batch uploaded from
pinned host memory as ``Trainer`` uploads it.

Traffic parameters (``traffic/<mix>.json``): ``batch`` crops a step,
``crops`` seeded crops cycled in order (a multiple of ``batch``), ``hw``,
``ignore_share`` and ``block`` of the crops, ``steps_per_epoch`` of the LR
schedule, and ``checked_steps``, the first steps the reference follows.

The check: set-up drives the model and optimizer that the window then
uses through their first ``checked_steps`` steps, on crops that all
differ, with the device's random generator seeded from the run's seed
before each, so that the reference's dropout draws the program's masks.
Once the window has closed the reference takes the same steps
from the same weights, in f32, and the two are held leaf by leaf: each
step's loss (``loss_gap``, relative), the norm of the first gradient as
SGD gets it (its momentum buffer after one step, weight decay included;
``grad_gap``), the norm of each parameter's change after the checked
steps (``change_gap``) and of each batch-norm running statistic's
(``stats_gap``). A leaf's gap is the difference of the two norms over the
larger of the reference's norm of that leaf and of the median leaf.
Parameters whose reference gradient is under a thousandth of the median
leaf's (a bias under batch norm) move by rounding alone and are left out
of ``change_gap``. The window's own steps are held finite: the sum of
every step's loss and, once the window has closed, every parameter and
batch-norm statistic (``window_nonfinite``, the count of those that are
not).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import costs
from portbench.core import laps, log, seeds
from portbench.inputs import program_config, scenes
from portbench.reference.common import F32, f32_math, seeded_state, \
    set_precision

STATS = ("running_mean", "running_var")


def _norms(tensors: list) -> np.ndarray:
    if not tensors:
        return np.zeros(0)
    return torch.stack(torch._foreach_norm(
        [t.float() for t in tensors])).cpu().numpy()


def leaf_gaps(got: dict, want: dict, what: str = "") -> np.ndarray:
    """|got - want| per leaf over max(want of the leaf, median of want);
    the widest three logged under ``what``."""
    keys = sorted(want)
    w = np.array([want[k] for k in keys])
    g = np.array([got.get(k, np.inf) for k in keys])
    gaps = np.abs(g - w) / np.maximum(w, np.median(w))
    if what and len(gaps):
        log(f"{what} widest: " + ", ".join(
            f"{keys[i]} {gaps[i]:.4g} ({g[i]:.4g} vs {w[i]:.4g})"
            for i in np.argsort(gaps)[::-1][:3]))
    return gaps


class Session:
    def __init__(self, cell, seed: int, device):
        lap = laps("set-up")
        from tpuseg_torch.config import eval_model_config
        from tpuseg_torch.losses import get_loss
        from tpuseg_torch.models import get_model
        from tpuseg_torch.train.optim import make_optimizer
        from tpuseg_torch.train.step import make_train_step

        lap("program imports")
        t, m = cell.traffic, cell.config["model"]
        self.cell, self.m, self.b = cell, m, t["batch"]
        self.dev = torch.device(device)
        self.ref = cell.reference()
        if t["crops"] % self.b or t["crops"] // self.b < t["checked_steps"]:
            raise ValueError("crops must be a multiple of batch, with a "
                             "distinct batch for every checked step")
        s_crop, s_weight, self.s_step = seeds(seed, 3)
        images, labels = scenes(t["crops"], t["hw"], s_crop, self.dev,
                                t["ignore_share"], t["block"])
        self.batches = [(images[i:i + self.b], labels[i:i + self.b])
                        for i in range(0, t["crops"], self.b)]
        with torch.device("meta"):
            shapes = self.ref.build(m)
        self.state = seeded_state(
            shapes, s_weight, self.dev, self.ref.tails(shapes),
            cell.config["weights"]["residual_tail_scale"])
        lap("crops and weights")

        cfg = program_config(cell.config, "train")
        model = get_model(eval_model_config(cfg), seed=cfg.train.seed)
        model = model.to(device=self.dev, memory_format=torch.channels_last)
        model.load_state_dict(self.state)
        self.model = model.train()
        criterion, _ = get_loss(cfg)
        self.opt, schedule = make_optimizer(cfg, model.parameters(),
                                            t["steps_per_epoch"])
        lc = cfg.loss
        self.train_step = make_train_step(
            criterion, schedule, ocr_alpha=lc.ocr_alpha,
            aux_rmi=lc.ocr_aux_rmi,
            supervised_mscale_wt=lc.supervised_mscale_wt,
            align_corners=cfg.model.align_corners, mean=cfg.dataset.mean,
            std=cfg.dataset.std)
        self.n = 0
        self.loss_sum = None
        lap("program")

        # the checked steps, which also warm up the window's one shape
        names = [n for n, _ in model.named_parameters()]
        params = [p for _, p in model.named_parameters()]
        losses = []
        for k in range(t["checked_steps"]):
            torch.manual_seed(self.s_step + k)
            losses.append(self._step())
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
            lap(f"checked step {k + 1}")
            if k == 0:
                # what SGD got: its momentum buffer (none if it never
                # stepped)
                self.grad = dict(zip(names, _norms(
                    [self.opt.state[p].get("momentum_buffer",
                                           torch.zeros(()))
                     for p in params])))
        self.losses = [float(v) for v in losses]
        self.change = dict(zip(names, _norms(
            [p.detach() - self.state[n] for n, p in zip(names, params)])))
        stats = {k: v for k, v in model.state_dict().items()
                 if k.endswith(STATS)}
        self.stats = dict(zip(stats, _norms(
            [v - self.state[k] for k, v in stats.items()])))

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.dev.type == "cuda":
            return t.pin_memory().to(self.dev, non_blocking=True)
        return t.to(self.dev)

    def _step(self) -> torch.Tensor:
        image, label = self.batches[self.n % len(self.batches)]
        batch = {"image": self._upload(image), "label": self._upload(label)}
        loss = self.train_step(self.model, self.opt, batch, self.n)["loss"]
        self.n += 1
        self.loss_sum = loss if self.loss_sum is None else \
            self.loss_sum + loss
        return loss

    def step(self) -> int:
        self._step()
        return self.b

    def finish(self):
        pass

    def end_to_end(self, images: int, window_s: float) -> dict:
        return {"train_img_s": images / window_s}

    def flops_per_image(self) -> float:
        t = self.cell.traffic
        return costs.train_flops_per_image(self.ref, self.m, t["hw"],
                                           t["batch"])

    def free_program(self):
        with torch.no_grad():
            held = [self.loss_sum] + list(self.model.state_dict().values())
            held = [v for v in held if v.is_floating_point()]
            self.nonfinite = int(torch.stack(
                [~torch.isfinite(v).all() for v in held]).sum())
        del self.model, self.opt, self.train_step, self.loss_sum
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, prec=F32) -> dict:
        """The reference's checked steps from the same weights on the same
        crops: losses, first-gradient, change and statistics norms."""
        o = self.cell.config["optim"]
        t = self.cell.traffic
        ref = set_precision(self.ref.build(self.m).to(self.dev), prec)
        ref.load_state_dict(self.state)
        ref.train().set_remat(self.dev.type == "cuda")
        names = [n for n, _ in ref.named_parameters()]
        params = [p for _, p in ref.named_parameters()]
        bufs, out = None, {"losses": []}
        with f32_math():
            for k in range(t["checked_steps"]):
                image, label = (torch.from_numpy(a).to(self.dev)
                                for a in self.batches[k])
                torch.manual_seed(self.s_step + k)
                loss = self.ref.train_loss(ref, image, label, self.m)
                loss.backward()
                out["losses"].append(float(loss.detach()))
                epoch = k // t["steps_per_epoch"]
                lr = o["lr"] * (1 - epoch / o["max_epoch"]) ** o["poly_exp"]
                with torch.no_grad():
                    d = [p.grad + o["weight_decay"] * p for p in params]
                    bufs = d if bufs is None else [
                        o["momentum"] * b + g for b, g in zip(bufs, d)]
                    for p, b in zip(params, bufs):
                        p -= lr * b
                if k == 0:
                    out["grad"] = dict(zip(names, _norms(d)))
                ref.zero_grad(set_to_none=True)
        with torch.no_grad():
            out["change"] = dict(zip(names, _norms(
                [p - self.state[n] for n, p in zip(names, params)])))
            sd = ref.state_dict()
            keys = [k for k in sd if k.endswith(STATS)]
            out["stats"] = dict(zip(keys, _norms(
                [sd[k] - self.state[k] for k in keys])))
        return out

    def compare(self, got: dict, want: dict) -> dict:
        """The four gaps of ``got`` (program or control) against the
        reference's ``want``."""
        lw = np.array(want["losses"])
        lg = np.array(got["losses"] + [np.inf] * (len(lw) - len(
            got["losses"])))
        med = np.median(list(want["grad"].values()))
        moved = {k for k, v in want["grad"].items() if v >= 1e-3 * med}
        return {
            "loss_gap": float(np.max(np.abs(lg - lw) / np.abs(lw))),
            "grad_gap": float(leaf_gaps(got["grad"], want["grad"],
                                        "grad").max()),
            "change_gap": float(leaf_gaps(
                got["change"],
                {k: v for k, v in want["change"].items() if k in moved},
                "change").max()),
            "stats_gap": float(leaf_gaps(got["stats"], want["stats"],
                                         "stats").max()
                               if want["stats"] else 0.0),
        }

    def program_readings(self) -> dict:
        return {"losses": self.losses, "grad": self.grad,
                "change": self.change, "stats": self.stats}

    def check(self):
        lim = self.cell.limits
        self.readings = (self.program_readings(), self.reference_steps())
        gaps = self.compare(*self.readings)
        gaps["window_nonfinite"] = float(self.nonfinite)
        # a gap the cell's limits do not name separates no control or fault
        # from sound runs (PERF.md) and is logged, not compared
        for k, v in gaps.items():
            if k not in lim:
                log(f"{k} {v!r} (not compared)")
        compared = {k: {"value": v, "limit": lim[k]} for k, v in gaps.items()
                    if k in lim}
        correct = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
                      for v in compared.values())
        return correct, 0 if correct else self.n * self.b, compared
