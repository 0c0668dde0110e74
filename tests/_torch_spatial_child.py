"""One rank of the dp x sp gloo clusters of tests/test_torch_spatial_ops.py,
tests/test_torch_spatial_train.py, tests/test_torch_spatial_zoo.py and
tests/test_torch_spatial_uneven.py on the CPU.

Run with torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) and ``<mode> <dir>``: reads ``<dir>/inputs.pt``
(what the parent drew from seeds), runs this rank's band of each case
under ``mesh.model_parallelism`` (2 unless a mode says otherwise) and
writes what the parent asserts to ``<dir>/<mode>_rank<r>.pt``. Modes:

- ``ops`` (one sp group of all the ranks, 2 or 3): every band primitive,
  forward and backward, on this rank's band of the parent's whole
  tensors (padded where they do not split evenly): convs,
  bilinear resizes, pools (the stems' pool modules too), the global
  average pool, ASPP and DPC, RMI's pooled bands, the OCR class gather
  the losses and batch norm;
- ``halo`` (4 ranks, one sp group of 4): ASPP's rate-36 conv on 24-row
  bands (and on 23-row bands of 90 rows), whose halo spans the
  neighbouring band and part of the next;
- ``train`` (2 ranks): one ``HRNet_Mscale_Tiny`` step under DDP with CE and
  with RMI + aux, then ``Trainer.fit`` through the CLI's ``--multi-host``,
  stopped by a termination request after the first epoch and resumed;
- ``grid`` (4 ranks, dp 2 x sp 2): the CE step, one image a dp group;
- ``zoo`` (one sp group of all the ranks, 2 or 3): one step of each of
  the parent's cases, a factory at full width (or its class on a tiny
  trunk) from seeded conditioned weights, dropout and drop path on and
  the default generator seeded alike on every rank (the cases held
  against ``tpuseg``, ``jax_cases``, from its variables, their dropout at
  p = 0). Then the ranks leave the group and run one process, each for
  its share of the cases (``one_cases``, all by default): the same step
  on the whole image, against which the rank measures its band's step,
  and the f32 floor (the step with every weight moved by one f32
  rounding). A case marked ``f64`` runs in f64 (its model's parameters,
  buffers and compute dtype), where the bands must match one process to
  f64 rounding, and takes no floor. tests/test_torch_spatial_zoo.py runs
  it on 2 ranks, tests/test_torch_spatial_uneven.py on 2 and on 3, on
  uneven bands.

Imports nothing of ``tpuseg`` or JAX; the modules it loaded go into the
result.
"""
import contextlib
import importlib
import io
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tpuseg_torch.cli.main import main as cli_main
from tpuseg_torch.config import make_config
from tpuseg_torch.losses import get_loss
from tpuseg_torch.losses import rmi as rmi_mod
from tpuseg_torch.models import get_model
from tpuseg_torch.models.heads import ASPP, DPC
from tpuseg_torch.models.layers import Conv2d, Norm
from tpuseg_torch.models.ocr import spatial_gather
from tpuseg_torch.ops import (
    MaxPool2d,
    avg_pool2d,
    global_avg_pool,
    max_pool2d,
    resize_x,
    scale_as,
)
from tpuseg_torch.parallel import (
    init_distributed,
    make_mesh,
    process_count,
    process_index,
    shard_batch_spatial,
    spatial,
)
from tpuseg_torch.train import loop
from tpuseg_torch.train.optim import make_optimizer
from tpuseg_torch.train.step import make_train_step


def _grad_case(fn, xs, dy, bands, whole_out=False):
    """``fn`` on this rank's bands of ``xs`` with ``sum(y * dy)``'s
    backward, ``dy`` this rank's band of the upstream gradient (zeros on
    its padding rows; the whole of it for a ``whole_out`` function): the
    output and the inputs' gradients, and whether the output is
    channels_last."""
    with spatial.sharded(bands):
        xs = [spatial.band(x, 2).requires_grad_() for x in xs]
        y = fn(*xs)
        (y * (dy if whole_out else spatial.band(dy, 2))).sum().backward()
    return {"y": y.detach(), "grads": [x.grad for x in xs],
            "channels_last": spatial.memory_format(y) == torch.channels_last}


def _conv_case(case, bands):
    conv = Conv2d(*case["args"], **case["kw"])
    conv.load_state_dict(case["state"])
    out = _grad_case(conv, [case["x"]], case["dy"], bands)
    out["dw"] = conv.weight.grad
    return out


def _head_case(case, bands):
    """ASPP, DPC or batch norm in train mode on this rank's band: the
    output, the input's and the parameters' gradients and the BN running
    statistics."""
    head = {"aspp": ASPP, "dpc": DPC, "norm": Norm}[case["kind"]](
        *case["args"])
    head.load_state_dict(case["state"])
    head.train()
    out = _grad_case(head, [case["x"]], case["dy"], bands)
    out["params"] = {n: p.grad for n, p in head.named_parameters()}
    out["stats"] = {k: v for k, v in head.state_dict().items()
                    if k.endswith(("running_mean", "running_var"))}
    return out


def ops(inp, bands):
    res = {"conv": {}, "resize": {}, "pool": {}, "rmi_pool": {}, "loss": {},
           "head": {}}
    for name, case in inp["conv"].items():
        res["conv"][name] = _conv_case(case, bands)
    for name, case in inp["resize"].items():
        ac = case["align_corners"]
        if "scale" in case:
            fn = lambda x: resize_x(x, case["scale"], ac)  # noqa: E731
            xs = [case["x"]]
        else:
            fn = lambda x, y: scale_as(x, y, ac)  # noqa: E731
            xs = [case["x"], case["like"]]
        res["resize"][name] = _grad_case(fn, xs, case["dy"], bands)
    for name, case in inp["pool"].items():
        pool = {"avg": avg_pool2d, "max": max_pool2d,
                "module": lambda x, *a: MaxPool2d(*a)(x)}[case["kind"]]
        res["pool"][name] = _grad_case(
            lambda x: pool(x, *case["args"]), [case["x"]], case["dy"],
            bands)
    g = inp["global_pool"]
    res["global_pool"] = _grad_case(global_avg_pool, [g["x"]], g["dy"],
                                    bands, whole_out=True)
    for name, case in inp["head"].items():
        res["head"][name] = _head_case(case, bands)
    res["norm"] = _head_case(inp["norm"], bands)
    for name, case in inp["rmi_pool"].items():
        with spatial.sharded(bands):
            oh, pr, n_rows = rmi_mod._pooled(
                spatial.band(case["onehot"], 2),
                spatial.band(case["probs"], 2), 4, case["way"], 3)
        res["rmi_pool"][name] = {"onehot": oh, "probs": pr,
                                 "n_rows": n_rows}
    g = inp["gather"]
    res["gather"] = _grad_case(spatial_gather, [g["feats"], g["probs"]],
                               g["dctx"], bands, whole_out=True)
    for name, case in inp["loss"].items():
        criterion, _ = get_loss(make_config(case["sets"]))
        target = case["target"]
        with spatial.sharded(bands):
            logits = spatial.band(case["logits"]).requires_grad_()
            # a multi-hot target's padding pixels have no class (as
            # shard_batch_spatial pads them), a label's are ignored
            loss = criterion(logits, spatial.band(
                target, fill=0 if target.dim() == 4 else 255))
            loss.backward()
        res["loss"][name] = {"loss": loss.detach(), "grad": logits.grad}
    return res


def train_step(inp, sets, mesh):
    """One step of the tiny model on this rank's band of this dp group's
    images under DDP, as ``Trainer.train_epoch`` runs it."""
    cfg = make_config(sets)
    model = get_model(cfg)
    model.load_state_dict(inp["state"])
    model.train()
    net = torch.nn.parallel.DistributedDataParallel(
        model, broadcast_buffers=False)
    criterion, _ = get_loss(cfg)
    opt, schedule = make_optimizer(cfg, model.parameters(), 1)
    lc = cfg.loss
    step = make_train_step(criterion, schedule, ocr_alpha=lc.ocr_alpha,
                           supervised_mscale_wt=lc.supervised_mscale_wt)
    per_dp = inp["image"].shape[0] // mesh.dp
    rows = slice(mesh.dp_index * per_dp, (mesh.dp_index + 1) * per_dp)
    with spatial.sharded(mesh.bands):
        batch = shard_batch_spatial(mesh, {"image": inp["image"][rows],
                                           "label": inp["label"][rows]})
        batch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
        loss = step(net, opt, batch, 0)["loss"]
    return {"loss": loss,
            "state": {k: v.detach().clone()
                      for k, v in model.state_dict().items()},
            "no_grad": [n for n, p in model.named_parameters()
                        if p.grad is None]}


ZOO_SEED = 11  # the default generator's seed of every zoo step


def condition(model, seed: int = 0) -> None:
    """Seeded weights that keep a train-mode net well conditioned (convs
    at 1/sqrt(fan_in), random BN affine parameters), so that its
    gradients are not dominated by f32 rounding (chip_smoke.py's
    ``_condition``; the HRNet trunk's own init draws its convs at std
    0.001, and one SGD step then moves them by more than their size)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5,
                                 generator=gen)
                if m.bias is not None:
                    m.bias.normal_(0.0, 0.1, generator=gen)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.normal_(1.0, 0.2, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)


def zoo_model(case):
    """``case``'s factory at full width, or its factory's class on a tiny
    trunk (``case["tiny"]``: module, class, trunk; the class's keywords
    in ``case["kw"]``), in train mode; for
    ``tpuseg``'s weights (``case["state"]``) with its ``Dropout2d`` at
    p = 0 (``tpuseg`` draws its masks from one key, which no band can
    draw); in f64 with ``case["f64"]``."""
    dtype = torch.float64 if case.get("f64") else torch.float32
    if case.get("tiny"):
        module, cls, trunk = case["tiny"]
        model = getattr(importlib.import_module(
            f"tpuseg_torch.models.{module}"), cls)(
                19, trunk=trunk, dtype=dtype,
                **case.get("kw", {})).train()
    else:
        model = get_model(make_config(case["sets"])).train()
    model = model.to(dtype)
    if case.get("state") is not None:
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout2d):
                m.p = 0.0
    return model


def _fresh(model, case, moved: bool) -> None:
    """``model`` back at ``case``'s weights (tpuseg's, or the seeded
    conditioned ones) with fresh BN statistics; with ``moved``, every
    weight then moved by one f32 rounding (a relative 2**-24, seeded
    random signs)."""
    if case.get("state") is not None:
        model.load_state_dict(case["state"])
    else:
        condition(model)
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.reset_running_stats()
    if moved:
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for p in model.parameters():
                sign = torch.randint(0, 2, p.shape, generator=gen) * 2 - 1
                p.mul_(1 + 2.0 ** -24 * sign)


def zoo_step(case, model, mesh=None, moved: bool = False):
    """One CE step of ``model`` from ``case``'s weights (``moved``: by one
    f32 rounding), dropout and drop path at their rates, the default
    generator seeded with ZOO_SEED: on this rank's band under DDP when
    ``mesh`` is given, else in one process. -> the loss, the gradients,
    the parameters after SGD, the BN statistics and the sp
    collectives."""
    _fresh(model, case, moved)
    cfg = make_config(case["sets"])
    net = model
    if mesh is not None:
        # the ranks built the same weights: no broadcast from rank 0
        net = torch.nn.parallel.DistributedDataParallel(
            model, broadcast_buffers=False, init_sync=False)
    criterion, _ = get_loss(cfg)
    opt, schedule = make_optimizer(cfg, model.parameters(), 1)
    lc = cfg.loss
    step = make_train_step(criterion, schedule, ocr_alpha=lc.ocr_alpha,
                           supervised_mscale_wt=lc.supervised_mscale_wt)
    spatial.reset_counts()
    torch.manual_seed(ZOO_SEED)
    with spatial.sharded(None if mesh is None else mesh.bands):
        batch = {k: case[k] for k in ("image", "label")}
        if mesh is not None:
            batch = shard_batch_spatial(mesh, batch)
        batch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
        loss = float(step(net, opt, batch, 0)["loss"])
    return {"loss": loss, "counts": dict(spatial.COUNTS),
            "grads": {n: p.grad for n, p in model.named_parameters()},
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "stats": {k: v.clone() for k, v in model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}}


def _l1(got: dict, want: dict) -> float:
    num = sum(float((got[k].double() - want[k].double()).abs().sum())
              for k in want)
    return num / sum(float(want[k].double().abs().sum()) for k in want)


def _checksums(r: dict) -> dict:
    return {k: float(sum(t.double().abs().sum() for t in r[k].values()))
            for k in ("grads", "params", "stats")}


def zoo(inp, mesh):
    """Every zoo case on this rank's band; then, in one process, each
    rank takes every other factory (DDP left both ranks' results equal):
    the whole image's step (its loss, and its gradients, parameters and
    BN statistics against the band's) and the f32 floor, the same step
    with every weight moved by one f32 rounding."""
    rank, world = process_index(), process_count()
    res = {"sums": {}, "counts": {}, "loss": {}, "jax": {}}
    mine = {}
    for i, (name, case) in enumerate(inp["zoo"].items()):
        model = zoo_model(case)
        r = zoo_step(case, model, mesh)
        res["sums"][name] = _checksums(r)
        res["counts"][name], res["loss"][name] = r["counts"], r["loss"]
        if name in inp.get("jax_cases", ()):
            res["jax"][name] = {"loss": r["loss"],
                                "state": {**r["params"], **r["stats"]}}
        if name in inp.get("one_cases", inp["zoo"]) and i % world == rank:
            mine[name] = model, r
    dist.destroy_process_group()  # one process from here on
    res["gaps"] = {}
    for name, (model, band) in mine.items():
        case = inp["zoo"][name]
        one = zoo_step(case, model)
        res["gaps"][name] = {
            "loss": one["loss"],
            "grad_l1": _l1(band["grads"], one["grads"]),
            "params_l1": _l1(band["params"], one["params"]),
            "stats_l1": _l1(band["stats"], one["stats"])}
        if not case.get("f64"):
            moved = zoo_step(case, model, moved=True)
            res["gaps"][name].update(
                floor_loss_rel=abs(moved["loss"] - one["loss"]) / abs(
                    one["loss"]),
                floor_grad_l1=_l1(moved["grads"], one["grads"]))
    return res


def halo(inp, bands):
    """The halo cases on a 4-band sp group."""
    return {"conv": {name: _conv_case(case, bands)
                     for name, case in inp["conv"].items()}}


def fit_case(inp, logdir, terminate_file=None):
    """The CLI's train command with ``--multi-host``; returns the primary's
    output and what each validation returned on this rank."""
    seen = []
    orig = loop.Trainer.validate

    def validate(self, epoch):
        metrics = orig(self, epoch)
        seen.append((epoch, metrics.mean_iou, float(metrics.hist.sum())))
        return metrics

    argv = ["train", "--multi-host", "--device", "cpu", "--config",
            inp["recipe"], "--logdir", logdir]
    for item in inp["fit_sets"]:
        argv += ["--set", item]
    os.environ.pop("TPUSEG_TERMINATE_FILE", None)
    if terminate_file:
        os.environ["TPUSEG_TERMINATE_FILE"] = terminate_file
    out = io.StringIO()
    loop.Trainer.validate = validate
    try:
        with contextlib.redirect_stdout(out):
            rc = cli_main(argv)
    finally:
        loop.Trainer.validate = orig
    # the default generator's seed the Trainer set (per dp group)
    return {"rc": rc, "validations": seen, "text": out.getvalue(),
            "seed": torch.initial_seed()}


def main():
    mode, out_dir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(2 if mode == "zoo" else 1)
    init_distributed("cpu")
    rank = process_index()
    inp = torch.load(os.path.join(out_dir, f"{mode}_inputs.pt"
                                  if mode in ("halo", "zoo") else
                                  "inputs.pt"), weights_only=False)
    res = {"world": process_count()}
    if mode == "ops":
        res.update(ops(inp, make_mesh(process_count()).bands))
    elif mode == "halo":
        res.update(halo(inp, make_mesh(4).bands))
    elif mode == "zoo":
        res.update(zoo(inp, make_mesh(process_count())))
    elif mode == "grid":
        res["step"] = train_step(inp, inp["step_sets"]["ce"], make_mesh(2))
    else:
        mesh = make_mesh(2)
        res["step"] = {name: train_step(inp, sets, mesh)
                       for name, sets in inp["step_sets"].items()}
        stop = os.path.join(out_dir, "terminate")
        if rank == 1:
            open(stop, "w").close()
        logdir = os.path.join(out_dir, "fit")
        # the first epoch, stopped by rank 1's termination request; then
        # the run resumed from its checkpoint
        res["stop"] = fit_case(inp, logdir, terminate_file=stop if rank == 1
                               else os.path.join(out_dir, "absent"))
        res["resume"] = fit_case(inp, logdir)
    res["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in (
        "tpuseg", "jax", "jaxlib", "flax", "optax", "orbax"))
    torch.save(res, os.path.join(out_dir, f"{mode}_rank{rank}.pt"))


if __name__ == "__main__":
    main()
