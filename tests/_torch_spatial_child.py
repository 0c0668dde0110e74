"""One rank of the dp x sp gloo clusters of tests/test_torch_spatial_ops.py
and tests/test_torch_spatial_train.py on the CPU.

Run with torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) and ``<mode> <dir>``: reads ``<dir>/inputs.pt``
(what the parent drew from seeds), runs this rank's band of each case
under ``mesh.model_parallelism = 2`` and writes what the parent asserts
to ``<dir>/<mode>_rank<r>.pt``. Modes:

- ``ops`` (2 ranks, one sp group): every band primitive, forward and
  backward, on this rank's band of the parent's whole tensors: convs,
  bilinear resizes, pools, RMI's pooled bands, the OCR class gather and
  the losses;
- ``train`` (2 ranks): one ``HRNet_Mscale_Tiny`` step under DDP with CE and
  with RMI + aux, then ``Trainer.fit`` through the CLI's ``--multi-host``,
  stopped by a termination request after the first epoch and resumed;
- ``grid`` (4 ranks, dp 2 x sp 2): the CE step, one image a dp group.

Imports nothing of ``tpuseg`` or JAX; the modules it loaded go into the
result.
"""
import contextlib
import io
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tpuseg_torch.cli.main import main as cli_main
from tpuseg_torch.config import make_config
from tpuseg_torch.losses import get_loss
from tpuseg_torch.losses import rmi as rmi_mod
from tpuseg_torch.models import get_model
from tpuseg_torch.models.layers import Conv2d
from tpuseg_torch.models.ocr import spatial_gather
from tpuseg_torch.ops import avg_pool2d, max_pool2d, resize_x, scale_as
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


def band(t: torch.Tensor, bands, dim: int = 2) -> torch.Tensor:
    """This rank's band of whole tensor ``t`` (rows along ``dim``)."""
    h = t.shape[dim] // bands.size
    return t.narrow(dim, bands.index * h, h).contiguous()


def _grad_case(fn, xs, dy, bands, whole_out=False):
    """``fn`` on this rank's bands of ``xs`` with ``sum(y * dy)``'s
    backward, ``dy`` this rank's band of the upstream gradient (the whole
    of it for a ``whole_out`` function): the output and the inputs'
    gradients."""
    xs = [band(x, bands).requires_grad_() for x in xs]
    with spatial.sharded(bands):
        y = fn(*xs)
        (y * (dy if whole_out else band(dy, bands))).sum().backward()
    return {"y": y.detach(), "grads": [x.grad for x in xs]}


def ops(inp, bands):
    res = {"conv": {}, "resize": {}, "pool": {}, "rmi_pool": {}, "loss": {}}
    for name, case in inp["conv"].items():
        conv = Conv2d(*case["args"], **case["kw"])
        conv.load_state_dict(case["state"])
        out = _grad_case(conv, [case["x"]], case["dy"], bands)
        out["dw"] = conv.weight.grad
        res["conv"][name] = out
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
        pool = avg_pool2d if case["kind"] == "avg" else max_pool2d
        res["pool"][name] = _grad_case(
            lambda x: pool(x, *case["args"]), [case["x"]], case["dy"],
            bands)
    for name, case in inp["rmi_pool"].items():
        with spatial.sharded(bands):
            oh, pr, n_rows = rmi_mod._pooled(
                band(case["onehot"], bands), band(case["probs"], bands),
                4, case["way"], 3)
        res["rmi_pool"][name] = {"onehot": oh, "probs": pr,
                                 "n_rows": n_rows}
    g = inp["gather"]
    res["gather"] = _grad_case(spatial_gather, [g["feats"], g["probs"]],
                               g["dctx"], bands, whole_out=True)
    for name, case in inp["loss"].items():
        criterion, _ = get_loss(make_config(case["sets"]))
        logits = band(case["logits"], bands, 1).requires_grad_()
        with spatial.sharded(bands):
            loss = criterion(logits, band(case["target"], bands, 1))
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
    batch = shard_batch_spatial(mesh, {"image": inp["image"][rows],
                                       "label": inp["label"][rows]})
    batch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    with spatial.sharded(mesh.bands):
        loss = step(net, opt, batch, 0)["loss"]
    return {"loss": loss,
            "state": {k: v.detach().clone()
                      for k, v in model.state_dict().items()},
            "no_grad": [n for n, p in model.named_parameters()
                        if p.grad is None]}


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
    return {"rc": rc, "validations": seen, "text": out.getvalue()}


def main():
    mode, out_dir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    init_distributed("cpu")
    rank = process_index()
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    res = {"world": process_count()}
    if mode == "ops":
        res.update(ops(inp, make_mesh(2).bands))
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
