"""One rank of tests/test_torch_ddp.py's two-process gloo cluster on the CPU.

Run with torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) and ``<dir>``: reads ``<dir>/inputs.pt`` (the
global batches, weights and configs the parent drew from seeds), runs this
rank's share of each case and writes what the parent asserts to
``<dir>/rank<r>.pt``:

- ``BatchNorm2d`` in train mode on this rank's half of a global batch
  (forward, backward of ``sum(y * dy)``, running statistics), also at one
  value a channel a rank;
- each recipe loss's value and logits gradient through ``get_loss``;
- ``multihost_sum`` and the per-scale reduction with this rank's val shard
  empty on rank 1;
- one tiny ``HRNet_Mscale_Tiny`` train step under DDP at batch 1 a rank;
- ``Trainer.fit`` through the CLI's ``--multi-host``, twice: a whole
  test-mode run, and one where only rank 1 sees the termination file.

With ``<dir> validate`` it runs only ``Trainer.validate`` over the val
split of ``<dir>/val_inputs.pt``'s Cityscapes miniature (any number of
ranks; tests/test_torch_val_shards.py) and writes ``<dir>/val_rank<r>.pt``:
the names of the images this rank scored and the summed confusion matrix.

Imports nothing of ``tpuseg`` or JAX; the modules it loaded go into the
result.
"""
import contextlib
import io
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tpuseg_torch.cli.main import load_config
from tpuseg_torch.cli.main import main as cli_main
from tpuseg_torch.config import make_config
from tpuseg_torch.losses import get_loss
from tpuseg_torch.models import get_model
from tpuseg_torch.models.layers import BatchNorm2d
from tpuseg_torch.parallel import (
    init_distributed,
    multihost_sum,
    process_count,
    process_index,
)
from tpuseg_torch.train import loop
from tpuseg_torch.train.optim import make_optimizer
from tpuseg_torch.train.step import make_train_step


def _half(a, rank):
    """This rank's half of a global batch (its leading rows)."""
    n = a.shape[0] // 2
    return a[rank * n:(rank + 1) * n]


def bn_case(case, rank):
    x = torch.from_numpy(_half(case["x"], rank)).requires_grad_()
    dy = torch.from_numpy(_half(case["dy"], rank))
    bn = BatchNorm2d(x.shape[1])
    bn.load_state_dict(case["state"])
    y = bn.train()(x)
    (y * dy).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad,
            "db": bn.bias.grad, "state": bn.state_dict()}


def loss_case(case, rank):
    criterion, _ = get_loss(make_config(case["sets"]))
    logits = torch.from_numpy(_half(case["logits"], rank)).requires_grad_()
    loss = criterion(logits, torch.from_numpy(_half(case["target"], rank)))
    loss.backward()
    return {"loss": loss.detach(), "grad": logits.grad}


def train_step_case(inp, rank):
    cfg = make_config(inp["step_sets"])
    torch.manual_seed(0)
    model = get_model(cfg)
    model.load_state_dict(inp["step_state"])
    model.train()
    net = torch.nn.parallel.DistributedDataParallel(
        model, broadcast_buffers=False)
    criterion, _ = get_loss(cfg)
    opt, schedule = make_optimizer(cfg, model.parameters(), 1)
    lc = cfg.loss
    step = make_train_step(criterion, schedule, ocr_alpha=lc.ocr_alpha,
                           supervised_mscale_wt=lc.supervised_mscale_wt)
    batch = {"image": torch.from_numpy(_half(inp["step_image"], rank)),
             "label": torch.from_numpy(_half(inp["step_label"], rank))}
    loss = step(net, opt, batch, 0)["loss"]
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return {"loss": loss, "state": state,
            "no_grad": [n for n, p in model.named_parameters()
                        if p.grad is None]}


def fit_case(inp, rank, logdir, terminate_file=None):
    """The CLI's train command with ``--multi-host``; returns the primary's
    output and the mIoU each validation returned on this rank."""
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


def validate_case(inp, rank, logdir):
    """``Trainer.validate`` on this rank's val shard: the image names this
    rank scored and the matrix summed over the ranks."""
    cfg = load_config(inp["recipe"], inp["sets"])
    trainer = loop.Trainer(cfg, logdir, device="cpu", is_primary=rank == 0)
    names = []
    run_batch = trainer.eval_runner.run_batch

    def spy(batch, *args, **kwargs):
        names.extend(batch["name"])
        return run_batch(batch, *args, **kwargs)

    trainer.eval_runner.run_batch = spy
    metrics = trainer.validate(0)
    return {"names": names, "hist": metrics.hist}


def main():
    out_dir = sys.argv[1]
    torch.set_num_threads(1)
    init_distributed("cpu")
    rank = process_index()
    if sys.argv[2:] == ["validate"]:
        inp = torch.load(os.path.join(out_dir, "val_inputs.pt"),
                         weights_only=False)
        res = validate_case(inp, rank, os.path.join(out_dir, "val"))
        torch.save(res, os.path.join(out_dir, f"val_rank{rank}.pt"))
        return
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    res = {"world": process_count()}
    res["bn"] = {name: bn_case(case, rank)
                 for name, case in inp["bn"].items()}
    res["loss"] = {name: loss_case(case, rank)
                   for name, case in inp["loss"].items()}
    res["sum"] = multihost_sum(np.asarray([rank + 1.0, 2.0 * rank]))

    class Runner:  # the runner's static scale set
        scale_hist_scales = (1.0, 0.5, 2.0)

    # rank 1's val shard is empty: no per-scale matrix was accumulated
    local = {} if rank == 1 else {
        s: np.full((3, 3), 10.0 * s) for s in Runner.scale_hist_scales}
    res["scale_hists"] = loop._reduce_scale_hists(local, Runner, 3)
    res["step"] = train_step_case(inp, rank)
    res["fit"] = fit_case(inp, rank, os.path.join(out_dir, "fit"))
    # a termination request seen on rank 1 alone stops both ranks
    stop = os.path.join(out_dir, "terminate")
    if rank == 1:
        open(stop, "w").close()
    res["stop"] = fit_case(inp, rank, os.path.join(out_dir, "stop"),
                           terminate_file=stop if rank == 1 else
                           os.path.join(out_dir, "absent"))
    res["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in (
        "tpuseg", "jax", "jaxlib", "flax", "optax", "orbax"))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
