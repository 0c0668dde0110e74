"""Data-parallel training of the port on a real two-process gloo cluster on
the CPU, against one process on the global batch and against tpuseg.

One module-scoped fixture draws seeded global batches, writes them for
two child processes (tests/_torch_ddp_child.py, torchrun's environment,
batch 1 a rank where a batch is split) and, while they run, computes the
same cases in this process: the port on the global batch, and tpuseg's
single-process loss and train step (``_torch_port.quick_jit``). The
cases: ``BatchNorm2d``'s global statistics (forward, backward, running
statistics, one value a channel a rank), each recipe loss with unequal
ignore counts across the ranks, one ``HRNet_Mscale_Tiny`` step,
``multihost_sum`` and the per-scale reduction with one rank's val shard
empty, and ``Trainer.fit`` through the CLI's ``--multi-host`` (the
counterpart of tests/test_multihost.py's two-process checks)."""
import os
import re
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import l1_rel, load_into, quick_jit, random_variables, \
    set_threads
from tpuseg.config import make_config as jax_make_config
from tpuseg.losses.factory import get_loss as jax_get_loss
from tpuseg.models import get_model as jax_get_model
from tpuseg.train.optim import make_optimizer as jax_make_optimizer
from tpuseg.train.step import make_loss_fn as jax_make_loss_fn
from tpuseg_torch.config import make_config
from tpuseg_torch.convert import state_dict_from_flax
from tpuseg_torch.data.relaxed_labels import relaxed_onehot
from tpuseg_torch.losses import get_loss
from tpuseg_torch.models import get_model
from tpuseg_torch.models.layers import BatchNorm2d
from tpuseg_torch.train.optim import make_optimizer
from tpuseg_torch.train.step import make_train_step

set_threads()

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHILD = os.path.join(HERE, "_torch_ddp_child.py")
RECIPE = os.path.join(REPO, "tpuseg_torch", "cli", "recipes",
                      "train_cityscapes.yaml")
C = 6  # classes of the loss cases
LOSSES = {
    "ce": {"loss.loss_type": "ce"},
    "rmi": {"loss.loss_type": "rmi"},
    "img_wt": {"loss.loss_type": "img_wt"},
    "img_wt_batch": {"loss.loss_type": "img_wt",
                     "loss.batch_weighting": True},
    "relaxed": {"loss.loss_type": "relaxed"},
    "relaxed_batch": {"loss.loss_type": "relaxed",
                      "loss.batch_weighting": True},
}
# the tiny train step (tests/test_torch_train.py's), with CE: RMI's nearly
# singular 9x9 factors amplify the f32 summation order of the global BN
# statistics to 1.4e-6 of the loss, past DP_REL (its value and gradient
# are held on fixed logits below)
H, W = 64, 128
STEP_SETS = {"model.arch": "ocrnet.HRNet_Mscale_Tiny",
             "model.compute_dtype": "float32", "model.remat": False,
             "model.n_scales": (), "model.ocr.dropout": 0.0,
             "loss.loss_type": "ce", "loss.ocr_alpha": 0.4,
             "loss.supervised_mscale_wt": 0.05, "optim.lr": 5e-4,
             "optim.weight_decay": 1e-3}
# Trainer.fit over a Cityscapes miniature of 4 train and 2 val scenes:
# 2 steps an epoch a rank at global batch 2, one val image a rank (every
# step costs ~2,500 synced-BN all-reduces, slow under a loaded CPU)
FIT_SETS = ["model.arch=ocrnet.HRNet_Mscale_Tiny", "model.remat=false",
            "dataset.name=cityscapes", "dataset.crop_size=[64,64]",
            "dataset.class_uniform_pct=0", "train.test_mode=true",
            "train.batch_size=2", "train.val_freq=2", "train.log_every=1"]
# two ranks vs one process on the global batch, f32 on the CPU: the same
# sums in another order
DP_REL = 1e-6
# port vs tpuseg (the North star's tolerances: tests/test_torch_train.py's
# bands for the CE step, tests/test_torch_losses.py's for the losses)
TPUSEG_LOSS_REL = {"rmi": 1e-4}
TPUSEG_GRAD_L1 = {"rmi": 5e-4}
STEP_TOL = dict(loss=1e-5, stats=1e-5, params=1e-5)


def _write_cityscapes(root) -> None:
    """4 train and 2 val 64x64 scenes of train classes in 16-px squares."""
    from PIL import Image

    rng = np.random.RandomState(1)
    for split, city, n in [("train", "aachen", 4), ("val", "lindau", 2)]:
        img_dir = root / "leftImg8bit_trainvaltest/leftImg8bit" / split / city
        msk_dir = root / "gtFine_trainvaltest/gtFine" / split / city
        img_dir.mkdir(parents=True)
        msk_dir.mkdir(parents=True)
        for i in range(n):
            base = f"{city}_{i:06d}_000019"
            Image.fromarray(rng.randint(0, 255, (64, 64, 3),
                                        dtype=np.uint8)).save(
                img_dir / f"{base}_leftImg8bit.png")
            ids = rng.choice([7, 8, 11, 17, 21, 24, 26], (4, 4))
            Image.fromarray(np.repeat(np.repeat(ids, 16, 0), 16, 1).astype(
                np.uint8)).save(msk_dir / f"{base}_gtFine_labelIds.png")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _bn_cases(rng) -> dict:
    """A global batch of 4 and one of 2 images of one pixel (one value a
    channel a rank), with random affine parameters and running stats."""
    cases = {}
    for name, shape in (("batch", (4, 8, 6, 5)), ("one_value", (2, 8, 1, 1))):
        bn = BatchNorm2d(shape[1])
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(1 + 0.2 * rng.randn(shape[1])))
            bn.bias.copy_(torch.from_numpy(0.1 * rng.randn(shape[1])))
            bn.running_mean.copy_(torch.from_numpy(rng.randn(shape[1])))
            bn.running_var.copy_(torch.from_numpy(1 + rng.rand(shape[1])))
        cases[name] = {
            "x": (2 + 3 * rng.randn(*shape)).astype(np.float32),
            "dy": rng.randn(*shape).astype(np.float32),
            "state": {k: v.clone() for k, v in bn.state_dict().items()}}
    return cases


def _bn_one_process(case) -> dict:
    x = torch.from_numpy(case["x"]).requires_grad_()
    bn = BatchNorm2d(x.shape[1])
    bn.load_state_dict(case["state"])
    y = bn.train()(x)
    (y * torch.from_numpy(case["dy"])).sum().backward()
    var = x.detach().double().var(dim=(0, 2, 3), unbiased=False)
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad,
            "db": bn.bias.grad, "state": bn.state_dict(),
            "invstd": (var + bn.eps).rsqrt().numpy(),
            "dy_max": float(np.abs(case["dy"]).max())}


def _loss_inputs(rng):
    """Logits and labels of a global batch of 4 at 32x32 whose halves (the
    ranks' shards) have different numbers of ignore pixels."""
    logits = (2 * rng.randn(4, 32, 32, C)).astype(np.float32)
    labels = np.repeat(np.repeat(rng.randint(0, C, (4, 8, 8)), 4, 1), 4, 2)
    labels = labels.astype(np.int32)
    labels[0, :3] = 255          # rank 0: 96 ignore pixels
    labels[2, :, :20] = 255      # rank 1: 640
    labels[3, 10:14, 5:9] = 255
    return logits, labels


def _sets(name):
    return {"dataset.num_classes": C, **LOSSES[name]}


def _target(name, labels):
    if LOSSES[name]["loss.loss_type"] != "relaxed":
        return labels
    return np.stack([relaxed_onehot(lab, C) for lab in labels]
                    ).astype(np.float32)


def _port_loss(name, logits, target):
    criterion, _ = get_loss(make_config(_sets(name)))
    t = torch.from_numpy(logits).requires_grad_()
    loss = criterion(t, torch.from_numpy(target))
    loss.backward()
    return float(loss.detach()), t.grad.numpy()


def _jax_loss(name, logits, target):
    criterion, _ = jax_get_loss(jax_make_config(_sets(name)))
    loss, grad = quick_jit(jax.value_and_grad(criterion))(
        jnp.asarray(logits), jnp.asarray(target))
    return float(loss), np.asarray(grad)


def _step_batch():
    """tests/test_torch_train.py's batch: image 1 has 20 more ignore
    columns than image 0, so the two ranks' valid-pixel counts differ."""
    rng = np.random.RandomState(7)
    image = rng.randint(0, 256, (2, H, W, 3)).astype(np.uint8)
    label = np.zeros((2, H, W), np.uint8)
    label[:, H // 2:] = 7
    label[:, :H // 4] = 10
    label[0, 20:40, 30:90] = 13
    label[1, :, :20] = 255
    label[:, :2] = 255
    return image, label


def _port_step_one_process(state, image, label):
    cfg = make_config(STEP_SETS)
    model = get_model(cfg)
    model.load_state_dict(state)
    model.train()
    criterion, _ = get_loss(cfg)
    opt, schedule = make_optimizer(cfg, model.parameters(), 1)
    step = make_train_step(criterion, schedule, ocr_alpha=0.4,
                           supervised_mscale_wt=0.05)
    loss = step(model, opt, {"image": torch.from_numpy(image),
                             "label": torch.from_numpy(label)}, 0)["loss"]
    return float(loss), {k: v.detach().clone()
                         for k, v in model.state_dict().items()}


def _jax_step(variables, image, label):
    """tpuseg's single-process step on the global batch: the loss, and the
    BN statistics and parameters after one SGD step, in the port's names."""
    cfg = jax_make_config(STEP_SETS)
    model = jax_get_model(cfg)
    criterion, _ = jax_get_loss(cfg)
    loss_fn = jax_make_loss_fn(model, criterion, ocr_alpha=0.4,
                               supervised_mscale_wt=0.05)
    batch = {"image": jnp.asarray(image), "label": jnp.asarray(label)}
    tx, _ = jax_make_optimizer(cfg, 1)

    @quick_jit
    def step(params, stats):
        (loss, mutated), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, stats, batch, jax.random.PRNGKey(0))
        updates, _ = tx.update(grads, tx.init(params), params)
        return loss, mutated["batch_stats"], optax.apply_updates(params,
                                                                 updates)

    loss, stats, params = step(variables["params"],
                               variables["batch_stats"])
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return float(loss), state_dict_from_flax(to_np(params), to_np(stats))


def _tree_l1(got: dict, want: dict) -> float:
    num = sum(float((got[k].double() - want[k].double()).abs().sum())
              for k in want)
    return num / sum(float(want[k].double().abs().sum()) for k in want)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    out = tmp_path_factory.mktemp("ddp")
    rng = np.random.RandomState(0)
    bn = _bn_cases(rng)
    logits, labels = _loss_inputs(rng)
    losses = {name: {"sets": _sets(name), "logits": logits,
                     "target": _target(name, labels)} for name in LOSSES}
    jm = jax_get_model(jax_make_config(STEP_SETS))
    variables = random_variables(jm, np.random.RandomState(0),
                                 jnp.zeros((1, H, W, 3), jnp.float32))
    state = load_into(get_model(make_config(STEP_SETS)),
                      variables).state_dict()
    image, label = _step_batch()
    _write_cityscapes(out / "cityscapes")
    fit_sets = FIT_SETS + [f"dataset.cityscapes_dir={out / 'cityscapes'}"]
    torch.save({"bn": bn, "loss": losses, "step_sets": STEP_SETS,
                "step_state": state, "step_image": image,
                "step_label": label, "recipe": RECIPE,
                "fit_sets": fit_sets}, out / "inputs.pt")

    port = _free_port()
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        env.pop("TPUSEG_TERMINATE_FILE", None)
        procs.append(subprocess.Popen(
            [sys.executable, CHILD, str(out)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO))
    try:
        # the same cases in this process while the ranks run; tpuseg's step
        # compiles in a thread (XLA's compile releases the interpreter)
        with ThreadPoolExecutor(1) as pool:
            jax_step = pool.submit(_jax_step, variables, image, label)
            want = {
                "bn": {name: _bn_one_process(case)
                       for name, case in bn.items()},
                "loss": {name: _port_loss(name, logits, case["target"])
                         for name, case in losses.items()},
                "jax_loss": {name: _jax_loss(name, logits, case["target"])
                             for name, case in losses.items()},
                "step": _port_step_one_process(state, image, label),
                "jax_step": jax_step.result(timeout=300),
            }
        texts = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, texts):
        assert p.returncode == 0, text[-4000:]
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in (0, 1)]
    return ranks, want, out


def _cat(ranks, *keys):
    parts = []
    for r in ranks:
        v = r
        for k in keys:
            v = v[k]
        parts.append(v)
    return torch.cat(parts)


@pytest.mark.parametrize("case", ["batch", "one_value"])
def test_batchnorm_global_statistics(cluster, case):
    """Each rank's output and input gradient are its half of the one
    process's; the local weight and bias gradients sum to the one
    process's (DDP then averages them, as the loss is a mean over ranks);
    both ranks' running statistics equal the one process's, Bessel's
    factor taken from the global count."""
    ranks, want, _ = cluster
    want = want["bn"][case]
    got = [r["bn"][case] for r in ranks]
    assert l1_rel(_cat(got, "y"), want["y"]) < DP_REL
    if case == "batch":
        assert l1_rel(_cat(got, "dx"), want["dx"]) < DP_REL
    else:
        # two values a channel normalise to -1 and +1 whatever they are:
        # the input gradient is 0 up to rounding on both sides, which
        # the scale of w * invstd * dy bounds
        x = np.asarray(want["state"]["weight"])
        scale = float(np.abs(x).max() * want["invstd"].max()
                      * want["dy_max"])
        assert float((_cat(got, "dx") - want["dx"]).abs().max()) < \
            1e-5 * scale
    for key in ("dw", "db"):
        assert l1_rel(got[0][key] + got[1][key], want[key]) < DP_REL, key
    for r in got:
        for k, v in want["state"].items():
            assert l1_rel(r["state"][k].double(), v.double()) < DP_REL, k
        assert int(r["state"]["num_batches_tracked"]) == 1
    if case == "one_value":
        # two values a channel over the ranks, not one: a real variance
        assert float(_cat(got, "y").std()) > 0.1


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_is_global_batch_loss(cluster, name):
    """The ranks' mean loss is the global batch's loss, and each rank's
    logits gradient over the number of ranks (DDP's mean) is the global
    loss's gradient at its half, with unequal ignore counts across the
    ranks; both against the port in one process and against tpuseg."""
    ranks, want, _ = cluster
    loss = float(sum(r["loss"][name]["loss"] for r in ranks)) / 2
    grad = _cat(ranks, "loss", name, "grad") / 2
    one_loss, one_grad = want["loss"][name]
    jax_loss, jax_grad = want["jax_loss"][name]
    assert abs(loss - one_loss) <= DP_REL * abs(one_loss), (loss, one_loss)
    assert l1_rel(grad, one_grad) < 2 * DP_REL
    kind = LOSSES[name]["loss.loss_type"]
    assert abs(loss - jax_loss) <= TPUSEG_LOSS_REL.get(kind, 1e-5) * abs(
        jax_loss), (loss, jax_loss)
    assert l1_rel(grad, jax_grad) < TPUSEG_GRAD_L1.get(kind, 1e-5)


def test_multihost_sum_and_empty_shard_reduction(cluster):
    """``multihost_sum`` sums across the ranks; the per-scale reduction
    completes with rank 1's shard empty (the same collectives in the
    static sorted scale order) and gives both ranks rank 0's matrices."""
    ranks, _, _ = cluster
    for r in ranks:
        assert r["world"] == 2
        np.testing.assert_array_equal(r["sum"], [3.0, 2.0])
        assert list(r["scale_hists"]) == [0.5, 1.0, 2.0]
        for s, h in r["scale_hists"].items():
            np.testing.assert_array_equal(h, np.full((3, 3), 10.0 * s))


def test_train_step_two_ranks(cluster):
    """One HRNet_Mscale_Tiny step at batch 1 a rank under DDP: every
    parameter gets a gradient; the global loss, the parameters after SGD
    and the BN running statistics match one process on the global batch
    (rel / L1-rel 1e-6) and tpuseg's single-process step."""
    ranks, want, _ = cluster
    got = [r["step"] for r in ranks]
    assert got[0]["no_grad"] == [] and got[1]["no_grad"] == []
    loss = float(got[0]["loss"] + got[1]["loss"]) / 2
    one_loss, one_state = want["step"]
    jax_loss, jax_state = want["jax_step"]
    assert abs(loss - one_loss) <= DP_REL * abs(one_loss), (loss, one_loss)
    assert abs(loss - jax_loss) <= STEP_TOL["loss"] * abs(jax_loss)
    params = [k for k in one_state if k.endswith(("weight", "bias"))]
    stats = [k for k in one_state
             if k.endswith(("running_mean", "running_var"))]
    for r in got:
        assert _tree_l1({k: r["state"][k] for k in params},
                        {k: one_state[k] for k in params}) < DP_REL
        assert _tree_l1({k: r["state"][k] for k in stats},
                        {k: one_state[k] for k in stats}) < DP_REL
        assert _tree_l1({k: r["state"][k] for k in params},
                        {k: jax_state[k] for k in params}) < STEP_TOL[
            "params"]
        assert _tree_l1({k: r["state"][k] for k in stats},
                        {k: jax_state[k] for k in stats}) < STEP_TOL["stats"]
    # DDP kept the ranks' weights identical
    assert all(torch.equal(got[0]["state"][k], got[1]["state"][k])
               for k in params)


def test_fit_multi_host(cluster):
    """``Trainer.fit`` through the CLI's ``--multi-host`` on two ranks: both
    validate the whole val set's shards and hold the same mIoU, the
    primary logs the global rate and each rank's data wait, and one
    checkpoint (one validation) is written."""
    ranks, _, out = cluster
    fits = [r["fit"] for r in ranks]
    assert [f["rc"] for f in fits] == [0, 0]
    assert fits[0]["validations"] == fits[1]["validations"]
    (epoch, miou, pixels), = fits[0]["validations"]
    # one val image a rank of 64x64, every pixel labelled
    assert epoch == 1 and pixels == 2 * 64 * 64
    text = fits[0]["text"]
    assert fits[1]["text"] == ""  # only the primary logs
    m = re.search(r"mIoU by rank ([\d.]+) ([\d.]+)", text)
    assert m and m.group(1) == m.group(2) == f"{miou:.6f}", text[-2000:]
    assert re.search(r"host data wait by rank [\d.]+ [\d.]+ ms/step", text)
    assert sorted(os.listdir(out / "fit" / "ckpt")) == [
        "ckpt_4.json", "ckpt_4.pt"]
    ckpt = torch.load(out / "fit" / "ckpt" / "ckpt_4.pt",
                      weights_only=True)
    # the module's own names, loadable by one process
    model = get_model(make_config(
        {"model.arch": "ocrnet.HRNet_Mscale_Tiny"}))
    model.load_state_dict(ckpt["model"])


def test_termination_on_one_rank_stops_both(cluster):
    """Only rank 1 sees the termination file: both ranks stop after the
    first epoch, with no validation, and one checkpoint of that epoch."""
    ranks, _, out = cluster
    stops = [r["stop"] for r in ranks]
    assert [s["rc"] for s in stops] == [0, 0]
    assert stops[0]["validations"] == stops[1]["validations"] == []
    assert "termination requested" in stops[0]["text"]
    assert "done; best mIoU" not in stops[0]["text"]
    assert sorted(os.listdir(out / "stop" / "ckpt")) == [
        "ckpt_2.json", "ckpt_2.pt"]


def test_children_import_no_jax(cluster):
    ranks, _, _ = cluster
    assert ranks[0]["modules"] == ranks[1]["modules"] == []
