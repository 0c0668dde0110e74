"""The training slice against tpuseg: one and two train steps of the tiny
two-scale HRNet_Mscale from the same weights and batch (loss, gradient
tree, BN running statistics, parameters after SGD), stage remat on vs off,
and the engine (Trainer.fit and auto-resume, checkpoints, snapshots, the
CLI) on the CPU."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from _torch_port import load_into, random_variables, set_threads
from tpuseg.config import make_config as jax_make_config
from tpuseg.losses.factory import get_loss as jax_get_loss
from tpuseg.models import get_model as jax_get_model
from tpuseg.train.optim import make_optimizer as jax_make_optimizer
from tpuseg.train.step import make_loss_fn as jax_make_loss_fn
from tpuseg_torch.cli.main import load_config, main as cli_main
from tpuseg_torch.config import make_config
from tpuseg_torch.convert import state_dict_from_flax
from tpuseg_torch.losses import get_loss
from tpuseg_torch.models import get_model
from tpuseg_torch.train.checkpoint import (
    CheckpointManager,
    forgiving_merge,
    load_snapshot,
)
from tpuseg_torch.train.loop import Trainer
from tpuseg_torch.train.optim import make_optimizer
from tpuseg_torch.train.step import make_train_step

set_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "tpuseg_torch", "cli", "recipes",
                      "train_cityscapes.yaml")
H, W = 64, 128
SETS = {"model.arch": "ocrnet.HRNet_Mscale_Tiny",
        "model.compute_dtype": "float32", "model.remat": False,
        "model.n_scales": (), "model.ocr.dropout": 0.0,
        "loss.ocr_alpha": 0.4, "loss.supervised_mscale_wt": 0.05,
        "optim.lr": 5e-4, "optim.weight_decay": 1e-3}

# port vs tpuseg, f32 on the CPU: loss relative error, gradient-tree and
# BN-running-stat L1-relative errors, and the parameters after two SGD
# steps. The gradient bands are those tests/test_train_parity.py holds
# tpuseg to against the torch reference (the tiny train-mode backward
# amplifies f32 rounding; measured 5.7e-4 for ce); RMI adds its f32
# Cholesky chain. The small LR keeps a step at ~4e-4 of the parameters, so
# the gradients' f32 gap moves them by ~1e-6, while a wrong LR, momentum
# or step order moves them by ~4e-4.
TOL = {"ce": dict(loss=1e-5, grad=1.5e-3, stats=1e-5, params=1e-5),
       "rmi": dict(loss=1e-4, grad=5e-3, stats=1e-5, params=1e-5)}


def _batch():
    rng = np.random.RandomState(7)
    image = rng.randint(0, 256, (2, H, W, 3)).astype(np.uint8)
    label = np.zeros((2, H, W), np.uint8)
    label[:, H // 2:] = 7
    label[:, :H // 4] = 10
    label[0, 20:40, 30:90] = 13
    label[1, :, :20] = 255
    label[:, :2] = 255
    return image, label


def _tree_l1(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    num = sum(float((got[k].double() - want[k].double()).abs().sum())
              for k in want)
    den = sum(float(want[k].double().abs().sum()) for k in want)
    return num / den


def _stats(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _jax_steps(cfg, variables, image, label, steps):
    """tpuseg's production loss_fn differentiated, then its optax SGD:
    (loss, BN stats, gradients) of the first step and the parameters after
    ``steps`` steps, as the port's state-dict tensors."""
    model = jax_get_model(jax_make_config(cfg))
    criterion, _ = jax_get_loss(jax_make_config(cfg))
    loss_fn = jax_make_loss_fn(model, criterion, ocr_alpha=0.4,
                               supervised_mscale_wt=0.05)
    batch = {"image": jnp.asarray(image), "label": jnp.asarray(label)}

    @jax.jit
    def run(params, stats):
        (loss, mutated), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, stats, batch, jax.random.PRNGKey(0))
        return loss, mutated["batch_stats"], grads

    tx, _ = jax_make_optimizer(jax_make_config(cfg), 1)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    first = None
    for _ in range(steps):
        loss, stats, grads = run(params, stats)
        if first is None:
            first = (float(loss), stats, grads)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    loss, stats1, grads = first
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return (loss, state_dict_from_flax({}, to_np(stats1)),
            state_dict_from_flax(to_np(grads), {}),
            state_dict_from_flax(to_np(params), {}))


def _port_model(cfg, variables, remat=False):
    cfg = make_config({**cfg, "model.remat": remat})
    return load_into(get_model(cfg), variables).train()


def _port_step(cfg, model):
    criterion, _ = get_loss(make_config(cfg))
    opt, schedule = make_optimizer(make_config(cfg), model.parameters(), 1)
    step = make_train_step(criterion, schedule, ocr_alpha=0.4,
                           supervised_mscale_wt=0.05)
    image, label = _batch()
    batch = {"image": torch.from_numpy(image),
             "label": torch.from_numpy(label)}
    return lambda i: step(model, opt, batch, i)


@pytest.fixture(scope="module", params=["ce", "rmi"])
def stepped(request):
    crit = request.param
    cfg = {**SETS, "loss.loss_type": crit}
    jm = jax_get_model(jax_make_config(cfg))
    variables = random_variables(jm, np.random.RandomState(0),
                                 jnp.zeros((1, H, W, 3), jnp.float32))
    image, label = _batch()
    want = _jax_steps(cfg, variables, image, label, steps=2)

    model = _port_model(cfg, variables)
    run = _port_step(cfg, model)
    loss = float(run(0)["loss"])
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    stats = _stats(model)
    run(1)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return crit, cfg, variables, (loss, stats, grads, params), want


def test_train_loss_matches_tpuseg(stepped):
    crit, _, _, got, want = stepped
    assert abs(got[0] - want[0]) / abs(want[0]) < TOL[crit]["loss"], \
        (got[0], want[0])


def test_gradients_match_tpuseg(stepped):
    crit, _, _, got, want = stepped
    assert _tree_l1(got[2], want[2]) < TOL[crit]["grad"]


def test_bn_running_stats_match_tpuseg(stepped):
    """Both scales' train-mode passes update the running statistics, in
    order, with torch's unbiased variance."""
    crit, _, _, got, want = stepped
    want_stats = {k: v for k, v in want[1].items() if k in got[1]}
    assert len(want_stats) == len(got[1])
    assert _tree_l1(got[1], want_stats) < TOL[crit]["stats"]


def test_params_after_two_sgd_steps_match_tpuseg(stepped):
    crit, _, _, got, want = stepped
    assert _tree_l1(got[3], want[3]) < TOL[crit]["params"]


def test_remat_matches_no_remat(stepped):
    """Every stage remat'd (the recompute must not update BN statistics a
    second time): loss, gradients and the whole state dict after one step,
    num_batches_tracked included, equal to the run without remat up to the
    CPU's summation order."""
    _, cfg, variables, got, _ = stepped
    model = _port_model(cfg, variables, remat=True)
    assert model.backbone.remat == (1, 2, 3, 4)
    loss = float(_port_step(cfg, model)(0)["loss"])
    assert abs(loss - got[0]) <= 1e-6 * abs(got[0])
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert _tree_l1(grads, got[2]) < 1e-6
    assert _tree_l1(_stats(model), got[1]) < 1e-7
    tracked = {k: int(v) for k, v in model.state_dict().items()
               if k.endswith("num_batches_tracked")}
    assert set(tracked.values()) == {2}  # the 0.5x and 1.0x passes


def test_remat_stages_from_config():
    cfg = make_config({**SETS, "model.remat": True,
                       "model.remat_stages": [1, 2, 3]})
    assert get_model(cfg).backbone.remat == (1, 2, 3)
    assert get_model(make_config(SETS)).backbone.remat == ()
    # eval and no-grad forwards never checkpoint
    model = get_model(cfg).eval()
    with torch.no_grad():
        out = model(torch.zeros(1, 32, 64, 3))
    assert out["pred"].shape == (1, 32, 64, 19)


# ---------------------------------------------------------------- engine

@pytest.fixture(scope="module")
def fake_cityscapes(tmp_path_factory):
    """leftImg8bit/gtFine tree: 4 train and 2 val images of 64x128."""
    root = tmp_path_factory.mktemp("cs")
    rng = np.random.RandomState(0)
    for split, city, n in [("train", "aachen", 4), ("val", "lindau", 2)]:
        img_dir = root / "leftImg8bit_trainvaltest/leftImg8bit" / split / city
        msk_dir = root / "gtFine_trainvaltest/gtFine" / split / city
        img_dir.mkdir(parents=True)
        msk_dir.mkdir(parents=True)
        for i in range(n):
            base = f"{city}_{i:06d}_000019"
            Image.fromarray(rng.randint(0, 255, (H, W, 3), dtype=np.uint8)
                            ).save(img_dir / f"{base}_leftImg8bit.png")
            mask = np.zeros((H, W), np.uint8)
            mask[H // 2:, :] = 7      # road
            mask[:H // 4, :] = 23     # sky
            Image.fromarray(mask).save(
                msk_dir / f"{base}_gtFine_labelIds.png")
    return str(root)


def engine_sets(root: str, tmp: str) -> list:
    return ["model.arch=ocrnet.HRNet_Mscale_Tiny",
            "model.compute_dtype=float32",
            f"dataset.cityscapes_dir={root}",
            f"dataset.centroid_root={os.path.join(tmp, 'centroids')}",
            "dataset.crop_size=[32,32]", "dataset.class_uniform_tile=32",
            "dataset.num_workers=2", "dataset.color_aug=0.0",
            "train.batch_size=2", "train.test_mode=true",
            "train.log_every=1", "eval.scales=[0.5,1.0]", "optim.lr=1e-3"]


def test_trainer_fit_then_auto_resume(fake_cityscapes, tmp_path):
    logdir = str(tmp_path / "logs")
    cfg = load_config(RECIPE, engine_sets(fake_cityscapes, str(tmp_path)))
    assert cfg.loss.loss_type == "rmi" and cfg.dataset.transfer_uint8
    trainer = Trainer(cfg, logdir=logdir, device="cpu")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.fit()
    assert trainer.model.training

    lines = [json.loads(line)
             for line in open(os.path.join(logdir, "metrics.jsonl"))]
    train = [line for line in lines if line["phase"] == "train"]
    val = [line for line in lines if line["phase"] == "val"]
    assert len(val) == 2 and all(0.0 <= v["mIoU"] <= 1.0 for v in val)
    assert train and all(np.isfinite(t["loss"]) for t in train)
    steps = trainer.step
    assert steps == 2 * trainer.steps_per_epoch
    after = trainer.model.state_dict()
    for k in ("ocr.cls_head.weight",
              "backbone.stage4.0.branches.3.0.bn2.running_var"):
        assert not torch.equal(before[k], after[k]), k
    log = open(os.path.join(logdir, "log.txt")).read()
    assert log.count(" s/step, ") == 2          # one rate line an epoch
    # each validation dumps composites of the images the dumper picks
    dumped = os.listdir(os.path.join(logdir, "best_images"))
    assert "index.html" in dumped
    assert any(f.endswith("_composited.png") for f in dumped)

    # the checkpoint holds the trained state; a second Trainer resumes it
    assert trainer.ckpt.latest_step() == steps
    trainer2 = Trainer(cfg, logdir=logdir, device="cpu")
    assert trainer2.start_epoch == 2 and trainer2.step == steps
    for k, v in trainer2.model.state_dict().items():
        assert torch.equal(v, after[k]), k
    assert trainer2.optimizer.state_dict()["state"]  # momentum buffers
    batch = next(iter(trainer2.train_loader))
    out = trainer2.train_step(trainer2.model, trainer2.optimizer,
                              {"image": torch.from_numpy(batch["image"]),
                               "label": torch.from_numpy(batch["label"])},
                              trainer2.step)
    assert np.isfinite(float(out["loss"]))


def test_trainer_profile_steps(fake_cityscapes, tmp_path):
    sets = engine_sets(fake_cityscapes, str(tmp_path)) + [
        "train.profile_steps=2", "loss.loss_type=ce"]
    trainer = Trainer(load_config(None, sets), logdir=str(tmp_path),
                      device="cpu")
    trainer.train_epoch(0)
    traces = os.listdir(tmp_path / "trace")
    assert traces and all(t.endswith(".json") for t in traces)
    # the trace carries the step's layer spans
    text = (tmp_path / "trace" / traces[0]).read_text()
    assert all(f'"{name}"' in text for name in (
        "train.forward", "train.backward", "train.optimizer", "model.trunk"))


def test_checkpoint_retention_and_snapshot(tmp_path):
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 1),
                                torch.nn.BatchNorm2d(4))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    for step, miou in ((1, 0.5), (2, 0.2), (3, 0.1)):
        mgr.save(step, model, opt, epoch=step, mean_iu=miou,
                 extra={"aux_wt": 0.4})
    assert mgr.steps() == [1, 3]          # the best and the latest
    meta = mgr.restore()["meta"]
    assert meta["epoch"] == 3 and abs(meta["aux_wt"] - 0.4) < 1e-12
    assert mgr.restore(1)["meta"]["mean_iu"] == 0.5

    # a reference-format .pth with DataParallel prefixes and a wider head
    ref = {f"module.{k}": v + 1 for k, v in model.state_dict().items()}
    ref["module.0.weight"] = torch.zeros(8, 3, 1, 1)
    torch.save({"state_dict": ref}, tmp_path / "ref.pth")
    target = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 1),
                                 torch.nn.BatchNorm2d(4))
    skipped = []
    load_snapshot(str(tmp_path / "ref.pth"), target, skipped.append)
    assert skipped == ["Skipped loading parameter 0.weight"]
    assert torch.equal(target[1].running_var,
                       model[1].running_var + 1)


def test_forgiving_merge_shape_mismatch():
    target = {"a.w": torch.zeros(3, 3), "cls.w": torch.zeros(19, 4),
              "gone": torch.zeros(2)}
    loaded = {"a.w": torch.ones(3, 3), "cls.w": torch.ones(65, 4)}
    merged = forgiving_merge(target, loaded, log=lambda *_: None)
    assert (merged["a.w"] == 1).all()      # shape match -> loaded
    assert (merged["cls.w"] == 0).all()    # 65 vs 19 classes -> kept
    assert (merged["gone"] == 0).all()     # missing -> kept


def test_cli_train_subprocess_on_cpu(tmp_path):
    """The acceptance run: the shipped recipe, tiny, on the CPU; no JAX or
    tpuseg module loaded."""
    code = (
        "import atexit, runpy, sys\n"
        "atexit.register(lambda: print('FOREIGN', sorted(m for m in "
        "sys.modules if m.split('.')[0] in {'jax', 'flax', 'optax', "
        "'orbax', 'tpuseg'})))\n"
        "sys.argv = ['tpuseg_torch.cli'] + sys.argv[1:]\n"
        "runpy.run_module('tpuseg_torch.cli', run_name='__main__')\n")
    args = ["train", "--device", "cpu", "--config", RECIPE,
            "--logdir", str(tmp_path),
            "--set", "model.arch=ocrnet.HRNet_Mscale_Tiny",
            "--set", "dataset.name=synthetic",
            "--set", "dataset.crop_size=[64,128]",
            "--set", "train.test_mode=true",
            "--set", "train.batch_size=1",
            "--set", "dataset.num_workers=2"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "FOREIGN []" in res.stdout, res.stdout[-500:]
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 20


def test_cli_train_cuda_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli_main(["train", "--config", RECIPE, "--logdir", str(tmp_path),
                  "--set", "model.arch=ocrnet.HRNet_Mscale_Tiny",
                  "--set", "dataset.name=synthetic"])


def test_cli_train_checkpoint_maps_to_snapshot(monkeypatch, tmp_path):
    seen = {}

    class FakeTrainer:
        def __init__(self, cfg, logdir, device, is_primary):
            seen.update(snapshot=cfg.train.snapshot, device=device,
                        is_primary=is_primary)

        def fit(self):
            seen["fit"] = True

    monkeypatch.setattr("tpuseg_torch.train.loop.Trainer", FakeTrainer)
    assert cli_main(["train", "--checkpoint", "w.pth", "--logdir",
                     str(tmp_path)]) == 0
    assert seen == {"snapshot": "w.pth", "device": "cuda",
                    "is_primary": True, "fit": True}
