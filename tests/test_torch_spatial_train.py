"""dp x sp training of the port (``mesh.model_parallelism = 2``) on real gloo
clusters on the CPU, against tpuseg's spatially sharded step and against
one process.

One module-scoped fixture draws seeded tpuseg variables and a batch of two
128x32 images, writes them, and starts at once: tpuseg's step under
``make_mesh(devices[:2], model_parallelism=2)`` + ``shard_batch_spatial``
for each loss (tests/_torch_spatial_jax.py, one process each: tracing and
compiling them is most of this file's time), the port's two ranks of one
sp group (tests/_torch_spatial_child.py ``train``: the step with CE and
with RMI + aux under DDP, then ``Trainer.fit`` through the CLI's
``--multi-host`` over a Cityscapes miniature, stopped after the first
epoch by a termination request on rank 1 and resumed) and four ranks as
dp 2 x sp 2 (``grid``: the CE step, one image a dp group). Meanwhile this
process runs the port's step on the whole batch.

Bounds (tests/test_spatial_sharding.py:135-144, tpuseg's own for its
sharded step against the unsharded one): the loss within rtol 1e-5, the
parameters after one SGD step and the BN statistics within L1-rel 2e-5.
Dropout is off (``model.ocr.dropout: 0``): the port seeds its masks per dp
group and tpuseg draws them from one key, so no mask can match.
"""
import math
import os
import pickle
import re
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import load_into, random_variables, set_threads
from tpuseg.config import make_config as jax_make_config
from tpuseg.models import get_model as jax_get_model
from tpuseg_torch.cli.main import load_config
from tpuseg_torch.config import infer_mscale, make_config
from tpuseg_torch.losses import get_loss
from tpuseg_torch.models import PORTED, band_geometry, get_model
from tpuseg_torch.train.loop import Trainer, check_spatial
from tpuseg_torch.train.optim import make_optimizer
from tpuseg_torch.train.step import make_train_step

set_threads()

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHILD = os.path.join(HERE, "_torch_spatial_child.py")
JAX_STEP = os.path.join(HERE, "_torch_spatial_jax.py")
RECIPE = os.path.join(REPO, "tpuseg_torch", "cli", "recipes",
                      "train_cityscapes.yaml")
DEEPV3_RECIPE = os.path.join(os.path.dirname(RECIPE),
                             "train_cityscapes_deepv3.yaml")
H, W = 128, 32
BASE = {"model.arch": "ocrnet.HRNet_Mscale_Tiny",
        "model.compute_dtype": "float32", "model.remat": False,
        "model.n_scales": (), "model.ocr.dropout": 0.0,
        "dataset.num_classes": 19, "loss.ocr_alpha": 0.4,
        "loss.supervised_mscale_wt": 0.05, "optim.lr": 5e-4,
        "optim.weight_decay": 1e-3}
STEP_SETS = {"ce": {**BASE, "loss.loss_type": "ce"},
             "rmi": {**BASE, "loss.loss_type": "rmi"}}
TOL = dict(loss=1e-5, params=2e-5, stats=2e-5)
# Trainer.fit over 2 train and 2 val 128x64 scenes: 2 steps an epoch at
# global batch 1, one val image a rank
FIT_SETS = ["model.arch=ocrnet.HRNet_Mscale_Tiny", "model.remat=true",
            "dataset.name=cityscapes", "dataset.crop_size=[128,64]",
            "dataset.class_uniform_pct=0", "train.test_mode=true",
            "train.batch_size=1", "train.val_freq=2", "train.log_every=1",
            "mesh.model_parallelism=2"]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_cityscapes(root) -> None:
    """2 train and 2 val 128x64 scenes of train classes in 16-px squares."""
    from PIL import Image

    rng = np.random.RandomState(1)
    for split, city in [("train", "aachen"), ("val", "lindau")]:
        img_dir = root / "leftImg8bit_trainvaltest/leftImg8bit" / split / city
        msk_dir = root / "gtFine_trainvaltest/gtFine" / split / city
        img_dir.mkdir(parents=True)
        msk_dir.mkdir(parents=True)
        for i in range(2):
            base = f"{city}_{i:06d}_000019"
            Image.fromarray(rng.randint(0, 255, (128, 64, 3),
                                        dtype=np.uint8)).save(
                img_dir / f"{base}_leftImg8bit.png")
            ids = rng.choice([7, 8, 11, 17, 21, 24, 26], (8, 4))
            Image.fromarray(np.repeat(np.repeat(ids, 16, 0), 16, 1).astype(
                np.uint8)).save(msk_dir / f"{base}_gtFine_labelIds.png")


def _batch():
    """Two images whose bands hold different numbers of ignore pixels."""
    rng = np.random.RandomState(7)
    image = rng.randint(0, 256, (2, H, W, 3)).astype(np.uint8)
    label = np.repeat(np.repeat(rng.randint(0, 19, (2, H // 8, W // 8)), 8,
                                1), 8, 2).astype(np.uint8)
    label[0, :10] = 255           # the top band of image 0
    label[1, 90:, :12] = 255      # the bottom band of image 1
    return image, label


def _port_step(sets, state, image, label):
    """The port's step on the whole batch in one process."""
    cfg = make_config(sets)
    model = get_model(cfg)
    model.load_state_dict(state)
    model.train()
    criterion, _ = get_loss(cfg)
    opt, schedule = make_optimizer(cfg, model.parameters(), 1)
    step = make_train_step(criterion, schedule, ocr_alpha=0.4,
                           supervised_mscale_wt=0.05)
    loss = step(model, opt, {"image": torch.from_numpy(image),
                             "label": torch.from_numpy(label)}, 0)["loss"]
    return {"loss": float(loss),
            "state": {k: v.detach().clone()
                      for k, v in model.state_dict().items()}}


def _launch(out, mode, world):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        env.pop("TPUSEG_TERMINATE_FILE", None)
        procs.append(subprocess.Popen(
            [sys.executable, CHILD, mode, str(out)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO))
    return procs


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    out = tmp_path_factory.mktemp("spatial_train")
    jm = jax_get_model(jax_make_config(STEP_SETS["ce"]))
    variables = random_variables(jm, np.random.RandomState(0),
                                 jnp.zeros((1, H, W, 3), jnp.float32))
    state = load_into(get_model(make_config(STEP_SETS["ce"])),
                      variables).state_dict()
    image, label = _batch()
    _write_cityscapes(out / "cityscapes")
    with open(out / "jax_inputs.pkl", "wb") as f:
        pickle.dump({"variables": variables, "image": image, "label": label,
                     "step_sets": STEP_SETS}, f)
    torch.save({"state": state, "image": image, "label": label,
                "step_sets": STEP_SETS, "recipe": RECIPE,
                "fit_sets": FIT_SETS + [
                    f"dataset.cityscapes_dir={out / 'cityscapes'}"]},
               out / "inputs.pt")
    procs = [subprocess.Popen(
        [sys.executable, JAX_STEP, str(out), name], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=REPO)
        for name in STEP_SETS]
    procs += _launch(out, "train", 2) + _launch(out, "grid", 4)
    try:
        want = {name: _port_step(sets, state, image, label)
                for name, sets in STEP_SETS.items()}
        texts = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, texts):
        assert p.returncode == 0, text[-4000:]
    load = lambda name: torch.load(out / name, weights_only=False)  # noqa
    return {"train": [load(f"train_rank{r}.pt") for r in range(2)],
            "grid": [load(f"grid_rank{r}.pt") for r in range(4)],
            "jax": {name: load(f"jax_{name}.pt") for name in STEP_SETS},
            "one": want, "out": out}


def _tree_l1(got: dict, want: dict, keys) -> float:
    num = sum(float((got[k].double() - want[k].double()).abs().sum())
              for k in keys)
    return num / sum(float(want[k].double().abs().sum()) for k in keys)


def _assert_step(ranks, want):
    """The ranks' mean loss, and every rank's parameters and BN statistics
    after the step, against ``want``'s at ``TOL``."""
    loss = float(sum(r["loss"] for r in ranks)) / len(ranks)
    assert abs(loss - want["loss"]) <= TOL["loss"] * abs(want["loss"]), (
        loss, want["loss"])
    ref = want["state"]
    params = [k for k in ref if k.endswith(("weight", "bias"))]
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    for r in ranks:
        assert r["no_grad"] == []
        assert _tree_l1(r["state"], ref, params) < TOL["params"]
        assert _tree_l1(r["state"], ref, stats) < TOL["stats"]
    # DDP kept the ranks' weights identical
    assert all(torch.equal(ranks[0]["state"][k], r["state"][k])
               for r in ranks[1:] for k in params)


@pytest.mark.parametrize("name", list(STEP_SETS))
def test_sp_step_matches_tpuseg_sharded_step(cluster, name):
    """Two ranks of one sp group, each on its 64-row band of both images,
    against tpuseg's step with the images' height sharded over a 2-device
    ``model`` axis: CE, and RMI + aux (RMI's 33 pooled rows split 17 / 16
    over the bands)."""
    ranks = [r["step"][name] for r in cluster["train"]]
    _assert_step(ranks, cluster["jax"][name])


@pytest.mark.parametrize("name", list(STEP_SETS))
def test_sp_step_matches_one_process(cluster, name):
    """The same two ranks against the port's step on the whole batch in
    one process."""
    ranks = [r["step"][name] for r in cluster["train"]]
    _assert_step(ranks, cluster["one"][name])


def test_dp_sp_grid_step_matches_one_process(cluster):
    """Four ranks as dp 2 x sp 2 (ranks 0-1 and 2-3 an sp group, one image
    a dp group) against one process on both images, and against tpuseg's
    sharded step."""
    ranks = [r["step"] for r in cluster["grid"]]
    assert [r["world"] for r in cluster["grid"]] == [4] * 4
    _assert_step(ranks, cluster["one"]["ce"])
    _assert_step(ranks, cluster["jax"]["ce"])


def test_fit_stop_and_resume(cluster):
    """``Trainer.fit`` through the CLI at dp 1 x sp 2: a termination request
    on rank 1 alone stops both ranks after the first epoch with one
    checkpoint; the rerun resumes at epoch 1, validates whole images
    sharded over both ranks (every labelled pixel counted once, the same
    mIoU on both) and writes the second checkpoint."""
    ranks, out = cluster["train"], cluster["out"]
    stops = [r["stop"] for r in ranks]
    assert [s["rc"] for s in stops] == [0, 0]
    assert stops[0]["validations"] == stops[1]["validations"] == []
    assert "termination requested" in stops[0]["text"]
    assert "dp 1 x sp 2" in stops[0]["text"]
    assert re.search(r"sp collectives a step \(steps 2-2\): [\d.]+ halo",
                     stops[0]["text"]), stops[0]["text"][-2000:]
    resumes = [r["resume"] for r in ranks]
    assert [s["rc"] for s in resumes] == [0, 0]
    assert "resumed at epoch 1" in resumes[0]["text"]
    assert resumes[0]["validations"] == resumes[1]["validations"]
    (epoch, miou, pixels), = resumes[0]["validations"]
    assert epoch == 1 and pixels == 2 * 128 * 64
    m = re.search(r"mIoU by rank ([\d.]+) ([\d.]+)", resumes[0]["text"])
    assert m and m.group(1) == m.group(2) == f"{miou:.6f}"
    assert sorted(os.listdir(out / "fit" / "ckpt")) == [
        "ckpt_2.json", "ckpt_2.pt", "ckpt_4.json", "ckpt_4.pt"]


def test_bands_share_the_mask_seed(cluster):
    """The two ranks of one sp group train bands of the same images, so
    the Trainer seeds their default generators alike (per dp group): the
    dropout and drop-path masks of one image are the same on every band
    (tests/test_torch_spatial_zoo.py holds EfficientNet-B4's drop path and
    the OCR and WRN38 dropout of such ranks against one process)."""
    seeds = [r[run]["seed"] for run in ("stop", "resume")
             for r in cluster["train"]]
    assert len(set(seeds)) == 1, seeds


@pytest.mark.parametrize("sets, error, match", [
    ({"dataset.crop_size": (64, 64)}, ValueError,
     r"crop_size \(64, 64\) is too small for mesh.model_parallelism=2: "
     r"ocrnet.HRNet_Mscale_Tiny's 0.5x pass's stride-32 feature maps have "
     r"1 row, fewer than the 2 bands; the crop height must be at least 128"),
    ({"model.arch": "deepv3.DeepV3PlusW38Tiny",
      "dataset.crop_size": (72, 64)}, ValueError,
     r"model_parallelism=2 must divide the number of ranks \(1\)"),
    ({}, ValueError, r"model_parallelism=2 must divide the number of "
                     r"ranks \(1\)"),
], ids=["uneven_crop", "arch", "world"])
def test_trainer_refuses(tmp_path, sets, error, match):
    """``Trainer`` refuses, before any data or model setup, a crop whose
    0.5x pass's deepest maps have fewer rows than the sp group has ranks
    (64 rows give one stride-32 row at 0.5x: tpuseg refuses the same crop
    at sp 2, 64 // 2 // 32 = 1, tests/test_spatial_sharding.py:190-204),
    and ranks that do not form whole sp groups. The ``arch`` case's crop,
    72 rows on DeepV3PlusW38Tiny, splits unevenly (9 stride-8 rows, 5 + 4
    over 2 bands) and is admitted: the one refusal left is the world's."""
    cfg = make_config({"model.arch": "ocrnet.HRNet_Mscale_Tiny",
                       "dataset.name": "synthetic",
                       "dataset.crop_size": (128, 64),
                       "mesh.model_parallelism": 2, **sets})
    with pytest.raises(error, match=match):
        Trainer(cfg, logdir=str(tmp_path), device="cpu")


@pytest.mark.parametrize("arch, crop, sp", [
    ("deepv3.DeepV3PlusW38Tiny", (80, 64), 2),
    ("deepv3.DeepV3PlusW38Tiny", (48, 32), 2),
    ("recipe", None, 2),
    ("recipe", None, 4),
    ("deepv3.DeepV3PlusW38Tiny", (72, 64), 2),
    ("recipe", None, 3),
    ("recipe", None, 8),
    ("w48_recipe", None, 3),
], ids=["w38tiny_80", "w38tiny_48", "deepv3_recipe_sp2",
        "deepv3_recipe_sp4", "w38tiny_72", "deepv3_recipe_sp3",
        "deepv3_recipe_sp8", "w48_recipe_sp3"])
def test_check_spatial_admits(arch, crop, sp):
    """Crops the guard of equal bands refused: DeepV3PlusW38Tiny at
    multiples of 16 but not 64, and at 72 rows (9 stride-8 rows: 5 + 4);
    ``train_cityscapes_deepv3.yaml`` as shipped (800x800, stride 8: 100
    rows) at sp 2, 3, 4 and 8; ``train_cityscapes.yaml`` (W48, 1024
    rows: 16 stride-32 rows at the 0.5x pass) at sp 3. tpuseg admits
    each of them too."""
    if arch in ("recipe", "w48_recipe"):
        recipe = DEEPV3_RECIPE if arch == "recipe" else RECIPE
        cfg = load_config(recipe, [f"mesh.model_parallelism={sp}"])
    else:
        cfg = make_config({"model.arch": arch, "dataset.crop_size": crop,
                           "mesh.model_parallelism": sp})
    check_spatial(cfg, sp)


def _rule_rows(sets: dict) -> int:
    """The crop height per band that ``check_spatial``'s rule asks for:
    the arch's deepest stride over its lowest train scale."""
    cfg = make_config(sets)
    stride, scales = band_geometry(cfg)
    lo = min({1.0, *scales}
             | ({cfg.model.mscale_lo_scale} if infer_mscale(cfg) else set()))
    return stride / lo


def _assert_rule(sets: dict) -> None:
    """At sp 2, 3 and 4: the smallest crop whose deepest map at the
    lowest train scale has sp rows is admitted, a row less is refused, and
    the crops past it that split unevenly are admitted."""
    unit = _rule_rows(sets)
    for sp in (2, 3, 4):
        cfg = lambda rows: make_config({  # noqa: E731
            **sets, "dataset.crop_size": (rows, 64),
            "mesh.model_parallelism": sp})
        least = math.ceil(sp * unit)
        for rows in (least, least + 1, least + int(unit) + 3):
            check_spatial(cfg(rows), sp)
        with pytest.raises(ValueError, match="too small"):
            check_spatial(cfg(least - 1), sp)


@pytest.mark.parametrize("arch", sorted(
    f"{m}.{f}" for m, fs in PORTED.items() for f in fs))
def test_check_spatial_every_arch(arch):
    """Every arch of the port runs on bands under one rule,
    ``floor(crop_h * s_min / stride) >= sp``: at sp 2, 3 and 4 the crop
    just under it is refused, and every crop from it on is admitted,
    those whose maps split unevenly too (the guard of equal bands
    refused them, and the plain attention head of attnscale's ASDV3P,
    whose maps are 2 rows taller, at every sp above 2). On HRNet_Mscale
    the rule is tpuseg's guard, ``crop_h // 2 // 32 >= sp``."""
    _assert_rule({"model.arch": arch})
    if arch == "ocrnet.HRNet_Mscale":
        for rows in range(120, 600, 7):
            for sp in (2, 3, 4):
                cfg = make_config({"model.arch": arch,
                                   "dataset.crop_size": (rows, 64),
                                   "mesh.model_parallelism": sp})
                admitted = rows // 2 // 32 >= sp
                if admitted:
                    check_spatial(cfg, sp)
                else:
                    with pytest.raises(ValueError, match="too small"):
                        check_spatial(cfg, sp)


def test_check_spatial_admits_old_arch_two_channel_head():
    """mscale's ``attn_2b`` head in the old arch is a 2x2 conv with no
    padding: its map is a row shorter than its input, which no number of
    equal bands splits, and is padded like any other map now. The rule
    holds for it at sp 2, 3 and 4."""
    _assert_rule({"model.arch": "mscale.DeepV3W38Fuse2",
                  "model.mscale_old_arch": True})


def test_children_import_no_jax(cluster):
    ranks = cluster["train"] + cluster["grid"]
    assert all(r["modules"] == [] for r in ranks)
