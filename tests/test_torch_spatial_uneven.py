"""dp x sp training of the port on uneven bands: crops whose feature maps do
not split evenly over the sp group, each band padded to ``ceil(H / sp)``
rows (``tpuseg_torch/parallel/spatial.py``), on gloo clusters on the CPU,
against tpuseg's sharded step and against one process of the port.

One module-scoped fixture draws seeded tpuseg variables of
``ocrnet.HRNet_Mscale_Tiny`` and a batch a case, and starts at once:
tpuseg's step at 160x32 under ``make_mesh(devices[:2],
model_parallelism=2)`` + ``shard_batch_spatial`` for CE and for RMI + aux
(tests/_torch_spatial_jax.py, a process each: tracing and compiling them
is the file's floor), two ranks of one sp group and three ranks of
another (tests/_torch_spatial_child.py ``zoo``). The ranks take one step
of each case of their group on their bands under DDP; then they leave
the group and take, in one process, the same step on the whole batch and
the f32 floor (every weight moved by one f32 rounding).

The cases, every one admitted by ``check_spatial``:

- sp 2: ``HRNet_Mscale_Tiny`` at 160x32, CE and RMI + aux, from tpuseg's
  variables, against tpuseg's sharded step and one process. 160 rows
  split evenly, but the maps do not: 5 stride-32 rows at 1.0x (3 + 2),
  and 3 at the 0.5x pass (2 + 1): every band of every map keeps a true
  row, where tpuseg's GSPMD step is exact (its degenerate-shard
  gradient bug, ``tpuseg/parallel/mesh.py:57-66``, needs a band of
  padding only). ``DeepV3PlusW38Tiny`` at 72x32 (9 stride-8 rows: 5 + 4),
  and mscale's old-arch ``attn_2b`` head (a 2x2 conv, maps a row shorter)
  on ``wrn38_tiny`` at 64x32, against one process.
- sp 3: ``HRNet_Mscale_Tiny``, CE and RMI + aux, at 320x32 (10 stride-32
  rows at 1.0x, 4 + 4 + 2, and 5 at 0.5x, 2 + 2 + 1) and at 224x32 (the
  0.5x pass's 4 stride-32 rows are held as 2 + 2 + 0, so one
  band holds no true row of that map; tpuseg's step is unreliable there,
  so the port's own unsharded step is the reference), and
  ``attnscale.DeepV3R50``'s plain head at 80x32 (three scales; its 12-row
  attention map and the 10-row stride-8 map would share 4-row bands, so
  the attention map takes 5-row bands), against one process.

The HRNet cases train on two images, the others on one: ASPP's image
pooling normalises two values a channel at batch 2, and that batch norm
amplifies the f32 rounding of the pooled sums, on even bands as on
uneven ones (DeepV3PlusW38Tiny at 64x32 over 2 even bands: 1.3e-3 L1-rel
between the bands' and one process's activation gradients at the ASPP
output), so far that a ReLU's mask flips; at batch 1 it is
``BatchNorm2d``'s one value a channel, whose output is its bias.

Bounds (tests/test_torch_spatial_train.py's ``TOL``, tpuseg's own for its
sharded step): the ranks' mean loss within rtol 1e-5, the parameters after
one SGD step and the BN statistics within L1-rel 2e-5; the gradients
(L1-rel over every parameter) within twice the f32 floor or 1e-4,
whichever is larger (tests/test_torch_spatial_zoo.py's). The RMI steps'
gradients are not held to that floor: the 9x9 solves amplify the f32
rounding of the forward, which grows through the tiny net's small batch
norms to ~1e-5, more than one rounding of the weights moves it, and they
miss it on even bands too (192x32 over 3 even bands: 5.5e-4 against a
floor of 2.0e-4). The RMI loss's own gradient on uneven bands is held in
tests/test_torch_spatial_ops.py (the ``rmi`` loss at 37 rows over 2 and
3 bands), and each RMI step here at the loss, parameters and statistics.

In f64 the bands are exact. The sp 3 group also takes the HRNet cases
(CE and RMI + aux, 320x32 and 224x32), ``DeepV3PlusW38Tiny`` at 72x32
and ``attnscale.DeepV3R50`` at 80x32 in f64: parameters, buffers and
compute dtype f64, the image normalised in f64 on the host (the uint8
wire normalises to f32). Every upcast of the port promotes (f64 stays
f64, ``tpuseg_torch/ops/precision.py``), so nothing rounds to f32 and
the loss, the gradients (RMI's too), the parameters and the BN
statistics are held at 1e-10 against one process.
"""
import os
import pickle
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
from tpuseg_torch.config import make_config
from tpuseg_torch.models import get_model
from tpuseg_torch.ops.normalize import IMAGENET_MEAN, IMAGENET_STD
from tpuseg_torch.train.loop import check_spatial

set_threads()

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHILD = os.path.join(HERE, "_torch_spatial_child.py")
JAX_STEP = os.path.join(HERE, "_torch_spatial_jax.py")
TOL = dict(loss=1e-5, params=2e-5, stats=2e-5)
GRAD_L1, GRAD_FLOORS = 1e-4, 2.0
BASE = {"model.compute_dtype": "float32", "model.remat": False,
        "model.n_scales": (), "model.ocr.dropout": 0.0,
        "dataset.num_classes": 19, "loss.ocr_alpha": 0.4,
        "loss.supervised_mscale_wt": 0.05, "optim.lr": 5e-4,
        "optim.weight_decay": 1e-3}
HR = {**BASE, "model.arch": "ocrnet.HRNet_Mscale_Tiny"}
# sp -> case -> (config overrides, (H, W), tiny class: (module, class,
# trunk, keywords) or None)
CASES = {
    2: {"hrnet160_ce": ({**HR, "loss.loss_type": "ce"}, (160, 32), None),
        "hrnet160_rmi": ({**HR, "loss.loss_type": "rmi"}, (160, 32), None),
        "w38tiny72": ({**BASE, "model.arch": "deepv3.DeepV3PlusW38Tiny",
                       "loss.loss_type": "ce"}, (72, 32), None),
        "attn2b_old": ({**BASE, "model.arch": "mscale.DeepV3W38Fuse2",
                        "model.mscale_old_arch": True,
                        "loss.loss_type": "ce"}, (64, 32),
                       ("mscale", "MscaleV3Plus", "wrn38_tiny",
                        {"fuse_aspp": True, "attn_2b": True,
                         "attn_old_arch": True, "bot_ch": 16}))},
    3: {"hrnet320_ce": ({**HR, "loss.loss_type": "ce"}, (320, 32), None),
        "hrnet320_rmi": ({**HR, "loss.loss_type": "rmi"}, (320, 32), None),
        "hrnet224_ce": ({**HR, "loss.loss_type": "ce"}, (224, 32), None),
        "hrnet224_rmi": ({**HR, "loss.loss_type": "rmi"}, (224, 32), None),
        "attnscale_r50": ({**BASE, "model.arch": "attnscale.DeepV3R50",
                           "model.n_scales": (0.5, 1.0, 2.0),
                           "loss.loss_type": "ce"}, (80, 32), None)},
}
# the f64 cases, exact up to f64 rounding (module docstring)
F64 = {"hrnet320_ce": "hrnet320_ce_f64", "hrnet320_rmi": "hrnet320_rmi_f64",
       "hrnet224_ce": "hrnet224_ce_f64", "hrnet224_rmi": "hrnet224_rmi_f64",
       "w38tiny72": "w38tiny72_f64", "attnscale_r50": "attnscale_r50_f64"}
F64_TOL = 1e-10
CASES[3].update(
    {f64: ({**sets, "model.compute_dtype": "float64"}, hw, tiny)
     for name, f64 in F64.items()
     for sets, hw, tiny in [CASES[2 if name == "w38tiny72" else 3][name]]})
# held against tpuseg's sharded step too: case -> its loss
JAX_CASES = {"hrnet160_ce": "ce", "hrnet160_rmi": "rmi"}
ALL = {name: (sp, case) for sp, cases in CASES.items()
       for name, case in cases.items()}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _batch(rng, hw, n: int):
    """``n`` images, their labels in 8-px squares, ignore pixels in the top
    band of image 0 and the bottom band of the last image."""
    h, w = hw
    image = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    label = np.repeat(np.repeat(rng.randint(0, 19, (n, h // 8, w // 8)), 8,
                                1), 8, 2).astype(np.uint8)
    label[0, :5, :w // 2] = 255
    label[-1, h - 6:, w // 4:] = 255
    return image, label


def _launch(out, world: int) -> list:
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, CHILD, "zoo", str(out)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO))
    return procs


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    rng = np.random.RandomState(5)
    jax_sets = CASES[2]["hrnet160_ce"][0]
    hw = CASES[2]["hrnet160_ce"][1]
    variables = random_variables(
        jax_get_model(jax_make_config(jax_sets)), np.random.RandomState(0),
        jnp.zeros((1, *hw, 3), jnp.float32))
    state = load_into(get_model(make_config(jax_sets)),
                      variables).state_dict()
    image160, label160 = _batch(rng, hw, 2)
    jax_dir = tmp_path_factory.mktemp("uneven_jax")
    with open(jax_dir / "jax_inputs.pkl", "wb") as f:
        pickle.dump({"variables": variables, "image": image160,
                     "label": label160,
                     "step_sets": {loss: CASES[2][name][0]
                                   for name, loss in JAX_CASES.items()}}, f)
    procs = [subprocess.Popen(
        [sys.executable, JAX_STEP, str(jax_dir), loss],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO) for loss in JAX_CASES.values()]
    dirs = {}
    try:
        for sp, cases in CASES.items():
            zoo = {}
            for name, (sets, hw, tiny) in cases.items():
                if name in JAX_CASES:
                    image, label = image160, label160
                else:
                    # one image where ASPP pools (module docstring)
                    image, label = _batch(rng, hw,
                                          2 if "hrnet" in name else 1)
                zoo[name] = {"sets": sets, "image": image, "label": label}
                if name in F64.values():
                    zoo[name].update(f64=True, image=(
                        image / 255.0 - np.asarray(IMAGENET_MEAN))
                        / np.asarray(IMAGENET_STD))
                if name in JAX_CASES:
                    zoo[name]["state"] = state
                if tiny:
                    zoo[name]["tiny"] = tiny[:3]
                    zoo[name]["kw"] = tiny[3]
            dirs[sp] = tmp_path_factory.mktemp(f"uneven_sp{sp}")
            torch.save({"zoo": zoo, "jax_cases": list(JAX_CASES)},
                       dirs[sp] / "zoo_inputs.pt")
            procs += _launch(dirs[sp], sp)
        texts = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, texts):
        assert p.returncode == 0, text[-4000:]
    load = lambda path: torch.load(path, weights_only=False)  # noqa: E731
    return {"ranks": {sp: [load(dirs[sp] / f"zoo_rank{r}.pt")
                           for r in range(sp)] for sp in CASES},
            "jax": {loss: load(jax_dir / f"jax_{loss}.pt")
                    for loss in JAX_CASES.values()}}


def _tree_l1(got: dict, want: dict, keys) -> float:
    num = sum(float((got[k].double() - want[k].double()).abs().sum())
              for k in keys)
    return num / sum(float(want[k].double().abs().sum()) for k in keys)


@pytest.mark.parametrize("name", list(ALL))
def test_case_is_admitted(name):
    """``check_spatial`` admits every case at its sp: the guard of equal
    bands refused each of them."""
    sp, (sets, hw, _) = ALL[name]
    check_spatial(make_config({**sets, "dataset.crop_size": hw,
                               "mesh.model_parallelism": sp}), sp)


@pytest.mark.parametrize("name", [n for n in ALL if n not in F64.values()])
def test_uneven_step_matches_one_process(cluster, name):
    """The ranks of one sp group, each on its padded band of the images,
    against the port's step on the whole batch in one process: the ranks'
    mean loss, the gradients DDP averaged (within twice the f32 floor, but
    for RMI: module docstring), the parameters after SGD and the BN
    statistics; every rank's gradients, parameters and statistics equal
    (checksums). Halo exchanges and sp sums were issued."""
    sp = ALL[name][0]
    ranks = cluster["ranks"][sp]
    assert [r["world"] for r in ranks] == [sp] * sp
    gaps, = [r["gaps"][name] for r in ranks if name in r["gaps"]]
    loss = sum(r["loss"][name] for r in ranks) / sp
    assert abs(loss - gaps["loss"]) <= TOL["loss"] * abs(gaps["loss"]), (
        loss, gaps["loss"])
    assert gaps["params_l1"] < TOL["params"], gaps
    assert gaps["stats_l1"] < TOL["stats"], gaps
    if ALL[name][1][0]["loss.loss_type"] != "rmi":
        bound = max(GRAD_L1, GRAD_FLOORS * gaps["floor_grad_l1"])
        assert gaps["grad_l1"] <= bound, gaps
    assert all(r["sums"][name] == ranks[0]["sums"][name] for r in ranks)
    counts = ranks[0]["counts"][name]
    assert counts["halo"] > 0 and counts["sum"] > 0, counts


@pytest.mark.parametrize("name", list(F64.values()))
def test_uneven_f64_step_is_exact(cluster, name):
    """In f64 the three ranks' step on uneven bands (224x32 holds a band of
    padding only at 0.5x) equals one process's up to f64 rounding: the
    loss, the gradients (RMI's included), the parameters after SGD and the
    BN statistics within 1e-10 L1-relative; every rank alike."""
    ranks = cluster["ranks"][3]
    gaps, = [r["gaps"][name] for r in ranks if name in r["gaps"]]
    loss = sum(r["loss"][name] for r in ranks) / 3
    assert abs(loss - gaps["loss"]) <= F64_TOL * abs(gaps["loss"]), (
        loss, gaps["loss"])
    for key in ("grad_l1", "params_l1", "stats_l1"):
        assert gaps[key] < F64_TOL, gaps
    assert all(r["sums"][name] == ranks[0]["sums"][name] for r in ranks)
    counts = ranks[0]["counts"][name]
    assert counts["halo"] > 0 and counts["sum"] > 0, counts


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_uneven_step_matches_tpuseg_sharded_step(cluster, name):
    """The two ranks' step of HRNet_Mscale_Tiny at 160x32 from tpuseg's
    variables against tpuseg's step with the images' height sharded over
    a 2-device ``model`` axis (GSPMD pads the uneven maps): the loss, and
    each rank's parameters and BN statistics after the step."""
    want = cluster["jax"][JAX_CASES[name]]
    ranks = [r["jax"][name] for r in cluster["ranks"][2]]
    loss = sum(r["loss"] for r in ranks) / 2
    assert abs(loss - want["loss"]) <= TOL["loss"] * abs(want["loss"]), (
        loss, want["loss"])
    ref = want["state"]
    params = [k for k in ref if k.endswith(("weight", "bias"))]
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    for r in ranks:
        assert _tree_l1(r["state"], ref, params) < TOL["params"]
        assert _tree_l1(r["state"], ref, stats) < TOL["stats"]


def test_children_import_no_jax(cluster):
    assert all(r["modules"] == [] for ranks in cluster["ranks"].values()
               for r in ranks)
