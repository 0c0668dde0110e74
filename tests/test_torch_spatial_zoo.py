"""dp x sp training of every trunk and head family of the port
(``mesh.model_parallelism = 2``) on a two-rank gloo cluster on the CPU,
against one process of the port and against tpuseg's sharded step.

One module-scoped fixture draws a seeded image and label a case, seeded
tpuseg variables of ``mscale.DeepV3W38Tiny``, and starts at once: tpuseg's
CE step of that model under ``make_mesh(devices[:2],
model_parallelism=2)`` + ``shard_batch_spatial``
(tests/_torch_spatial_jax.py, in a process of its own: tracing and
compiling it is the file's floor) and the port's two ranks of one sp
group (tests/_torch_spatial_child.py ``zoo``). The ranks take one CE step
of each factory below at full width from seeded conditioned weights
(convs at 1/sqrt(fan_in)), each on its band of rows under DDP, with
dropout and EfficientNet's drop path on and the default generator seeded
alike on both ranks (the ``Trainer`` seeds it per dp group); then both
leave the group and each runs, for every other factory, the same step on
the whole image in one process and the f32 floor: that step with every
weight moved by one f32 rounding. (The image twice in a batch against
once, the floor ``chip_smoke.py`` also takes on the card, is no floor on
the CPU: its kernels treat both copies alike, and for SE-ResNeXt-50 it
read 3.6e-5 where one rounding of the weights moves the gradient by
9.5e-3.)

One factory a family: ResNet-50 (the stem's max pool), SE-ResNeXt-50 (the
Caffe-style ceil-mode pool and squeeze-excite), Xception-71,
EfficientNet-B4 (squeeze-excite in f32 and drop path), HRNet-ASPP-OCR
(the HRNetV2 trunk, ASPP and the OCR block) and attnscale's DeepV3R50
(three scales and the plain attention head, whose maps are 2 rows
taller); and the classes of the other families on tiny trunks:
mscale2's MscaleV3Plus2, basic's Basic and deeper's DeeperS8. All but
Basic have ASPP's image pooling, whose rate-12 to 36 convs read halos
far wider than a 2- to 4-row band.

Crops are the smallest whose maps split into two bands, grown where the
random net was chaotic in f32: 32x32 at stride 8; 64x32 for Xception-71
(at 32x32 its two bands sat 1.1e-5 from one process in the loss); 64x64
for attnscale and 128x64 on HRNetV2 (at 32x32 and 64x32 their 0.5x pass
and stride-32 branch keep 2x2 and 2x1 maps, and one process's loss moved
by 8.3e-3 and 2.1e-3 between one image and two copies of it).

Bounds (tests/test_torch_spatial_train.py's ``TOL``, tpuseg's own for
its sharded step): the ranks' mean loss within rtol 1e-5, the parameters
after one SGD step and the BN statistics within L1-rel 2e-5; the
gradients (L1-rel over every parameter) within twice the f32 floor or
1e-4, whichever is larger. ~45 s alone.
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
from tpuseg_torch.convert import arch_key_fn
from tpuseg_torch.models import get_model

set_threads()

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHILD = os.path.join(HERE, "_torch_spatial_child.py")
JAX_STEP = os.path.join(HERE, "_torch_spatial_jax.py")
TOL = dict(loss=1e-5, params=2e-5, stats=2e-5)
GRAD_L1, GRAD_FLOORS = 1e-4, 2.0
BASE = {"model.compute_dtype": "float32", "model.remat": False,
        "model.n_scales": (), "dataset.num_classes": 19,
        "loss.loss_type": "ce", "loss.ocr_alpha": 0.4,
        "optim.lr": 5e-4, "optim.weight_decay": 1e-3}
# factory -> (H, W) of its crop; in one process, rank 0 takes the 1st,
# 3rd, ... of ZOO and TINY, rank 1 the others
ZOO = {"ocrnet.HRNet_ASPP_OCR": (128, 64),
       "deepv3.DeepV3PlusX71": (64, 32),
       "deepv3.DeepV3PlusR50": (32, 32),
       "attnscale.DeepV3R50": (64, 64),
       "deepv3.DeepV3PlusEffB4": (32, 32),
       "deepv3.DeepV3PlusSRNX50": (32, 32)}
# the families left, each a factory's class on a tiny trunk (the same code
# as at full width, at a CPU's cost): factory -> (class, trunk, (H, W))
TINY = {"mscale2.DeepV3W38": ("MscaleV3Plus2", "wrn38_tiny", (64, 32)),
        "basic.HRNet": ("Basic", "hrnetv2_tiny", (128, 64)),
        "deeper.DeeperW38": ("DeeperS8", "wrn38_tiny", (32, 32))}
# held against tpuseg: its 0.5x pass's stride-8 maps keep 2 rows a device
JAX_ARCH, JAX_HW = "mscale.DeepV3W38Tiny", (64, 32)
JAX_SETS = {**BASE, "model.arch": JAX_ARCH,
            "loss.supervised_mscale_wt": 0.05}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _batch(rng, hw):
    """One image, its label in 8-px squares, ignore pixels in the top
    band only."""
    h, w = hw
    image = rng.randint(0, 256, (1, h, w, 3)).astype(np.uint8)
    label = np.repeat(np.repeat(rng.randint(0, 19, (1, h // 8, w // 8)), 8,
                                1), 8, 2).astype(np.uint8)
    label[0, :5, :w // 2] = 255
    return image, label


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    out = tmp_path_factory.mktemp("spatial_zoo")
    rng = np.random.RandomState(3)
    zoo = {}
    for arch, hw in ZOO.items():
        image, label = _batch(rng, hw)
        zoo[arch] = {"sets": {**BASE, "model.arch": arch}, "image": image,
                     "label": label}
    for arch, (cls, trunk, hw) in TINY.items():
        image, label = _batch(rng, hw)
        zoo[arch] = {"sets": {**BASE, "model.arch": arch}, "image": image,
                     "label": label,
                     "tiny": (arch.split(".")[0], cls, trunk)}
    image, label = _batch(rng, JAX_HW)
    variables = random_variables(
        jax_get_model(jax_make_config(JAX_SETS)), np.random.RandomState(0),
        jnp.zeros((1, *JAX_HW, 3), jnp.float32))
    state = load_into(get_model(make_config(JAX_SETS)), variables,
                      key_fn=arch_key_fn(JAX_ARCH)).state_dict()
    zoo[JAX_ARCH] = {"sets": JAX_SETS, "image": image, "label": label,
                     "state": state}
    with open(out / "jax_inputs.pkl", "wb") as f:
        pickle.dump({"variables": variables, "image": image, "label": label,
                     "step_sets": {"ce": JAX_SETS}}, f)
    torch.save({"zoo": zoo, "jax_cases": [JAX_ARCH],
                "one_cases": list(ZOO) + list(TINY)}, out / "zoo_inputs.pt")
    procs = [subprocess.Popen(
        [sys.executable, JAX_STEP, str(out), "ce"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=REPO)]
    port = _free_port()
    for rank in (0, 1):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, CHILD, "zoo", str(out)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO))
    try:
        texts = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, texts):
        assert p.returncode == 0, text[-4000:]
    return {"ranks": [torch.load(out / f"zoo_rank{r}.pt", weights_only=False)
                      for r in (0, 1)],
            "jax": torch.load(out / "jax_ce.pt", weights_only=False)}


def _tree_l1(got: dict, want: dict, keys) -> float:
    num = sum(float((got[k].double() - want[k].double()).abs().sum())
              for k in keys)
    return num / sum(float(want[k].double().abs().sum()) for k in keys)


@pytest.mark.parametrize("arch", list(ZOO) + list(TINY))
def test_sp_step_matches_one_process(cluster, arch):
    """Two ranks of one sp group, each on its band of the image, against
    the port's step on the whole image in one process: the ranks' mean
    loss, the gradients DDP averaged, the parameters after SGD and the BN
    statistics; both ranks' gradients, parameters and statistics equal
    (checksums). The dropout and drop-path masks match only because both
    bands draw what one process draws. Every factory exchanged halos and
    summed its global pools over the group."""
    ranks = cluster["ranks"]
    gaps, = [r["gaps"][arch] for r in ranks if arch in r["gaps"]]
    loss = sum(r["loss"][arch] for r in ranks) / 2
    assert abs(loss - gaps["loss"]) <= TOL["loss"] * abs(gaps["loss"]), (
        loss, gaps["loss"])
    assert gaps["params_l1"] < TOL["params"], gaps
    assert gaps["stats_l1"] < TOL["stats"], gaps
    bound = max(GRAD_L1, GRAD_FLOORS * gaps["floor_grad_l1"])
    assert gaps["grad_l1"] <= bound, gaps
    assert ranks[0]["sums"][arch] == ranks[1]["sums"][arch]
    counts = ranks[0]["counts"][arch]
    # Basic has no global pool to sum over the group
    assert counts["halo"] > 0, counts
    assert counts["sum"] > 0 or arch == "basic.HRNet", counts


def test_sp_step_matches_tpuseg_sharded_step(cluster):
    """The two ranks' CE step of mscale.DeepV3W38Tiny (two-scale, dropout
    off) from tpuseg's variables against tpuseg's step with the image's
    height sharded over a 2-device ``model`` axis: loss, and each rank's
    parameters and BN statistics after the step."""
    want = cluster["jax"]
    ranks = [r["jax"][JAX_ARCH] for r in cluster["ranks"]]
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
    assert [r["modules"] for r in cluster["ranks"]] == [[], []]
