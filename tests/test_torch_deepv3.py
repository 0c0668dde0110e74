"""Tiny DeepLabV3 and HRNet-ASPP-OCR models of the port vs tpuseg's, f32 on
the CPU, from the same converted weights and seeded inputs: DeepV3 on the
tiny WRN38 and OCRNetASPP on the tiny HRNet spec with both packages on
their fused-attention path (tpuseg: the Pallas kernel, interpreted; the
port: the kernel's plain version), logits < 1e-4; a DeepV3PlusW38Tiny
train step at batch 2 with dropout off (loss, BN running statistics,
gradient tree by L1-relative); and the reference-checkpoint loader on a
DeepLabV3+ state dict with a DataParallel prefix."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuseg.models.wider_resnet as jwrn
from _torch_port import LinenWithoutDropout, load_into, max_abs
from _torch_port import random_variables
from _torch_port import set_threads
from tpuseg.config import make_config as jax_make_config
from tpuseg.losses.factory import get_loss as jax_get_loss
from tpuseg.models import deepv3 as jdeepv3
from tpuseg.models import get_model as jax_get_model
from tpuseg.models import hrnet as jhrnet
from tpuseg.models import ocrnet as jocrnet
from tpuseg.train.step import make_loss_fn as jax_make_loss_fn
from tpuseg_torch.config import make_config
from tpuseg_torch.convert import load_reference_checkpoint
from tpuseg_torch.convert import state_dict_from_flax
from tpuseg_torch.keymap import deepv3_key_fn
from tpuseg_torch.losses import get_loss
from tpuseg_torch.models import deepv3, get_model
from tpuseg_torch.models.hrnet import TINY_SPEC
from tpuseg_torch.models.ocrnet import OCRNetASPP
from tpuseg_torch.train.step import make_loss_fn

set_threads()
F32 = jnp.float32


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _eval(jm, v, x):
    return jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x)


def test_deepv3_tiny_trunk_matches_tpuseg():
    """DeepV3: trunk -> ASPP -> the make_seg_head Sequential."""
    x = _x(0, 1, 64, 64, 3)
    jm = jdeepv3.DeepV3(19, trunk="wrn38_tiny", seg_bot_ch=16, dtype=F32)
    v = random_variables(jm, np.random.RandomState(1), jnp.asarray(x))
    want = np.asarray(_eval(jm, v, x)["pred"])
    port = load_into(deepv3.DeepV3(19, trunk="wrn38_tiny", seg_bot_ch=16,
                                   dtype=torch.float32), v,
                     key_fn=deepv3_key_fn("wrn38_tiny"))
    with torch.inference_mode():
        got = port(torch.from_numpy(x))["pred"]
    assert got.shape == want.shape == (1, 64, 64, 19)
    assert max_abs(got, want) < 1e-4


def test_ocrnet_aspp_tiny_use_pallas_matches_tpuseg():
    """OCRNetASPP: HRNet -> ASPP -> OCR, attention on the fused path."""
    x = _x(2, 1, 64, 64, 3)
    jm = jocrnet.OCRNetASPP(19, spec=jhrnet.TINY_SPEC, mid_channels=32,
                            key_channels=16, use_pallas=True, dtype=F32)
    v = random_variables(jm, np.random.RandomState(3), jnp.asarray(x))
    want = _eval(jm, v, x)
    port = load_into(OCRNetASPP(19, TINY_SPEC, 32, 16, use_pallas=True,
                                dtype=torch.float32), v)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    for k in ("pred", "aux"):
        assert got[k].shape == want[k].shape == (1, 64, 64, 19)
        assert max_abs(got[k], want[k]) < 1e-4, k


# ------------------------------------------------------------ train step

SETS = {"model.arch": "deepv3.DeepV3PlusW38Tiny",
        "model.compute_dtype": "float32", "model.remat": False,
        "loss.loss_type": "ce"}


def _batch():
    """Continuous f32 pixels (the f32 wire). With integer uint8 pixels the
    two f32 backward passes differ by 3.5e-4 - 7.9e-4 in gradient L1 (two
    seeds), as much as the port's own f32 pass differs from its f64 pass
    (5.2e-4); with continuous pixels by 1.4e-5 - 4.2e-5."""
    rng = np.random.RandomState(4)
    image = (128 + 40 * rng.randn(2, 64, 64, 3)).astype(np.float32)
    label = rng.randint(0, 19, (2, 4, 4)).astype(np.uint8).repeat(
        16, 1).repeat(16, 2)
    label[1, :, :12] = 255
    return image, label


@pytest.fixture(scope="module")
def stepped():
    return train_step_pair()


def train_step_pair(port_dtype=torch.float32):
    """One train-mode forward + backward of tpuseg (dropout off) and of the
    port (Dropout2d at p = 0) from the same weights and batch:
    -> ((loss, BN stats, grads) of the port, the same of tpuseg)."""
    image, label = _batch()
    jm = jax_get_model(jax_make_config(SETS))
    v = random_variables(jm, np.random.RandomState(5),
                         jnp.zeros((1, 64, 64, 3), F32))
    criterion, _ = jax_get_loss(jax_make_config(SETS))
    loss_fn = jax_make_loss_fn(jm, criterion)
    batch = {"image": jnp.asarray(image), "label": jnp.asarray(label)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwrn, "nn", LinenWithoutDropout())
        (loss, mutated), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v["params"], v["batch_stats"], batch,
                                    jax.random.PRNGKey(0))
    to_np = lambda t: jax.tree.map(np.asarray, t)
    want = (float(loss),
            state_dict_from_flax({}, to_np(mutated["batch_stats"]),
                                 arch=SETS["model.arch"]),
            state_dict_from_flax(to_np(grads), {}, arch=SETS["model.arch"]))

    model = load_into(get_model(make_config(SETS)), v,
                      key_fn=deepv3_key_fn("wrn38_tiny")).train()
    model.backbone.dtype = port_dtype
    model.to(port_dtype)
    drops = [m for m in model.modules() if isinstance(m, torch.nn.Dropout2d)]
    assert len(drops) == 2  # mod6 and mod7
    for m in drops:
        m.p = 0.0
    loss = make_loss_fn(get_loss(make_config(SETS))[0])(model, {
        "image": torch.from_numpy(image), "label": torch.from_numpy(label)})
    loss.backward()
    got = (float(loss.detach()),
           {k: t.detach() for k, t in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))},
           {n: p.grad for n, p in model.named_parameters()})
    return got, want


def _tree_l1(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    num = sum(float((got[k].double() - want[k].double()).abs().sum())
              for k in want)
    return num / sum(float(want[k].double().abs().sum()) for k in want)


def test_train_loss_matches_tpuseg(stepped):
    (got, _, _), (want, _, _) = stepped
    assert abs(got - want) / abs(want) < 1e-5, (got, want)


def test_train_bn_running_stats_match_tpuseg(stepped):
    (_, got, _), (_, want, _) = stepped
    assert _tree_l1(got, {k: want[k] for k in got}) < 1e-5


def test_train_gradients_match_tpuseg(stepped):
    (_, _, got), (_, _, want) = stepped
    assert _tree_l1(got, want) < 1e-4
    # every parameter gets a gradient: the whole head and trunk train
    assert all(float(g.abs().sum()) > 0 for g in got.values())


# ---------------------------------------------------------------- loader


def test_load_reference_checkpoint_with_module_prefix(tmp_path):
    """A reference-format DeepLabV3+ checkpoint ({'state_dict': ...} with
    DataParallel's 'module.' prefix) loads strictly."""
    cfg = make_config(SETS)
    src = get_model(cfg, seed=1).state_dict()
    path = tmp_path / "deepv3_w38_tiny.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in src.items()},
                "epoch": 3}, path)
    model = get_model(cfg, seed=2)
    assert not torch.equal(model.state_dict()["final.0.weight"],
                           src["final.0.weight"])
    load_reference_checkpoint(model, str(path))
    got = model.state_dict()
    assert set(got) == set(src)
    assert all(torch.equal(got[k], src[k]) for k in src)
