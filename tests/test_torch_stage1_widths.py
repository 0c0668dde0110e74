"""``MscaleOCR`` with a stage 1 of another width than W48's, the width the
port's kernel of the other widths takes on CUDA
(``tpuseg_torch/csrc/bottleneck_fused_any.cu``), on the CPU against
``tpuseg``.

- A bf16 eval forward of a tiny ``MscaleOCR`` whose stage 1 has two
  blocks of width 16, so one identity block at (C, M) = (64, 16), with
  ``fused_stage1`` and ``use_pallas`` on in both packages: ``tpuseg`` runs
  its Pallas kernels in interpret mode (the 64x512 image's stage-1 maps,
  16x128 and 32x256, meet its tiling), the port its plain versions. Held
  at the L1-relative bound of the bf16 bottleneck tests (2e-2). tpuseg's
  TPU kernel reads relu(b1) at the 3x3's out-of-image taps (ROADMAP
  Queue 3), so the drawn weights fold to b1 < 0, where relu(b1) is the
  zero padding and the two agree (the border is held against the block's
  math in tests/test_torch_kernels.py).
- The port's model with ``fused_stage1`` on against off.
- The key map carries an ``MscaleOCR`` with ``HRNetSpec(stage1_channels
  =32)`` (W48 in stages 2-4, a stage 1 of width 32: chip_smoke.py's
  ``[s1w32-eval]`` model) from ``tpuseg``'s variables into the port,
  strictly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (
    flax_shapes,
    l1_rel,
    load_into,
    quick_jit,
    random_variables,
    randomize,
    set_threads,
)
import tpuseg.kernels.bottleneck_fused as jax_bk
from tpuseg.models.hrnet import HRNetSpec as JaxSpec
from tpuseg.models.ocrnet import MscaleOCR as JaxMscale
from tpuseg_torch.convert import state_dict_from_flax
from tpuseg_torch.kernels import bottleneck_fused as bk
from tpuseg_torch.models.hrnet import Bottleneck, HRNetSpec
from tpuseg_torch.models.ocrnet import MscaleOCR

set_threads()

SPEC = dict(stage1_blocks=2, stage1_channels=16,
            stage2_modules=1, stage2_channels=(8, 16), stage2_blocks=1,
            stage3_modules=1, stage3_channels=(8, 16, 32), stage3_blocks=1,
            stage4_modules=1, stage4_channels=(8, 16, 32, 64),
            stage4_blocks=1)
MODEL = dict(num_classes=19, mid_channels=32, key_channels=16,
             n_scales=(1.0, 2.0), attn_bot_ch=16, use_pallas=True,
             fused_stage1=True)
HW = (64, 512)
BF16_L1 = 2e-2  # the bf16 bottleneck and eval tests' L1-relative bound


def _b1_negative(variables):
    """Every stage-1 bn1 bias set so that the folded b1 = bias - mean *
    scale / sqrt(var + eps) is below -0.1."""
    params = variables["params"]["backbone"]
    stats = variables["batch_stats"]["backbone"]
    for name in params:
        if not name.startswith("layer1_block"):
            continue
        bn, st = params[name]["bn1"]["bn"], stats[name]["bn1"]["bn"]
        s = bn["scale"] / np.sqrt(st["var"] + 1e-5)
        bn["bias"] = (st["mean"] * s - 0.1 - np.abs(bn["bias"])).astype(
            np.float32)
    return variables


@pytest.fixture(scope="module")
def pair():
    jm = JaxMscale(spec=JaxSpec(**SPEC), dtype=jnp.bfloat16, **MODEL)
    x = np.random.RandomState(1).randn(1, *HW, 3).astype(np.float32)
    v = _b1_negative(random_variables(jm, np.random.RandomState(0),
                                      jnp.asarray(x)))
    traced = []
    orig = jax_bk.fused_bottleneck

    def spy(x, *args, **kw):  # tpuseg imports it at each call: count them
        traced.append(tuple(x.shape))
        return orig(x, *args, **kw)

    jax_bk.fused_bottleneck = spy
    try:
        want = jax.tree.map(np.asarray, quick_jit(
            lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x)))
    finally:
        jax_bk.fused_bottleneck = orig
    port = load_into(MscaleOCR(spec=HRNetSpec(**SPEC), **MODEL), v)
    return port, x, want, traced


def _port_pred(port, x, count: list):
    orig = bk.bottleneck_reference

    def spy(*args):  # the op's plain version, what the CPU runs
        count.append(tuple(args[0].shape))
        return orig(*args)

    bk.bottleneck_reference = spy
    try:
        with torch.inference_mode():
            return port(torch.from_numpy(x))["pred"]
    finally:
        bk.bottleneck_reference = orig


def test_bf16_eval_matches_tpuseg(pair):
    """Both packages fuse the one identity block at both scales: tpuseg
    through its Pallas kernel, the port through its op's plain version."""
    port, x, want, traced = pair
    seen = []
    got = _port_pred(port, x, seen)
    assert sorted(traced) == sorted(seen) == [(1, 16, 128, 64),
                                              (1, 32, 256, 64)]
    assert got.shape == want["pred"].shape
    assert np.std(want["pred"]) > 1e-2
    assert l1_rel(got, want["pred"]) < BF16_L1


def test_fused_stage1_on_vs_off(pair):
    port, x, _, _ = pair
    seen = []
    on = _port_pred(port, x, seen)
    for m in port.modules():
        if isinstance(m, Bottleneck):
            m.fused_kernel = False
    try:
        off = _port_pred(port, x, seen)
    finally:
        for m in port.modules():
            if isinstance(m, Bottleneck):
                m.fused_kernel = True
    assert len(seen) == 2  # the on pass alone went through the op
    assert l1_rel(on, off) < BF16_L1


def test_stage1_width32_weights_carry_across():
    """W48 in stages 2-4 and a 32-wide stage 1: every tpuseg variable has
    its port name and shape (a strict load), and the stage-1 blocks hold
    tpuseg's numbers."""
    spec = dict(stage1_channels=32)
    jm = JaxMscale(19, spec=JaxSpec(**spec))
    v = randomize(flax_shapes(jm, jnp.zeros((1, 64, 64, 3))),
                  np.random.default_rng(0))
    trees = [jax.tree.map(np.asarray, v[c]) for c in ("params",
                                                      "batch_stats")]
    sd = state_dict_from_flax(*trees)
    port = MscaleOCR(19, spec=HRNetSpec(**spec))
    port.load_state_dict(sd, strict=True)
    blk = v["params"]["backbone"]["layer1_block1"]
    assert tuple(port.backbone.layer1[1].conv1.weight.shape) == (
        32, 128, 1, 1)
    np.testing.assert_array_equal(
        port.backbone.layer1[1].conv2.weight.detach().permute(2, 3, 1, 0),
        blk["conv2"]["kernel"])
    np.testing.assert_array_equal(
        port.backbone.layer1[3].bn3.running_var.numpy(),
        v["batch_stats"]["backbone"]["layer1_block3"]["bn3"]["bn"]["var"])
