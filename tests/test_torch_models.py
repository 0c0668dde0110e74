"""The port's model modules vs tpuseg's, from the same converted weights
(random, with random BN statistics so the mapping is load-bearing), on the
same seeded inputs. f32 forwards agree to < 1e-4 max abs (the repo's f32
convention); the bf16 Bottleneck to L1-relative < 2e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuseg_torch.models.hrnet as port_hrnet
import tpuseg_torch.models.ocrnet as port_ocrnet
from _torch_port import (
    l1_rel,
    load_into,
    max_abs,
    nchw,
    nhwc_np,
    random_variables,
    set_threads,
)
from tpuseg.config import make_config
from tpuseg_torch.config import make_config as port_config
from tpuseg.models import get_model as get_flax_model
from tpuseg.models import hrnet as jh
from tpuseg.models import layers as jl
from tpuseg.models import ocr as jo
from tpuseg.models import ocrnet as jocrnet
from tpuseg_torch.models import get_model, layers, ocr
from tpuseg_torch.models.hrnet import HRNetSpec, HRNetV2

set_threads()
F32 = jnp.float32

# TINY_SPEC with two stage-1 blocks: block 1 is an identity Bottleneck, the
# shape the fused kernel takes
SPEC2 = HRNetSpec(stage1_blocks=2, stage1_channels=8,
                  stage2_modules=1, stage2_channels=(8, 16), stage2_blocks=1,
                  stage3_modules=1, stage3_channels=(8, 16, 32),
                  stage3_blocks=1, stage4_modules=1,
                  stage4_channels=(8, 16, 32, 64), stage4_blocks=1)


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _run(jax_module, variables, *args):
    return jax.jit(lambda v, *a: jax_module.apply(v, *a, train=False))(
        variables, *args)


@pytest.mark.parametrize("use_bias", [False, True])
def test_conv_norm_act(use_bias):
    x = _x(0, 2, 8, 12, 16)
    jm = jl.ConvNormAct(24, 3, use_bias=use_bias, dtype=F32)
    v = random_variables(jm, np.random.RandomState(1), jnp.asarray(x))
    want = _run(jm, v, jnp.asarray(x))
    port = load_into(layers.ConvNormAct(16, 24, 3, bias=use_bias), v,
                     "ocr/conv3x3_ocr", "ocr.conv3x3_ocr.")
    with torch.inference_mode():
        got = port(nchw(x))
    assert max_abs(nhwc_np(got), want) < 1e-4


@pytest.mark.parametrize("old_arch", [False, True])
def test_attn_head(old_arch):
    x = _x(2, 2, 8, 12, 16)
    jm = jl.AttnHead(out_ch=1, bot_ch=16, old_arch=old_arch, dtype=F32)
    v = random_variables(jm, np.random.RandomState(3), jnp.asarray(x))
    want = _run(jm, v, jnp.asarray(x))
    port = load_into(layers.AttnHead(16, 1, 16, old_arch=old_arch), v,
                     "scale_attn", "scale_attn.")
    with torch.inference_mode():
        got = port(nchw(x))
    assert got.dtype == torch.float32
    assert max_abs(nhwc_np(got), want) < 1e-4


def test_bottleneck_fused_gate_bf16(monkeypatch):
    """The port's fused stage-1 path (on the CPU: the kernel's plain
    version over BN-folded weights) vs tpuseg's unfused bf16 block. A
    counter proves the fused path ran."""
    calls = []
    real = port_hrnet.fused_bottleneck_packed
    monkeypatch.setattr(port_hrnet, "fused_bottleneck_packed",
                        lambda *a: (calls.append(1), real(*a))[1])
    c, m = 64, 16
    x = jnp.asarray(_x(4, 2, 16, 24, c), jnp.bfloat16)
    jm = jh.Bottleneck(planes=m, dtype=jnp.bfloat16)
    v = random_variables(jm, np.random.RandomState(5), x)
    want = np.asarray(_run(jm, v, x), np.float32)
    port = load_into(port_hrnet.Bottleneck(c, m, fused_kernel=True), v,
                     "backbone/layer1_block1", "backbone.layer1.1.")
    with torch.inference_mode():
        got = port(nchw(np.asarray(x, np.float32)).bfloat16()
                   .contiguous(memory_format=torch.channels_last))
    assert calls and got.dtype == torch.bfloat16
    assert l1_rel(nhwc_np(got), want) < 2e-2


def test_bottleneck_fold_cache_follows_bn():
    """The folded weights are built once per weight state: a second eval
    forward reuses them, and an in-place change of a BN buffer (what a BN
    calibration or ``load_state_dict`` does) rebuilds them, so the fused
    path keeps following the plain block. bf16 to L1-relative < 2e-2."""
    c, m = 64, 16
    gen = torch.Generator().manual_seed(6)
    block = port_hrnet.Bottleneck(c, m, fused_kernel=True).eval()
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
        for bn in (block.bn1, block.bn2, block.bn3):
            bn.running_mean.copy_(torch.randn(bn.running_mean.shape,
                                              generator=gen) * 0.1)
            bn.running_var.copy_(torch.rand(bn.running_var.shape,
                                            generator=gen) + 0.5)
            # no BN shift: the branch then scales with bn1's 1/sqrt(var)
            bn.weight.fill_(1.0)
            bn.bias.zero_()
    x = (torch.randn(1, c, 12, 20, generator=gen).bfloat16()
         .contiguous(memory_format=torch.channels_last))

    def fused_and_plain():
        with torch.inference_mode():
            block.fused_kernel = True
            fused = block(x)
            block.fused_kernel = False
            plain = block(x)
        return fused.float().numpy(), plain.float().numpy()

    first, plain = fused_and_plain()
    assert l1_rel(first, plain) < 2e-2
    weights = block._folded()
    assert block._folded() is weights  # cached: nothing changed
    with torch.no_grad():
        block.bn1.running_var.mul_(9.0)
    assert block._folded() is not weights
    second, plain2 = fused_and_plain()
    assert l1_rel(plain2, plain) > 0.1  # the stale weights would fail
    assert l1_rel(second, plain2) < 2e-2


def test_hrnet_trunk_f32():
    x = _x(6, 1, 64, 128, 3)
    jm = jh.HRNetV2(SPEC2, dtype=F32)
    v = random_variables(jm, np.random.RandomState(7), jnp.asarray(x))
    want = _run(jm, v, jnp.asarray(x))[2]
    port = load_into(HRNetV2(SPEC2, dtype=torch.float32), v, "backbone",
                     "backbone.")
    with torch.inference_mode():
        got = port(nchw(x))[2]
    assert got.shape[1] == SPEC2.high_level_ch
    assert max_abs(nhwc_np(got), want) < 1e-4


def test_object_attention_use_pallas():
    """Both packages on their fused-kernel path (tpuseg: the Pallas kernel,
    interpreted on the CPU; the port: the kernel's plain version)."""
    x, proxy = _x(8, 2, 8, 16, 32), _x(9, 2, 19, 32)
    jm = jo.ObjectAttention(16, 32, use_pallas=True, dtype=F32)
    v = random_variables(jm, np.random.RandomState(10), jnp.asarray(x),
                         jnp.asarray(proxy))
    want = _run(jm, v, jnp.asarray(x), jnp.asarray(proxy))
    port = load_into(ocr.ObjectAttention(32, 16, 32, use_pallas=True), v,
                     "ocr/ocr_distri/object_context",
                     "ocr.ocr_distri_head.object_context_block.")
    with torch.inference_mode():
        got = port(nchw(x), torch.from_numpy(proxy))
    assert max_abs(nhwc_np(got), want) < 1e-4


def test_ocr_block():
    x = _x(11, 2, 8, 16, 40)
    jm = jo.OCRBlock(19, mid_channels=32, key_channels=16, use_pallas=True,
                     dtype=F32)
    v = random_variables(jm, np.random.RandomState(12), jnp.asarray(x))
    want = _run(jm, v, jnp.asarray(x))
    port = load_into(ocr.OCRBlock(40, 19, 32, 16, use_pallas=True), v, "ocr",
                     "ocr.")
    with torch.inference_mode():
        got = port(nchw(x))
    for g, w in zip(got, want):
        assert max_abs(nhwc_np(g), w) < 1e-4


@pytest.fixture(scope="module")
def mscale_pair():
    """tpuseg's and the port's tiny MscaleOCR (f32, both kernels' switches
    on, 3-scale eval) with the same weights; one JAX compile per module."""
    overrides = {"model.arch": "ocrnet.HRNet_Mscale_Tiny",
                 "model.n_scales": (0.5, 1.0, 2.0),
                 "model.compute_dtype": "float32",
                 "model.use_pallas": True,
                 "model.fused_stage1": True}
    cfg = make_config(overrides)
    x = _x(13, 1, 64, 128, 3)
    jm = get_flax_model(cfg)
    v = random_variables(jm, np.random.RandomState(14), jnp.asarray(x))
    want = jax.tree.map(np.asarray, _run(jm, v, jnp.asarray(x)))
    port = load_into(get_model(port_config(overrides)), v)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    return want, got


def test_mscale_nscale_f32(mscale_pair):
    want, got = mscale_pair
    assert set(got) == set(want)
    assert {"pred", "pred_0.5x", "pred_1.0x", "pred_2.0x", "attn_0.5x",
            "attn_1.0x"} == set(got)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert max_abs(got[k], want[k]) < 1e-4, k


def test_mscale_logits_not_degenerate(mscale_pair):
    """The comparison above is not trivial: logits spread and attention
    maps vary across pixels."""
    want, _ = mscale_pair
    assert np.std(want["pred"]) > 1e-2
    assert np.std(want["attn_1.0x"]) > 1e-3


@pytest.mark.parametrize("head", ["two_scale", "ocrnet"])
def test_other_eval_forwards_f32(head):
    """MscaleOCR with empty ``n_scales`` (the eval forward is then
    two_scale_fuse, with the aux chain) and the plain OCRNet (the ``HRNet``
    factory's model), at tiny width."""
    kw = dict(num_classes=19, mid_channels=32, key_channels=16,
              use_pallas=True)
    if head == "two_scale":
        jm = jocrnet.MscaleOCR(spec=SPEC2, n_scales=(), attn_bot_ch=16,
                               dtype=F32, **kw)
        port = port_ocrnet.MscaleOCR(spec=SPEC2, n_scales=(), attn_bot_ch=16,
                                     dtype=torch.float32, **kw)
        keys = {"pred", "aux", "pred_05x", "pred_10x", "attn_05x"}
    else:
        jm = jocrnet.OCRNet(spec=SPEC2, dtype=F32, **kw)
        port = port_ocrnet.OCRNet(spec=SPEC2, dtype=torch.float32, **kw)
        keys = {"pred", "aux"}
    x = _x(15, 1, 64, 128, 3)
    v = random_variables(jm, np.random.RandomState(16), jnp.asarray(x))
    want = jax.tree.map(np.asarray, _run(jm, v, jnp.asarray(x)))
    with torch.inference_mode():
        got = load_into(port, v)(torch.from_numpy(x))
    assert set(got) == set(want) == keys
    for k in keys:
        assert got[k].shape == want[k].shape, k
        assert max_abs(got[k], want[k]) < 1e-4, k
    assert np.std(want["pred"]) > 1e-2
