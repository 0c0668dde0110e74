"""The port's kernels vs tpuseg's Pallas kernels (interpret mode) and their
plain JAX references: on the CPU each wrapper runs its plain PyTorch
version. The CUDA kernels themselves are tested on a GPU by
tests/test_torch_kernels_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import l1_rel, max_abs, set_threads
from tpuseg.kernels.bottleneck_fused import fold_bn as jax_fold_bn
from tpuseg.kernels.bottleneck_fused import (
    fused_bottleneck as jax_fused_bottleneck,
    reference_bottleneck,
)
from tpuseg.kernels.ocr_attention import (
    fused_object_attention as jax_fused_attention,
    reference_object_attention,
)
from tpuseg_torch.kernels import bottleneck_fused as bk
from tpuseg_torch.kernels import ocr_attention as ak

set_threads()


def _attn_inputs(rng, b, n, k, d, scale=1.0):
    return [(scale * rng.randn(b, m, d)).astype(np.float32)
            for m in (n, k, k)]


@pytest.mark.parametrize("n,k,d", [(512, 19, 256), (700, 19, 256),
                                   (512, 65, 128), (100, 5, 128)])
def test_attention_f32(n, k, d):
    q, key, val = _attn_inputs(np.random.RandomState(0), 2, n, k, d)
    got = ak.fused_object_attention(*map(torch.from_numpy, (q, key, val)))
    assert got.dtype == torch.float32
    j = [jnp.asarray(a) for a in (q, key, val)]
    for want in (jax_fused_attention(*j, interpret=True),
                 reference_object_attention(*j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_attention_bf16():
    q, key, val = _attn_inputs(np.random.RandomState(1), 1, 512, 19, 256)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, key, val)]
    tb = [torch.from_numpy(np.asarray(a, np.float32)).bfloat16() for a in jb]
    got = ak.fused_object_attention(*tb)
    assert got.dtype == torch.bfloat16
    for want in (jax_fused_attention(*jb, interpret=True),
                 reference_object_attention(*jb)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=5e-2, atol=5e-2)


def test_attention_five_keys_mass():
    """K = 5 with tiny queries (tests/test_pallas_kernels.py:199-216): the
    softmax covers exactly the K real keys, so all-ones values give a
    context of exactly 1."""
    q, key, val = _attn_inputs(np.random.RandomState(2), 1, 512, 5, 256)
    q, key = 0.01 * q, 0.01 * key
    got = ak.fused_object_attention(*map(torch.from_numpy, (q, key, val)))
    want = jax_fused_attention(jnp.asarray(q), jnp.asarray(key),
                               jnp.asarray(val), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    ones = torch.ones(1, 5, 256)
    ctx = ak.fused_object_attention(torch.from_numpy(q),
                                    torch.from_numpy(key), ones)
    np.testing.assert_allclose(ctx.numpy(), 1.0, rtol=1e-5)


def test_attention_rejects_bad_inputs():
    q = torch.zeros(1, 8, 16)
    with pytest.raises(TypeError):
        ak.fused_object_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):
        ak.fused_object_attention(q, torch.zeros(1, 129, 16),
                                  torch.zeros(1, 129, 16))
    with pytest.raises(ValueError):
        ak.fused_object_attention(torch.zeros(1, 8, 12),
                                  torch.zeros(1, 3, 12),
                                  torch.zeros(1, 3, 12))


def _bottleneck_weights(rng, c, m):
    """Folded weights with a POSITIVE b1, as BN folding gives in a trained
    net: the case where tpuseg's TPU kernel reads relu(b1) at the image
    border instead of the 3x3's zero padding."""
    w1 = rng.randn(c, m) * 0.1
    b1 = np.abs(rng.randn(m)) + 0.5
    w2 = rng.randn(9, m, m) * 0.1
    b2 = rng.randn(m) * 0.1
    w3 = rng.randn(m, c) * 0.1
    b3 = rng.randn(c) * 0.1
    return [a.astype(np.float32) for a in (w1, b1, w2, b2, w3, b3)]


def _bottleneck_case(seed, h=16, w=32, c=64, m=16):
    rng = np.random.RandomState(seed)
    x = jnp.asarray(0.5 * rng.randn(1, h, w, c), jnp.bfloat16)
    ws = _bottleneck_weights(rng, c, m)
    xt = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    got = bk.fused_bottleneck(xt, *map(torch.from_numpy, ws))
    assert got.dtype == torch.bfloat16
    return x, ws, got.float().numpy()


def test_bottleneck_matches_reference_at_borders():
    x, ws, got = _bottleneck_case(0)
    want = np.asarray(reference_bottleneck(x, *map(jnp.asarray, ws)),
                      np.float32)
    # bf16 intermediates round at the same points in both; what differs is
    # the f32 sum order of the convs (bf16-noise level, L1-rel ~1e-3)
    assert l1_rel(got, want) < 2e-2
    border = np.ones(got.shape[1:3], bool)
    border[1:-1, 1:-1] = False
    assert max_abs(got[:, border], want[:, border]) < 2e-2


def test_bottleneck_matches_tpu_kernel_interior():
    """vs tpuseg's Pallas kernel (interpret mode) on interior pixels only:
    that kernel reads relu(b1), not zero, at the 3x3's out-of-image taps
    (bottleneck_fused.py:56-79; ROADMAP Queue 3), so its border row and
    column differ from the block's math whenever b1 > 0."""
    x, ws, got = _bottleneck_case(1)
    tpu = np.asarray(jax_fused_bottleneck(x, *map(jnp.asarray, ws), th=8,
                                          tw=16, interpret=True), np.float32)
    assert l1_rel(got[:, 1:-1, 1:-1], tpu[:, 1:-1, 1:-1]) < 2e-2
    # the border differs by far more than bf16 noise: the fault is real
    assert l1_rel(got[:, 0], tpu[:, 0]) > 2e-2


def test_bottleneck_supports_and_cpu_pack():
    """The CUDA kernel takes only the stage-1 width; on the CPU any width
    runs the plain version, and packing CPU weights builds no parameter
    block (that is packed by the CUDA source, for CUDA weights only)."""
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    assert bk.supports(gpu, *bk.KERNEL_SHAPE)
    assert not bk.supports(gpu, 64, 16)
    assert bk.supports(cpu, 64, 16)
    x, ws, _ = _bottleneck_case(2)
    packed = bk.pack_weights(*map(torch.from_numpy, ws))
    assert packed.blob is None
    xt = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    assert torch.equal(bk.fused_bottleneck_packed(xt, packed),
                       bk.bottleneck_reference(xt, *packed.weights))


def test_fold_bn_matches_jax():
    rng = np.random.RandomState(3)
    w = rng.randn(3, 3, 8, 16).astype(np.float32)            # HWIO
    scale, bias, mean = (rng.randn(16).astype(np.float32) for _ in range(3))
    var = (np.abs(rng.randn(16)) + 0.1).astype(np.float32)
    wj, bj = jax_fold_bn(*map(jnp.asarray, (w, scale, bias, mean, var)))
    wt, bt = bk.fold_bn(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                        *map(torch.from_numpy, (scale, bias, mean, var)))
    assert max_abs(wt.permute(2, 3, 1, 0), np.asarray(wj)) < 1e-6
    assert max_abs(bt, np.asarray(bj)) < 1e-6
