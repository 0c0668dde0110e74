"""The CUDA kernels vs their plain PyTorch versions on the card. Every case
is marked ``cuda`` and skips without a GPU. The file imports no JAX, so it
also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q
"""
import pytest
import torch

from tpuseg_torch.kernels import bottleneck_fused as bk
from tpuseg_torch.kernels import ocr_attention as ak


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: launches the CUDA kernel")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().sum() / want.abs().sum())


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d,dtype,tol", [
    (32768, 19, 256, torch.bfloat16, 5e-2),    # the main path's 0.5x shape
    (131072, 19, 256, torch.bfloat16, 5e-2),   # 1.0x
    (524288, 19, 256, torch.bfloat16, 5e-2),   # 2.0x
    (3001, 65, 256, torch.bfloat16, 5e-2),     # Mapillary's K, ragged N
    (70001, 19, 256, torch.bfloat16, 5e-2),    # persistent loop's ragged tail
    (2049, 128, 256, torch.bfloat16, 5e-2),    # the most keys, bf16
    (3001, 65, 128, torch.float32, 1e-4),      # ragged last row tile
    (5001, 128, 128, torch.float32, 1e-4),     # the most keys taken
    (257, 19, 16, torch.float32, 1e-4)])       # the tiny model's width
def test_attention_kernel(cuda, n, k, d, dtype, tol):
    g = torch.Generator().manual_seed(0)
    q, key, val = (torch.randn(2, m, d, generator=g).to(cuda, dtype)
                   for m in (n, k, k))
    before = ak.LAUNCHES
    got = ak.fused_object_attention(q, key, val)
    torch.cuda.synchronize()
    assert ak.LAUNCHES == before + 1
    want = ak.object_attention_reference(q, key, val)
    assert float((got.float() - want.float()).abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 128, 256), (1, 256, 512),
                                   (1, 512, 1024), (2, 37, 75), (3, 9, 13)])
def test_bottleneck_kernel(cuda, shape):
    """Positive b1 (the border case), the main path's shapes at the three
    scales and ragged batches. The max |d| bound is a few bf16 ulps of the
    output (|out| < 32): one wrong 8x8 tile exceeds it, where it would move
    the whole image's L1 by far less than 2e-2."""
    g = torch.Generator().manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    c, m = 256, 64
    x = r(*shape, c).to(cuda, torch.bfloat16)
    w1, w2, w3 = ((r(*s) * 0.1).to(cuda, torch.bfloat16)
                  for s in ((c, m), (9, m, m), (m, c)))
    b1 = (r(m).abs() + 0.5).to(cuda)
    b2, b3 = (r(m) * 0.1).to(cuda), (r(c) * 0.1).to(cuda)
    before = bk.LAUNCHES
    got = bk.fused_bottleneck(x, w1, b1, w2, b2, w3, b3)
    torch.cuda.synchronize()
    assert bk.LAUNCHES == before + 1
    want = bk.bottleneck_reference(x, w1, b1, w2, b2, w3, b3)
    border = torch.ones(shape[1:], dtype=torch.bool, device=cuda)
    border[1:-1, 1:-1] = False
    assert _rel(got, want) < 2e-2
    assert _rel(got[:, border], want[:, border]) < 2e-2
    assert float((got.float() - want.float()).abs().max()) < 0.25


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 8, 16, device=cuda)
    with pytest.raises(ValueError):
        ak.fused_object_attention(q[:, ::2], q[:, :4], q[:, :4])
    qb = torch.zeros(1, 8, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # bf16 width not a multiple of 64
        ak.fused_object_attention(qb, qb[:, :4], qb[:, :4])
    xb = torch.zeros(1, 8, 16, 64, device=cuda, dtype=torch.bfloat16)
    wb = [torch.zeros(*s, device=cuda, dtype=dt) for s, dt in (
        ((64, 16), torch.bfloat16), ((16,), torch.float32),
        ((9, 16, 16), torch.bfloat16), ((16,), torch.float32),
        ((16, 64), torch.bfloat16), ((64,), torch.float32))]
    with pytest.raises(ValueError):  # not the (256, 64) stage-1 width
        bk.fused_bottleneck(xb, *wb)
    x = torch.zeros(1, 8, 16, 64, device=cuda)  # f32, not bf16
    w = [torch.zeros(*s, device=cuda) for s in ((64, 16), (16,), (9, 16, 16),
                                                 (16,), (16, 64), (64,))]
    with pytest.raises(TypeError):
        bk.fused_bottleneck(x, *w)
