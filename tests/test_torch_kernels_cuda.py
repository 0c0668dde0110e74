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
    (131072, 19, 256, torch.bfloat16, 5e-2),   # the 1.0x main-path shape
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
@pytest.mark.parametrize("shape", [(1, 256, 512), (2, 37, 75)])
def test_bottleneck_kernel(cuda, shape):
    """Positive b1 (the border case), the 1.0x shape and a ragged batch."""
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


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 8, 16, device=cuda)
    with pytest.raises(ValueError):
        ak.fused_object_attention(q[:, ::2], q[:, :4], q[:, :4])
    x = torch.zeros(1, 8, 16, 64, device=cuda)  # f32, not bf16
    w = [torch.zeros(*s, device=cuda) for s in ((64, 16), (16,), (9, 16, 16),
                                                 (16,), (16, 64), (64,))]
    with pytest.raises(TypeError):
        bk.fused_bottleneck(x, *w)
