"""The CUDA kernels vs their plain PyTorch versions on the card. Every case
is marked ``cuda`` and skips without a GPU. The file imports no JAX, so it
also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q
"""
import pytest
import torch

from tpuseg_torch.kernels import bottleneck_fused as bk
from tpuseg_torch.kernels import ocr_attention as ak
from tpuseg_torch.utils.profiling import counters


def _launches(*kernels) -> tuple:
    now = counters()
    return tuple(now.get(f"kernel.{k}.launches", 0) for k in kernels)


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
    before, = _launches("ocr_attention")
    got = ak.fused_object_attention(q, key, val)
    torch.cuda.synchronize()
    assert _launches("ocr_attention") == (before + 1,)
    want = ak.object_attention_reference(q, key, val)
    assert float((got.float() - want.float()).abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["model", "any"])
@pytest.mark.parametrize("c,m", [
    (64, 16), (128, 32), (256, 64), (96, 40), (512, 128),
    (192, 48),   # the widest width along C = 4 M with resident weights
    (224, 56)])  # the narrowest along C = 4 M with streamed weights
@pytest.mark.parametrize("shape", [(1, 128, 256), (1, 256, 512),
                                   (1, 512, 1024), (2, 37, 75), (3, 9, 13),
                                   (1, 255, 509)])  # ragged, 3 consumers
def test_bottleneck_kernel(cuda, shape, c, m, kernel):
    """Positive b1 (the border case), the main path's shapes at the three
    scales and ragged batches, through the kernel the model runs at the
    width (``fused_bottleneck``: the wgmma kernel at (256, 64), the kernel
    of the other widths elsewhere) and through the kernel of the other
    widths (``fused_bottleneck_any``). The max |d| bound is a few bf16
    ulps of the output (|out| < 32): one wrong 8x8 tile exceeds it, where
    it would move the whole image's L1 by far less than 2e-2. The weights'
    scale follows their fan-in from 0.1 at (256, 64), so that every width's
    output keeps that magnitude."""
    g = torch.Generator().manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    x = r(*shape, c).to(cuda, torch.bfloat16)
    s1, s2 = 0.1 * (256 / c) ** 0.5, 0.1 * (64 / m) ** 0.5
    w1, w2, w3 = ((r(*s) * k).to(cuda, torch.bfloat16)
                  for s, k in (((c, m), s1), ((9, m, m), s2), ((m, c), s2)))
    b1 = (r(m).abs() + 0.5).to(cuda)
    b2, b3 = (r(m) * 0.1).to(cuda), (r(c) * 0.1).to(cuda)
    wgmma = kernel == "model" and (c, m) == bk.KERNEL_SHAPE
    before = _launches("bottleneck", "bottleneck_any")
    run = bk.fused_bottleneck if kernel == "model" else \
        bk.fused_bottleneck_any
    got = run(x, w1, b1, w2, b2, w3, b3)
    torch.cuda.synchronize()
    assert _launches("bottleneck", "bottleneck_any") == (
        before[0] + wgmma, before[1] + (not wgmma))
    want = bk.bottleneck_reference(x, w1, b1, w2, b2, w3, b3)
    border = torch.ones(shape[1:], dtype=torch.bool, device=cuda)
    border[1:-1, 1:-1] = False
    assert _rel(got, want) < 2e-2
    assert _rel(got[:, border], want[:, border]) < 2e-2
    assert float((got.float() - want.float()).abs().max()) < 0.25


@pytest.mark.cuda
def test_bottleneck_any_weight_classes(cuda):
    """Where the kernel of the other widths keeps its weights on the 1.0x
    map: resident in shared memory up to (192, 48) along C = 4 M, streamed
    from (224, 56) on; consumer warpgroups with a tile of their own up to
    M = 128 (three at the narrowest resident widths, two where three do
    not fit), two splitting one tile's channels past it; on the 0.5x map
    (512 tiles) two consumers at (128, 32), the rounds of three splitting
    unevenly over the SMs."""
    classes = {cm: bk.any_plan(*cm, (1, 256, 512)) for cm in (
        (64, 16), (128, 32), (96, 40), (192, 48), (224, 56), (256, 64),
        (512, 128), (1024, 160), (1024, 256))}
    assert [cm for cm, p in classes.items() if p["resident"]] == [
        (64, 16), (128, 32), (96, 40), (192, 48)]
    assert [cm for cm, p in classes.items() if p["consumers"] == 3] == [
        (64, 16), (128, 32)]
    assert [cm for cm, p in classes.items() if p["tiles"] == 1] == [
        (1024, 160), (1024, 256)]
    assert all(p["consumers"] >= 2 and p["smem"] <= 232448
               and p["x_stages"] >= 2 and (p["resident"] or p["w_stages"] >= 2)
               for p in classes.values())
    assert bk.any_plan(128, 32, (1, 128, 256))["consumers"] == 2


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
        ((64, 12), torch.bfloat16), ((12,), torch.float32),
        ((9, 12, 12), torch.bfloat16), ((12,), torch.float32),
        ((12, 64), torch.bfloat16), ((64,), torch.float32))]
    with pytest.raises(ValueError):  # M not a multiple of 8: no kernel
        bk.fused_bottleneck(xb, *wb)
    with pytest.raises(ValueError):
        bk.fused_bottleneck_any(xb, *wb)
    xw = torch.zeros(1, 8, 16, 256, device=cuda, dtype=torch.bfloat16)
    ww = [torch.zeros(*s, device=cuda, dtype=dt) for s, dt in (
        ((256, 64), torch.bfloat16), ((64,), torch.float32),
        ((9, 64, 64), torch.bfloat16), ((64,), torch.float32),
        ((64, 256), torch.bfloat16), ((256,), torch.float32))]
    with pytest.raises(ValueError):  # (256, 64) without its packed block
        torch.ops.tpuseg_torch.bottleneck_fused(xw, *ww, None)
    x = torch.zeros(1, 8, 16, 64, device=cuda)  # f32, not bf16
    w = [torch.zeros(*s, device=cuda) for s in ((64, 16), (16,), (9, 16, 16),
                                                 (16,), (16, 64), (64,))]
    with pytest.raises(TypeError):
        bk.fused_bottleneck(x, *w)
