"""ASPP's dilated 3x3 convs through ``kernels/dilated_conv.py`` on the CPU:
the ``supports()`` gate and who takes the wrapper, the autograd Function
against ``F.conv2d`` (forward and both gradients, band padding included),
ASPP with the wrapper against ASPP on plain convs, and the registered op's
shape function and flop formula. The kernel itself is held on the card in
``test_torch_kernels_cuda.py``."""
import copy

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from tpuseg_torch.kernels import dilated_conv as dc
from tpuseg_torch.models import heads
from tpuseg_torch.models.layers import Conv2d


def _inputs(b, cin, h, w, cout, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, cin, h, w, generator=g, dtype=dtype)
    wt = torch.randn(cout, cin, 3, 3, generator=g, dtype=dtype) / (
        9 * cin) ** 0.5
    return x, wt


@pytest.mark.parametrize("kernel,stride,dilation,groups,want", [
    (3, 1, (12, 12), 1, True),
    (3, 1, (1, 1), 1, True),
    (3, 2, (12, 12), 1, False),     # stride 2
    (1, 1, (1, 1), 1, False),       # 1x1
    (3, 1, (12, 12), 2, False),     # groups > 1
    (3, 1, (36, 30), 1, False)])    # DPC's unequal rates
def test_supports_gate(kernel, stride, dilation, groups, want):
    x = torch.zeros(1, 16, 8, 8)
    w = torch.zeros(8, 16 // groups, kernel, kernel)
    assert dc.supports(x, w, (stride, stride), dilation, groups) is want


def test_pack_round_trip():
    _, wt = _inputs(1, 16, 4, 4, 8)
    wp = dc.pack_weight(wt)
    assert wp.shape == (9, 8, 16) and wp.is_contiguous()
    assert torch.equal(wp[3 * 2 + 1], wt[:, :, 2, 1])  # tap 3 ky + kx
    assert torch.equal(dc.unpack_weight(wp), wt)


def test_aspp_dispatch(monkeypatch):
    """ASPP's three dilated branches take the wrapper, once each a forward,
    with one shared NCHW copy when a gradient is wanted; its 1x1 branches,
    a grouped conv and every DPC conv stay on ``Conv2d``."""
    calls = []
    real = dc.dilated_conv3x3

    def spy(x, weight, padding, dilation, x_nchw=None):
        calls.append((dilation, padding, x_nchw is not None))
        return real(x, weight, padding, dilation, x_nchw)

    monkeypatch.setattr(dc, "dilated_conv3x3", spy)
    aspp = heads.ASPP(16, 8, output_stride=8).train()
    kinds = [type(f[0]) for f in aspp.features]
    assert kinds == [Conv2d] + [heads.AtrousConv2d] * 3
    aspp(torch.randn(2, 16, 20, 20, requires_grad=True))
    assert calls == [(12, (12, 12), True), (24, (24, 24), True),
                     (36, (36, 36), True)]
    calls.clear()
    with torch.no_grad():
        aspp(torch.randn(2, 16, 20, 20))
    assert [c[2] for c in calls] == [False] * 3  # no copy without a backward

    dpc = heads.DPC(16, 8)
    assert all(type(m) is Conv2d and m.nchw for m in dpc.modules()
               if isinstance(m, torch.nn.Conv2d))
    calls.clear()
    dpc(torch.randn(1, 16, 24, 24))
    assert calls == []

    grouped = heads.AtrousConv2d(16, 8, 3, padding=12, dilation=12,
                                 groups=2, bias=False)
    x = torch.randn(1, 16, 20, 20)
    assert not grouped.takes_kernel(x)
    out = grouped(x)
    assert calls == []
    torch.testing.assert_close(out, F.conv2d(x, grouped.weight, None, 1, 12,
                                             12, 2), rtol=0, atol=0)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("d,pad_h,h", [
    (1, 1, 9), (12, 12, 20), (36, 36, 20),
    (12, 0, 40), (36, 0, 80)])  # a band: its halo rows given, no H padding
def test_function_matches_conv2d(d, pad_h, h, shared):
    """The autograd Function (the op's plain version forward, aten's
    convolution_backward on NCHW memory backward) against ``F.conv2d`` in
    f64: the output and both gradients."""
    x, wt = _inputs(2, 16, h, 13, 8)
    xa, wa = x.clone().requires_grad_(), wt.clone().requires_grad_()
    xb, wb = x.clone().requires_grad_(), wt.clone().requires_grad_()
    cl = xa.contiguous(memory_format=torch.channels_last)
    got = dc.DilatedConv3x3.apply(cl, wa, pad_h, d, d,
                                  x.contiguous() if shared else None)
    want = F.conv2d(xb, wb, None, 1, (pad_h, d), d)
    assert got.shape == want.shape == (2, 8, h + 2 * pad_h - 2 * d, 13)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    g = torch.randn(want.shape, generator=torch.Generator().manual_seed(1),
                    dtype=want.dtype)
    got.backward(g)
    want.backward(g)
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(wa.grad, wb.grad, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("grad", [False, True])
def test_wrapper_routes(grad):
    """The Function only where a gradient is wanted; the op alone else."""
    x, wt = _inputs(1, 8, 10, 10, 8, torch.float32)
    x.requires_grad_(grad)
    out = dc.dilated_conv3x3(x, wt, (2, 2), 2)
    assert (out.grad_fn is not None) is grad
    torch.testing.assert_close(out, F.conv2d(x, wt, None, 1, 2, 2),
                               rtol=0, atol=0)


@pytest.mark.parametrize("train", [False, True])
def test_aspp_wrapper_vs_plain_convs(train):
    """ASPP with the wrapper and the same ASPP with every dilated conv on
    ``Conv2d`` (the route before the kernel): equal in f32, outputs,
    input and parameter gradients and BN statistics."""
    torch.manual_seed(0)
    a = heads.ASPP(16, 8, output_stride=8).train(train)
    b = copy.deepcopy(a)
    for f in b.features[1:]:
        f[0].takes_kernel = lambda x: False
    x = torch.randn(2, 16, 20, 20)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya, yb = a(xa), b(xb)
    torch.testing.assert_close(ya, yb, rtol=0, atol=0)
    ya.square().sum().backward()
    yb.square().sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad, rtol=0, atol=0)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(p.grad, q.grad, rtol=0, atol=0, msg=n)
    for (n, s), t in zip(a.named_buffers(), b.buffers()):
        torch.testing.assert_close(s, t, rtol=0, atol=0, msg=n)


def test_fake_shape_and_export():
    """The shape function gives the kernel's channels_last output, and an
    exported ASPP holds the op as one node a dilated branch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(2, 64, 30, 45).contiguous(
            memory_format=torch.channels_last)
        wp = torch.empty(9, 256, 64)
        out = torch.ops.tpuseg_torch.dilated_conv3x3(x, wp, 0, 12, 12)
        assert out.shape == (2, 256, 6, 45)
        assert out.is_contiguous(memory_format=torch.channels_last)

    torch.manual_seed(0)
    aspp = heads.ASPP(16, 8, output_stride=8).eval()
    x = torch.randn(1, 16, 20, 20)
    program = torch.export.export(aspp, (x,), strict=False)
    ops = [n for n in program.graph.nodes
           if n.target == torch.ops.tpuseg_torch.dilated_conv3x3.default]
    assert len(ops) == 3
    with torch.no_grad():
        torch.testing.assert_close(program.module()(x), aspp(x), rtol=0,
                                   atol=0)


def test_flop_formula():
    """Every tap counted, as aten's conv formula counts them."""
    x, wt = _inputs(2, 16, 20, 20, 8, torch.float32)
    with FlopCounterMode(display=False) as fc:
        torch.ops.tpuseg_torch.dilated_conv3x3(x, dc.pack_weight(wt), 12, 12,
                                               12)
    with FlopCounterMode(display=False) as ref:
        F.conv2d(x, wt, None, 1, 12, 12)
    assert fc.get_total_flops() == ref.get_total_flops() == \
        2 * 2 * 20 * 20 * 8 * 16 * 9


@pytest.mark.parametrize("bad", ["shape", "dtype", "output"])
def test_op_raises(bad):
    x, wt = _inputs(1, 16, 10, 10, 8, torch.float32)
    wp = dc.pack_weight(wt)
    args = {"shape": (x, wp[:, :, :8], 1, 1, 1),
            "dtype": (x, wp.double(), 1, 1, 1),
            "output": (x, wp, 0, 0, 6)}[bad]
    with pytest.raises(ValueError):
        torch.ops.tpuseg_torch.dilated_conv3x3(*args)
