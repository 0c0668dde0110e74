"""ASPP's dilated 3x3 convs: CUDA kernel wrapper and its plain version.

The kernel is ``csrc/dilated_conv.cu``, a forward 3x3 conv at any
dilation, stride 1 and groups 1 over bf16 channels_last maps, with f32
accumulation; its header says what bounds it on the H100 and how it is laid
out. It replaces no ``tpuseg`` Pallas kernel: it takes the forward of
ASPP's atrous convs (``models/heads.py``) from cuDNN, whose NCHW route for
them is a legacy kernel at ~3 % of the card's peak.

Dispatch: a CPU tensor takes :func:`dilated_conv3x3_reference`; a CUDA
tensor launches the kernel or raises. There is no fallback: a caller asks
:func:`supports` first. The op is registered as
``tpuseg_torch::dilated_conv3x3`` with a shape function (``register_fake``)
and a flop formula, so an exported program (``tpuseg_torch.serving``) holds
the kernel as one node. Its gradient is :class:`DilatedConv3x3`'s backward,
``aten.convolution_backward`` on NCHW copies of the input and the weight:
the route cuDNN took before the kernel, unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.flop_counter

from tpuseg_torch.kernels import _build
from tpuseg_torch.utils.profiling import count, span

WIDTHS = (64, 128, 192, 256)  # output channels the kernel takes


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> (9, Cout, Cin), tap 3 ky + kx: the kernel's
    layout, each tap's rows K-major."""
    cout, cin = weight.shape[:2]
    return weight.permute(2, 3, 0, 1).reshape(9, cout, cin).contiguous()


def unpack_weight(wp: torch.Tensor) -> torch.Tensor:
    """(9, Cout, Cin) -> a (Cout, Cin, 3, 3) view."""
    return wp.view(3, 3, *wp.shape[1:]).permute(2, 3, 0, 1)


def out_hw(h: int, w: int, pad_h: int, pad_w: int, dilation: int) -> tuple:
    return h + 2 * pad_h - 2 * dilation, w + 2 * pad_w - 2 * dilation


def dilated_conv3x3_reference(x: torch.Tensor, wp: torch.Tensor, pad_h: int,
                              pad_w: int, dilation: int) -> torch.Tensor:
    """Plain version: ``F.conv2d`` of x (B, Cin, H, W) with the packed
    weights on NCHW memory, as the model ran these convs before the
    kernel."""
    return F.conv2d(x.contiguous(), unpack_weight(wp).contiguous(), None, 1,
                    (pad_h, pad_w), dilation)


def supports(x: torch.Tensor, weight: torch.Tensor, stride=(1, 1),
             dilation=(1, 1), groups: int = 1) -> bool:
    """Whether :func:`dilated_conv3x3` takes this conv: a 3x3 kernel, stride
    1, groups 1, one dilation for both axes; on CUDA also a bf16 input with
    Cin a multiple of 8 (TMA's 16-byte strides) and Cout in ``WIDTHS``. A
    CPU input always runs the plain version. Only the weight's shape is
    read: the wrapper takes it in x's dtype."""
    if tuple(weight.shape[2:]) != (3, 3) or tuple(stride) != (1, 1) \
            or groups != 1 or dilation[0] != dilation[1] \
            or x.dim() != 4 or weight.shape[1] != x.shape[1]:
        return False
    if x.device.type == "cpu":
        return True
    return (x.device.type == "cuda" and x.dtype == torch.bfloat16
            and x.shape[1] % 8 == 0 and weight.shape[0] in WIDTHS)


def _check(x, wp, pad_h, pad_w, dilation):
    if x.dim() != 4 or wp.dim() != 3 or wp.shape[0] != 9 \
            or wp.shape[2] != x.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)}, packed weight "
                         f"{tuple(wp.shape)}: want (B, Cin, H, W), "
                         f"(9, Cout, Cin)")
    if wp.dtype != x.dtype or wp.device != x.device:
        raise ValueError(f"weight {wp.dtype} on {wp.device}, x {x.dtype} "
                         f"on {x.device}")
    if dilation < 1 or pad_h < 0 or pad_w < 0 or min(out_hw(
            *x.shape[2:], pad_h, pad_w, dilation)) < 1:
        raise ValueError(f"dilation {dilation}, padding ({pad_h}, {pad_w}) "
                         f"leave no output of a {tuple(x.shape[2:])} map")


@torch.library.custom_op("tpuseg_torch::dilated_conv3x3", mutates_args=())
def _dilated_conv3x3(x: torch.Tensor, wp: torch.Tensor, pad_h: int,
                     pad_w: int, dilation: int) -> torch.Tensor:
    _check(x, wp, pad_h, pad_w, dilation)
    if x.device.type == "cpu":
        return dilated_conv3x3_reference(x, wp, pad_h, pad_w, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, cin, h, w = x.shape
    cout = wp.shape[1]
    if x.dtype != torch.bfloat16 or cin % 8 or cout not in WIDTHS:
        raise ValueError(f"the kernel takes bf16 with Cin a multiple of 8 "
                         f"and Cout in {WIDTHS}: got {x.dtype}, Cin {cin}, "
                         f"Cout {cout}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be channels_last contiguous")
    if not wp.is_contiguous():
        raise ValueError("the packed weight must be contiguous")
    if x.data_ptr() % 16 or wp.data_ptr() % 16:
        raise ValueError("x and the packed weight must be 16-byte aligned")
    ho, wo = out_hw(h, w, pad_h, pad_w, dilation)
    out = torch.empty((b, cout, ho, wo), device=x.device, dtype=x.dtype,
                      memory_format=torch.channels_last)
    lib = _build.library()
    with span("kernel.dilated_conv"):
        err = lib.tpuseg_dilated_conv3x3(
            x.data_ptr(), wp.data_ptr(), out.data_ptr(), b, h, w, cin, cout,
            pad_h, pad_w, dilation,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dilated_conv3x3")
    count("kernel.dilated_conv.launches")
    return out


@_dilated_conv3x3.register_fake
def _(x, wp, pad_h, pad_w, dilation):
    _check(x, wp, pad_h, pad_w, dilation)
    ho, wo = out_hw(*x.shape[2:], pad_h, pad_w, dilation)
    return torch.empty((x.shape[0], wp.shape[1], ho, wo), device=x.device,
                       dtype=x.dtype, memory_format=torch.channels_last)


@torch.utils.flop_counter.register_flop_formula(
    torch.ops.tpuseg_torch.dilated_conv3x3)
def _flops(x_shape, wp_shape, pad_h, pad_w, dilation, *args, **kwargs) -> int:
    b, cin, h, w = x_shape
    ho, wo = out_hw(h, w, pad_h, pad_w, dilation)
    return 2 * b * ho * wo * wp_shape[1] * cin * 9  # every tap, as aten's


def _forward(x, weight, pad_h, pad_w, dilation):
    if x.device.type == "cuda":
        x = x.contiguous(memory_format=torch.channels_last)
    return torch.ops.tpuseg_torch.dilated_conv3x3(
        x, pack_weight(weight), pad_h, pad_w, dilation)


class DilatedConv3x3(torch.autograd.Function):
    """The op's forward; a backward of ``aten.convolution_backward`` on
    NCHW memory (input and weight made contiguous), cuDNN's dgrad and wgrad
    as before the kernel. ``x_nchw``, where given, is x's NCHW copy for the
    backward, made once by a caller whose branches share the input (ASPP);
    else the backward copies the saved x itself."""

    @staticmethod
    def forward(ctx, x, weight, pad_h, pad_w, dilation, x_nchw=None):
        ctx.geometry = (pad_h, pad_w, dilation)
        ctx.save_for_backward(x if x_nchw is None else x_nchw, weight)
        return _forward(x, weight, pad_h, pad_w, dilation)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        pad_h, pad_w, d = ctx.geometry
        gx, gw, _ = torch.ops.aten.convolution_backward(
            grad, x.contiguous(), weight.contiguous(), None, (1, 1),
            (pad_h, pad_w), (d, d), False, (0, 0), 1,
            (ctx.needs_input_grad[0], ctx.needs_input_grad[1], False))
        return gx, gw, None, None, None, None


def dilated_conv3x3(x: torch.Tensor, weight: torch.Tensor, padding,
                    dilation: int, x_nchw: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """x (B, Cin, H, W), weight (Cout, Cin, 3, 3) in x's dtype, padding
    (pad_h, pad_w) -> (B, Cout, H + 2 pad_h - 2 d, W + 2 pad_w - 2 d),
    channels_last on CUDA. Through :class:`DilatedConv3x3` where a gradient
    is wanted, else the op alone."""
    pad_h, pad_w = padding
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return DilatedConv3x3.apply(x, weight, pad_h, pad_w, dilation,
                                    x_nchw)
    return _forward(x, weight, pad_h, pad_w, dilation)
