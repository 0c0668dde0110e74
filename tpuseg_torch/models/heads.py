"""ASPP / DPC context modules.

Port of ``tpuseg/models/heads.py:15-108`` (reference: network/utils.py:
162-311), over NCHW-logical tensors, with the reference's state-dict names:
ASPP's ``img_conv.{0,1}`` and ``features.{i}.{0,1}``, DPC's
``{a..e}.{0,1}`` (each a Sequential(conv, BN, ReLU)).

ASPP's dilated 3x3 convs (rates 12 / 24 / 36 at output stride 8) run
``csrc/dilated_conv.cu`` (``kernels/dilated_conv.py``) wherever its
``supports()`` takes them (on the card: bf16, Cin a multiple of 8, Cout
64-256), on channels_last memory; their backward is cuDNN's dgrad and
wgrad on NCHW memory, from one NCHW copy of the input for the three
branches. cuDNN has no good forward for them: on NCHW memory it picks the
legacy ``implicit_convolve_sgemm`` (20.2 ms a crop of the DeepLabV3+
train step's 51.8; HRNet_ASPP_OCR's 720 -> 256 rate-12 conv at 256x512
about 15 ms, 34x its bound), and its channels_last kernels for these rates
took about 1 s for that conv, with or without ``cudnn.benchmark``
(``chip_smoke.py`` [zoo-eval], PERF.md). A conv the kernel does not take
stays on NCHW memory (``Conv2d.nchw``), as DPC's convs do: its unequal
(ry, rx) rates and its depthwise form are not the kernel's. The
concatenation goes back to channels_last.

On bands (dp x sp, ``parallel/spatial.py``) ASPP's image pooling takes the
whole image's mean (``ops.global_avg_pool``); its 1x1 conv and BN then
run on a (N, C, 1, 1) tensor that is the same on every rank of the sp
group (``spatial.replicated``: batch norm counts it once), broadcast to
the band's rows. The dilated convs take their halos in ``Conv2d``: up to
36 rows (ASPP's rate 36, DPC's (36, 30) pair at output stride 8), which
on a small crop or a wide sp group reach past the neighbouring band.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from tpuseg_torch.kernels import dilated_conv
from tpuseg_torch.models.layers import Conv2d, Norm, conv
from tpuseg_torch.ops import global_avg_pool
from tpuseg_torch.parallel import spatial


class AtrousConv2d(Conv2d):
    """ASPP's dilated 3x3 conv (no bias, stride 1): the kernel where
    ``dilated_conv.supports`` takes it, else cuDNN on NCHW memory (module
    docstring). ``x_nchw``: x's NCHW copy for the backward, shared by the
    branches (:func:`backward_copy`)."""

    nchw = True

    def takes_kernel(self, x: torch.Tensor) -> bool:
        return self.bias is None and dilated_conv.supports(
            x, self.weight, self.stride, self.dilation, self.groups)

    def forward(self, x: torch.Tensor,
                x_nchw: torch.Tensor | None = None) -> torch.Tensor:
        if not self.takes_kernel(x):
            return super().forward(x)
        x, padding = self.band_rows(x)
        return dilated_conv.dilated_conv3x3(
            x, self.weight.to(x.dtype), padding, self.dilation[0], x_nchw)


def backward_copy(x: torch.Tensor, convs) -> torch.Tensor | None:
    """x on NCHW memory, once for every conv of ``convs`` that takes the
    kernel, where a backward will read it (a gradient is wanted and x is
    not a band); else None and each conv's backward copies its own."""
    if spatial.active() is not None or not torch.is_grad_enabled() \
            or not any(c.takes_kernel(x) for c in convs) \
            or not (x.requires_grad
                    or any(c.weight.requires_grad for c in convs)):
        return None
    return x.detach().contiguous()


def _conv_bn_relu(cin: int, cout: int, kernel: int, dilation: int = 1
                  ) -> nn.Sequential:
    if dilation > 1:
        c = AtrousConv2d(cin, cout, kernel, padding=dilation,
                         dilation=dilation, bias=False)
    else:
        c = conv(cin, cout, kernel, dilation=dilation)
    return nn.Sequential(c, Norm(cout), nn.ReLU())


class ASPP(nn.Module):
    """Atrous Spatial Pyramid Pooling: image pooling + 1x1 + three dilated
    3x3 (rates doubled at output stride 8 -> 12/24/36), concatenated
    (reference AtrousSpatialPyramidPoolingModule: network/utils.py:
    162-218). Output channels = 5 * reduction_dim."""

    def __init__(self, cin: int, reduction_dim: int = 256,
                 output_stride: int = 8, rates: Sequence[int] = (6, 12, 18)):
        super().__init__()
        if output_stride == 8:
            rates = [2 * r for r in rates]
        self.img_conv = _conv_bn_relu(cin, reduction_dim, 1)
        self.features = nn.ModuleList(
            [_conv_bn_relu(cin, reduction_dim, 1)]
            + [_conv_bn_relu(cin, reduction_dim, 3, r) for r in rates])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # image-level features: global average pool -> 1x1 -> broadcast
        # (the bilinear upsample of a 1x1 map; a BN over one value per
        # channel at batch 1: layers.BatchNorm2d)
        pooled = global_avg_pool(x)
        with spatial.replicated():
            img = self.img_conv(pooled)
        img = img.to(x.dtype).expand(-1, -1, *x.shape[-2:])
        outs = [img, self.features[0](x)]
        atrous = [f[0] for f in self.features[1:]]
        shared = backward_copy(x, atrous)
        for c, (_, norm, relu) in zip(atrous, self.features[1:]):
            outs.append(relu(norm(c(x, shared))))
        return _channels_last(torch.cat(outs, dim=1))


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


def _dpc_conv(cin: int, cout: int, rate: Tuple[int, int],
              separable: bool) -> nn.Sequential:
    """3x3 conv dilated (ry, rx) -> BN -> relu (tpuseg ``_DPCConv``)."""
    c = Conv2d(cin, cout, 3, padding=rate, dilation=rate,
               groups=cout if separable else 1, bias=False)
    c.nchw = True  # module docstring
    return nn.Sequential(c, Norm(cout), nn.ReLU())


class DPC(nn.Module):
    """Dense Prediction Cell (reference: network/utils.py:263-298); rate
    pairs doubled at output stride 8. Dropout (0.1) acts in training."""

    def __init__(self, cin: int, reduction_dim: int = 256,
                 output_stride: int = 8, dropout: bool = False,
                 separable: bool = False):
        super().__init__()
        rates = [(1, 6), (18, 15), (6, 21), (1, 1), (6, 3)]
        if output_stride == 8:
            rates = [(2 * ry, 2 * rx) for ry, rx in rates]
        r = reduction_dim
        self.a = _dpc_conv(cin, r, rates[0], separable)
        self.b = _dpc_conv(r, r, rates[1], separable)
        self.c = _dpc_conv(r, r, rates[2], separable)
        self.d = _dpc_conv(r, r, rates[3], separable)
        self.e = _dpc_conv(r, r, rates[4], separable)
        self.drop = nn.Dropout(0.1) if dropout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.a(x)
        b = self.b(a)
        out = _channels_last(
            torch.cat([a, b, self.c(a), self.d(a), self.e(b)], dim=1))
        return self.drop(out) if self.drop is not None else out


def make_aspp(cin: int, bottleneck_ch: int, output_stride: int,
              dpc: bool = False):
    """-> (module, out_channels) (reference get_aspp: network/utils.py:
    301-311)."""
    if dpc:
        mod = DPC(cin, bottleneck_ch, output_stride)
    else:
        mod = ASPP(cin, bottleneck_ch, output_stride)
    return mod, 5 * bottleneck_ch
