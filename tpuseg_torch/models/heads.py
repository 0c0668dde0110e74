"""ASPP / DPC context modules.

Port of ``tpuseg/models/heads.py:15-108`` (reference: network/utils.py:
162-311), over NCHW-logical tensors, with the reference's state-dict names:
ASPP's ``img_conv.{0,1}`` and ``features.{i}.{0,1}``, DPC's
``{a..e}.{0,1}`` (each a Sequential(conv, BN, ReLU)).

The dilated 3x3 convs (rates 12 / 24 / 36 at output stride 8, DPC's up to
42) run on NCHW memory (``Conv2d.nchw``) and the concatenation goes back
to channels_last: on an H100, cuDNN's channels_last kernels for these
rates took about 1 s for HRNet_ASPP_OCR's 720 -> 256 rate-12 conv at
256x512 against about 15 ms on NCHW, with or without
``cudnn.benchmark`` (``chip_smoke.py`` [zoo-eval], PERF.md).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from tpuseg_torch.models.layers import Conv2d, Norm, conv
from tpuseg_torch.ops import resize_bilinear


def _conv_bn_relu(cin: int, cout: int, kernel: int, dilation: int = 1
                  ) -> nn.Sequential:
    c = conv(cin, cout, kernel, dilation=dilation)
    c.nchw = dilation > 1  # module docstring
    return nn.Sequential(c, Norm(cout), nn.ReLU())


class ASPP(nn.Module):
    """Atrous Spatial Pyramid Pooling: image pooling + 1x1 + three dilated
    3x3 (rates doubled at output stride 8 -> 12/24/36), concatenated
    (reference AtrousSpatialPyramidPoolingModule: network/utils.py:
    162-218). Output channels = 5 * reduction_dim."""

    def __init__(self, cin: int, reduction_dim: int = 256,
                 output_stride: int = 8, rates: Sequence[int] = (6, 12, 18),
                 align_corners: bool = False):
        super().__init__()
        if output_stride == 8:
            rates = [2 * r for r in rates]
        self.align_corners = align_corners
        self.img_conv = _conv_bn_relu(cin, reduction_dim, 1)
        self.features = nn.ModuleList(
            [_conv_bn_relu(cin, reduction_dim, 1)]
            + [_conv_bn_relu(cin, reduction_dim, 3, r) for r in rates])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # image-level features: global average pool -> 1x1 -> upsample (a
        # BN over one value per channel at batch 1: layers.BatchNorm2d)
        img = self.img_conv(x.mean(dim=(2, 3), keepdim=True))
        img = resize_bilinear(img, x.shape[-2:], self.align_corners)
        outs = [img.to(x.dtype)] + [f(x) for f in self.features]
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
              dpc: bool = False, align_corners: bool = False):
    """-> (module, out_channels) (reference get_aspp: network/utils.py:
    301-311)."""
    if dpc:
        mod = DPC(cin, bottleneck_ch, output_stride)
    else:
        mod = ASPP(cin, bottleneck_ch, output_stride,
                   align_corners=align_corners)
    return mod, 5 * bottleneck_ch
