"""ResNet-50/101 trunks, dilated for output stride 8.

Port of ``tpuseg/models/resnet.py`` (reference: network/Resnet.py and the
stride-8 rewrite of network/utils.py:48-99: layer3 conv2 dilation 2,
layer4 conv2 dilation 4, downsample strides 1), built with the dilation
plan. Returns ``(s2=layer1, None, high=layer4)``.

State-dict names are those of a reference seg checkpoint: the stem is
get_resnet's positional ``layer0`` (``layer0.0`` conv, ``layer0.1`` BN),
the blocks torchvision's ``layer{L}.{b}.conv1..bn3`` and
``downsample.{0,1}``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from tpuseg_torch.models.hrnet import remat_call
from tpuseg_torch.models.layers import Norm, conv
from tpuseg_torch.ops import MaxPool2d
from tpuseg_torch.utils.profiling import spanned


class ResNetBottleneck(nn.Module):
    """torchvision-style bottleneck (1x1 -> 3x3 -> 1x1 x4)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = conv(inplanes, planes, 1)
        self.bn1 = Norm(planes)
        self.conv2 = conv(planes, planes, 3, stride, dilation=dilation)
        self.bn2 = Norm(planes)
        self.conv3 = conv(planes, out, 1)
        self.bn3 = Norm(out)
        self.downsample = (nn.Sequential(conv(inplanes, out, 1, stride),
                                         Norm(out)) if downsample else None)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


def stride_plan(output_stride: int, width: int):
    """(planes, stride, dilation) of layer1..layer4."""
    w = width
    if output_stride == 8:
        return [(w, 1, 1), (2 * w, 2, 1), (4 * w, 1, 2), (8 * w, 1, 4)]
    if output_stride == 16:
        return [(w, 1, 1), (2 * w, 2, 1), (4 * w, 2, 1), (8 * w, 1, 2)]
    raise ValueError(output_stride)


class LayeredTrunk(nn.Module):
    """``layer0`` (the stem) then the blocks of ``layer1`` .. ``layer4`` over
    an NCHW image cast to ``dtype``, channels_last; returns
    ``(layer1, None, layer4)``. ``remat`` recomputes each block in the
    backward pass."""

    @spanned("model.trunk")
    def forward(self, x):
        x = self.layer0(
            x.to(self.dtype).contiguous(memory_format=torch.channels_last))
        remat = self.remat and self.training and torch.is_grad_enabled()
        s2 = None
        for li in range(1, 5):
            for blk in getattr(self, f"layer{li}"):
                x = remat_call(blk, x) if remat else blk(x)
            if li == 1:
                s2 = x
        return s2, None, x


class ResNet(LayeredTrunk):
    """Dilated ResNet trunk. layers=(3,4,6,3) -> R50; (3,4,23,3) -> R101."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 output_stride: int = 8, dtype=torch.bfloat16,
                 remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = bool(remat)
        # stem: 7x7 s2 + maxpool s2 (ops.max_pool2d: on the image's grid
        # on bands too)
        self.layer0 = nn.Sequential(conv(3, width, 7, 2, padding=3),
                                    Norm(width), nn.ReLU(),
                                    MaxPool2d(3, 2, 1))
        inplanes = width
        for li, (n, (planes, stride, dil)) in enumerate(
                zip(layers, stride_plan(output_stride, width)), start=1):
            blocks = []
            for b in range(n):
                blocks.append(ResNetBottleneck(inplanes, planes,
                                               stride if b == 0 else 1, dil,
                                               downsample=b == 0))
                inplanes = planes * ResNetBottleneck.expansion
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
