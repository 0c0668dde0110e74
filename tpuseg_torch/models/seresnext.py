"""SE-ResNeXt-50/101 trunks (squeeze-excite + grouped bottlenecks), output
stride 8.

Port of ``tpuseg/models/seresnext.py`` (reference: network/SEresnext.py,
with the stride-8 dilation rewrite of network/utils.py:48-99). Returns
``(s2=layer1, None, high=layer4)``. State-dict names are Cadene's:
``layer0.conv1`` / ``layer0.bn1``, ``layer{L}.{b}.conv1..bn3``,
``se_module.fc1|fc2``, ``downsample.{0,1}``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn as nn

from tpuseg_torch.models.layers import Conv2d, Norm, conv
from tpuseg_torch.models.resnet import LayeredTrunk, stride_plan


class SEModule(nn.Module):
    """Squeeze-and-excite (reference: SEresnext.py:70-90); the gate's
    sigmoid in f32."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = conv(channels, channels // reduction, 1, bias=True)
        self.fc2 = conv(channels // reduction, channels, 1, bias=True)

    def forward(self, x):
        s = torch.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True)))
        return x * torch.sigmoid(self.fc2(s).float()).to(x.dtype)


class SEResNeXtBottleneck(nn.Module):
    """ResNeXt bottleneck + SE (reference: SEresnext.py:170-191): 32
    groups, base width 4."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, groups: int = 32,
                 stride: int = 1, dilation: int = 1,
                 downsample: bool = False, base_width: int = 4):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * self.expansion
        self.conv1 = conv(inplanes, width, 1)
        self.bn1 = Norm(width)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=dilation,
                            dilation=dilation, groups=groups, bias=False)
        self.bn2 = Norm(width)
        self.conv3 = conv(width, out, 1)
        self.bn3 = Norm(out)
        self.se_module = SEModule(out)
        self.downsample = (nn.Sequential(conv(inplanes, out, 1, stride),
                                         Norm(out)) if downsample else None)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.se_module(self.bn3(self.conv3(y)))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class SEResNeXt(LayeredTrunk):
    """layers=(3,4,6,3) -> SE-ResNeXt-50; (3,4,23,3) -> -101."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 output_stride: int = 8, dtype=torch.bfloat16,
                 remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = bool(remat)
        # one 7x7 s2 (input_3x3=False for se_resnext, SEresnext.py:44-67)
        # and a Caffe-style maxpool: padding 0, ceil_mode (SEresnext.py:
        # 269-272; torchvision's padding=1 aligns the windows differently)
        self.layer0 = nn.Sequential(OrderedDict(
            conv1=conv(3, 64, 7, 2, padding=3), bn1=Norm(64),
            relu1=nn.ReLU(), pool=nn.MaxPool2d(3, 2, 0, ceil_mode=True)))
        inplanes = 64
        for li, (n, (planes, stride, dil)) in enumerate(
                zip(layers, stride_plan(output_stride, 64)), start=1):
            blocks = []
            for b in range(n):
                blocks.append(SEResNeXtBottleneck(
                    inplanes, planes, 32, stride if b == 0 else 1, dil,
                    downsample=b == 0))
                inplanes = planes * SEResNeXtBottleneck.expansion
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
