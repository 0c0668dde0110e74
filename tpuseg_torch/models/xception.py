"""Aligned Xception-71 trunk, output stride 8.

Port of ``tpuseg/models/xception.py`` (reference: network/xception.py):
entry / middle / exit flows of separable convs, dilation 2 in the middle
blocks and (2, 4) in the exit flow at output stride 8. Taps: s2 = the
stride-2 stem relu (64 ch), s4 = block1's output (128 ch), high = the exit
flow's conv5 (2048 ch).

TF "fixed padding" (``pad_beg = (eff - 1) // 2``, ``pad_end = eff - 1 -
pad_beg``, ``tpuseg/models/xception.py:34-37``) is asymmetric only for an
even effective kernel. Every separable conv here is 3x3, whose effective
size ``eff = 2 * dilation + 1`` is odd, so both pads equal the dilation,
stride 2 included, and the conv's own symmetric padding computes it.

State-dict names are the reference's: ``conv1|2``, ``bn1|2``,
``block{n}.rep.{i}`` (the [relu, SeparableConv2d, BN] triples, without
the first relu in block1 / block2), ``block{n}.skip|skipbn``, and
``conv3..5`` / ``bn3..5`` of the exit flow; a separable conv is
``conv1`` (depthwise), ``bn``, ``pointwise``.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from tpuseg_torch.models.hrnet import remat_call
from tpuseg_torch.models.layers import Conv2d, Norm, conv
from tpuseg_torch.utils.profiling import spanned


class SeparableConv(nn.Module):
    """depthwise 3x3 -> BN -> pointwise 1x1 (reference: xception.py:15-40)."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        eff = 3 + 2 * (dilation - 1)
        pad = (eff - 1) // 2  # == eff - 1 - pad: eff is odd
        self.conv1 = Conv2d(cin, cin, 3, stride=stride, padding=pad,
                            dilation=dilation, groups=cin, bias=False)
        self.bn = Norm(cin)
        self.pointwise = conv(cin, cout, 1)

    def forward(self, x):
        return self.pointwise(self.bn(self.conv1(x)))


class XceptionBlock(nn.Module):
    """(reference Block: xception.py:43-107). ``rep`` is the reference's
    Sequential of [ReLU, SeparableConv, BN] triples; with
    ``start_with_relu`` False its first ReLU is left out."""

    def __init__(self, cin: int, planes: int, reps: int, stride: int = 1,
                 dilation: int = 1, start_with_relu: bool = True,
                 grow_first: bool = True, is_last: bool = False):
        super().__init__()
        self.start_with_relu = start_with_relu
        convs = []  # (cin, cout, stride, dilation) of each separable conv
        filters = cin
        if grow_first:
            convs.append((cin, planes, 1, dilation))
            filters = planes
        convs += [(filters, filters, 1, dilation)] * (reps - 1)
        if not grow_first:
            convs.append((filters, planes, 1, dilation))
        if stride != 1:
            convs.append((planes, planes, 2, 1))
        elif is_last:
            # the reference hard-codes dilation 1 here (xception.py:87),
            # even in a dilated block
            convs.append((planes, planes, 1, 1))
        rep = []
        for ci, co, s, d in convs:
            if rep or start_with_relu:
                rep.append(nn.ReLU())
            rep += [SeparableConv(ci, co, s, d), Norm(co)]
        self.rep = nn.Sequential(*rep)
        if planes != cin or stride != 1:
            self.skip = conv(cin, planes, 1, stride)
            self.skipbn = Norm(planes)
        else:
            self.skip = self.skipbn = None

    def forward(self, x):
        if self.start_with_relu:
            # the reference's leading ReLU is inplace (xception.py:56-60),
            # so the skip branch reads relu(x) too; rep's own first ReLU is
            # then a no-op
            x = torch.relu(x)
        skip = x if self.skip is None else self.skipbn(self.skip(x))
        return self.rep(x) + skip


class Xception71(nn.Module):
    """Over an NCHW image (cast to ``dtype``, channels_last); returns
    ``(s2, s4, high)``. ``middle_blocks`` shrinks the 16-block middle flow
    (``xception71_tiny``: 2); the exit block keeps the name ``block20``."""

    def __init__(self, output_stride: int = 8, middle_blocks: int = 16,
                 dtype=torch.bfloat16, remat: bool = False):
        super().__init__()
        if output_stride == 8:
            mid_dil, exit_dils, exit_stride = 2, (2, 4), 1
        elif output_stride == 16:
            mid_dil, exit_dils, exit_stride = 1, (1, 2), 2
        else:
            raise ValueError(output_stride)
        self.dtype = dtype
        self.remat = bool(remat)
        # entry flow
        self.conv1 = conv(3, 32, 3, 2)
        self.bn1 = Norm(32)
        self.conv2 = conv(32, 64, 3)
        self.bn2 = Norm(64)
        self.block1 = XceptionBlock(64, 128, 2, 2, 1, False, True)
        self.block2 = XceptionBlock(128, 256, 2, 1, 1, False, True)
        self.block3 = XceptionBlock(256, 728, 2, 2, 1, True, True,
                                    is_last=True)
        # middle flow
        self.middle = [f"block{i + 4}" for i in range(middle_blocks)]
        for name in self.middle:
            setattr(self, name, XceptionBlock(728, 728, 3, 1, mid_dil))
        # exit flow
        self.block20 = XceptionBlock(728, 1024, 2, exit_stride, exit_dils[0],
                                     True, False, is_last=True)
        for i, (ci, co) in enumerate(((1024, 1536), (1536, 1536),
                                      (1536, 2048)), start=3):
            setattr(self, f"conv{i}", SeparableConv(ci, co, 1, exit_dils[1]))
            setattr(self, f"bn{i}", Norm(co))

    @spanned("model.trunk")
    def forward(self, x):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        remat = self.remat and self.training and torch.is_grad_enabled()

        def block(name, y):
            blk = getattr(self, name)
            return remat_call(blk, y) if remat else blk(y)

        x = torch.relu(self.bn1(self.conv1(x)))
        s2 = torch.relu(self.bn2(self.conv2(x)))
        s4 = torch.relu(block("block1", s2))
        x = block("block2", s4)
        x = block("block3", x)
        for name in self.middle:
            x = block(name, x)
        x = torch.relu(block("block20", x))
        for i in (3, 4, 5):
            x = getattr(self, f"conv{i}")(x)
            x = torch.relu(getattr(self, f"bn{i}")(x))
        return s2, s4, x
