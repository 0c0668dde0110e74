"""EfficientNet-B4 trunk, output stride 8 (dilated).

Port of ``tpuseg/models/efficientnet.py``, whose module docstring gives the
design: the reference's own EffB4 factories are dead code (its get_trunk
has no ``efficientnet_b4`` branch), so this follows ``tpuseg``'s working
trunk, built from the paper (Tan & Le, arXiv:1905.11946):

- the B0 stage table scaled by width 1.4 / depth 1.8;
- MBConv: 1x1 expand -> k x k depthwise -> squeeze-excite (width 0.25 of
  the block's *input* channels) -> 1x1 project, SiLU, BN eps 1e-3, and a
  residual with per-sample drop-path (0.2, linear over depth) on stride-1
  same-width blocks, in training only;
- output stride 8: the s16 stage runs stride 1 / dilation 2 and the s32
  stage stride 1 / dilation 4.

Taps: s2 = stage 1 (24 ch), s4 = stage 2 (32 ch), high = stage 7 (448 ch).
State-dict names follow timm: ``conv_stem``, ``bn1``,
``blocks.{s}.{b}.{conv_pw,bn1,conv_dw,bn2,se.conv_reduce,se.conv_expand,
conv_pwl,bn3}`` (a block without expansion: ``conv_dw``, ``bn1``, ``se``,
``conv_pw``, ``bn2``).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpuseg_torch.models.hrnet import remat_call
from tpuseg_torch.models.layers import Conv2d, Norm, conv
from tpuseg_torch.ops import global_avg_pool, upcast
from tpuseg_torch.utils.profiling import spanned

# B0 stage table: (expand, channels, repeats, stride, kernel)
_B0_STAGES = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)
_B4_WIDTH, _B4_DEPTH = 1.4, 1.8
BN_EPS = 1e-3


def round_filters(ch: float, width_mult: float, divisor: int = 8) -> int:
    """EfficientNet's channel rounding (paper Sec. 3.3)."""
    ch = ch * width_mult
    new = max(divisor, int(ch + divisor / 2) // divisor * divisor)
    if new < 0.9 * ch:
        new += divisor
    return int(new)


def round_repeats(n: int, depth_mult: float) -> int:
    return int(math.ceil(n * depth_mult))


def drop_path(x: torch.Tensor, rate: float) -> torch.Tensor:
    """Stochastic depth on a residual branch: one keep draw a sample, from
    the device's default generator. Under dp x sp the ``Trainer`` seeds it
    per dp group, so the bands of one image draw the same mask."""
    keep = 1.0 - rate
    mask = torch.empty((x.shape[0], 1, 1, 1), device=x.device,
                       dtype=x.dtype).bernoulli_(keep)
    return x * mask / keep


class SqueezeExcite(nn.Module):
    """Global pool (in f32, ``ops.global_avg_pool``: the whole image's mean
    on bands too) -> 1x1 reduce -> SiLU -> 1x1 expand -> sigmoid gate (in
    f32)."""

    def __init__(self, channels: int, se_ch: int):
        super().__init__()
        self.conv_reduce = conv(channels, se_ch, 1, bias=True)
        self.conv_expand = conv(se_ch, channels, 1, bias=True)

    def forward(self, x):
        s = global_avg_pool(upcast(x)).to(x.dtype)
        s = self.conv_expand(F.silu(self.conv_reduce(s)))
        return x * torch.sigmoid(upcast(s)).to(x.dtype)


class MBConv(nn.Module):
    """Mobile inverted bottleneck with SE, timm's names."""

    def __init__(self, cin: int, features: int, expand: int,
                 kernel: int = 3, stride: int = 1, dilation: int = 1,
                 se_ratio: float = 0.25, drop_path: float = 0.0):
        super().__init__()
        mid = cin * expand
        self.expand = expand
        self.drop_path = drop_path
        self.residual = stride == 1 and cin == features
        dw = Conv2d(mid, mid, kernel, stride=stride,
                    padding=(kernel - 1) // 2 * dilation, dilation=dilation,
                    groups=mid, bias=False)
        se = (SqueezeExcite(mid, max(1, int(cin * se_ratio)))
              if se_ratio > 0 else None)
        if expand != 1:
            self.conv_pw = conv(cin, mid, 1)
            self.bn1 = Norm(mid, BN_EPS)
            self.conv_dw = dw
            self.bn2 = Norm(mid, BN_EPS)
            self.se = se
            self.conv_pwl = conv(mid, features, 1)
            self.bn3 = Norm(features, BN_EPS)
        else:
            self.conv_dw = dw
            self.bn1 = Norm(mid, BN_EPS)
            self.se = se
            self.conv_pw = conv(mid, features, 1)
            self.bn2 = Norm(features, BN_EPS)

    def forward(self, x):
        if self.expand != 1:
            y = F.silu(self.bn1(self.conv_pw(x)))
            y = F.silu(self.bn2(self.conv_dw(y)))
            project, norm = self.conv_pwl, self.bn3
        else:
            y = F.silu(self.bn1(self.conv_dw(x)))
            project, norm = self.conv_pw, self.bn2
        if self.se is not None:
            y = self.se(y)
        y = norm(project(y))
        if self.residual:
            if self.training and self.drop_path > 0:
                y = drop_path(y, self.drop_path)
            y = y + x
        return y


class EfficientNetB4(nn.Module):
    """B4 trunk over an NCHW image (cast to ``dtype``, channels_last)
    -> (s2 24 ch, s4 32 ch, high 448 ch) at output stride 8."""

    def __init__(self, output_stride: int = 8, width_mult: float = _B4_WIDTH,
                 depth_mult: float = _B4_DEPTH, drop_path_rate: float = 0.2,
                 dtype=torch.bfloat16, remat: bool = False):
        super().__init__()
        assert output_stride == 8, "stride-8 only (like the reference)"
        self.dtype = dtype
        self.remat = bool(remat)
        stem_ch = round_filters(32, width_mult)
        self.conv_stem = conv(3, stem_ch, 3, 2)
        self.bn1 = Norm(stem_ch, BN_EPS)
        repeats = [round_repeats(n, depth_mult) for (_, _, n, _, _)
                   in _B0_STAGES]
        total, done = sum(repeats), 0
        current_stride, dilation = 2, 1  # after the stem
        cin = stem_ch
        stages = []
        for si, (expand, c, _, stride, kernel) in enumerate(_B0_STAGES):
            features = round_filters(c, width_mult)
            # the dilated rewrite past the output stride
            if stride == 2 and current_stride >= output_stride:
                dilation *= 2
                stride = 1
            blocks = []
            for bi in range(repeats[si]):
                blocks.append(MBConv(
                    cin, features, expand, kernel,
                    stride if bi == 0 else 1, dilation,
                    drop_path=drop_path_rate * done / total))
                cin = features
                done += 1
            if stride == 2:
                current_stride *= 2
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)

    @spanned("model.trunk")
    def forward(self, x):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = F.silu(self.bn1(self.conv_stem(x)))
        remat = self.remat and self.training and torch.is_grad_enabled()
        taps = []
        for stage in self.blocks:
            for blk in stage:
                x = remat_call(blk, x) if remat else blk(x)
            taps.append(x)
        return taps[0], taps[1], x
