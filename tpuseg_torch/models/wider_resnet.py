"""WideResNet-38 trunk (pre-activation identity residual blocks), output
stride 8.

Port of ``tpuseg/models/wider_resnet.py`` (reference: network/
wider_resnet.py, WiderResNetA2 + the wrn38 wrapper). Structure
[3, 3, 6, 3, 1, 1]; max-pool downsampling before mod2 / mod3, a strided
conv in mod4, dilation 2 in mod5 and 4 in mod6 / mod7; per-channel dropout
(``nn.Dropout2d``: ``tpuseg`` broadcasts its mask over H and W) 0.3 in mod6
and 0.5 in mod7. Taps: s2 after mod2, s4 after mod3, high after mod7 taken
before activation (the wrapper applies no ``bn_out``,
wider_resnet.py:425-435).

State-dict names are the reference's: ``mod1.conv1``,
``mod{m}.block{b}.bn1.0``, ``.proj_conv``, ``.convs.conv{i}``,
``.convs.bn{i}.0``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn as nn

from tpuseg_torch.models.hrnet import remat_call
from tpuseg_torch.models.layers import bn_relu, conv
from tpuseg_torch.ops import max_pool2d
from tpuseg_torch.utils.profiling import spanned


class IdentityResidualBlock(nn.Module):
    """Pre-activation residual block, 2-conv (wide) or 3-conv (bottleneck)
    (reference: wider_resnet.py:67-185)."""

    def __init__(self, cin: int, channels: Sequence[int], stride: int = 1,
                 dilation: int = 1, dropout: float = 0.0):
        super().__init__()
        c = tuple(channels)
        self.bn1 = bn_relu(cin)
        self.proj_conv = (conv(cin, c[-1], 1, stride)
                          if stride != 1 or cin != c[-1] else None)
        drop = [("dropout", nn.Dropout2d(dropout))] if dropout else []
        if len(c) == 2:
            layers = [("conv1", conv(cin, c[0], 3, stride,
                                     dilation=dilation)),
                      ("bn2", bn_relu(c[0])), *drop,
                      ("conv2", conv(c[0], c[1], 3, dilation=dilation))]
        else:
            layers = [("conv1", conv(cin, c[0], 1, stride)),
                      ("bn2", bn_relu(c[0])),
                      ("conv2", conv(c[0], c[1], 3, dilation=dilation)),
                      ("bn3", bn_relu(c[1])), *drop,
                      ("conv3", conv(c[1], c[2], 1))]
        self.convs = nn.Sequential(OrderedDict(layers))

    def forward(self, x):
        bn1 = self.bn1(x)
        shortcut = x if self.proj_conv is None else self.proj_conv(bn1)
        return self.convs(bn1) + shortcut


# module channel plans (reference: wider_resnet.py:317-318)
CHANNELS = ((128, 128), (256, 256), (512, 512), (512, 1024),
            (512, 1024, 2048), (1024, 2048, 4096))
# the tiny variant for tests: the same topology, one narrow block a module
TINY_WRN_STRUCTURE = (1, 1, 1, 1, 1, 1)
TINY_WRN_CHANNELS = ((8, 8), (16, 16), (16, 16), (16, 32),
                     (16, 32, 48), (32, 48, 64))


class WRN38(nn.Module):
    """Dilated WideResNet-38-A2 trunk over an NCHW image (cast to
    ``dtype``, channels_last). Returns ``(s2, s4, high)``."""

    def __init__(self, structure: Sequence[int] = (3, 3, 6, 3, 1, 1),
                 channels: Sequence = CHANNELS, stem_ch: int = 64,
                 dtype=torch.bfloat16, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = bool(remat)
        self.mod1 = nn.Sequential(OrderedDict(conv1=conv(3, stem_ch, 3)))
        cin = stem_ch
        for mod_id, num in enumerate(structure):
            # the dilated stride-8 plan (reference: wider_resnet.py:326-333)
            dil = 2 if mod_id == 3 else (4 if mod_id > 3 else 1)
            drop = {4: 0.3, 5: 0.5}.get(mod_id, 0.0)
            blocks = []
            for block_id in range(num):
                stride = 2 if block_id == 0 and mod_id == 2 else 1
                blocks.append((f"block{block_id + 1}", IdentityResidualBlock(
                    cin, channels[mod_id], stride, dil, drop)))
                cin = channels[mod_id][-1]
            setattr(self, f"mod{mod_id + 2}", nn.Sequential(OrderedDict(
                blocks)))
        self.n_mods = len(structure)

    @spanned("model.trunk")
    def forward(self, x):
        x = self.mod1(
            x.to(self.dtype).contiguous(memory_format=torch.channels_last))
        remat = self.remat and self.training and torch.is_grad_enabled()
        taps = []
        for mod_id in range(self.n_mods):
            if mod_id < 2:  # maxpool before mod2 / mod3
                x = max_pool2d(x, 3, 2, 1)
            for blk in getattr(self, f"mod{mod_id + 2}"):
                x = remat_call(blk, x) if remat else blk(x)
            taps.append(x)
        return taps[0], taps[1], x
