"""Panoptic-DeepLab-style decoder with s2 + s4 skips, single-scale (port of
``tpuseg/models/deeper.py``; reference: network/deeper.py:36-91).

``mscale.MscaleDeeper`` puts an attention head on the same decoder.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from tpuseg_torch.models.heads import make_aspp
from tpuseg_torch.models.layers import ConvBnRelu, conv
from tpuseg_torch.models.ocrnet import to_nchw, to_nhwc
from tpuseg_torch.models.trunks import get_trunk
from tpuseg_torch.ops import resize_x


class DeeperS8(nn.Module):
    """trunk -> ASPP -> conv_up1, x2 || convs4(s4) -> conv_up2 (5x5), x2 ||
    convs2(s2) -> conv_up3 (5x5) -> conv_up5 classifier, x2."""

    def __init__(self, num_classes: int, trunk: str = "wrn38",
                 align_corners: bool = False, remat=False,
                 fused_stage1: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.align_corners = align_corners
        self.backbone, s2_ch, s4_ch, high_ch = get_trunk(
            trunk, remat=remat, dtype=dtype, align_corners=align_corners,
            fused_stage1=fused_stage1)
        self.aspp, aspp_out_ch = make_aspp(high_ch, 256, output_stride=8,
                                           align_corners=align_corners)
        self.convs2 = conv(s2_ch, 32, 1)
        self.convs4 = conv(s4_ch, 64, 1)
        self.conv_up1 = conv(aspp_out_ch, 256, 1)
        self.conv_up2 = ConvBnRelu(256 + 64, 256, 5, padding=2)
        self.conv_up3 = ConvBnRelu(256 + 32, 256, 5, padding=2)
        self.conv_up5 = conv(256, num_classes, 1)

    def features(self, x):
        """NCHW image -> (the trunk's s2 and s4 taps, ASPP features)."""
        s2, s4, high = self.backbone(x)
        return s2, s4, self.aspp(high)

    def decode(self, s2, s4, aspp):
        """-> (f32 logits at twice the s2 tap's size, ``conv_up3``'s output
        the attention head reads)."""
        ac = self.align_corners
        y = resize_x(self.conv_up1(aspp), 2.0, ac)
        y = self.conv_up2(torch.cat([y, self.convs4(s4)], dim=1))
        y = resize_x(y, 2.0, ac)
        up3 = self.conv_up3(torch.cat([y, self.convs2(s2)], dim=1))
        return resize_x(self.conv_up5(up3).float(), 2.0, ac), up3

    def forward(self, x):
        out, _ = self.decode(*self.features(to_nchw(x)))
        return {"pred": to_nhwc(out)}


def _kw(cfg):
    return dict(num_classes=cfg.dataset.num_classes,
                align_corners=cfg.model.align_corners,
                remat=cfg.model.remat,
                fused_stage1=cfg.model.fused_stage1,
                dtype=getattr(torch, cfg.model.compute_dtype))


# factory -> (class, trunk)
FACTORIES = {"DeeperW38": (DeeperS8, "wrn38"),
             "DeeperX71": (DeeperS8, "xception71")}


def DeeperW38(cfg):
    """Factory: the Deeper decoder on WRN38."""
    return DeeperS8(trunk="wrn38", **_kw(cfg))


def DeeperX71(cfg):
    """Factory: the Deeper decoder on Xception-71."""
    return DeeperS8(trunk="xception71", **_kw(cfg))
