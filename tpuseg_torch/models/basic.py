"""Plain (single-scale) trunk + head models (port of
``tpuseg/models/basic.py``; reference: network/basic.py).

Models take an NHWC image and return ``{"pred": NHWC f32 logits}`` at the
input's size. ``infer_mscale`` does not promote them to n-scale, so
``EvalRunner`` runs them with ``is_mscale=False``.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from tpuseg_torch.models.heads import make_aspp
from tpuseg_torch.models.layers import SegHead, conv
from tpuseg_torch.models.ocrnet import to_nchw, to_nhwc
from tpuseg_torch.models.trunks import get_trunk
from tpuseg_torch.ops import scale_as, upcast


class Basic(nn.Module):
    """trunk -> seg head (reference: basic.py:38-64)."""

    def __init__(self, num_classes: int, trunk: str = "hrnetv2",
                 align_corners: bool = False, seg_bot_ch: int = 256,
                 remat=False, fused_stage1: bool = False,
                 dtype=torch.bfloat16):
        super().__init__()
        self.align_corners = align_corners
        self.backbone, _, _, high_ch = get_trunk(
            trunk, remat=remat, dtype=dtype, align_corners=align_corners,
            fused_stage1=fused_stage1)
        # the reference's make_seg_head reads SEGATTN_BOT_CH
        self.seg_head = SegHead(high_ch, num_classes, seg_bot_ch)

    def forward(self, x):
        x = to_nchw(x)
        _, _, high = self.backbone(x)
        pred = self.seg_head(high)
        return {"pred": to_nhwc(scale_as(upcast(pred), x,
                                         self.align_corners))}


class ASPPModel(nn.Module):
    """trunk -> ASPP -> bot 1x1 -> seg head (reference: basic.py:67-101).
    ``mscale.MscaleASPP`` adds its attention head on ``features``."""

    def __init__(self, num_classes: int, trunk: str = "hrnetv2",
                 aspp_bot_ch: int = 256, align_corners: bool = False,
                 seg_bot_ch: int = 256, remat=False,
                 fused_stage1: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.align_corners = align_corners
        self.backbone, _, _, high_ch = get_trunk(
            trunk, remat=remat, dtype=dtype, align_corners=align_corners,
            fused_stage1=fused_stage1)
        self.aspp, aspp_out_ch = make_aspp(high_ch, aspp_bot_ch,
                                           output_stride=8)
        self.bot_aspp = conv(aspp_out_ch, 256, 1)
        self.final = SegHead(256, num_classes, seg_bot_ch)

    def features(self, x):
        """NCHW image -> the 256-channel ``bot_aspp`` features."""
        _, _, high = self.backbone(x)
        return self.bot_aspp(self.aspp(high))

    def forward(self, x):
        x = to_nchw(x)
        pred = self.final(self.features(x))
        return {"pred": to_nhwc(scale_as(upcast(pred), x,
                                         self.align_corners))}


def _kw(cfg):
    return dict(num_classes=cfg.dataset.num_classes,
                align_corners=cfg.model.align_corners,
                seg_bot_ch=cfg.model.segattn_bot_ch,
                remat=cfg.model.remat,
                fused_stage1=cfg.model.fused_stage1,
                dtype=getattr(torch, cfg.model.compute_dtype))


# factory -> (class, trunk)
FACTORIES = {"HRNet": (Basic, "hrnetv2"),
             "HRNet_ASP": (ASPPModel, "hrnetv2")}


def band_geometry(name: str, cfg) -> tuple:
    """-> (trunk, train scales besides 1.0 and the two-scale pass) of
    factory ``name`` (``models.band_geometry``)."""
    return FACTORIES[name][1], ()


def HRNet(cfg):
    """Factory: HRNetV2-W48 -> seg head."""
    return Basic(trunk="hrnetv2", **_kw(cfg))


def HRNet_ASP(cfg):
    """Factory: HRNetV2-W48 -> ASPP (``model.aspp_bot_ch``) -> seg head."""
    return ASPPModel(trunk="hrnetv2", aspp_bot_ch=cfg.model.aspp_bot_ch,
                     **_kw(cfg))
