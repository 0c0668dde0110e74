"""mscale2: the attention predicted from the CONCATENATED features of both
scales (port of ``tpuseg/models/mscale2.py``; reference:
network/mscale2.py), instead of the low scale's features alone.

Models take an NHWC image and return ``{"pred", "attn_10x"}`` NHWC.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from tpuseg_torch.models.deepv3 import DeepV3Plus
from tpuseg_torch.models.layers import AttnHead, SegHead
from tpuseg_torch.models.ocrnet import to_nchw, to_nhwc
from tpuseg_torch.models.trunks import get_trunk
from tpuseg_torch.ops import resize_x, scale_as


class _AttnHeadNoSigmoidLast(nn.Sequential):
    """conv3x3-BN-relu x2 -> 1x1 -> sigmoid in f32, 256 wide: the
    reference's hard-coded Sequential (mscale2.py:193-202), convs at
    ``.0``, ``.3``, ``.6``, BNs at ``.1``, ``.4``, as ``SegHead``. Despite
    the name it ends in a sigmoid."""

    def __init__(self, cin: int, bot_ch: int = 256):
        super().__init__(*SegHead(cin, 1, bot_ch))

    def forward(self, x):
        return torch.sigmoid(super().forward(x).float())


def _nscale2(model, x_1x, scales):
    """(reference: mscale2.py:55-129) The attention of each scale after
    the first reads its features and the previous scale's."""
    scales = sorted((float(s) for s in scales), reverse=True)
    if 1.0 not in scales:
        raise ValueError(f"1.0 must be among eval scales, got {scales}")
    ac = model.align_corners
    pred = last_feats = attn = None
    for s in scales:
        x = x_1x if s == 1.0 else resize_x(x_1x, s, ac)
        p, feats = model._fwd(x)
        p = p.float()
        if pred is not None:
            last_s = scale_as(last_feats, feats, ac).to(feats.dtype)
            attn = model.scale_attn(torch.cat([feats, last_s], dim=1))
            attn = scale_as(attn, p, ac)
        if pred is None:
            pred = p
        elif s >= 1.0:
            pred = scale_as(pred, p, ac)
            pred = attn * p + (1.0 - attn) * pred
        else:
            p = scale_as(attn * p, pred, ac)
            attn = scale_as(attn, pred, ac)
            pred = p + (1.0 - attn) * pred
        last_feats = feats
    return {"pred": pred, "attn_10x": attn}


class MscaleV3Plus2(DeepV3Plus):
    """DeepLabV3+ with the attention from both scales' decoder concat, at
    the low scale's feature resolution (reference: mscale2.py:165-225)."""

    def __init__(self, num_classes: int, trunk: str = "wrn38",
                 n_scales: Sequence[float] = (), lo_scale: float = 0.5,
                 align_corners: bool = False, remat=False,
                 fused_stage1: bool = False, dtype=torch.bfloat16):
        super().__init__(num_classes, trunk, align_corners=align_corners,
                         remat=remat, fused_stage1=fused_stage1, dtype=dtype)
        self.n_scales = tuple(n_scales)
        self.lo_scale = lo_scale
        self.scale_attn = _AttnHeadNoSigmoidLast(2 * (256 + 48))

    def _fwd(self, x):
        return self.decode(x, *self.features(x))

    def forward(self, x):
        x = to_nchw(x)
        if not self.training and self.n_scales:
            out = _nscale2(self, x, self.n_scales)
        else:
            out = self._two_scale(x)
        return {k: to_nhwc(v) for k, v in out.items()}

    def _two_scale(self, x_1x):
        """(reference: mscale2.py:131-157)"""
        ac = self.align_corners
        p_lo, feats_lo = self._fwd(resize_x(x_1x, self.lo_scale, ac))
        p_1x, feats_hi = self._fwd(x_1x)
        feats_hi_s = scale_as(feats_hi, feats_lo, ac).to(feats_lo.dtype)
        attn = self.scale_attn(torch.cat([feats_lo, feats_hi_s], dim=1))
        attn = scale_as(attn, p_lo, ac)
        p_lo = scale_as(attn * p_lo.float(), p_1x, ac)
        attn_1x = scale_as(attn, p_1x, ac)
        return {"pred": p_lo + (1.0 - attn_1x) * p_1x.float(),
                "attn_10x": attn_1x}


class Basic2(nn.Module):
    """Trunk + seg head, the attention from both scales' trunk features
    (reference: mscale2.py:231-282). The two-scale pass scales the low
    scale's features UP to the high scale's (mscale2.py:253-256), the
    opposite of ``MscaleV3Plus2``. The reference class does not construct
    (make_attn_head takes no ``bot_ch``, mscale2.py:243 vs utils.py:343);
    this is tpuseg's reading of its intent: make_attn_head 256 wide."""

    def __init__(self, num_classes: int, trunk: str = "hrnetv2",
                 n_scales: Sequence[float] = (), lo_scale: float = 0.5,
                 align_corners: bool = False, attn_old_arch: bool = False,
                 remat=False, fused_stage1: bool = False,
                 dtype=torch.bfloat16):
        super().__init__()
        self.n_scales = tuple(n_scales)
        self.lo_scale = lo_scale
        self.align_corners = align_corners
        self.backbone, _, _, high_ch = get_trunk(
            trunk, remat=remat, dtype=dtype, align_corners=align_corners,
            fused_stage1=fused_stage1)
        self.cls_head = SegHead(high_ch, num_classes, 256)
        self.scale_attn = AttnHead(2 * high_ch, out_ch=1, bot_ch=256,
                                   old_arch=attn_old_arch)

    def _fwd(self, x):
        _, _, high = self.backbone(x)
        pred = scale_as(self.cls_head(high).float(), x, self.align_corners)
        return pred, high

    def forward(self, x):
        x = to_nchw(x)
        if not self.training and self.n_scales:
            out = _nscale2(self, x, self.n_scales)
        else:
            out = self._two_scale(x)
        return {k: to_nhwc(v) for k, v in out.items()}

    def _two_scale(self, x_1x):
        """(reference: mscale2.py:242-268)"""
        ac = self.align_corners
        p_lo, feats_lo = self._fwd(resize_x(x_1x, self.lo_scale, ac))
        p_1x, feats_hi = self._fwd(x_1x)
        feats_lo_s = scale_as(feats_lo, feats_hi, ac).to(feats_hi.dtype)
        attn = self.scale_attn(torch.cat([feats_lo_s, feats_hi], dim=1))
        attn_lo = scale_as(attn, p_lo, ac)
        attn_1x = scale_as(attn, p_1x, ac)
        p_lo = scale_as(attn_lo * p_lo, p_1x, ac)
        return {"pred": p_lo + (1.0 - attn_1x) * p_1x, "attn_10x": attn_1x}


def _common(cfg):
    return dict(num_classes=cfg.dataset.num_classes,
                n_scales=tuple(cfg.model.n_scales or ()),
                lo_scale=cfg.model.mscale_lo_scale,
                align_corners=cfg.model.align_corners,
                remat=cfg.model.remat,
                fused_stage1=cfg.model.fused_stage1,
                dtype=getattr(torch, cfg.model.compute_dtype))


# factory -> (class, trunk)
FACTORIES = {"DeepV3R50": (MscaleV3Plus2, "resnet-50"),
             "DeepV3W38": (MscaleV3Plus2, "wrn38"),
             "HRNet": (Basic2, "hrnetv2")}


def DeepV3R50(cfg):
    """Factory: MscaleV3Plus2 on resnet-50."""
    return MscaleV3Plus2(trunk="resnet-50", **_common(cfg))


def DeepV3W38(cfg):
    """Factory: MscaleV3Plus2 on wrn38."""
    return MscaleV3Plus2(trunk="wrn38", **_common(cfg))


def HRNet(cfg):
    """Factory: Basic2 on HRNetV2-W48 (its attention head reads
    ``model.mscale_old_arch``; MscaleV3Plus2's hard-coded one does not)."""
    return Basic2(trunk="hrnetv2", attn_old_arch=cfg.model.mscale_old_arch,
                  **_common(cfg))
