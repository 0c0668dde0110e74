"""Attention-to-scale models: run every scale, predict the per-scale
attention maps jointly from the concatenated multi-scale features, and sum
the weighted predictions (port of ``tpuseg/models/attnscale.py``;
reference: network/attnscale.py:39-199). The same graph runs in train and
eval (``ASDV3P_Paired`` picks its scale list by mode).

Models take an NHWC image and return ``{"pred", "pred_{s}x",
"attn_{s}x"}`` NHWC, an asset a scale (2.0x included).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from tpuseg_torch.evaluation.metrics import fmt_scale
from tpuseg_torch.models.deepv3 import DeepV3Plus
from tpuseg_torch.models.layers import SegHead, conv
from tpuseg_torch.models.ocrnet import to_nchw, to_nhwc
from tpuseg_torch.ops import resize_x, scale_as


def _scale_attn(cin: int, n: int, bn_head: bool) -> nn.Sequential:
    """The attention head -> ``n`` channels, raw logits. BN head: 3x3 -
    BN - relu x2 -> 1x1, 256 wide, as ``SegHead`` (reference:
    attnscale.py:84-93). Plain: 3x3 (512) - relu -> 1x1 with the
    reference's padding=1, so the map is 2 px larger than its input and
    is then resized (attnscale.py:95-99)."""
    if bn_head:
        return SegHead(cin, n, 256)
    return nn.Sequential(conv(cin, 512, 3), nn.ReLU(),
                         conv(512, n, 1, padding=1))


class ASDV3P(DeepV3Plus):
    """DeepLabV3+ with joint multi-scale attention (reference:
    attnscale.py:39-199)."""

    def __init__(self, num_classes: int, trunk: str = "wrn38",
                 scales: Sequence[float] = (0.5, 1.0, 2.0),
                 use_dpc: bool = False, bn_head: bool = False,
                 align_corners: bool = False, remat=False,
                 fused_stage1: bool = False, dtype=torch.bfloat16,
                 n_attn: int | None = None):
        super().__init__(num_classes, trunk, use_dpc, align_corners, remat,
                         fused_stage1, dtype)
        self.scales = tuple(scales)
        n = n_attn or len(self.scales)
        self.scale_attn = _scale_attn(n * (256 + 48), n, bn_head)

    def _fwd(self, x):
        return self.decode(x, *self.features(x))

    def _all_scales(self, x, scales):
        """-> ({scale: f32 logits at x's size}, {scale: decoder features
        at the 1.0x features' size})."""
        if 1.0 not in scales:
            raise ValueError(f"1.0 must be among the scales, got {scales}")
        ac = self.align_corners
        preds, feats = {}, {}
        preds[1.0], feats[1.0] = self._fwd(x)
        for s in scales:
            if s == 1.0:
                continue
            p, f = self._fwd(resize_x(x, s, ac))
            preds[s] = scale_as(p, x, ac)
            feats[s] = scale_as(f, feats[1.0], ac).to(feats[1.0].dtype)
        return preds, feats

    def forward(self, x):
        """_forward_fused (reference: attnscale.py:139-185)."""
        x = to_nchw(x)
        scales = sorted(float(s) for s in self.scales)
        preds, feats = self._all_scales(x, scales)
        # the 1.0x features first, then the others in ascending order
        cat = [feats[1.0]] + [feats[s] for s in scales if s != 1.0]
        attn_all = self.scale_attn(torch.cat(cat, dim=1)).float()
        attn = {s: scale_as(attn_all[:, i:i + 1], x, self.align_corners)
                for i, s in enumerate(scales)}
        return _weighted_sum(preds, attn, scales)


def _weighted_sum(preds, attn, scales):
    out, output = {}, None
    for s in scales:
        contrib = preds[s] * attn[s]
        output = contrib if output is None else output + contrib
        out[fmt_scale("pred", s)] = to_nhwc(preds[s])
        out[fmt_scale("attn", s)] = to_nhwc(attn[s])
    out["pred"] = to_nhwc(output)
    return out


class ASDV3P_Paired(ASDV3P):
    """Pairwise variant: attention predicted for ADJACENT scale pairs from
    their concatenated features, then chain-normalized (reference:
    attnscale.py:199-366). ``trn_scales`` in train mode, ``inf_scales``
    in eval. The head sees two scales; its outputs are raw logits, BN head
    or plain (as tpuseg computes them)."""

    def __init__(self, num_classes: int, trunk: str = "wrn38",
                 inf_scales: Sequence[float] = (0.5, 1.0, 2.0),
                 trn_scales: Sequence[float] = (0.5, 1.0),
                 use_dpc: bool = False, bn_head: bool = False,
                 align_corners: bool = False, remat=False,
                 fused_stage1: bool = False, dtype=torch.bfloat16):
        super().__init__(num_classes, trunk, inf_scales, use_dpc, bn_head,
                         align_corners, remat, fused_stage1, dtype, n_attn=2)
        self.trn_scales = tuple(trn_scales)

    def forward(self, x):
        """_forward_paired (reference: attnscale.py:293-359)."""
        x = to_nchw(x)
        scales = sorted(float(s) for s in (
            self.trn_scales if self.training else self.scales))
        preds, feats = self._all_scales(x, scales)
        pair_attn = {}
        for lo, hi in zip(scales, scales[1:]):
            pa = self.scale_attn(torch.cat([feats[lo], feats[hi]], dim=1))
            pair_attn[lo] = scale_as(pa.float(), x, self.align_corners)
        # chain-normalize (reference: attnscale.py:330-345)
        attn, last = {}, None
        for lo, hi in zip(scales, scales[1:]):
            a_lo, a_hi = pair_attn[lo][:, 0:1], pair_attn[lo][:, 1:2]
            if last is None:
                attn[lo], attn[hi] = a_lo, a_hi
            else:
                renorm = last / (a_lo + a_hi + 1e-12)
                attn[lo], attn[hi] = a_lo * renorm, a_hi * renorm
            last = a_hi
        return _weighted_sum(preds, attn, scales)


def _common(cfg):
    return dict(num_classes=cfg.dataset.num_classes,
                scales=tuple(cfg.model.n_scales or (0.5, 1.0, 2.0)),
                bn_head=cfg.model.attnscale_bn_head,
                align_corners=cfg.model.align_corners,
                remat=cfg.model.remat,
                fused_stage1=cfg.model.fused_stage1,
                dtype=getattr(torch, cfg.model.compute_dtype))


# factory -> (class, trunk)
FACTORIES = {"DeepV3R50": (ASDV3P, "resnet-50"),
             "DeepV3R50B": (ASDV3P, "resnet-50"),
             "DeepV3W38": (ASDV3P, "wrn38"),
             "DeepV3R50BP": (ASDV3P_Paired, "resnet-50")}


def DeepV3R50(cfg):
    """Factory: ASDV3P on resnet-50, head by ``model.attnscale_bn_head``."""
    return ASDV3P(trunk="resnet-50", **_common(cfg))


def DeepV3R50B(cfg):
    """Factory: ASDV3P on resnet-50 with the BN head."""
    return ASDV3P(trunk="resnet-50", **{**_common(cfg), "bn_head": True})


def DeepV3W38(cfg):
    """Factory: ASDV3P on wrn38, head by ``model.attnscale_bn_head``."""
    return ASDV3P(trunk="wrn38", **_common(cfg))


def DeepV3R50BP(cfg):
    """Factory: paired attention with the BN head (reference:
    attnscale.py:370-372); ``model.n_scales`` are its inference scales."""
    kw = _common(cfg)
    kw["inf_scales"] = kw.pop("scales")
    return ASDV3P_Paired(trunk="resnet-50", **{**kw, "bn_head": True})
