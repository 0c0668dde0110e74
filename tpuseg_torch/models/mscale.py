"""Multi-scale attention over DeepLabV3+, Deeper, Basic and ASPP heads
(port of ``tpuseg/models/mscale.py``; reference: network/mscale.py).

These differ from ``MscaleOCR`` in three ways: no aux head, the attention
head reads the decoder's features, and ``fuse_aspp`` feeds the low scale's
ASPP features into the next scale's pass, weighted by its attention, with
``attn_2b`` a 2-channel attention head whose channel 0 weighs the logits
and channel 1 the ASPP features.

Models take an NHWC image and return a dict of NHWC tensors. Train mode
runs the fused two-scale forward; eval runs n-scale fusion over
``n_scales`` (two-scale when it is empty). Each class keeps the
reference's state-dict names: its decoder's (``deepv3.DeepV3Plus``,
``deeper.DeeperS8``, ``basic.ASPPModel``, ``cls_head``) and
``scale_attn``, make_attn_head's layout (``layers.AttnHead``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from tpuseg_torch.models.basic import ASPPModel
from tpuseg_torch.models.deeper import DeeperS8
from tpuseg_torch.models.deepv3 import DeepV3Plus
from tpuseg_torch.models.layers import AttnHead, SegHead
from tpuseg_torch.models.mscale_core import nscale_fuse, two_scale_fuse
from tpuseg_torch.models.ocrnet import to_nchw, to_nhwc
from tpuseg_torch.models.trunks import get_trunk
from tpuseg_torch.ops import resize_x, scale_as


class _Mscale(nn.Module):
    """Shared forward dispatch (reference MscaleBase.forward:
    mscale.py:222-229). A subclass sets ``n_scales``, ``lo_scale``,
    ``align_corners``, ``fuse_aspp`` and ``attn_2b``, and defines
    ``_fwd(x, aspp_lo=None, aspp_attn=None) -> {'cls_out', 'logit_attn',
    'aspp_attn', 'aspp'}`` over an NCHW image, outputs at its size."""

    fuse_aspp = False
    attn_2b = False

    def _mscale_init(self, n_scales, lo_scale, align_corners):
        self.n_scales = tuple(n_scales)
        self.lo_scale = lo_scale
        self.align_corners = align_corners

    def forward(self, x):
        x = to_nchw(x)
        if not self.training and self.n_scales:
            if self.fuse_aspp:
                out = self._nscale_fused(x)
            else:
                out = nscale_fuse(self._fwd, x, self.n_scales,
                                  self.align_corners)
        else:
            fwd_hi = None
            if self.fuse_aspp:
                fwd_hi = lambda xi, lo: self._fwd(  # noqa: E731
                    xi, aspp_lo=lo["aspp"], aspp_attn=lo["aspp_attn"])
            out = two_scale_fuse(self._fwd, x, self.lo_scale,
                                 self.align_corners, fwd_hi=fwd_hi)
        return {k: to_nhwc(v) for k, v in out.items()}

    def _nscale_fused(self, x_1x):
        """Recursive low -> high fused-ASPP eval (reference
        recurse_fuse_fwd: mscale.py:53-112): each scale's pass takes the
        next lower scale's ASPP features and attention."""
        scales = sorted((float(s) for s in self.n_scales), reverse=True)
        if 1.0 not in scales:
            raise ValueError(f"1.0 must be among eval scales, got {scales}")
        ac = self.align_corners

        def recurse(aspp_lo, aspp_attn):
            s = scales.pop()
            x = x_1x if s == 1.0 else resize_x(x_1x, s, ac)
            o = self._fwd(x, aspp_lo=aspp_lo, aspp_attn=aspp_attn)
            p, attn = o["cls_out"].float(), o["logit_attn"].float()
            if s != 1.0:
                p, attn = scale_as(p, x_1x, ac), scale_as(attn, x_1x, ac)
            if not scales:
                return p, attn
            p_next, _ = recurse(o["aspp"], o["aspp_attn"])
            return attn * p + (1.0 - attn) * p_next, attn

        pred, attn = recurse(None, None)
        return {"pred": pred, "attn_10x": attn}

    def _outputs(self, out, attn, aspp):
        if self.attn_2b:
            return {"cls_out": out, "logit_attn": attn[:, 0:1],
                    "aspp_attn": attn[:, 1:], "aspp": aspp}
        return {"cls_out": out, "logit_attn": attn, "aspp_attn": attn,
                "aspp": aspp}


def _fuse_aspp(aspp, aspp_lo, aspp_attn, align_corners):
    """The low scale's ASPP features, weighted by its attention, mixed into
    this scale's in f32 and cast back (reference: mscale.py:296-328)."""
    attn = scale_as(aspp_attn, aspp, align_corners)
    lo = scale_as(aspp_lo, aspp, align_corners)
    return (attn * lo + (1.0 - attn) * aspp.float()).to(aspp.dtype)


class MscaleV3Plus(_Mscale, DeepV3Plus):
    """DeepLabV3+ + multi-scale attention (reference: mscale.py:232-328);
    the attention head reads the decoder's 304-channel concat."""

    def __init__(self, num_classes: int, trunk: str = "wrn38",
                 use_dpc: bool = False, fuse_aspp: bool = False,
                 attn_2b: bool = False, n_scales: Sequence[float] = (),
                 lo_scale: float = 0.5, align_corners: bool = False,
                 bot_ch: int = 256, attn_inner_3x3: bool = True,
                 attn_old_arch: bool = False, attn_dropout: bool = False,
                 remat=False, fused_stage1: bool = False,
                 dtype=torch.bfloat16):
        DeepV3Plus.__init__(self, num_classes, trunk, use_dpc,
                            align_corners, remat, fused_stage1, dtype,
                            bot_ch)
        self._mscale_init(n_scales, lo_scale, align_corners)
        self.fuse_aspp, self.attn_2b = fuse_aspp, attn_2b
        self.scale_attn = AttnHead(256 + 48, 2 if attn_2b else 1, bot_ch,
                                   attn_inner_3x3, attn_dropout,
                                   attn_old_arch)

    def _fwd(self, x, aspp_lo=None, aspp_attn=None):
        """(reference: mscale.py:296-328)"""
        s2, aspp = self.features(x)
        if aspp_lo is not None and aspp_attn is not None:
            aspp = _fuse_aspp(aspp, aspp_lo, aspp_attn, self.align_corners)
        out, cat_s4 = self.decode(x, s2, aspp)
        attn = scale_as(self.scale_attn(cat_s4), x, self.align_corners)
        return self._outputs(out, attn, aspp)


class MscaleDeeper(_Mscale, DeeperS8):
    """The Deeper decoder + multi-scale attention (reference:
    mscale.py:363-433); the attention head reads ``conv_up3``'s output."""

    def __init__(self, num_classes: int, trunk: str = "wrn38",
                 fuse_aspp: bool = False, attn_2b: bool = False,
                 n_scales: Sequence[float] = (), lo_scale: float = 0.5,
                 align_corners: bool = False, bot_ch: int = 256,
                 attn_inner_3x3: bool = True, attn_old_arch: bool = False,
                 attn_dropout: bool = False, remat=False,
                 fused_stage1: bool = False, dtype=torch.bfloat16):
        DeeperS8.__init__(self, num_classes, trunk, align_corners, remat,
                          fused_stage1, dtype)
        self._mscale_init(n_scales, lo_scale, align_corners)
        self.fuse_aspp, self.attn_2b = fuse_aspp, attn_2b
        self.scale_attn = AttnHead(256, 2 if attn_2b else 1, bot_ch,
                                   attn_inner_3x3, attn_dropout,
                                   attn_old_arch)

    def _fwd(self, x, aspp_lo=None, aspp_attn=None):
        """(reference: mscale.py:399-433)"""
        s2, s4, aspp = self.features(x)
        if aspp_lo is not None and aspp_attn is not None:
            aspp = _fuse_aspp(aspp, aspp_lo, aspp_attn, self.align_corners)
        out, up3 = self.decode(s2, s4, aspp)
        attn = resize_x(self.scale_attn(up3), 2.0, self.align_corners)
        return self._outputs(out, attn, aspp)


class MscaleBasic(_Mscale):
    """Trunk + seg head + multi-scale attention, both heads on the trunk's
    features (reference: mscale.py:450-476)."""

    def __init__(self, num_classes: int, trunk: str = "hrnetv2",
                 n_scales: Sequence[float] = (), lo_scale: float = 0.5,
                 align_corners: bool = False, bot_ch: int = 256,
                 attn_inner_3x3: bool = True, attn_old_arch: bool = False,
                 attn_dropout: bool = False, remat=False,
                 fused_stage1: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self._mscale_init(n_scales, lo_scale, align_corners)
        self.backbone, _, _, high_ch = get_trunk(
            trunk, remat=remat, dtype=dtype, align_corners=align_corners,
            fused_stage1=fused_stage1)
        self.cls_head = SegHead(high_ch, num_classes, bot_ch)
        self.scale_attn = AttnHead(high_ch, 1, bot_ch, attn_inner_3x3,
                                   attn_dropout, attn_old_arch)

    def _fwd(self, x, aspp_lo=None, aspp_attn=None):
        _, _, high = self.backbone(x)
        ac = self.align_corners
        pred = scale_as(self.cls_head(high).float(), x, ac)
        attn = scale_as(self.scale_attn(high), x, ac)
        return self._outputs(pred, attn, high)


class MscaleASPP(_Mscale, ASPPModel):
    """trunk -> ASPP -> bot 1x1 -> seg head + attention head, multi-scale
    (reference ASPP(MscaleBase): mscale.py:479-511)."""

    def __init__(self, num_classes: int, trunk: str = "hrnetv2",
                 aspp_bot_ch: int = 256, n_scales: Sequence[float] = (),
                 lo_scale: float = 0.5, align_corners: bool = False,
                 bot_ch: int = 256, attn_inner_3x3: bool = True,
                 attn_old_arch: bool = False, attn_dropout: bool = False,
                 remat=False, fused_stage1: bool = False,
                 dtype=torch.bfloat16):
        ASPPModel.__init__(self, num_classes, trunk, aspp_bot_ch,
                           align_corners, bot_ch, remat, fused_stage1,
                           dtype)
        self._mscale_init(n_scales, lo_scale, align_corners)
        self.scale_attn = AttnHead(256, 1, bot_ch, attn_inner_3x3,
                                   attn_dropout, attn_old_arch)

    def _fwd(self, x, aspp_lo=None, aspp_attn=None):
        """(reference: mscale.py:496-511)"""
        aspp = self.features(x)
        ac = self.align_corners
        pred = scale_as(self.final(aspp).float(), x, ac)
        attn = scale_as(self.scale_attn(aspp), x, ac)
        return self._outputs(pred, attn, aspp)


def _common(cfg):
    return dict(num_classes=cfg.dataset.num_classes,
                n_scales=tuple(cfg.model.n_scales or ()),
                lo_scale=cfg.model.mscale_lo_scale,
                align_corners=cfg.model.align_corners,
                bot_ch=cfg.model.segattn_bot_ch,
                attn_inner_3x3=cfg.model.mscale_inner_3x3,
                attn_old_arch=cfg.model.mscale_old_arch,
                attn_dropout=cfg.model.mscale_dropout,
                remat=cfg.model.remat,
                fused_stage1=cfg.model.fused_stage1,
                dtype=getattr(torch, cfg.model.compute_dtype))


# factory -> (class, trunk, fixed arguments) (reference: mscale.py:331-360,
# 436-447, 474-515). EffB4 is dead code in the reference (its get_trunk has
# no efficientnet_b4 branch); tpuseg's working trunk here
FACTORIES = {
    "DeepV3R50": (MscaleV3Plus, "resnet-50", {}),
    "DeepV3W38": (MscaleV3Plus, "wrn38", {}),
    "DeepV3W38Fuse": (MscaleV3Plus, "wrn38", {"fuse_aspp": True}),
    "DeepV3W38Fuse2": (MscaleV3Plus, "wrn38",
                       {"fuse_aspp": True, "attn_2b": True}),
    "DeepV3X71": (MscaleV3Plus, "xception71", {}),
    "DeepV3EffB4": (MscaleV3Plus, "efficientnet_b4", {}),
    "DeepV3EffB4Fuse": (MscaleV3Plus, "efficientnet_b4",
                        {"fuse_aspp": True}),
    "DeeperW38": (MscaleDeeper, "wrn38", {}),
    "DeeperX71": (MscaleDeeper, "xception71", {}),
    "DeeperEffB4": (MscaleDeeper, "efficientnet_b4", {}),
    "Basic": (MscaleBasic, "hrnetv2", {}),
    "HRNet": (MscaleBasic, "hrnetv2", {}),
    "HRNet_ASP": (MscaleASPP, "hrnetv2", {}),
    "DeepV3W38Tiny": (MscaleV3Plus, "wrn38_tiny", {"bot_ch": 16}),
}


def _factory(name):
    cls, trunk, fixed = FACTORIES[name]

    def build(cfg):
        kw = {**_common(cfg), **fixed}
        if cls is MscaleASPP:
            kw["aspp_bot_ch"] = cfg.model.aspp_bot_ch
        return cls(trunk=trunk, **kw)

    build.__name__ = build.__qualname__ = name
    build.__doc__ = f"Factory: {cls.__name__} on {trunk}, {fixed}."
    return build


DeepV3R50 = _factory("DeepV3R50")
DeepV3W38 = _factory("DeepV3W38")
DeepV3W38Fuse = _factory("DeepV3W38Fuse")
DeepV3W38Fuse2 = _factory("DeepV3W38Fuse2")
DeepV3X71 = _factory("DeepV3X71")
DeepV3EffB4 = _factory("DeepV3EffB4")
DeepV3EffB4Fuse = _factory("DeepV3EffB4Fuse")
DeeperW38 = _factory("DeeperW38")
DeeperX71 = _factory("DeeperX71")
DeeperEffB4 = _factory("DeeperEffB4")
Basic = _factory("Basic")
HRNet = _factory("HRNet")
HRNet_ASP = _factory("HRNet_ASP")
DeepV3W38Tiny = _factory("DeepV3W38Tiny")
