"""DeepLabV3+ and DeepLabV3 (port of ``tpuseg/models/deepv3.py``;
reference: network/deepv3.py).

Models take an NHWC image and return ``{"pred": NHWC f32 logits}`` at the
input's size, as ``tpuseg``'s do; inside they run NCHW-logical,
channels_last. State-dict names are the reference's: ``backbone.*``,
``aspp.*``, ``bot_fine``, ``bot_aspp`` and the ``final`` Sequential.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from tpuseg_torch.models.heads import make_aspp
from tpuseg_torch.models.layers import SegHead, conv
from tpuseg_torch.models.ocrnet import to_nchw, to_nhwc
from tpuseg_torch.models.trunks import get_trunk
from tpuseg_torch.ops import scale_as, upcast


class DeepV3Plus(nn.Module):
    """trunk -> ASPP -> bot_aspp (1x1 -> 256) || bot_fine (s2 -> 48) ->
    concat -> 3-conv final head -> upsample (reference: deepv3.py:40-93).
    Output stride 8. The attention-scale models on this decoder
    (``mscale``, ``mscale2``, ``attnscale``) subclass it; ``bot_ch`` is
    the width of their ``final`` head (the reference's SEGATTN_BOT_CH)."""

    def __init__(self, num_classes: int, trunk: str = "wrn38",
                 use_dpc: bool = False, align_corners: bool = False,
                 remat=False, fused_stage1: bool = False,
                 dtype=torch.bfloat16, bot_ch: int = 256):
        super().__init__()
        self.align_corners = align_corners
        self.backbone, s2_ch, _, high_ch = get_trunk(
            trunk, remat=remat, dtype=dtype, align_corners=align_corners,
            fused_stage1=fused_stage1)
        self.aspp, aspp_out_ch = make_aspp(high_ch, 256, output_stride=8,
                                           dpc=use_dpc)
        self.bot_fine = conv(s2_ch, 48, 1)
        self.bot_aspp = conv(aspp_out_ch, 256, 1)
        # the reference's final Sequential has make_seg_head's layout
        self.final = SegHead(256 + 48, num_classes, bot_ch)

    def features(self, x):
        """NCHW image -> (the trunk's s2 tap, ASPP features)."""
        s2, _, high = self.backbone(x)
        return s2, self.aspp(high)

    def decode(self, x, s2, aspp):
        """-> (f32 logits at ``x``'s size, the decoder's concat ``cat_s4``
        the attention heads read)."""
        conv_aspp = self.bot_aspp(aspp)
        conv_s2 = self.bot_fine(s2)
        conv_aspp = scale_as(conv_aspp, s2,
                             self.align_corners).to(conv_s2.dtype)
        cat_s4 = torch.cat([conv_s2, conv_aspp], dim=1)
        out = scale_as(upcast(self.final(cat_s4)), x, self.align_corners)
        return out, cat_s4

    def forward(self, x):
        x = to_nchw(x)
        return {"pred": to_nhwc(self.decode(x, *self.features(x))[0])}


class DeepV3(nn.Module):
    """trunk -> ASPP -> seg head (reference: deepv3.py:126-161)."""

    def __init__(self, num_classes: int, trunk: str = "resnet-50",
                 use_dpc: bool = False, output_stride: int = 8,
                 align_corners: bool = False, seg_bot_ch: int = 256,
                 remat=False, fused_stage1: bool = False,
                 dtype=torch.bfloat16):
        super().__init__()
        self.align_corners = align_corners
        self.backbone, _, _, high_ch = get_trunk(
            trunk, remat=remat, dtype=dtype, align_corners=align_corners,
            fused_stage1=fused_stage1)
        self.aspp, aspp_out_ch = make_aspp(high_ch, 256, output_stride,
                                           dpc=use_dpc)
        # the reference's make_seg_head reads SEGATTN_BOT_CH
        self.final = SegHead(aspp_out_ch, num_classes, seg_bot_ch)

    def forward(self, x):
        x = to_nchw(x)
        _, _, high = self.backbone(x)
        y = self.final(self.aspp(high))
        return {"pred": to_nhwc(scale_as(upcast(y), x, self.align_corners))}


def _kw(cfg):
    return dict(num_classes=cfg.dataset.num_classes,
                align_corners=cfg.model.align_corners,
                remat=cfg.model.remat,
                fused_stage1=cfg.model.fused_stage1,
                dtype=getattr(torch, cfg.model.compute_dtype))


# each factory's trunk (reference: deepv3.py:96-166). W38I's init_all only
# changes the reference's torch init; DeepWV3Plus is the recipes' alias;
# EffB4 is dead code in the reference (tpuseg's working trunk here)
TRUNKS = {
    "DeepV3PlusSRNX50": "seresnext-50",
    "DeepV3PlusR50": "resnet-50",
    "DeepV3PlusSRNX101": "seresnext-101",
    "DeepV3PlusW38": "wrn38",
    "DeepV3PlusW38I": "wrn38",
    "DeepV3PlusX71": "xception71",
    "DeepV3PlusEffB4": "efficientnet_b4",
    "DeepWV3Plus": "wrn38",
    "DeepV3PlusW38Tiny": "wrn38_tiny",
    "DeepV3R50": "resnet-50",
}


def band_geometry(name: str, cfg) -> tuple:
    """-> (trunk, train scales besides 1.0 and the two-scale pass) of
    factory ``name`` (``models.band_geometry``)."""
    return TRUNKS[name], ()


def _plus(factory):
    def build(cfg):
        return DeepV3Plus(trunk=TRUNKS[factory], **_kw(cfg))

    build.__name__ = build.__qualname__ = factory
    build.__doc__ = f"Factory: DeepLabV3+ on {TRUNKS[factory]}."
    return build


DeepV3PlusSRNX50 = _plus("DeepV3PlusSRNX50")
DeepV3PlusR50 = _plus("DeepV3PlusR50")
DeepV3PlusSRNX101 = _plus("DeepV3PlusSRNX101")
DeepV3PlusW38 = _plus("DeepV3PlusW38")
DeepV3PlusW38I = _plus("DeepV3PlusW38I")
DeepV3PlusX71 = _plus("DeepV3PlusX71")
DeepV3PlusEffB4 = _plus("DeepV3PlusEffB4")
DeepWV3Plus = _plus("DeepWV3Plus")
DeepV3PlusW38Tiny = _plus("DeepV3PlusW38Tiny")


def DeepV3R50(cfg):
    """Factory: DeepLabV3 on resnet-50, seg head width
    ``model.segattn_bot_ch``."""
    return DeepV3(trunk=TRUNKS["DeepV3R50"],
                  seg_bot_ch=cfg.model.segattn_bot_ch, **_kw(cfg))
