"""OCRNet and the flagship hierarchical multi-scale attention model.

Port of ``tpuseg/models/ocrnet.py`` (reference: network/ocrnet.py). Models
take an NHWC image and return a dict of NHWC tensors, as ``tpuseg``'s do;
inside they run NCHW-logical, channels_last. The loss is not in the model.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from tpuseg_torch.models.heads import make_aspp
from tpuseg_torch.models.hrnet import HRNetSpec, HRNetV2, TINY_SPEC, W48_SPEC
from tpuseg_torch.models.layers import AttnHead
from tpuseg_torch.models.mscale_core import nscale_fuse, two_scale_fuse
from tpuseg_torch.models.ocr import OCRBlock
from tpuseg_torch.ops import at_least_f32, scale_as, upcast
from tpuseg_torch.utils.profiling import span


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW-logical view (channels_last memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class OCRNet(nn.Module):
    """trunk -> OCR -> cls+aux, upsampled to input size
    (reference: network/ocrnet.py:94-122)."""

    def __init__(self, num_classes: int, spec: HRNetSpec = W48_SPEC,
                 mid_channels: int = 512, key_channels: int = 256,
                 ocr_dropout: float = 0.05, align_corners: bool = False,
                 use_pallas: bool = False, fused_stage1: bool = False,
                 dtype=torch.bfloat16, remat=False):
        super().__init__()
        self.align_corners = align_corners
        self.backbone = HRNetV2(spec, align_corners, dtype, fused_stage1,
                                remat)
        self.ocr = OCRBlock(spec.high_level_ch, num_classes, mid_channels,
                            key_channels, use_pallas, ocr_dropout)

    def forward(self, x):
        x = to_nchw(x)
        _, _, high = self.backbone(x)
        cls_out, aux_out, _ = self.ocr(high)
        # cast BEFORE the resize: the f32 island includes the interpolation
        with span("model.head"):
            return {
                "pred": to_nhwc(scale_as(upcast(cls_out), x,
                                         self.align_corners)),
                "aux": to_nhwc(scale_as(upcast(aux_out), x,
                                        self.align_corners)),
            }


class OCRNetASPP(nn.Module):
    """trunk -> ASPP -> OCR -> cls+aux (reference: network/ocrnet.py:
    125-155). ``use_pallas`` and ``fused_stage1`` reach the OCR block and
    the trunk as in ``OCRNet``."""

    def __init__(self, num_classes: int, spec: HRNetSpec = W48_SPEC,
                 mid_channels: int = 512, key_channels: int = 256,
                 ocr_dropout: float = 0.05, align_corners: bool = False,
                 use_pallas: bool = False, fused_stage1: bool = False,
                 dtype=torch.bfloat16, remat=False):
        super().__init__()
        self.align_corners = align_corners
        self.backbone = HRNetV2(spec, align_corners, dtype, fused_stage1,
                                remat)
        self.aspp, aspp_out_ch = make_aspp(spec.high_level_ch, 256,
                                           output_stride=8)
        self.ocr = OCRBlock(aspp_out_ch, num_classes, mid_channels,
                            key_channels, use_pallas, ocr_dropout)

    def forward(self, x):
        x = to_nchw(x)
        _, _, high = self.backbone(x)
        with span("model.head"):
            aspp = self.aspp(high)
        cls_out, aux_out, _ = self.ocr(aspp)
        with span("model.head"):
            return {
                "pred": to_nhwc(scale_as(upcast(cls_out), x,
                                         self.align_corners)),
                "aux": to_nhwc(scale_as(upcast(aux_out), x,
                                        self.align_corners)),
            }


class MscaleOCR(nn.Module):
    """Hierarchical multi-scale attention over HRNet-OCR
    (reference: network/ocrnet.py:158-334).

    Train: fused 0.5x + 1.0x two-scale forward, whatever ``n_scales`` is,
    so one module serves training and validation. Eval: chained n-scale
    fusion over ``n_scales`` (two-scale when ``n_scales`` is empty)."""

    def __init__(self, num_classes: int, spec: HRNetSpec = W48_SPEC,
                 mid_channels: int = 512, key_channels: int = 256,
                 ocr_dropout: float = 0.05,
                 n_scales: Sequence[float] = (0.5, 1.0, 2.0),
                 lo_scale: float = 0.5, align_corners: bool = False,
                 attn_bot_ch: int = 256, attn_inner_3x3: bool = True,
                 attn_dropout: bool = False, attn_old_arch: bool = False,
                 use_pallas: bool = False, fused_stage1: bool = False,
                 dtype=torch.bfloat16, fusion_dtype: str = "float32",
                 remat=False):
        super().__init__()
        self.n_scales = tuple(n_scales)
        self.lo_scale = lo_scale
        self.align_corners = align_corners
        self.fusion_dtype = getattr(torch, fusion_dtype)
        self.backbone = HRNetV2(spec, align_corners, dtype, fused_stage1,
                                remat)
        self.ocr = OCRBlock(spec.high_level_ch, num_classes, mid_channels,
                            key_channels, use_pallas, ocr_dropout)
        self.scale_attn = AttnHead(mid_channels, out_ch=1,
                                   bot_ch=attn_bot_ch,
                                   inner_3x3=attn_inner_3x3,
                                   dropout=attn_dropout,
                                   old_arch=attn_old_arch)

    def single_scale(self, x, need_aux: bool = True):
        """One trunk+OCR+attention pass on an NCHW image, outputs at input
        resolution (reference _fwd: ocrnet.py:170-183). ``need_aux=False``
        skips the aux upsample, which only training losses read."""
        _, _, high = self.backbone(x)
        cls_out, aux_out, ocr_mid = self.ocr(high)
        with span("model.head"):
            attn = self.scale_attn(ocr_mid)
            fdt = (self.fusion_dtype if not self.training
                   else at_least_f32(cls_out.dtype))
            out = {
                "cls_out": scale_as(cls_out.to(fdt), x, self.align_corners),
                "logit_attn": scale_as(attn.to(fdt), x, self.align_corners),
            }
            if need_aux:
                out["aux_out"] = scale_as(aux_out.to(fdt), x,
                                          self.align_corners)
        return out

    def forward(self, x):
        x = to_nchw(x)
        if not self.training and self.n_scales:
            out = nscale_fuse(lambda xi: self.single_scale(xi, False), x,
                              self.n_scales, self.align_corners)
        else:
            out = two_scale_fuse(self.single_scale, x, self.lo_scale,
                                 self.align_corners)
        return {k: to_nhwc(v) for k, v in out.items()}


def _common(cfg):
    return dict(
        num_classes=cfg.dataset.num_classes,
        mid_channels=cfg.model.ocr.mid_channels,
        key_channels=cfg.model.ocr.key_channels,
        ocr_dropout=cfg.model.ocr.dropout,
        align_corners=cfg.model.align_corners,
        use_pallas=cfg.model.use_pallas,
        fused_stage1=cfg.model.fused_stage1,
        dtype=getattr(torch, cfg.model.compute_dtype),
        remat=cfg.model.remat,
    )


def band_geometry(name: str, cfg) -> tuple:
    """-> (trunk, train scales besides 1.0 and the two-scale pass) of
    factory ``name`` (``models.band_geometry``):
    every factory here is HRNetV2 under an OCR head."""
    return "hrnetv2", ()


def HRNet(cfg):
    """Factory: plain HRNet-OCR (reference: ocrnet.py:337-338)."""
    return OCRNet(spec=W48_SPEC, **_common(cfg))


def HRNet_ASPP_OCR(cfg):
    """Factory: HRNet -> ASPP -> OCR (reference OCRNetASPP: ocrnet.py:125)."""
    return OCRNetASPP(spec=W48_SPEC, **_common(cfg))


def _mscale(cfg, spec, **over):
    kw = dict(
        spec=spec,
        n_scales=tuple(cfg.model.n_scales or ()),
        lo_scale=cfg.model.mscale_lo_scale,
        attn_bot_ch=cfg.model.segattn_bot_ch,
        attn_inner_3x3=cfg.model.mscale_inner_3x3,
        attn_dropout=cfg.model.mscale_dropout,
        attn_old_arch=cfg.model.mscale_old_arch,
        fusion_dtype=cfg.model.eval_fusion_dtype,
        **_common(cfg))
    kw.update(over)
    return MscaleOCR(**kw)


def HRNet_Mscale(cfg):
    """Factory: HRNet-OCR + multi-scale attention (reference: ocrnet.py:341-342)."""
    return _mscale(cfg, W48_SPEC)


def HRNet_Mscale_Tiny(cfg):
    """Tiny-width variant for smoke tests (tpuseg ocrnet.py:213-224)."""
    return _mscale(cfg, TINY_SPEC, attn_bot_ch=16, attn_dropout=False,
                   mid_channels=32, key_channels=16)
