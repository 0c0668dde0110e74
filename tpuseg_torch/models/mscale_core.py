"""Hierarchical multi-scale attention fusion — pure functions.

Port of ``tpuseg/models/mscale_core.py:33-130`` (reference:
network/ocrnet.py:185-327). The combinators run over a single-scale
forward ``fwd(x) -> {'cls_out', 'logit_attn'[, 'aux_out']}`` whose outputs
are at input resolution. Tensors here are NCHW-logical.

Exact reference order: high scale -> low scale; for s >= 1 the accumulated
prediction is downscaled to the current scale before fusing; for s < 1 the
current prediction is premultiplied by its attention, then upscaled.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from tpuseg_torch.evaluation.metrics import fmt_scale
from tpuseg_torch.ops import resize_x, scale_as, upcast

ForwardFn = Callable[[torch.Tensor], Dict[str, torch.Tensor]]


def two_scale_fuse(fwd: ForwardFn, x_1x: torch.Tensor, lo_scale: float = 0.5,
                   align_corners: bool = False,
                   fwd_hi=None) -> Dict[str, torch.Tensor]:
    """Fused two-scale forward (reference: ocrnet.py:264-327).

    ``fwd_hi(x, lo_out)``, when given, computes the high-scale pass with
    the low-scale output at hand (mscale's ``fuse_aspp``, reference:
    mscale.py:182-220); otherwise ``fwd`` runs at both scales."""
    lo = fwd(resize_x(x_1x, lo_scale, align_corners))
    hi = fwd_hi(x_1x, lo) if fwd_hi is not None else fwd(x_1x)

    pred_05x = upcast(lo["cls_out"])
    attn = upcast(lo["logit_attn"])
    p_1x = upcast(hi["cls_out"])

    # premultiply at low res, then upscale (reference: ocrnet.py:289-294)
    p_lo = scale_as(attn * pred_05x, p_1x, align_corners)
    attn_up = scale_as(attn, p_1x, align_corners)
    out = {
        "pred": p_lo + (1.0 - attn_up) * p_1x,
        "pred_05x": pred_05x,
        "pred_10x": p_1x,
        "attn_05x": attn,
    }
    if "aux_out" in lo:
        aux_lo_up = scale_as(attn * upcast(lo["aux_out"]), p_1x,
                             align_corners)
        out["aux"] = aux_lo_up + (1.0 - attn_up) * upcast(hi["aux_out"])
    return out


def nscale_fuse(fwd: ForwardFn, x_1x: torch.Tensor, scales,
                align_corners: bool = False) -> Dict[str, torch.Tensor]:
    """Inference-time hierarchical N-scale fusion (reference:
    ocrnet.py:185-262). ``scales`` must contain 1.0. Returns 'pred',
    'aux' (when the forward gives 'aux_out') and the per-scale
    'pred_{s}x' / 'attn_{s}x' assets (no 'attn_2.0x', as the reference)."""
    if 1.0 not in [float(s) for s in scales]:
        raise ValueError(f"1.0 must be among eval scales, got {scales}")
    scales = sorted((float(s) for s in scales), reverse=True)

    pred = aux = None
    out: Dict[str, torch.Tensor] = {}
    for s in scales:
        x = resize_x(x_1x, s, align_corners) if s != 1.0 else x_1x
        o = fwd(x)
        # fusion arithmetic in the forward's output dtype (fusion_dtype)
        cls_out = o["cls_out"]
        attn_out = o["logit_attn"].to(cls_out.dtype)
        aux_out = o.get("aux_out")

        out[fmt_scale("pred", s)] = cls_out
        if s != 2.0:
            out[fmt_scale("attn", s)] = attn_out

        if pred is None:
            pred, aux = cls_out, aux_out
        elif s >= 1.0:
            # downscale accumulated, fuse at current resolution
            pred = scale_as(pred, cls_out, align_corners)
            pred = attn_out * cls_out + (1.0 - attn_out) * pred
            if aux is not None:
                aux = scale_as(aux, cls_out, align_corners)
                aux = attn_out * aux_out + (1.0 - attn_out) * aux
        else:
            # premultiply at low res, upscale, fuse at accumulated resolution
            cls_up = scale_as(attn_out * cls_out, pred, align_corners)
            attn_up = scale_as(attn_out, pred, align_corners)
            pred = cls_up + (1.0 - attn_up) * pred
            if aux is not None:
                aux_up = scale_as(attn_out * aux_out, pred, align_corners)
                aux = aux_up + (1.0 - attn_up) * aux

    out["pred"] = upcast(pred)
    if aux is not None:
        out["aux"] = upcast(aux)
    return out
