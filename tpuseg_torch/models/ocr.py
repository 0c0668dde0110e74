"""Object-Contextual Representation (OCR) head.

Port of ``tpuseg/models/ocr.py`` (reference: network/ocr_utils.py,
network/ocrnet.py:42-91):

1. ``spatial_gather``: class-probability-weighted pooling,
   ``context[b,k,c] = sum_n softmax_n(aux)[b,n,k] * feats[b,n,c]``;
2. ``ObjectAttention``: pixel queries vs class keys/values, softmax over
   the K classes, ``1/sqrt(d)`` scaling;
3. ``SpatialOCR``: concat(context, feats) -> 1x1 -> dropout.

On bands (dp x sp, ``parallel/spatial.py``) the gather's softmax runs over
every pixel of the image: its max, its normaliser and the class context
are sums (a max) over the sp group, and the class proxies are then the
same on every rank of the group (``spatial.replicated``), so the
distribute step is band-local. A band's padding rows take logit -inf in
the gather: they leave the softmax over the image's pixels and the class
sums, and get no gradient.

Softmaxes run in f32. Module names are the reference's
(``ocr_distri_head.object_context_block.f_pixel.{0,1.0,2,3.0}``, ...).
``use_pallas`` (the ``tpuseg`` switch name) routes the eval-mode attention
through the fused CUDA kernel (tpuseg_torch/kernels/ocr_attention.py).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from tpuseg_torch.kernels.ocr_attention import (
    fused_object_attention,
    object_attention_reference,
)
from tpuseg_torch.models.layers import ConvNormAct, bn_relu, conv
from tpuseg_torch.ops import upcast
from tpuseg_torch.parallel import spatial


def _nhwc_flat(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C); free for channels_last memory."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def spatial_gather(feats: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Soft class-region pooling (reference: ocr_utils.py:34-46).
    feats (B, C, H, W), probs (B, K, H, W) logits -> (B, K, C)."""
    b, k = probs.shape[:2]
    f = _nhwc_flat(feats)
    # softmax over the pixels as the contiguous last axis: a softmax over
    # axis 1 of (B, HW, K) runs PyTorch's strided "spatial" softmax kernel,
    # measured at 24 ms over the three scales of one 1024x2048 image on an
    # H100 (14% of the device time)
    logits = upcast(probs).reshape(b, k, -1)
    if spatial.active() is None:
        p = torch.softmax(logits, dim=-1)
        ctx = torch.bmm(upcast(p.to(feats.dtype)), upcast(f))
        return ctx.to(feats.dtype)
    v = spatial.valid_rows(probs)
    if v < probs.shape[2]:
        pixel = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(pixel >= v * probs.shape[3],
                                    float("-inf"))
    # the softmax over the whole image's pixels: the max shifts without a
    # gradient (the softmax does not depend on it)
    e = torch.exp(logits - spatial.band_max(logits.amax(-1, keepdim=True)))
    p = e / spatial.band_sum(e.sum(-1, keepdim=True))
    ctx = spatial.band_sum(torch.bmm(upcast(p.to(feats.dtype)), upcast(f)))
    return ctx.to(feats.dtype)


class ObjectAttention(nn.Module):
    """Pixel-query / class-proxy attention (reference: ocr_utils.py:49-119)."""

    def __init__(self, in_channels: int, key_channels: int,
                 out_channels: int, use_pallas: bool = False):
        super().__init__()
        kc = key_channels
        self.key_channels = kc
        self.use_pallas = use_pallas
        self.f_pixel = nn.Sequential(conv(in_channels, kc, 1), bn_relu(kc),
                                     conv(kc, kc, 1), bn_relu(kc))
        self.f_object = nn.Sequential(conv(in_channels, kc, 1), bn_relu(kc),
                                      conv(kc, kc, 1), bn_relu(kc))
        self.f_down = ConvNormAct(in_channels, kc, 1)
        self.f_up = ConvNormAct(kc, out_channels, 1)

    def forward(self, x: torch.Tensor, proxy: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) pixel feats; proxy (B, K, C) class context."""
        b, _, h, w = x.shape
        kc = self.key_channels
        # the K proxies as a (K x 1) image for the 1x1 convs
        proxy_img = proxy.permute(0, 2, 1)[..., None]
        q = _nhwc_flat(self.f_pixel(x))
        with spatial.replicated():
            key = _nhwc_flat(self.f_object(proxy_img))
            val = _nhwc_flat(self.f_down(proxy_img))
        # the fused kernel is inference-only, as in tpuseg (ocr.py:90)
        if self.use_pallas and not self.training:
            context = fused_object_attention(q.contiguous(), key.contiguous(),
                                             val.contiguous())
        else:
            context = object_attention_reference(q, key, val)
        context = context.to(x.dtype).reshape(b, h, w, kc).permute(0, 3, 1, 2)
        return self.f_up(context)


class SpatialOCR(nn.Module):
    """Distribute class context back to pixels (reference: ocr_utils.py:122-158)."""

    def __init__(self, in_channels: int, key_channels: int,
                 out_channels: int, dropout: float = 0.05,
                 use_pallas: bool = False):
        super().__init__()
        self.object_context_block = ObjectAttention(
            in_channels, key_channels, in_channels, use_pallas)
        self.conv_bn_dropout = nn.Sequential(
            conv(2 * in_channels, out_channels, 1), bn_relu(out_channels),
            nn.Dropout2d(dropout))

    def forward(self, feats, proxy):
        context = self.object_context_block(feats, proxy)
        return self.conv_bn_dropout(torch.cat([context, feats], dim=1))


class OCRBlock(nn.Module):
    """conv3x3 -> gather -> distribute -> cls head, plus the aux head off the
    trunk features (reference: network/ocrnet.py:42-91). ``conv3x3_ocr``,
    ``aux_head`` and ``cls_head`` convs carry biases (ocrnet.py:55-56,70-71)."""

    def __init__(self, high_level_ch: int, num_classes: int,
                 mid_channels: int = 512, key_channels: int = 256,
                 use_pallas: bool = False, dropout: float = 0.05):
        super().__init__()
        self.conv3x3_ocr = ConvNormAct(high_level_ch, mid_channels, 3,
                                       bias=True)
        self.ocr_distri_head = SpatialOCR(mid_channels, key_channels,
                                          mid_channels, dropout, use_pallas)
        self.cls_head = conv(mid_channels, num_classes, 1, bias=True)
        self.aux_head = nn.Sequential(
            conv(high_level_ch, high_level_ch, 1, bias=True),
            bn_relu(high_level_ch),
            conv(high_level_ch, num_classes, 1, bias=True))

    def forward(self, high_level_features):
        feats = self.conv3x3_ocr(high_level_features)
        aux_out = self.aux_head(high_level_features)
        context = spatial_gather(feats, aux_out)
        ocr_feats = self.ocr_distri_head(feats, context)
        cls_out = self.cls_head(ocr_feats)
        return cls_out, aux_out, ocr_feats
