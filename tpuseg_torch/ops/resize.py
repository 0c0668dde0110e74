"""Bilinear resize with PyTorch's own coordinate semantics.

Port of ``tpuseg/ops/resize.py:136-184``. ``tpuseg`` re-implemented
``F.interpolate(mode='bilinear')`` as a separable gather + lerp; here the
real thing is called. Every resize passes ``size`` explicitly, so the
``recompute_scale_factor=True`` semantics of the reference
(network/mynn.py:102-114) hold: ``out = floor(in * scale)`` and the
coordinate map uses the recomputed in/out ratio.

Layout: these helpers take NCHW-logical tensors (``F.interpolate``'s
convention); a ``channels_last`` input keeps its memory format.

Numerics: interpolation runs in float32 and is cast back once (the
reference's fp32 island, mynn.py:42-58). ``tpuseg`` casts back after each
axis, so for bf16 inputs the two differ by at most ~2 bf16 ulps of the
input's magnitude (tests/test_torch_ops.py). For f32 inputs torch computes
source coordinates in f32 where ``tpuseg`` uses f64: identical at the
power-of-two ratios the model uses, ~1e-5 apart at ragged ratios.

The training-only custom VJP, ``avg_pool2d`` and ``max_pool2d`` are not
ported yet (ROADMAP Queue 1).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = False
                    ) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to ``size=(H, W)``; f32 arithmetic,
    result in ``x.dtype``. Same-size resizes return ``x`` itself."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[-2:]) == size:
        return x
    y = F.interpolate(x.float(), size=size, mode="bilinear",
                      align_corners=align_corners)
    return y.to(x.dtype)


def resize_x(x: torch.Tensor, scale: float, align_corners: bool = False
             ) -> torch.Tensor:
    """Scale-factor resize: ``out = floor(in * scale)`` per axis."""
    h, w = x.shape[-2:]
    size = (int(math.floor(h * scale)), int(math.floor(w * scale)))
    return resize_bilinear(x, size, align_corners)


def scale_as(x: torch.Tensor, y: torch.Tensor, align_corners: bool = False
             ) -> torch.Tensor:
    """Resize ``x`` to the spatial size of ``y`` (reference:
    network/mynn.py:70-84)."""
    return resize_bilinear(x, y.shape[-2:], align_corners)
