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

``tpuseg``'s custom VJP for the bilinear lerp (``tpuseg/ops/resize.py:
87-127``) replaces a full-resolution scatter, which is slow on a TPU, with
a gather. It computes the same linear map as the autograd of
``F.interpolate``, so it has no counterpart here.

``avg_pool2d`` and ``max_pool2d`` (``tpuseg/ops/resize.py:187-238``) take
NCHW-logical tensors like the resizes above (``tpuseg``'s take NHWC) and
compute in f32, cast back to the input's dtype.
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


def avg_pool2d(x: torch.Tensor, window: int, stride: int | None = None,
               padding: int = 0) -> torch.Tensor:
    """Average pool that counts the zero padding in each window's divisor
    (``count_include_pad``, torch's default; the RMI loss's downsample,
    reference: loss/rmi.py:154-155)."""
    y = F.avg_pool2d(x.float(), window, stride or window, padding,
                     count_include_pad=True)
    return y.to(x.dtype)


def max_pool2d(x: torch.Tensor, window: int, stride: int | None = None,
               padding: int = 0, ceil_mode: bool = False) -> torch.Tensor:
    """Max pool; ``ceil_mode`` keeps the partial windows at the trailing
    edge (the Caffe-style SENet stem, reference SEresnext.py:269-272)."""
    y = F.max_pool2d(x.float(), window, stride or window, padding,
                     ceil_mode=ceil_mode)
    return y.to(x.dtype)
