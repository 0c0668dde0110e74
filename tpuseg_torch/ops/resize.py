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
NCHW-logical tensors like the resizes above (``tpuseg``'s take NHWC);
``avg_pool2d`` computes in f32, cast back to the input's dtype, and
``max_pool2d`` in the input's. Both keep the input's memory format on
every band. ``MaxPool2d`` is
``max_pool2d`` as a module, for the trunks' stems; ``global_avg_pool`` is
the mean over H x W of ASPP's image pooling and squeeze-excite.

On bands (dp x sp, ``parallel/spatial.py``) sizes are the image's global
sizes (``scale_as`` reads ``y``'s global height), and the H axis is
resampled from global row indices: source rows are clamped only at the
image's top and bottom, and a band reads the rows it needs past its edges
from its neighbours. ``F.interpolate`` on a bare band would clamp at the
band's edges, and so be wrong on exactly the rows next to a band boundary.
Pool windows sit on the global grid the same way, and a global average
pool takes the image's mean: the bands' sums of their true rows summed
over the group, over the image's pixel count. Sizes are true sizes: on
an uneven split a band ends in padding rows (``spatial``'s layout), which
a max pool's output keeps at zero rather than at its -inf fill.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpuseg_torch.ops.precision import upcast
from tpuseg_torch.parallel import spatial
from tpuseg_torch.utils.profiling import spanned


@spanned("op.resize")
def resize_bilinear(x: torch.Tensor, size, align_corners: bool = False
                    ) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to ``size=(H, W)`` (the image's size
    on bands); f32 arithmetic, result in ``x.dtype``. Same-size resizes
    return ``x`` itself."""
    size = (int(size[0]), int(size[1]))
    if spatial.global_size(x) == size:
        return x
    y = upcast(x)
    if spatial.active() is not None:
        # H from global rows, then W alone (H same-size: F.interpolate's
        # identity map there)
        if spatial.global_height(x) != size[0]:
            y = spatial.resize_rows(y, size[0], align_corners)
        if y.shape[-1] == size[1]:
            return y.to(x.dtype)
        size = (y.shape[2], size[1])
    y = F.interpolate(y, size=size, mode="bilinear",
                      align_corners=align_corners)
    return y.to(x.dtype)


def resize_x(x: torch.Tensor, scale: float, align_corners: bool = False
             ) -> torch.Tensor:
    """Scale-factor resize: ``out = floor(in * scale)`` per axis."""
    h, w = spatial.global_size(x)
    size = (int(math.floor(h * scale)), int(math.floor(w * scale)))
    return resize_bilinear(x, size, align_corners)


def scale_as(x: torch.Tensor, y: torch.Tensor, align_corners: bool = False
             ) -> torch.Tensor:
    """Resize ``x`` to the spatial size of ``y`` (reference:
    network/mynn.py:70-84)."""
    return resize_bilinear(x, spatial.global_size(y), align_corners)


def avg_pool2d(x: torch.Tensor, window: int, stride: int | None = None,
               padding: int = 0) -> torch.Tensor:
    """Average pool that counts the zero padding in each window's divisor
    (``count_include_pad``, torch's default; the RMI loss's downsample,
    reference: loss/rmi.py:154-155)."""
    y, pad = _band_rows(upcast(x), window, stride or window, padding, 0.0)
    y = F.avg_pool2d(y, window, stride or window, pad,
                     count_include_pad=True)
    return y.to(x.dtype)


def max_pool2d(x: torch.Tensor, window: int, stride: int | None = None,
               padding: int = 0, ceil_mode: bool = False) -> torch.Tensor:
    """Max pool in ``x``'s dtype (a max is exact in any); ``ceil_mode``
    keeps the partial windows at the trailing edge (the Caffe-style SENet
    stem, reference SEresnext.py:269-272)."""
    y, pad = _band_rows(x, window, stride or window, padding, float("-inf"),
                        ceil_mode)
    return spatial.zero_padding(F.max_pool2d(y, window, stride or window,
                                             pad, ceil_mode=ceil_mode))


class MaxPool2d(nn.Module):
    """``max_pool2d`` as a parameter-free module (``nn.MaxPool2d``'s
    arguments), so a stem's ``nn.Sequential`` keeps its indices and its
    state-dict keys."""

    def __init__(self, kernel_size: int, stride: int | None = None,
                 padding: int = 0, ceil_mode: bool = False):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride or kernel_size
        self.padding, self.ceil_mode = padding, ceil_mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool2d(x, self.kernel_size, self.stride, self.padding,
                          self.ceil_mode)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """The (N, C, 1, 1) mean of NCHW ``x`` over the image's H x W. On bands:
    the band's f32 sum, summed over the sp group (whose backward spreads
    the gradient to every band), over the image's pixel count, in
    ``x.dtype``; otherwise ``x.mean((2, 3))``."""
    if spatial.active() is None:
        return x.mean(dim=(2, 3), keepdim=True)
    h, w = spatial.global_size(x)
    rows = x.narrow(2, 0, spatial.valid_rows(x))
    s = spatial.band_sum(upcast(rows).sum(dim=(2, 3), keepdim=True))
    return (s / (h * w)).to(x.dtype)


def _band_rows(x: torch.Tensor, window: int, stride: int, padding: int,
               fill: float, ceil_mode: bool = False):
    """-> (the rows a pool of ``x`` reads, its padding): on bands, the
    band's windows on the global grid, rows past the image's true edges
    ``fill`` (the pool's own padding value) and no H padding; otherwise
    ``x`` and ``padding``."""
    bands = spatial.active()
    if bands is None:
        return x, padding
    h_in = spatial.global_height(x)
    total = spatial.window_rows(h_in, window, stride, padding,
                                ceil_mode=ceil_mode)
    h_out = spatial.split_rows(total)
    needs = spatial.window_needs(h_out, bands, window, stride, padding,
                                 total=total)
    size = (h_out - 1) * stride + window
    y = spatial.gather_rows(x, needs, size=size)
    lo = needs[bands.index][0]
    if fill and (lo < 0 or lo + size > h_in):
        # masked_fill's broadcast mask would leave the band NCHW: an edge
        # band keeps the format its neighbours keep
        rows = torch.arange(lo, lo + size, device=x.device).view(1, 1, -1, 1)
        y = y.masked_fill((rows < 0) | (rows >= h_in), fill).contiguous(
            memory_format=spatial.memory_format(x))
    return y, (0, padding)
