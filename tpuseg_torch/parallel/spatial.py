"""Spatial (H-band) sharding: each image's rows spread over the sp group.

The counterpart of ``tpuseg``'s ``spatial_sharding`` layout
(``tpuseg/parallel/mesh.py:41-84``), where GSPMD partitions every conv over
the ``model`` mesh axis and inserts the halo exchanges. PyTorch has no such
partitioner (DTensor's conv sharding takes only the last dim and refuses
dilation, and stride with padding), so the port does it by hand:

- ``Bands`` is the layout: rank ``i`` of an sp group of ``n`` ranks holds
  rows ``[i * h, (i + 1) * h)`` of every image-shaped tensor of global
  height ``H = n * h`` (uniform bands; ``Trainer`` refuses a crop whose
  feature maps would not split evenly).
- While ``sharded(bands)`` is active, the ops that look across rows read
  it: ``models/layers.py::Conv2d``, ``ops/resize.py``, the OCR block's
  class gather and the losses. Outside it (validation, eval, one rank)
  they are the plain ops.
- Three primitives, all autograd-aware: :func:`gather_rows` (the halo
  exchange: global rows a band needs from its neighbours, zeros beyond
  the image's edges), :func:`band_sum` (a sum over the sp group whose
  backward sums too) and :func:`band_max` (no gradient).

Gradient convention (``losses/ce.py``): DDP averages over all
``dp * sp`` ranks, so each rank's loss is its share of the global loss
times the number of ranks, and every primitive's backward is the adjoint
of its forward over the sp group (a halo row's gradient goes back to the
rank that owns the row). A value computed alike on every rank of the
group from ``band_sum`` results counts once per rank.

The collectives run on the sp group's own process group, never the world
group that DDP and batch norm use, in the same order on every rank (the
same graph), also inside ``torch.utils.checkpoint``'s recompute: the
context stays active through the backward. Gloo's point-to-point calls
take no CUDA tensors, so a halo exchange is one ``all_reduce`` of a buffer
of slots in which each row has one writer and zeros elsewhere: exact in
any dtype.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Bands:
    """The band layout of one sp group: this rank is band ``index`` of
    ``size``, and ``group`` is the group's process group."""

    group: object
    index: int
    size: int


_active: Optional[Bands] = None
_replicated: Optional[Bands] = None

# collectives issued on the sp groups by kind ("halo" exchanges, "sum",
# "max"), and their host seconds (gloo on CUDA copies through the host, so
# these include the device sync); the train loop logs them per step
COUNTS = {"halo": 0, "sum": 0, "max": 0}
SECONDS = {"halo": 0.0, "sum": 0.0, "max": 0.0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k], SECONDS[k] = 0, 0.0


def _all_reduce(t: torch.Tensor, group, kind: str,
                op=dist.ReduceOp.SUM) -> None:
    t0 = time.perf_counter()
    dist.all_reduce(t, op=op, group=group)
    SECONDS[kind] += time.perf_counter() - t0
    COUNTS[kind] += 1


@contextlib.contextmanager
def sharded(bands: Optional[Bands]):
    """Image-shaped tensors are bands of ``bands`` inside (a no-op for
    ``None``). Keep it active through the backward pass: a remat'd block
    recomputes its forward there."""
    global _active, _replicated
    prev = _active, _replicated
    _active, _replicated = bands, None
    try:
        yield
    finally:
        _active, _replicated = prev


@contextlib.contextmanager
def replicated():
    """Inside a ``sharded`` context: the tensors made here are whole and
    the same on every rank of the sp group (the OCR block's class proxies),
    so the ops treat them as plain tensors, and batch norm counts each
    value once (:func:`replicas`)."""
    global _active, _replicated
    prev = _active, _replicated
    _active, _replicated = None, _active or _replicated
    try:
        yield
    finally:
        _active, _replicated = prev


def active() -> Optional[Bands]:
    """The band layout in force, or None."""
    return _active


def replicas() -> int:
    """How many ranks hold a copy of the tensors made in the current
    ``replicated`` region (1 outside one)."""
    return _replicated.size if _replicated is not None else 1


def global_height(x: torch.Tensor, dim: int = -2) -> int:
    """The image height of NCHW (``dim=-2``) or NHW[C] (``dim=1``) ``x``."""
    h = x.shape[dim]
    return h * _active.size if _active is not None else h


def global_size(x: torch.Tensor) -> tuple:
    """The (H, W) of the image an NCHW tensor or band belongs to."""
    return global_height(x), x.shape[-1]


def split_rows(total: int, bands: Bands, what: str) -> int:
    """The rows a band holds of ``total`` image rows; raises when they do
    not split evenly over the group."""
    if total % bands.size:
        raise ValueError(
            f"{what}: {total} rows do not split into {bands.size} equal "
            f"bands (dp x sp needs every feature-map height divisible by "
            f"mesh.model_parallelism)")
    return total // bands.size


def window_rows(h_in: int, kernel: int, stride: int, padding: int,
                dilation: int = 1, ceil_mode: bool = False) -> int:
    """The output rows of a conv or pool window over ``h_in`` rows."""
    span = h_in + 2 * padding - dilation * (kernel - 1) - 1
    out = (-(-span // stride) if ceil_mode else span // stride) + 1
    if ceil_mode and (out - 1) * stride >= h_in + padding:
        out -= 1  # torch drops a last window that starts in the padding
    return out


def window_needs(h_out: int, bands: Bands, kernel: int, stride: int,
                 padding: int, dilation: int = 1) -> list:
    """Per band: the global input rows ``[lo, hi)`` that its ``h_out``
    output rows of a window op read."""
    needs = []
    for i in range(bands.size):
        o = i * h_out
        needs.append((o * stride - padding,
                      (o + h_out - 1) * stride - padding
                      + dilation * (kernel - 1) + 1))
    return needs


def _halo_slots(needs, h: int, total: int):
    """Rows of the exchange buffer: for each band, the needed rows inside
    the image but outside the band, above and below it. -> (list of
    (band, lo, hi, offset), buffer rows)."""
    slots, off = [], 0
    for i, (lo, hi) in enumerate(needs):
        for a, b in ((max(lo, 0), min(hi, i * h)),
                     (max(lo, (i + 1) * h), min(hi, total))):
            if b > a:
                slots.append((i, a, b, off))
                off += b - a
    return slots, off


class _GatherRows(torch.autograd.Function):
    """Forward: this band's needed global rows, from its own rows, the
    exchange buffer and zeros beyond the image. Backward: the gradient of
    its own rows plus what the other bands' halos send back."""

    @staticmethod
    def forward(ctx, x, dim, needs, bands):
        h = x.shape[dim]
        me = bands.index
        slots, rows = _halo_slots(needs, h, h * bands.size)
        ctx.geometry = dim, needs, bands, slots, rows, h
        buf = None
        if rows:
            # every band writes the rows it owns into the others' slots
            buf = _buffer(x, dim, rows)
            for i, a, b, off in slots:
                a2, b2 = max(a, me * h), min(b, (me + 1) * h)
                if i != me and b2 > a2:
                    buf.narrow(dim, off + a2 - a, b2 - a2).copy_(
                        x.narrow(dim, a2 - me * h, b2 - a2))
            _all_reduce(buf, bands.group, "halo")
        lo, hi = needs[me]
        out = _buffer(x, dim, hi - lo)
        a, b = max(lo, me * h), min(hi, (me + 1) * h)
        if b > a:
            out.narrow(dim, a - lo, b - a).copy_(
                x.narrow(dim, a - me * h, b - a))
        for i, a, b, off in slots:
            if i == me:
                out.narrow(dim, a - lo, b - a).copy_(
                    buf.narrow(dim, off, b - a))
        return out

    @staticmethod
    def backward(ctx, g):
        dim, needs, bands, slots, rows, h = ctx.geometry
        me = bands.index
        lo, hi = needs[me]
        dx = _buffer(g, dim, h)
        a, b = max(lo, me * h), min(hi, (me + 1) * h)
        if b > a:
            dx.narrow(dim, a - me * h, b - a).copy_(
                g.narrow(dim, a - lo, b - a))
        if rows:
            # each band sends its halo rows' gradients back to their owners
            buf = _buffer(g, dim, rows)
            for i, a, b, off in slots:
                if i == me:
                    buf.narrow(dim, off, b - a).copy_(
                        g.narrow(dim, a - lo, b - a))
            _all_reduce(buf, bands.group, "halo")
            for i, a, b, off in slots:
                a2, b2 = max(a, me * h), min(b, (me + 1) * h)
                if i != me and b2 > a2:
                    dx.narrow(dim, a2 - me * h, b2 - a2).add_(
                        buf.narrow(dim, off + a2 - a, b2 - a2))
        return dx, None, None, None


def _buffer(like: torch.Tensor, dim: int, rows: int) -> torch.Tensor:
    """Zeros shaped as ``like`` with ``rows`` along ``dim``, in its memory
    format (channels_last stays channels_last for cuDNN)."""
    shape = list(like.shape)
    shape[dim] = rows
    fmt = (torch.channels_last if like.dim() == 4 and not
           like.is_contiguous() and
           like.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    return torch.empty(shape, dtype=like.dtype, device=like.device,
                       memory_format=fmt).zero_()


def gather_rows(x: torch.Tensor, needs: Sequence[tuple], dim: int = 2,
                bands: Optional[Bands] = None) -> torch.Tensor:
    """Global rows ``needs[i] = [lo, hi)`` of the image, on band ``i``, for
    band tensor ``x`` (rows along ``dim``): the halo exchange. Rows beyond
    the image are zeros. Every band passes the same ``needs``."""
    bands = bands or _active
    dim = dim % x.dim()
    return _GatherRows.apply(x, dim, tuple(tuple(n) for n in needs), bands)


class _BandSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        _all_reduce(y, group, "sum")
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        _all_reduce(g, ctx.group, "sum")
        return g, None


def band_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the sp group (``x`` itself outside a ``sharded``
    context); the backward sums the gradients over the group too
    (``torch.distributed.nn.functional.all_reduce``'s rule)."""
    bands = _active
    if bands is None:
        return x
    if not x.requires_grad:
        x = x.clone()
        _all_reduce(x, bands.group, "sum")
        return x
    return _BandSum.apply(x, bands.group)


def band_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the sp group, without a gradient
    (``x`` detached outside a ``sharded`` context)."""
    x = x.detach().clone()
    if _active is not None:
        _all_reduce(x, _active.group, "max", dist.ReduceOp.MAX)
    return x


def conv_rows(x: torch.Tensor, kernel: int, stride: int, padding: int,
              dilation: int = 1) -> torch.Tensor:
    """The rows band ``x`` (NCHW) needs for its band of a conv's output,
    halo and image-edge zeros included: convolve the result with no H
    padding. Raises when the output does not split evenly."""
    bands = _active
    h_out = split_rows(
        window_rows(x.shape[2] * bands.size, kernel, stride, padding,
                    dilation), bands, "conv output")
    return gather_rows(x, window_needs(h_out, bands, kernel, stride, padding,
                                       dilation))


def _source_rows(h_in: int, h_out: int, rows: torch.Tensor,
                align_corners: bool):
    """Bilinear source rows and weights of output ``rows`` for ``h_in ->
    h_out``: ``F.interpolate``'s coordinate map (with ``size`` given), in
    f32 as its kernels compute it. -> (i0, i1, lam1)."""
    r = rows.float()
    if align_corners:
        scale = (h_in - 1) / (h_out - 1) if h_out > 1 else 0.0
        src = r * torch.tensor(scale, dtype=torch.float32)
    else:
        scale = torch.tensor(h_in / h_out, dtype=torch.float32)
        src = (scale * (r + 0.5) - 0.5).clamp_min(0.0)
    i0 = src.long().clamp(max=h_in - 1)
    i1 = (i0 + 1).clamp(max=h_in - 1)
    return i0, i1, (src - i0.float()).clamp(0.0, 1.0)


def resize_rows(x: torch.Tensor, h_out: int, align_corners: bool
                ) -> torch.Tensor:
    """Band ``x`` (NCHW, f32) resized along H to its band of a global
    ``h_out`` rows: source rows from global row indices, clamped only at
    the image's edges, one halo row (or more) from the neighbours."""
    bands = _active
    h_in = x.shape[2] * bands.size
    h = split_rows(h_out, bands, "resize output")
    needs, mine = [], None
    for i in range(bands.size):
        rows = torch.arange(i * h, (i + 1) * h)
        i0, i1, lam = _source_rows(h_in, h_out, rows, align_corners)
        needs.append((int(i0.min()), int(i1.max()) + 1))
        if i == bands.index:
            mine = i0, i1, lam
    ext = gather_rows(x, needs)
    lo = needs[bands.index][0]
    i0, i1, lam = (t.to(x.device) for t in mine)
    lam = lam.to(x.dtype).view(1, 1, -1, 1)
    return ((1 - lam) * ext.index_select(2, i0 - lo)
            + lam * ext.index_select(2, i1 - lo))


__all__ = ["Bands", "COUNTS", "SECONDS", "active", "band_max", "band_sum",
           "conv_rows", "gather_rows", "global_height", "global_size",
           "replicas", "replicated", "reset_counts", "resize_rows",
           "sharded", "split_rows", "window_needs",
           "window_rows"]
