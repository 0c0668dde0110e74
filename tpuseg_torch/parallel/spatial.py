"""Spatial (H-band) sharding: each image's rows spread over the sp group.

The counterpart of ``tpuseg``'s ``spatial_sharding`` layout
(``tpuseg/parallel/mesh.py:41-84``), where GSPMD partitions every conv over
the ``model`` mesh axis and inserts the halo exchanges. PyTorch has no such
partitioner (DTensor's conv sharding takes only the last dim and refuses
dilation, and stride with padding), so the port does it by hand:

- ``Bands`` is the layout: rank ``i`` of an sp group of ``n`` ranks holds
  rows ``[i * h, (i + 1) * h)`` of every image-shaped tensor of true
  height ``H``, with ``h = ceil(H / n)`` (padded bands, as GSPMD pads an
  uneven shard). Rows at or past ``H`` are padding: a band may hold a few,
  or only padding on a small map. Every band has the same shape, so the
  ranks' buffers have one size and the dropout generators, seeded alike,
  draw the same masks on every band.
- The true heights live in a table that ``sharded(bands)`` starts empty:
  padded band rows -> true rows. ``shard_batch_spatial`` (:func:`band`)
  enters the crop's height, and each op that makes a new height enters
  its output's (:func:`split_rows`: the conv and pool windows, the
  resizes, and through them the attention heads that add or drop rows).
  The ops read a map's true height back from its band's rows
  (:func:`global_height`). A map whose ``ceil(H / n)`` another true
  height of the step already holds takes the next free band height
  instead, one more padding row or a few: the plain attnscale head's map
  is 2 rows taller than its input, so at sp 3 a 100-row map and its
  102-row attention map would both pad to 34 rows. The table is then one
  to one, and no collective carries a height: every rank runs the same
  graph, so enters the same heights in the same order.
- Padding rows hold finite values that nothing reads: every op that
  looks across rows reads true rows only (zeros past ``H``, as past the
  image's edge), and every reduction over pixels (batch norm, the global
  average pool, the OCR class gather, the losses, whose labels are
  ignored there) leaves them out, so their gradient is zero. A band's
  true rows are a prefix of it (:func:`valid_rows`).
- While ``sharded(bands)`` is active, the ops that look across rows read
  it: ``models/layers.py::Conv2d``, ``ops/resize.py``, the OCR block's
  class gather and the losses. Outside it (validation, eval, one rank)
  they are the plain ops.
- Three primitives, all autograd-aware: :func:`gather_rows` (the halo
  exchange: global rows a band needs from its neighbours, zeros beyond
  the image's true edges), :func:`band_sum` (a sum over the sp group
  whose backward sums too) and :func:`band_max` (no gradient).

Gradient convention (``losses/ce.py``): DDP averages over all
``dp * sp`` ranks, so each rank's loss is its share of the global loss
times the number of ranks, and every primitive's backward is the adjoint
of its forward over the sp group (a halo row's gradient goes back to the
rank that owns the row). A value computed alike on every rank of the
group from ``band_sum`` results counts once per rank.

The collectives run on the sp group's own process group, never the world
group that DDP and batch norm use, in the same order on every rank (the
same graph), also inside ``torch.utils.checkpoint``'s recompute: the
context stays active through the backward, and with it the table of
heights. Gloo's point-to-point calls take no CUDA tensors, so a halo
exchange is one ``all_reduce`` of a buffer of slots in which each row has
one writer and zeros elsewhere: exact in any dtype.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpuseg_torch.ops.precision import at_least_f32


@dataclass(frozen=True)
class Bands:
    """The band layout of one sp group: this rank is band ``index`` of
    ``size``, and ``group`` is the group's process group."""

    group: object
    index: int
    size: int


_active: Optional[Bands] = None
_replicated: Optional[Bands] = None
# the active context's maps: padded band rows -> true rows, and back
_true: dict = {}
_padded: dict = {}

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
    ``None``), with an empty table of map heights. Keep it active through
    the backward pass: a remat'd block recomputes its forward there."""
    global _active, _replicated, _true, _padded
    prev = _active, _replicated, _true, _padded
    _active, _replicated, _true, _padded = bands, None, {}, {}
    try:
        yield
    finally:
        _active, _replicated, _true, _padded = prev


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


def split_rows(total: int) -> int:
    """The rows each band holds of a map of ``total`` true rows, entered
    in the table: ``ceil(total / sp)``, or the next band height that no
    other true height holds (the module docstring)."""
    h = _padded.get(total)
    if h is None:
        h = -(-total // _active.size)
        while h in _true:
            h += 1
        _true[h], _padded[total] = total, h
    return h


def _true_rows(h: int) -> int:
    """The true height of the maps held as bands of ``h`` rows; a band
    height no op entered is a map of whole bands."""
    total = _true.get(h)
    if total is None:
        total = h * _active.size
        _true[h] = total
        _padded.setdefault(total, h)
    return total


def global_height(x: torch.Tensor, dim: int = -2) -> int:
    """The true image height of NCHW (``dim=-2``) or NHW[C] (``dim=1``)
    ``x``."""
    h = x.shape[dim]
    return _true_rows(h) if _active is not None else h


def global_size(x: torch.Tensor) -> tuple:
    """The (H, W) of the image an NCHW tensor or band belongs to."""
    return global_height(x), x.shape[-1]


def valid_rows(x: torch.Tensor, dim: int = -2) -> int:
    """How many of band ``x``'s rows are true rows (they come first, the
    padding after them); all of ``x``'s rows outside a ``sharded``
    context."""
    h = x.shape[dim]
    if _active is None:
        return h
    return max(0, min(h, global_height(x, dim) - _active.index * h))


def band(a, dim: int = 1, fill=0):
    """This rank's band of the whole image-shaped numpy array or tensor
    ``a`` (rows along ``dim``): its true rows, then padding rows of
    ``fill`` (the image's zeros, the label's ignore value); ``a``'s height
    enters the table. A tensor keeps its memory format."""
    total = a.shape[dim]
    h = split_rows(total)
    lo = min(_active.index * h, total)
    n = min(h, total - lo)
    pad = list(a.shape)
    pad[dim] = h - n
    if isinstance(a, torch.Tensor):
        part = a.narrow(dim, lo, n)
        if n < h:
            part = torch.cat([part, torch.full(pad, fill, dtype=a.dtype,
                                               device=a.device)], dim)
        return part.contiguous(memory_format=memory_format(a))
    part = a[(slice(None),) * dim + (slice(lo, lo + n),)]
    if n < h:
        part = np.concatenate([part, np.full(pad, fill, a.dtype)], dim)
    return part


def window_rows(h_in: int, kernel: int, stride: int, padding: int,
                dilation: int = 1, ceil_mode: bool = False) -> int:
    """The output rows of a conv or pool window over ``h_in`` rows."""
    span = h_in + 2 * padding - dilation * (kernel - 1) - 1
    out = (-(-span // stride) if ceil_mode else span // stride) + 1
    if ceil_mode and (out - 1) * stride >= h_in + padding:
        out -= 1  # torch drops a last window that starts in the padding
    return out


def window_needs(h_out: int, bands: Bands, kernel: int, stride: int,
                 padding: int, dilation: int = 1,
                 total: Optional[int] = None) -> list:
    """Per band: the global input rows ``[lo, hi)`` that the true rows
    among its ``h_out`` output rows of a window op read (``total`` true
    output rows, all of them by default); ``lo`` is where its window
    starts, and ``hi = lo`` for a band of padding only."""
    total = h_out * bands.size if total is None else total
    needs = []
    for i in range(bands.size):
        o = i * h_out
        n = max(0, min(h_out, total - o))
        lo = o * stride - padding
        needs.append((lo, (lo + (n - 1) * stride + dilation * (kernel - 1)
                           + 1) if n else lo))
    return needs


def _halo_slots(needs, h: int, total: int):
    """Rows of the exchange buffer: for each band, the needed rows inside
    the image's ``total`` true rows but outside the band, above and below
    it. -> (list of (band, lo, hi, offset), buffer rows)."""
    slots, off = [], 0
    for i, (lo, hi) in enumerate(needs):
        for a, b in ((max(lo, 0), min(hi, i * h, total)),
                     (max(lo, (i + 1) * h), min(hi, total))):
            if b > a:
                slots.append((i, a, b, off))
                off += b - a
    return slots, off


class _GatherRows(torch.autograd.Function):
    """Forward: this band's needed global rows, from its own true rows,
    the exchange buffer and zeros beyond the image's true rows, into a
    window of ``size`` rows. Backward: the gradient of its own rows plus
    what the other bands' halos send back."""

    @staticmethod
    def forward(ctx, x, dim, needs, bands, total, size):
        h = x.shape[dim]
        me = bands.index
        mine = me * h, min((me + 1) * h, total)
        slots, rows = _halo_slots(needs, h, total)
        ctx.geometry = dim, needs, bands, slots, rows, h, mine
        buf = None
        if rows:
            # every band writes the rows it owns into the others' slots
            buf = _buffer(x, dim, rows, keep_format=False)
            for i, a, b, off in slots:
                a2, b2 = max(a, mine[0]), min(b, mine[1])
                if i != me and b2 > a2:
                    buf.narrow(dim, off + a2 - a, b2 - a2).copy_(
                        x.narrow(dim, a2 - me * h, b2 - a2))
            _all_reduce(buf, bands.group, "halo")
        lo, hi = needs[me]
        out = _buffer(x, dim, size)
        a, b = max(lo, mine[0]), min(hi, mine[1])
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
        dim, needs, bands, slots, rows, h, mine = ctx.geometry
        me = bands.index
        lo, hi = needs[me]
        dx = _buffer(g, dim, h)
        a, b = max(lo, mine[0]), min(hi, mine[1])
        if b > a:
            dx.narrow(dim, a - me * h, b - a).copy_(
                g.narrow(dim, a - lo, b - a))
        if rows:
            # each band sends its halo rows' gradients back to their owners
            buf = _buffer(g, dim, rows, keep_format=False)
            for i, a, b, off in slots:
                if i == me:
                    buf.narrow(dim, off, b - a).copy_(
                        g.narrow(dim, a - lo, b - a))
            _all_reduce(buf, bands.group, "halo")
            for i, a, b, off in slots:
                a2, b2 = max(a, mine[0]), min(b, mine[1])
                if i != me and b2 > a2:
                    dx.narrow(dim, a2 - me * h, b2 - a2).add_(
                        buf.narrow(dim, off + a2 - a, b2 - a2))
        return dx, None, None, None, None, None


def memory_format(x: torch.Tensor) -> torch.memory_format:
    """``x``'s memory format: channels_last for a 4-D tensor laid out so
    (and not also contiguous), else contiguous."""
    return (torch.channels_last if x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last)
            else torch.contiguous_format)


def _buffer(like: torch.Tensor, dim: int, rows: int,
            keep_format: bool = True) -> torch.Tensor:
    """Zeros shaped as ``like`` with ``rows`` along ``dim``, in its memory
    format (channels_last stays channels_last for cuDNN) or, for a buffer
    that is all-reduced (``keep_format`` off), contiguous: ``all_reduce``
    adds the ranks' buffers element by element in memory, so its layout
    must not hang on each rank's format of the band."""
    shape = list(like.shape)
    shape[dim] = rows
    return torch.empty(shape, dtype=like.dtype, device=like.device,
                       memory_format=(memory_format(like) if keep_format
                                      else torch.contiguous_format)).zero_()


def gather_rows(x: torch.Tensor, needs: Sequence[tuple], dim: int = 2,
                size: Optional[int] = None) -> torch.Tensor:
    """Global rows ``needs[i] = [lo, hi)`` of the image, on band ``i``, for
    band tensor ``x`` (rows along ``dim``): the halo exchange. Rows at or
    past the image's true height, and before its top, are zeros; so are
    the rows of the ``size``-row window (``hi - lo`` rows by default) past
    ``hi``. Every band passes the same ``needs``."""
    dim = dim % x.dim()
    lo, hi = needs[_active.index]
    return _GatherRows.apply(x, dim, tuple(tuple(n) for n in needs),
                             _active, global_height(x, dim),
                             hi - lo if size is None else size)


def zero_padding(x: torch.Tensor) -> torch.Tensor:
    """Band ``x`` (NCHW) with its padding rows zeroed (``x`` itself when
    it has none), in its memory format."""
    v = valid_rows(x)
    if v == x.shape[2]:
        return x
    x = x.clone()
    x.narrow(2, v, x.shape[2] - v).zero_()
    return x


class _BandSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        _all_reduce(y, group, "sum")
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
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
        x = x.clone(memory_format=torch.contiguous_format)
        _all_reduce(x, bands.group, "sum")
        return x
    return _BandSum.apply(x, bands.group)


def band_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the sp group, without a gradient
    (``x`` detached outside a ``sharded`` context)."""
    x = x.detach().clone(memory_format=torch.contiguous_format)
    if _active is not None:
        _all_reduce(x, _active.group, "max", dist.ReduceOp.MAX)
    return x


def conv_rows(x: torch.Tensor, kernel: int, stride: int, padding: int,
              dilation: int = 1) -> torch.Tensor:
    """The rows band ``x`` (NCHW) needs for its band of a conv's output,
    halo and image-edge zeros included: convolve the result with no H
    padding. The output's true height enters the table."""
    total = window_rows(global_height(x), kernel, stride, padding, dilation)
    h_out = split_rows(total)
    needs = window_needs(h_out, _active, kernel, stride, padding, dilation,
                         total)
    return gather_rows(x, needs, size=(h_out - 1) * stride
                       + dilation * (kernel - 1) + 1)


def _source_rows(h_in: int, h_out: int, rows: torch.Tensor,
                 align_corners: bool, dtype: torch.dtype):
    """Bilinear source rows and weights of output ``rows`` for ``h_in ->
    h_out``: ``F.interpolate``'s coordinate map (with ``size`` given), in
    ``dtype`` (f32 for bf16 and f32 maps, f64 for f64) as its kernels
    compute it. -> (i0, i1, lam1)."""
    r = rows.to(dtype)
    if align_corners:
        scale = (h_in - 1) / (h_out - 1) if h_out > 1 else 0.0
        src = r * torch.tensor(scale, dtype=dtype)
    else:
        scale = torch.tensor(h_in / h_out, dtype=dtype)
        src = (scale * (r + 0.5) - 0.5).clamp_min(0.0)
    i0 = src.long().clamp(max=h_in - 1)
    i1 = (i0 + 1).clamp(max=h_in - 1)
    return i0, i1, (src - i0.to(dtype)).clamp(0.0, 1.0)


def resize_rows(x: torch.Tensor, h_out: int, align_corners: bool
                ) -> torch.Tensor:
    """Band ``x`` (NCHW, f32) resized along H to its band of a global
    ``h_out`` true rows: source rows from global row indices of the true
    input rows, clamped only at the image's true edges, one halo row (or
    more) from the neighbours. Padding rows of the output are zeros."""
    bands = _active
    h_in = global_height(x)
    h = split_rows(h_out)
    needs, mine = [], None
    for i in range(bands.size):
        n = max(0, min(h, h_out - i * h))
        rows = torch.arange(i * h, i * h + n)
        i0, i1, lam = _source_rows(h_in, h_out, rows, align_corners,
                                   at_least_f32(x.dtype))
        needs.append((int(i0.min()), int(i1.max()) + 1) if n else (0, 0))
        if i == bands.index:
            mine = i0, i1, lam, n
    lo, hi = needs[bands.index]
    ext = gather_rows(x, needs, size=max(hi - lo, 1))
    i0, i1, lam, n = mine
    lam = lam.to(x.dtype)
    w0 = 1 - lam
    if n < h:
        # padding rows: weight 0 on the window's first row
        i0, i1 = (torch.cat([t, t.new_full((h - n,), lo)]) for t in (i0, i1))
        w0, lam = (torch.cat([t, t.new_zeros(h - n)]) for t in (w0, lam))
    i0, i1, w0, lam = (t.to(x.device) for t in (i0, i1, w0, lam))
    return (w0.view(1, 1, -1, 1) * ext.index_select(2, i0 - lo)
            + lam.view(1, 1, -1, 1) * ext.index_select(2, i1 - lo))


__all__ = ["Bands", "COUNTS", "SECONDS", "active", "band", "band_max",
           "band_sum", "conv_rows", "gather_rows", "global_height",
           "global_size", "memory_format", "replicas", "replicated",
           "reset_counts", "resize_rows", "sharded", "split_rows",
           "valid_rows", "window_needs", "window_rows", "zero_padding"]
