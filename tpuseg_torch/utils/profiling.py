"""Profiling: model summary, device tracing, the program's spans and its
counters (port of ``tpuseg/utils/profiling.py``).

``tpuseg`` reads FLOPs and bytes from XLA's cost model of the compiled
program. Here FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``
over one eval forward (its formulas for convolutions and matrix products,
and the two kernels' own formulas registered beside them); elementwise
passes count no FLOPs there. No stock torch counter gives XLA's "bytes
accessed", so the summary has none. Tracing is ``torch.profiler``.

Spans mark the program's layers on the profiler's own timeline: while a
``torch.profiler`` records, :func:`span` opens a record function of its
name (PyTorch's C++ ``_RecordFunctionFast``, ~2 us a span on the host where
``record_function`` takes ~15), so the span, the host ops under it and the
device kernels they launch share one clock. When none records, a span is a
shared no-op after one check. Counters (:func:`count`) are always on.
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading

import torch
from torch.autograd import profiler as _profiler

# every span the program opens, one line each on the layer it marks; a
# name is dotted and stable, and a span is read inclusively (its ops and
# those of every span nested in it)
SPANS = (
    "eval.upload",      # EvalRunner.run_batch: the batch's host->device copy
    "eval.forward",     # eval forward: normalize, pad mask, model calls
    "eval.score",       # eval forward: softmax, argmax, hists, val loss
    "eval.drain",       # EvalRunner.drain: the accumulator's device->host read
    "train.upload",     # Trainer._upload: the batch's host->device copy
    "train.forward",    # train step: normalize, the model, the loss terms
    "train.backward",   # train step: loss.backward()
    "train.optimizer",  # train step: set_lr, zero_grad, optimizer.step()
    "model.trunk",      # the trunk's forward (HRNetV2, WRN38, the others)
    "model.ocr",        # models/ocr.py OCRBlock
    "model.head",       # scale-attention head and output upsamples; ASPP,
                        # decoder and seg head of the DeepLab models
    "model.fusion",     # mscale_core fusions outside their forward calls
    "remat.block",      # hrnet.remat_call: a checkpointed block, again in
                        # the backward where it is recomputed
    "op.resize",        # ops/resize.py resize_bilinear
    "op.bn",            # models/layers.py BatchNorm2d.forward
    "kernel.ocr_attention",  # csrc/ocr_attention.cu launch
    "kernel.bottleneck",     # csrc/bottleneck_fused{,_any}.cu launch
)


class _NoSpan:
    """The span of a process no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


_RECORD = getattr(torch._C._profiler, "_RecordFunctionFast",
                  _profiler.record_function)


def span(name: str):
    """``with span(name):`` marks the block as the layer ``name`` (one of
    :data:`SPANS`) while a ``torch.profiler`` records; otherwise the
    shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _RECORD(name)


def spanned(name: str):
    """Decorator: every call of the function runs under ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


# the program's counters by name: kernel launches, nvcc builds, eval
# shapes first seen, sp collectives and their host seconds
COUNTERS: dict = {}
_COUNTERS_LOCK = threading.Lock()


def count(name: str, n=1) -> None:
    """Add ``n`` (an int, or float seconds) to the counter ``name``."""
    with _COUNTERS_LOCK:
        COUNTERS[name] = COUNTERS.get(name, 0) + n


def counters() -> dict:
    """A copy of every counter."""
    with _COUNTERS_LOCK:
        return dict(COUNTERS)


def reset_counters() -> None:
    with _COUNTERS_LOCK:
        COUNTERS.clear()


def model_summary(model: torch.nn.Module, input_shape=(1, 1024, 2048, 3),
                  dtype=torch.bfloat16, device: str = "cuda") -> dict:
    """-> {params, flops, peak_bytes} of one eval forward of ``model`` on
    ``device`` (the model is moved there and put in eval mode).
    ``peak_bytes`` is ``torch.cuda.max_memory_allocated`` over the forward
    on a CUDA device, None elsewhere."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = torch.device(device)
    model = model.to(dev, memory_format=torch.channels_last).eval()
    n_params = sum(p.numel() for p in model.parameters())
    x = torch.zeros(input_shape, dtype=dtype, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        model(x)
    peak = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    return {"params": n_params, "flops": counter.get_total_flops(),
            "peak_bytes": peak}


def start_trace(cuda: bool):
    """A started ``torch.profiler`` of the host and, with ``cuda``, the
    device: the program's spans record while it runs."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_trace(prof, path: str, cuda: bool) -> None:
    """Stop ``prof`` once the device is done and write its trace to
    ``path`` (Chrome trace format, for Perfetto or chrome://tracing: the
    spans are ranges named as in :data:`SPANS` on the threads that opened
    them, the kernels under them on the device's rows)."""
    if cuda:
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a host and device trace of the block into
    ``<logdir>/trace.json`` (see :func:`stop_trace`)."""
    cuda = torch.cuda.is_available()
    prof = start_trace(cuda)
    try:
        yield prof
    finally:
        stop_trace(prof, os.path.join(logdir, "trace.json"), cuda)
