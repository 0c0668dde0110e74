"""Profiling: model summary and device tracing (port of
``tpuseg/utils/profiling.py``).

``tpuseg`` reads FLOPs and bytes from XLA's cost model of the compiled
program. Here FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``
over one eval forward (its formulas for convolutions and matrix products,
and the two kernels' own formulas registered beside them); elementwise
passes count no FLOPs there. No stock torch counter gives XLA's "bytes
accessed", so the summary has none. Tracing is ``torch.profiler``.
"""
from __future__ import annotations

import contextlib
import os

import torch


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


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a host and device trace of the block into
    ``<logdir>/trace.json`` (Chrome trace format, for Perfetto or
    chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
