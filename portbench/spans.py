"""The program's spans in a finished ``torch.profiler`` run: device time,
launches, calls and idle time by span, and the per-layer metrics that read
them.

The program (``tpuseg_torch.utils.profiling``) opens a record function
for each of its ``SPANS`` while a profiler records, so a span, the host
ops under it and the device ops they launch lie on the profiler's one
clock. Here:

- a span's parent is the innermost span of its own thread that holds it;
  a span with none on its thread (the backward's recomputation on the
  autograd thread) takes the innermost span of the main thread (the one
  that opened the run's first span) open at its start;
- a device op (kernel, copy, set; not an annotation range) belongs to the
  innermost span that holds, on its thread, the host op the trace links it
  to (its launch); with none there, to the innermost span of the main
  thread open at the launch; with no link or no span, to ``(none)``;
- each idle gap of the device (between busy runs, as ``core.read_profile``
  finds them) belongs to the innermost span of the main thread open at its
  middle, or to ``(none)``.

A span is read inclusively: a path (the distinct span names from the
outermost down to the innermost) counts toward every name on it. The table
keys its sums by path, so that "``remat.block`` within ``train.backward``"
(the recomputation) reads as well as a name alone.

    python3 portbench/spans.py --workload <cell> --seed <n>

sets the cell up as a run does, records the profiled steps of a traced run
and prints the table and the metrics below as one JSON line.
"""
from __future__ import annotations

import bisect
import sys
from pathlib import Path

import numpy as np

NONE = "(none)"

# metric -> (what it sums: "device_s" or "idle_s", the span names of which
# a path holds any, the span names of which it holds all)
MODEL = ("model.trunk", "model.ocr", "model.head", "model.fusion")
METRICS = {
    "trunk_ms_per_img.eval": ("device_s", ("model.trunk",), ()),
    "ocr_ms_per_img.eval": ("device_s", ("model.ocr",), ()),
    "fusion_ms_per_img.eval": ("device_s", ("model.head", "model.fusion"),
                               ()),
    "score_ms_per_img.eval": ("device_s", ("eval.score",), ()),
    "model_idle_ms_per_img.eval": ("idle_s", MODEL, ()),
    "resize_op_ms_per_img.eval": ("device_s", ("op.resize",), ()),
    "fwd_ms_per_img.train": ("device_s", ("train.forward",), ()),
    "bwd_ms_per_img.train": ("device_s", ("train.backward",), ()),
    "recompute_ms_per_img.train": ("device_s", ("remat.block",),
                                   ("train.backward",)),
    "optim_ms_per_img.train": ("device_s", ("train.optimizer",), ()),
    "bn_op_ms_per_img.train": ("device_s", ("op.bn",), ()),
}


class _Thread:
    """One thread's spans, properly nested, sorted by start: the innermost
    span that holds an interval or a moment."""

    def __init__(self, spans: list, ids: list):
        order = sorted(ids, key=lambda i: (spans[i][2], -spans[i][3], i))
        self.ids = order
        self.starts = [spans[i][2] for i in order]
        self.spans = spans
        # the enclosing span of each, on this thread (-1: none)
        self.parent = {}
        stack: list = []
        for i in order:
            while stack and spans[stack[-1]][3] <= spans[i][2]:
                stack.pop()
            self.parent[i] = stack[-1] if stack else -1
            stack.append(i)

    def innermost(self, start: float, end: float | None = None) -> int:
        """The innermost span that holds [start, end] (the moment
        ``start`` when ``end`` is None: start <= t < end), or -1."""
        k = bisect.bisect_right(self.starts, start) - 1
        if k < 0:
            return -1
        i = self.ids[k]
        while i >= 0:
            s, e = self.spans[i][2], self.spans[i][3]
            if s <= start and (e > start if end is None else e >= end):
                return i
            i = self.parent[i]
        return -1


def main_thread(spans: list):
    """The thread that opened the earliest span (None without spans)."""
    if not spans:
        return None
    return min(spans, key=lambda sp: sp[2])[1]


def tree(spans: list, main=None) -> tuple:
    """(parent of each span, -1 for none; the threads' span indexes) of
    ``spans`` as (name, thread, start, end), ``main`` the main thread
    (default :func:`main_thread`)."""
    threads: dict = {}
    for i, (_, tid, _, _) in enumerate(spans):
        threads.setdefault(tid, []).append(i)
    by_thread = {t: _Thread(spans, ids) for t, ids in threads.items()}
    main = main_thread(spans) if main is None else main
    on_main = by_thread.get(main)
    parent = [-1] * len(spans)
    for t, th in by_thread.items():
        for i, p in th.parent.items():
            if p < 0 and t != main and on_main is not None:
                p = on_main.innermost(spans[i][2])
            parent[i] = p
    return parent, by_thread


def attribute(spans: list, ops: list, main=None) -> tuple:
    """(the path of each op, [(path, seconds)] of each idle gap, busy
    seconds) of ``spans`` as (name, thread, start, end) and ``ops`` as
    (name, start, end, launch), ``launch`` the op's launch as (thread,
    start, end) or None; times in microseconds, on one clock. ``main``: the
    main thread (default :func:`main_thread`). A path is the distinct span
    names from the outermost down, joined by "/", or ``(none)``."""
    from portbench.core import _union

    main = main_thread(spans) if main is None else main
    parent, by_thread = tree(spans, main)
    on_main = by_thread.get(main)
    paths: dict = {}

    def path_of(i: int) -> str:
        if i < 0:
            return NONE
        if i not in paths:
            names, j = [], i
            while j >= 0:
                names.append(spans[j][0])
                j = parent[j]
            seen: list = []
            for n in reversed(names):
                if n not in seen:
                    seen.append(n)
            paths[i] = "/".join(seen)
        return paths[i]

    op_paths = []
    for _, _, _, launch in ops:
        i = -1
        if launch is not None:
            tid, ls, le = launch
            if tid in by_thread:
                i = by_thread[tid].innermost(ls, le)
            if i < 0 and tid != main and on_main is not None:
                i = on_main.innermost(ls)
        op_paths.append(path_of(i))
    busy, gaps = _union(np.asarray([(s, e) for _, s, e, _ in ops],
                                   dtype=np.float64).reshape(-1, 2))
    gap_paths = [
        (path_of(on_main.innermost(0.5 * (a + b)) if on_main else -1),
         float(b - a) / 1e6) for a, b in gaps]
    return op_paths, gap_paths, busy


def table(spans: list, ops: list, main=None) -> dict:
    """The span table of one profiled run (arguments as
    :func:`attribute`): {"paths": {path: {"device_s", "launches",
    "idle_s"}}, "calls": {name: spans opened}, "busy_s", "idle_s"}."""
    op_paths, gap_paths, busy = attribute(spans, ops, main)
    out: dict = {}

    def add(path: str, key: str, value) -> None:
        row = out.setdefault(path, {"device_s": 0.0, "launches": 0,
                                    "idle_s": 0.0})
        row[key] += value

    for (name, start, end, _), path in zip(ops, op_paths):
        add(path, "device_s", (end - start) / 1e6)
        if not name.startswith(("Memcpy", "Memset")):
            add(path, "launches", 1)
    for path, sec in gap_paths:
        add(path, "idle_s", sec)
    calls: dict = {}
    for name, _, _, _ in spans:
        calls[name] = calls.get(name, 0) + 1
    return {"paths": out, "calls": calls, "busy_s": busy,
            "idle_s": sum(sec for _, sec in gap_paths)}


def select(tab: dict, key: str, any_of, all_of=()) -> float:
    """The sum of ``key`` over the paths that hold any name of ``any_of``
    and every name of ``all_of``."""
    total = 0.0
    for path, row in tab["paths"].items():
        names = path.split("/")
        if any(n in names for n in any_of) and all(
                n in names for n in all_of):
            total += row[key]
    return total


def by_name(tab: dict) -> dict:
    """{span name or ``(none)``: inclusive device_s, launches, calls,
    idle_s}."""
    out = {}
    for name in [*tab["calls"], NONE]:
        out[name] = {key: select(tab, key, (name,))
                     for key in ("device_s", "launches", "idle_s")}
        out[name]["calls"] = tab["calls"].get(name, 0)
    return out


def metric(tab: dict, name: str, images: int):
    """Milliseconds an image of the metric ``name`` (one of
    :data:`METRICS`), or None where none of its spans was opened."""
    key, any_of, all_of = METRICS[name]
    if not images or not any(tab["calls"].get(n) for n in any_of):
        return None
    if any(not tab["calls"].get(n) for n in all_of):
        return None
    return 1e3 * select(tab, key, any_of, all_of) / images


def from_profile(prof) -> tuple:
    """(spans, ops) of a finished ``torch.profiler.profile`` for
    :func:`table`, from its Kineto events: the program's spans (``SPANS``
    of ``tpuseg_torch.utils.profiling``; none where the program has no
    such tuple) and every device op with its launch: the runtime or driver
    call that shares its correlation id, on the thread of the PyTorch op
    (or span) that both link to; that op itself where the trace has no
    such call. Device annotation ranges are not ops."""
    from torch.autograd import DeviceType

    try:
        from tpuseg_torch.utils.profiling import SPANS
    except ImportError:
        SPANS = ()
    names = set(SPANS)
    host, calls, spans, device = {}, {}, [], []
    for k in prof.profiler.kineto_results.events():
        if getattr(k, "is_hidden_event", lambda: False)():
            continue
        start = k.start_ns() / 1e3
        end = start + k.duration_ns() / 1e3
        note = getattr(k, "is_user_annotation", lambda: False)()
        link = k.linked_correlation_id()
        if k.device_type() == DeviceType.CUDA:
            if not note:
                device.append((k.name(), start, end, k.correlation_id(),
                               link))
        elif link == 0:  # a PyTorch op, span or annotation
            host[k.correlation_id()] = (k.start_thread_id(), start, end)
            if k.name() in names:
                spans.append((k.name(), k.start_thread_id(), start, end))
        else:  # a runtime or driver call, linked to the op that made it
            calls[k.correlation_id()] = (start, end, link)
    ops = []
    for name, start, end, corr, link in device:
        op = host.get(link)
        launch = None
        if op is not None:
            call = calls.get(corr)
            launch = ((op[0], call[0], call[1])
                      if call is not None and call[2] == link else op)
        ops.append((name, start, end, launch))
    return spans, ops


def report(tab: dict, images: int) -> dict:
    """The table by name, the share of the device ops' time under no span,
    and the metrics that read something."""
    names = by_name(tab)
    total = sum(row["device_s"] for row in tab["paths"].values())
    return {"images": images, "busy_s": tab["busy_s"],
            "idle_s": tab["idle_s"],
            "none_pct": (100.0 * names[NONE]["device_s"] / total
                         if total else None),
            "by_name": names, "paths": tab["paths"],
            "metrics": {m: v for m in METRICS
                        if (v := metric(tab, m, images)) is not None}}


def main(argv=None) -> int:
    import argparse
    import json
    import time

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import core

    cell = core.cell(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sess = cell.driver().Session(cell, args.seed, "cuda:0")
    sess.step()  # the window's first step, untraced as in a traced run
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    t0 = time.perf_counter()
    images = sum(sess.step() for _ in range(core.PROFILED_STEPS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof.stop()
    spans, ops = from_profile(prof)
    rows, busy, _ = core.read_profile(prof)
    out = report(table(spans, ops), images)
    kind = "." + cell.traffic["kind"]
    out["metrics"] = {m: v for m, v in out["metrics"].items()
                      if m.endswith(kind)}
    # the largest device ops of each path
    ops_by_path: dict = {}
    for (name, start, end, _), path in zip(ops, attribute(spans, ops)[0]):
        row = ops_by_path.setdefault(path, {})
        row[name[:80]] = row.get(name[:80], 0.0) + (end - start) / 1e6
    out["top_ops"] = {p: sorted(r.items(), key=lambda kv: -kv[1])[:6]
                      for p, r in ops_by_path.items()}
    out.update(workload=args.workload, seed=args.seed, span_s=wall,
               read_profile_busy_s=busy,
               kernel_launches=sum(c for n, (_, c) in rows.items()
                                   if not n.startswith(("Memcpy",
                                                        "Memset"))),
               unlinked_ops=sum(1 for op in ops if op[3] is None),
               device=torch.cuda.get_device_name(0))
    for name, row in sorted(out["by_name"].items(),
                            key=lambda kv: -kv[1]["device_s"]):
        core.log(f"span {name}: {1e3 * row['device_s']:.3f} ms device, "
                 f"{row['launches']} launches, {row['calls']} calls, "
                 f"{1e3 * row['idle_s']:.3f} ms idle")
    core.log(f"device time under no span: {out['none_pct']} %")
    sess.finish()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main())
