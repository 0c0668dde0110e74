"""The harness: what a cell is, where its files are, one run of a cell,
and the reading of a profiler trace.

A cell is one entry of ``BENCHMARK.json``'s ``workloads``. Everything that
belongs to it is found by name, under the benchmark's folder:

- ``configs/<config>.json``: the program's recipe and overrides, the
  reference's widths, ``source``, ``reduced`` and ``assumed``;
- ``traffic/<traffic>.json``: the mix's parameters, and ``kind``, the
  general driver under ``drivers/`` that reads them;
- ``limits/<cell>.json``: each compared number's limit;
- ``reference/<reference>.py``: the plain reference the config names;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``tests/tiny/configs/<config>.json``: the configuration's tiny CPU
  variant, and ``tests/tiny/traffic/<traffic>.json``: the mix's small
  shapes, which the benchmark's CPU tests build the cell from (no run
  reads them).

Adding a configuration, a mix or a metric is adding such files and their
``BENCHMARK.json`` entries.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuseg")
# steps of a traced run's window that the profiler records, after the first
PROFILED_STEPS = 2


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def laps(what: str):
    """-> ``lap(name)``, which logs the seconds since the last lap."""
    last = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        log(f"{what} {name}: {now - last[0]:.3f} s")
        last[0] = now
    return lap


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def load_module(path: Path):
    """A module from its file (names with dots and dashes)."""
    name = "portbench_" + "".join(c if c.isalnum() else "_"
                                  for c in str(path.relative_to(path.parents[1])))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path = HERE

    def reference(self):
        ref = self.config.get("reference", self.config["name"])
        return load_module(self.root / "reference" / f"{ref}.py")

    def driver(self):
        return load_module(self.root / "drivers" / f"{self.traffic['kind']}.py")

    def reader(self, metric: str):
        return load_module(self.root / "metrics" / f"{metric}.py")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, manifest: dict | None = None, root: Path = HERE) -> Cell:
    """The cell ``name`` of ``manifest`` (``BENCHMARK.json`` by default),
    with its files read from ``root``."""
    if manifest is None:
        manifest = _json(ROOT / "BENCHMARK.json")
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise SystemExit(f"no workload {name!r}; the workloads are "
                         f"{sorted(by_name)}")
    w = by_name[name]
    config = _json(root / "configs" / f"{w['config']}.json")
    config["name"] = w["config"]
    traffic = _json(root / "traffic" / f"{w['traffic']}.json")
    limits = _json(root / "limits" / f"{name}.json")
    return Cell(name, w["chips"], config, traffic, limits,
                [m for m in manifest["end_to_end"] if _applies(m, name)],
                [m for m in manifest["per_layer"] if _applies(m, name)],
                root)


def seeds(seed: int, n: int) -> list:
    """``n`` independent 63-bit seeds drawn from the run's ``--seed``."""
    state = np.random.SeedSequence(int(seed)).generate_state(n, np.uint64)
    return [int(s) >> 1 for s in state]


# ------------------------------------------------------------ the trace

@dataclass
class Trace:
    """What the profiled steps of a traced run give the metric readers:
    device time and launches by name, busy and wall seconds of the
    profiled span, and the images it covered; the whole window's images
    and seconds; the cell."""

    rows: dict            # device op name -> (seconds, launches)
    busy_s: float
    span_s: float
    images: int
    window_images: int
    window_s: float
    cell: Cell
    flops_per_image: float = 0.0
    idle_gaps: list = field(default_factory=list)

    def seconds(self, match) -> tuple:
        """(seconds, launches) of the device ops whose name ``match``es."""
        s = n = 0
        for name, (sec, cnt) in self.rows.items():
            if match(name):
                s, n = s + sec, n + cnt
        return s, n

    def kernel_launches(self) -> int:
        return sum(c for name, (_, c) in self.rows.items()
                   if not name.startswith(("Memcpy", "Memset")))


def _union(intervals: np.ndarray) -> tuple:
    """(busy seconds, gaps as (start, end) rows) of [start, end) rows in
    microseconds."""
    if len(intervals) == 0:
        return 0.0, np.zeros((0, 2))
    iv = intervals[np.argsort(intervals[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    # a new busy run starts where a start lies past every earlier end
    new = np.r_[True, iv[1:, 0] > ends[:-1]]
    starts = iv[new, 0]
    run_ends = np.r_[ends[np.flatnonzero(new)[1:] - 1], ends[-1]]
    gaps = np.stack([run_ends[:-1], starts[1:]], 1)
    return float((run_ends - starts).sum()) / 1e6, gaps


# idle gaps shorter than this are summed under one name, not attributed
SHORT_GAP_US = 20.0


def read_profile(prof) -> tuple:
    """(rows, busy_s, idle gaps by host op) from a finished
    ``torch.profiler.profile``: device kernels, copies and sets (not
    annotation ranges), and each idle gap of the device named by the
    innermost host op under way at its middle."""
    from torch.autograd import DeviceType

    rows, dev, host = {}, [], []
    for e in prof.events():
        tr = e.time_range
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            sec, cnt = rows.get(e.name, (0.0, 0))
            rows[e.name] = (sec + (tr.end - tr.start) / 1e6, cnt + 1)
            dev.append((tr.start, tr.end))
        else:
            host.append((tr.start, tr.end, e.name))
    busy, gaps = _union(np.asarray(dev, dtype=np.float64).reshape(-1, 2))
    by_host: dict = {}
    if len(gaps) and host:
        hs = np.array([h[0] for h in host], dtype=np.float64)
        he = np.array([h[1] for h in host], dtype=np.float64)
        names = [h[2] for h in host]
        length = he - hs
        short = gaps[:, 1] - gaps[:, 0] < SHORT_GAP_US
        if short.any():
            by_host[f"gaps under {SHORT_GAP_US:g} us"] = float(
                (gaps[short, 1] - gaps[short, 0]).sum()) / 1e6
        for a, b in gaps[~short]:
            mid = 0.5 * (a + b)
            live = np.flatnonzero((hs <= mid) & (he >= mid))
            who = (names[live[np.argmin(length[live])]] if len(live)
                   else "no host op")
            by_host[who] = by_host.get(who, 0.0) + (b - a) / 1e6
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])
    return rows, busy, idle


def breakdown(trace: Trace) -> dict:
    ops = sorted(((n[:160], s) for n, (s, _) in trace.rows.items()),
                 key=lambda kv: -kv[1])
    return {"device_ops": [[n, s] for n, s in ops[:10]],
            "idle_gaps": [[n[:160], s] for n, s in trace.idle_gaps[:10]]}


# ------------------------------------------------------------ one run

@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    compared: dict
    setup_s: float
    window_s: float
    memory_peak: int
    trace: Trace | None = None
    readings: tuple | None = None   # a train check's norms, leaf by leaf


def run(c: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float | None = None) -> Result:
    """One run of cell ``c`` on ``device``: set-up, the measured window,
    then the check of what the window produced against the reference.
    ``t_start`` is the process's start on the host clock."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sess = c.driver().Session(c, seed, device)
    sync()
    setup_s = time.perf_counter() - t_start
    log(f"{c.name} seed {seed}: set-up {setup_s:.3f} s")
    if cuda:
        torch.cuda.reset_peak_memory_stats()  # the window's own peak

    prof = None
    profiled = images = steps = 0
    p_t0 = p_t1 = 0.0
    t0 = time.perf_counter()
    while True:
        # a traced run records its profiled steps however short it is
        if (prof is None and time.perf_counter() - t0 >= seconds
                and (not trace or p_t1)):
            break
        if trace and steps == 1 and prof is None and not p_t1:
            from torch.profiler import ProfilerActivity, profile

            sync()
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.start()
            p_t0 = time.perf_counter()
        done = sess.step()
        images += done
        steps += 1
        if prof is not None:
            profiled += done
            if steps == 1 + PROFILED_STEPS:
                sync()
                p_t1 = time.perf_counter()
                prof.stop()
                prof_obj, prof = prof, None
    sess.finish()
    sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"window {window_s:.3f} s, {images} images, {steps} steps, "
        f"peak {peak / 2**30:.2f} GiB")

    tr = None
    if trace:
        rows, busy, idle = read_profile(prof_obj)
        tr = Trace(rows, busy, p_t1 - p_t0, profiled, images, window_s, c,
                   sess.flops_per_image(), idle)
    sess.free_program()
    t_check = time.perf_counter()
    correct, failed, compared = sess.check()
    log(f"check {time.perf_counter() - t_check:.3f} s: correct {correct}")
    values = sess.end_to_end(images, window_s)
    values["setup_s"] = setup_s
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in c.end_to_end}
    return Result(correct, images, failed, metrics, compared, setup_s,
                  window_s, peak, tr, getattr(sess, "readings", None))


def per_layer(res: Result) -> dict:
    """The cell's per-layer metrics from its traced run; a reader that
    finds nothing to read leaves its metric out."""
    out = {}
    for m in res.trace.cell.per_layer:
        value = res.trace.cell.reader(m["name"]).read(res.trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
