"""Run one cell of the benchmark of ``tpuseg_torch`` once and print its
result as one JSON line, last on standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The run makes its inputs and weights from ``--seed``, sets up and warms the
program for the cell's one shape, measures for ``--seconds``, then checks
what the window produced against the cell's plain reference. With
``--trace 1`` it records a few steps of the window with ``torch.profiler``
and reports the cell's per-layer metrics in place of its end-to-end ones.

It needs as many CUDA devices as the cell asks for, and exits with a code
other than 0, printing no result, without them or if JAX or ``tpuseg`` was
loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# a library the program uses never loads JAX on its own
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def _finite(v):
    """``v`` with every non-finite number (a check that found nothing to
    compare) as null, so that the line is strict JSON."""
    if isinstance(v, dict):
        return {k: _finite(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_finite(x) for x in v]
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import core

    cell = core.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    core.log(f"set-up python, torch and the device look: "
             f"{time.perf_counter() - T_START:.3f} s")
    res = core.run(cell, args.seed, args.seconds, bool(args.trace),
                   "cuda:0", T_START)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": res.memory_peak}
    line = {"correct": res.correct, "attempted": res.attempted,
            "failed": min(res.failed, res.attempted)}
    if args.trace:
        line["metrics"] = core.per_layer(res)
        device["busy_s"] = res.trace.busy_s
        device["window_s"] = res.trace.span_s
        line["device"] = device
        line["breakdown"] = core.breakdown(res.trace)
    else:
        line["metrics"] = res.metrics
        line["device"] = device
    line["compared"] = res.compared

    found = core.forbidden_modules()
    if found:
        print(f"loaded by this run, which may load none of "
              f"{core.FORBIDDEN}: {found}", file=sys.stderr)
        return 3
    for name, v in res.compared.items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(line), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
