"""Readings that set a cell's limits; not run by the benchmark's runs.

    python3 portbench/control.py --workload <cell> --program SEED ... \
        --control SEED ... [--seconds S] [--fault NAME ...]

``--program``: full runs of the cell in one process, one a seed, with a
short window (the lower readings: what sound runs of the program give).
``--fault``: those runs with each named fault of ``portbench/faults.py``
planted under the timed path, in place of the sound ones (the faults'
readings).
``--dump DIR`` writes each train reading's norms leaf by leaf there.
``--control``: the control on the same inputs: the cell's plain reference
computed with float8 e4m3 operands (the step below the bfloat16 the
configurations state) put in the program's place and held against the f32
reference by the cell's own comparison (the upper readings). Each reading
is one JSON line on standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def control_readings(sess, kind: str, dump=None) -> dict:
    """The cell's compared numbers of the FP8 control on ``sess``'s inputs
    (its program already freed)."""
    import torch

    from portbench.reference.common import FP8

    if kind == "eval":
        want = sess.reference_logits()
        low = sess.reference_logits(FP8)
        preds = [torch.stack([low[k * sess.b + r].argmax(0)
                              for r in range(sess.b)])
                 for k in range(len(sess.batches))]
        got = sess.compare(preds, list(range(len(sess.batches))), want)
        return {"logit_gap": float(got["gaps"].max()),
                "mismatch_pct": 100 * float(got["mismatch"].mean())}
    low, want = sess.reference_steps(FP8), sess.reference_steps()
    if dump is not None:
        _dump(dump, {"control": low, "reference": want})
    return sess.compare(low, want)


def _dump(path: Path, readings: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(readings, default=float))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--dump", type=Path, default=None)
    ap.add_argument("--fault", nargs="*", default=[])
    args = ap.parse_args(argv)

    from portbench import core, faults

    cell = core.cell(args.workload)
    for fault in args.fault or [None]:
        patch = faults.Patch()
        if fault:
            faults.plant(cell.traffic["kind"], fault, patch)
        side = fault or "program"
        for seed in args.program:
            res = core.run(cell, seed, args.seconds, False, "cuda:0")
            if args.dump is not None and res.readings is not None:
                got, want = res.readings
                _dump(args.dump / f"{side}-{seed}.json",
                      {"program": got, "reference": want})
            print(json.dumps({"side": side, "seed": seed,
                              "correct": res.correct,
                              **{k: v["value"]
                                 for k, v in res.compared.items()}}),
                  flush=True)
        patch.undo()
    for seed in args.control:
        t0 = time.perf_counter()
        sess = cell.driver().Session(cell, seed, "cuda:0")
        sess.free_program()
        got = control_readings(
            sess, cell.traffic["kind"],
            args.dump / f"control-{seed}.json" if args.dump else None)
        print(json.dumps({"side": "control", "seed": seed,
                          "seconds": time.perf_counter() - t0, **got}),
              flush=True)
        del sess
    return 0


if __name__ == "__main__":
    sys.exit(main())
