"""Tiny cells on the CPU: the published configurations' files with tiny
widths and small images, in a benchmark folder of their own that shares
the real drivers, references and metric readers.

Each configuration's tiny variant and each mix's small shapes are data
files found by name, so a new cell brings its own and joins every test
that is parametrised from ``BENCHMARK.json``:

- ``tiny/configs/<config>.json``: ``{"arch": <the program's arch>,
  "model": {<widths over the configuration's "model">}}``; the model dict
  may be empty (a full-width model on small images);
- ``tiny/traffic/<traffic>.json``: the keys of the mix's file it
  overrides (batch, sizes, counts).
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import pytest

from portbench import core

TINY = Path(__file__).resolve().parent / "tiny"
MANIFEST = json.loads((core.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
LOOSE = {"logit_gap": 1e9, "hist_diff": 0,
         "loss_gap": 1e9, "grad_gap": 1e9, "change_gap": 1e9,
         "stats_gap": 1e9, "window_nonfinite": 0}
# limits for the tiny cells computed in f32 on both sides: f32 rounding
# gives under 2e-3 on every number (one checked step), none at all on the
# eval's predictions
TIGHT = {"logit_gap": 1e-3, "hist_diff": 0,
         "loss_gap": 1e-4, "grad_gap": 1e-2, "change_gap": 1e-2,
         "stats_gap": 1e-3, "window_nonfinite": 0}
# each cell held to its committed limits
COMMITTED = "committed"


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def tiny_config(config: str) -> dict:
    return _json(TINY / "configs" / f"{config}.json")


def kind_of(w: dict) -> str | None:
    """The ``kind`` of workload ``w``'s mix; None where its file does not
    read, which fails that cell's own tests and no other's."""
    try:
        return _json(core.HERE / "traffic" / f"{w['traffic']}.json")["kind"]
    except (OSError, ValueError, KeyError):
        return None


def config_kinds() -> list:
    """(config, mix kind) of every cell, each pair once, in the
    manifest's order."""
    pairs = [(w["config"], kind_of(w)) for w in MANIFEST["workloads"]]
    return list(dict.fromkeys(p for p in pairs if p[1] is not None))


def fault_cases(kind: str, tight_cell: str) -> list:
    """The fault tests' (cell, limits) cases for mix ``kind``: the
    f32-tight limits on ``tight_cell``, and every cell of the kind under
    its committed limits (``tight_cell``'s case keeps the id
    ``committed``)."""
    cases = [pytest.param(tight_cell, TIGHT, id="tight")]
    for w in MANIFEST["workloads"]:
        if kind_of(w) == kind:
            c = w["name"]
            name = "committed" if c == tight_cell else f"committed-{c}"
            cases.append(pytest.param(c, COMMITTED, id=name))
    return cases


def tiny_root(tmp: Path, f32: bool = True, limits=None, cells=None) -> tuple:
    """(root, manifest) of the benchmark's cells at tiny size, computed in
    f32 when ``f32`` (held tight against the reference) or in the
    configuration's own bf16. ``limits``: one dict for every cell, or
    ``COMMITTED`` for each cell's own ``limits/<cell>.json``. ``cells``:
    the cells to build, all by default."""
    for d in ("drivers", "reference", "metrics"):
        os.symlink(core.HERE / d, tmp / d)
    for d in ("configs", "traffic", "limits"):
        (tmp / d).mkdir()
    for w in MANIFEST["workloads"]:
        if cells is not None and w["name"] not in cells:
            continue
        cfg = _json(core.HERE / "configs" / f"{w['config']}.json")
        small = tiny_config(w["config"])
        cfg["model"].update(small["model"])
        for prog in cfg["program"].values():
            sets = list(prog["set"]) + [f"model.arch={small['arch']}"]
            if f32:
                sets.append("model.compute_dtype=float32")
            prog["set"] = sets
        (tmp / "configs" / f"{w['config']}.json").write_text(json.dumps(cfg))
        t = _json(core.HERE / "traffic" / f"{w['traffic']}.json")
        t.update(_json(TINY / "traffic" / f"{w['traffic']}.json"))
        (tmp / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
        lim = (core.HERE / "limits" / f"{w['name']}.json").read_text() \
            if limits is COMMITTED else json.dumps(limits or LOOSE)
        (tmp / "limits" / f"{w['name']}.json").write_text(lim)
    return tmp, MANIFEST


def tiny_run(tmp: Path, cell_name: str, seed: int = 7, limits=None,
             seconds: float = 0.5):
    """One run of a tiny f32 cell on the CPU with the look for a chip
    skipped: kernels off, one checked train step."""
    root, manifest = tiny_root(tmp, f32=True, limits=limits or TIGHT,
                               cells=[cell_name])
    cell = core.cell(cell_name, manifest, root)
    for prog in cell.config["program"].values():
        prog["set"] += ["model.use_pallas=false", "model.fused_stage1=false"]
    if cell.traffic["kind"] == "train":
        cell.traffic["checked_steps"] = 1
    return core.run(cell, seed, seconds, False, "cpu")
