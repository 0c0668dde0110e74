"""Tiny cells on the CPU: the published configurations' files with tiny
widths and small images, in a benchmark folder of their own that shares
the real drivers, references and metric readers."""
from __future__ import annotations

import copy
import json
import os
from pathlib import Path

from portbench import core

HRNET_TINY = {
    "spec": {"stage1_blocks": 1, "stage1_channels": 8,
             "stage2_modules": 1, "stage2_channels": [8, 16],
             "stage2_blocks": 1, "stage3_modules": 1,
             "stage3_channels": [8, 16, 32], "stage3_blocks": 1,
             "stage4_modules": 1, "stage4_channels": [8, 16, 32, 64],
             "stage4_blocks": 1},
    "mid_channels": 32, "key_channels": 16, "attn_bot_ch": 16}
WRN_TINY = {"structure": [1, 1, 1, 1, 1, 1],
            "channels": [[8, 8], [16, 16], [16, 16], [16, 32], [16, 32, 48],
                         [32, 48, 64]],
            "stem_ch": 8, "s2_ch": 8}
# config -> (the program's tiny variant of its arch, its widths)
TINY = {
    "hrnet-w48-mscale": ("ocrnet.HRNet_Mscale_Tiny", HRNET_TINY),
    "deepv3plus-w38": ("deepv3.DeepV3PlusW38Tiny", WRN_TINY),
}
SHAPES = {"eval-3scale-bs4": {"batch": 2, "scenes": 4, "hw": [64, 128],
                              "block": 16},
          "train-800-bs8": {"batch": 2, "crops": 6, "hw": [48, 48],
                            "block": 16}}
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


def tiny_root(tmp: Path, f32: bool = True, limits=None) -> tuple:
    """(root, manifest) of the benchmark's cells at tiny size, computed in
    f32 when ``f32`` (held tight against the reference) or in the
    configuration's own bf16. ``limits``: one dict for every cell, or
    ``COMMITTED`` for each cell's own ``limits/<cell>.json``."""
    manifest = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    for d in ("drivers", "reference", "metrics"):
        os.symlink(core.HERE / d, tmp / d)
    for d in ("configs", "traffic", "limits"):
        (tmp / d).mkdir()
    for w in manifest["workloads"]:
        cfg = json.loads((core.HERE / "configs" / f"{w['config']}.json")
                         .read_text())
        arch, widths = TINY[w["config"]]
        cfg["model"].update(copy.deepcopy(widths))
        for kind, prog in cfg["program"].items():
            sets = list(prog["set"]) + [f"model.arch={arch}"]
            if f32:
                sets.append("model.compute_dtype=float32")
            prog["set"] = sets
        (tmp / "configs" / f"{w['config']}.json").write_text(json.dumps(cfg))
        t = json.loads((core.HERE / "traffic" / f"{w['traffic']}.json")
                       .read_text())
        t.update(SHAPES[w["traffic"]])
        (tmp / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
        lim = (core.HERE / "limits" / f"{w['name']}.json").read_text() \
            if limits is COMMITTED else json.dumps(limits or LOOSE)
        (tmp / "limits" / f"{w['name']}.json").write_text(lim)
    return tmp, manifest


def tiny_run(tmp: Path, cell_name: str, seed: int = 7, limits=None,
             seconds: float = 0.5):
    """One run of a tiny f32 cell on the CPU with the look for a chip
    skipped: kernels off, one checked train step."""
    root, manifest = tiny_root(tmp, f32=True, limits=limits or TIGHT)
    cell = core.cell(cell_name, manifest, root)
    for prog in cell.config["program"].values():
        prog["set"] += ["model.use_pallas=false", "model.fused_stage1=false"]
    if cell.traffic["kind"] == "train":
        cell.traffic["checked_steps"] = 1
    return core.run(cell, seed, seconds, False, "cpu")
