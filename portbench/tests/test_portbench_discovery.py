"""A configuration, a traffic mix and a per-layer metric are added as new
files and ``BENCHMARK.json`` entries alone: the harness finds them by name
in a copy of the benchmark's folder where no existing file was edited."""
import json
import shutil

from portbench import core


def test_new_files_alone_make_a_cell(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(core.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    manifest = json.loads((core.ROOT / "BENCHMARK.json").read_text())

    cfg = json.loads((root / "configs" / "deepv3plus-w38.json").read_text())
    cfg["reference"] = "deepv3plus-w38"
    (root / "configs" / "dummy-net.json").write_text(json.dumps(cfg))
    (root / "traffic" / "train-dummy.json").write_text(json.dumps(
        {"kind": "train", "batch": 2, "crops": 6, "hw": [64, 64],
         "ignore_share": 0.1, "block": 16, "steps_per_epoch": 10,
         "checked_steps": 3}))
    (root / "limits" / "dummy-net.train-dummy.json").write_text(json.dumps(
        {"loss_gap": 1.0, "grad_gap": 1.0, "change_gap": 1.0,
         "stats_gap": 1.0}))
    (root / "metrics" / "dummy_ms_per_img.train.py").write_text(
        "def read(trace):\n"
        "    sec, n = trace.seconds(lambda name: 'dummy' in name)\n"
        "    return 1e3 * sec / trace.images if n else None\n")
    manifest["configs"].append({"name": "dummy-net", "source": "x",
                                "file": "portbench/configs/dummy-net.json",
                                "reduced": cfg["reduced"], "why": "x"})
    manifest["workloads"].append({"name": "dummy-net.train-dummy",
                                  "config": "dummy-net",
                                  "traffic": "train-dummy", "chips": 1,
                                  "why": "x"})
    manifest["end_to_end"][1]["workloads"].append("dummy-net.train-dummy")
    manifest["per_layer"].append({"name": "dummy_ms_per_img.train",
                                  "unit": "ms/img", "better": "lower",
                                  "source": "device_trace", "layer": "x",
                                  "moves": "train_img_s",
                                  "workloads": ["dummy-net.train-dummy"]})

    cell = core.cell("dummy-net.train-dummy", manifest, root)
    assert cell.traffic["hw"] == [64, 64] and cell.limits["loss_gap"] == 1.0
    assert cell.reference().__file__.endswith("deepv3plus-w38.py")
    assert hasattr(cell.driver(), "Session")
    assert [m["name"] for m in cell.per_layer] == ["dummy_ms_per_img.train"]
    trace = core.Trace({"dummy_kernel": (0.004, 2), "other": (1.0, 5)},
                       busy_s=1.0, span_s=2.0, images=4, window_images=8,
                       window_s=4.0, cell=cell)
    res = core.Result(True, 8, 0, {}, {}, 1.0, 4.0, 0, trace)
    assert core.per_layer(res) == {
        "dummy_ms_per_img.train": {"value": 1.0, "unit": "ms/img"}}
    after = {p: p.read_bytes() for p in before}
    assert after == before
