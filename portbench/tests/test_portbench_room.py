"""A configuration and a traffic mix join the benchmark, and every CPU test
of it that is parametrised from ``BENCHMARK.json``, by new files and
entries appended to ``BENCHMARK.json``'s lists alone.

In a copy of the benchmark's folder beside the program, a configuration
(``deepv3plus-w38``'s file under a new name and source) gets a cell on the
existing mix ``train-800-bs8`` and one on a new mix, each with its limits
and tiny files. The copy's own tests, run there, take the two new cells in
beside the old ones: each new cell's tiny run is correct, and its control
and its committed-limit faults are not; every test that was there passes;
and no file that was there changes."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import core, faults

CONFIG = "copy-w38"
MIX = "train-640x960-bs4"
CELLS = [f"{CONFIG}.train-800-bs8", f"{CONFIG}.{MIX}"]
TESTS = "portbench/tests"


def _pytest(room: Path, *args) -> subprocess.CompletedProcess:
    """The copy's own CPU tests, this file left out."""
    return subprocess.run(
        [sys.executable, "-m", "pytest", TESTS, "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-k", "not cuda",
         "--ignore", f"{TESTS}/{Path(__file__).name}", *args],
        capture_output=True, text=True, timeout=900, cwd=str(room))


def _write(path: Path, body: dict) -> None:
    path.write_text(json.dumps(body, indent=1))


def _add_cells(room: Path) -> None:
    """New files, and entries at the ends of ``BENCHMARK.json``'s lists."""
    bench = room / "portbench"
    tiny = bench / "tests" / "tiny"
    cfg = json.loads((bench / "configs" / "deepv3plus-w38.json").read_text())
    cfg["source"] = "https://example.org/copy-w38"
    cfg["reference"] = "deepv3plus-w38"
    _write(bench / "configs" / f"{CONFIG}.json", cfg)
    shutil.copy(tiny / "configs" / "deepv3plus-w38.json",
                tiny / "configs" / f"{CONFIG}.json")
    _write(bench / "traffic" / f"{MIX}.json",
           {"kind": "train", "batch": 4, "crops": 12, "hw": [640, 960],
            "ignore_share": 0.2, "block": 64, "steps_per_epoch": 100,
            "checked_steps": 3})
    _write(tiny / "traffic" / f"{MIX}.json",
           {"batch": 2, "crops": 4, "hw": [32, 48], "block": 8})
    for c in CELLS:
        shutil.copy(bench / "limits" / "deepv3plus-w38.train-800-bs8.json",
                    bench / "limits" / f"{c}.json")

    manifest = json.loads((room / "BENCHMARK.json").read_text())
    manifest["configs"].append(
        {"name": CONFIG, "source": cfg["source"],
         "file": f"portbench/configs/{CONFIG}.json",
         "reduced": cfg["reduced"], "why": "a copy of deepv3plus-w38"})
    for c in CELLS:
        manifest["workloads"].append(
            {"name": c, "config": CONFIG, "traffic": c.split(".", 1)[1],
             "chips": 1, "why": "a cell of the copy"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if m["name"] in ("train_img_s", "mfu_pct.train",
                         "device_idle_pct.train"):
            m["workloads"] += CELLS
    _write(room / "BENCHMARK.json", manifest)


def _outcomes(out: str) -> dict:
    """test id -> outcome, from ``-rA``'s summary."""
    got = {}
    for line in out.splitlines():
        word, _, rest = line.partition(" ")
        if word in ("PASSED", "FAILED", "ERROR") and "::" in rest:
            got[rest.split(" - ")[0]] = word
    return got


def test_a_configuration_and_a_mix_join_by_new_files_alone(tmp_path):
    room = tmp_path / "repo"
    shutil.copytree(core.HERE, room / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(core.ROOT / "BENCHMARK.json", room / "BENCHMARK.json")
    (room / "tpuseg_torch").symlink_to(core.ROOT / "tpuseg_torch")
    before = {p: p.read_bytes() for p in (room / "portbench").rglob("*")
              if p.is_file()}
    listed = _pytest(room, "--collect-only")
    assert listed.returncode == 0, listed.stdout[-4000:]
    old = {line for line in listed.stdout.splitlines() if "::" in line}

    _add_cells(room)
    ran = _pytest(room, "-rA")
    assert ran.returncode == 0, ran.stdout[-8000:]
    got = _outcomes(ran.stdout)
    assert set(got.values()) == {"PASSED"}
    assert old <= set(got), sorted(old - set(got))
    want = {f"{TESTS}/test_portbench_reference.py::"
            f"test_reference_state_dict_matches_the_program[{CONFIG}-train]",
            f"{TESTS}/test_portbench_manifest.py::"
            f"test_tiny_file_is_there[configs-{CONFIG}]",
            f"{TESTS}/test_portbench_manifest.py::"
            f"test_tiny_file_is_there[traffic-{MIX}]"}
    for c in CELLS:
        want |= {f"{TESTS}/test_portbench_reference.py::"
                 f"test_tiny_cell_is_correct[{c}]",
                 f"{TESTS}/test_portbench_control.py::"
                 f"test_control_is_not_correct[{c}]"}
        want |= {f"{TESTS}/test_portbench_faults_train.py::"
                 f"test_fault_is_not_correct[{f}-committed-{c}]"
                 for f in faults.FAULTS}
    assert want <= set(got) - old, sorted(want - set(got))
    assert all(p.read_bytes() == b for p, b in before.items())
