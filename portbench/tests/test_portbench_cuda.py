"""Each cell of ``BENCHMARK.json`` run on the card for 10 seconds, its last
line held to the result's shape. Skips without an NVIDIA GPU; on the card:

    python -m pytest portbench/tests/test_portbench_cuda.py -q
"""
import json
import subprocess
import sys

import pytest
import torch

from portbench import core

CELLS = [w["name"] for w in json.loads(
    (core.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_prints_one_result_line(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: runs the benchmark's cells")
    cell = core.cell(name)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(2**31 + 17), "--seconds", "10", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=str(core.ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == cell.chips
    assert dev["kind"] == torch.cuda.get_device_name(0)
    assert dev["memory_peak_bytes"] > 0
    last = out.stderr.strip().splitlines()[-len(line["compared"]):]
    assert [s.split()[0] for s in last] == list(line["compared"])
