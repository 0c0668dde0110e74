"""``BENCHMARK.json`` against the benchmark's contract: names, units and
lengths, what each metric moves, the cells' chips, and every file a cell
needs found by name."""
import ast
import json
import math
import re

import pytest

from portbench import core

MANIFEST = json.loads((core.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# keys that name a width, which a configuration may never cut
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|experts_per|channels|_ch$|spec)")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
    cmd = MANIFEST["command"]
    assert len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd:
        if w.endswith(".py") or "/" in w:
            assert any(w.startswith(p + "/") for p in MANIFEST["paths"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_unique_and_allowed(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_entries_have_only_their_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_pairs_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    cells = len(MANIFEST["workloads"])
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, math.floor(cells / 4))
    assert 1 <= cells <= 24 and 1 <= len(MANIFEST["configs"]) <= 24


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_metric_moves_one_its_cells_report():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = [w["name"] for w in MANIFEST["workloads"]]
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        for c in cells:
            if _reports(m, c):
                assert _reports(e2e[m["moves"]], c), (m["name"], c)
    for c in cells:
        got = [n for n, m in e2e.items() if _reports(m, c)]
        assert "setup_s" in got and len(got) >= 2
        assert any(_reports(m, c) for m in MANIFEST["per_layer"])
    for name in [m["name"] for m in MANIFEST["per_layer"]]:
        if "roofline" in name:
            assert name.endswith("_roofline")


def test_configs_are_files_under_paths():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        body = json.loads((core.ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        assert sorted(c["reduced"]) == sorted(body["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key) and key in body
            assert not WIDTH.search(key), key
        assert (core.HERE / "reference"
                / f"{body.get('reference', c['name'])}.py").exists()


def test_every_cell_finds_its_files():
    for w in MANIFEST["workloads"]:
        cell = core.cell(w["name"])
        assert cell.chips == w["chips"]
        assert (core.HERE / "drivers" / f"{cell.traffic['kind']}.py").exists()
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]).read)
        assert cell.limits


def test_readers_define_read():
    for m in MANIFEST["per_layer"]:
        src = (core.HERE / "metrics" / f"{m['name']}.py").read_text()
        tree = ast.parse(src)
        assert any(isinstance(n, ast.FunctionDef) and n.name == "read"
                   for n in tree.body), m["name"]
