"""An eval cell's comparison finds each fault planted under its timed
path, on a tiny f32 cell on the CPU with the look for a chip skipped:
``CELL`` under limits that f32 rounding alone meets, and every eval cell
of ``BENCHMARK.json`` under its committed limits."""
import pytest

import _tiny
from portbench import faults

CELL = "hrnet-w48-mscale.eval-3scale-bs4"


@pytest.mark.parametrize("cell,limits", _tiny.fault_cases("eval", CELL))
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_not_correct(tmp_path, monkeypatch, fault, cell, limits):
    faults.plant("eval", fault, monkeypatch)
    res = _tiny.tiny_run(tmp_path, cell, limits=limits)
    assert not res.correct, (fault, res.compared)
    assert res.failed > 0
