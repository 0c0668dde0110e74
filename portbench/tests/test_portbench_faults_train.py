"""A train cell's comparison finds each fault planted under its timed
path, on a tiny f32 cell on the CPU with the look for a chip skipped:
``CELL`` under limits that f32 rounding alone meets, and every train cell
of ``BENCHMARK.json`` under its committed limits; and a window whose state
turns non-finite is not correct."""
import pytest
import torch

import _tiny
from portbench import faults

CELL = "deepv3plus-w38.train-800-bs8"


@pytest.mark.parametrize("cell,limits", _tiny.fault_cases("train", CELL))
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_not_correct(tmp_path, monkeypatch, fault, cell, limits):
    faults.plant("train", fault, monkeypatch)
    res = _tiny.tiny_run(tmp_path, cell, limits=limits)
    assert not res.correct, (fault, res.compared)


def test_a_non_finite_window_is_not_correct(tmp_path, monkeypatch):
    """A step of the window (after the checked ones) that leaves a NaN in
    the parameters."""
    sgd_step = torch.optim.SGD.step
    calls = []

    def late_nan(self, closure=None):
        calls.append(1)
        out = sgd_step(self, closure)
        if len(calls) == 2:
            with torch.no_grad():
                self.param_groups[0]["params"][0].fill_(float("nan"))
        return out

    monkeypatch.setattr(torch.optim.SGD, "step", late_nan)
    res = _tiny.tiny_run(tmp_path, CELL, limits=_tiny.COMMITTED)
    assert len(calls) >= 2
    assert res.compared["window_nonfinite"]["value"] > 0
    assert not res.correct
