"""The control: each cell's plain reference with float8 e4m3 operands in
the program's place comes out not correct under the cell's comparison, at
a tiny size on the CPU (on the card it is read at the cells' own sizes by
``portbench/control.py``)."""
import pytest

import _tiny
from portbench.control import control_readings
from portbench import core


@pytest.mark.parametrize("name", ["hrnet-w48-mscale.eval-3scale-bs4",
                                  "deepv3plus-w38.train-800-bs8"])
def test_control_is_not_correct(tmp_path, name):
    root, manifest = _tiny.tiny_root(tmp_path, limits=_tiny.TIGHT)
    cell = core.cell(name, manifest, root)
    if cell.traffic["kind"] == "train":
        cell.traffic["checked_steps"] = 1
    sess = cell.driver().Session(cell, 5, "cpu")
    sess.free_program()
    got = control_readings(sess, cell.traffic["kind"])
    assert any(v > cell.limits[k] for k, v in got.items()
               if k in cell.limits), got
