"""Each frozen reference against ``tpuseg_torch`` with its kernels off, at
a tiny size in f32 on the CPU: the whole run of each cell, held at limits
that f32 rounding alone meets, and the references' outputs beside the
program's."""
import pytest
import torch

import _tiny
from portbench import core
from portbench.reference.common import f32_math, seeded_state

CELLS = ["hrnet-w48-mscale.eval-3scale-bs4",
         "deepv3plus-w38.train-800-bs8"]


@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_is_correct(tmp_path, name):
    res = _tiny.tiny_run(tmp_path, name)
    assert res.correct, res.compared
    assert res.attempted > 0 and res.failed == 0


def test_hrnet_reference_logits_match_the_program(tmp_path):
    from tpuseg_torch.ops import device_normalize

    root, manifest = _tiny.tiny_root(tmp_path)
    cell = core.cell(CELLS[0], manifest, root)
    sess = cell.driver().Session(cell, 11, "cpu")
    image = torch.from_numpy(sess.images[:2])
    with torch.no_grad():
        got = sess.model(device_normalize(image))["pred"].permute(0, 3, 1, 2)
    sess.free_program()
    want = torch.stack(sess.reference_logits()[:2])
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("config,kind", [("hrnet-w48-mscale", "eval"),
                                         ("deepv3plus-w38", "train")])
def test_reference_state_dict_matches_the_program(config, kind):
    """At the published widths: every state-dict key and shape of the
    program's model is the reference's."""
    import json

    from tpuseg_torch.config import eval_model_config
    from tpuseg_torch.models import get_model

    from portbench.inputs import program_config

    cfg = json.loads((core.HERE / "configs" / f"{config}.json").read_text())
    ref = core.load_module(core.HERE / "reference" / f"{config}.py")
    with torch.device("meta"):
        shapes = ref.build(cfg["model"]).state_dict()
        program = get_model(eval_model_config(program_config(cfg, kind)))
    want = {k: v.shape for k, v in program.state_dict().items()}
    assert {k: v.shape for k, v in shapes.items()} == want


def test_seeded_state_is_the_seeds(tmp_path):
    with torch.device("meta"):
        ref = core.cell(CELLS[0]).reference().build(
            {**core.cell(CELLS[0]).config["model"], **_tiny.HRNET_TINY})
    a = seeded_state(ref, 2**40 + 3, "cpu")
    b = seeded_state(ref, 2**40 + 3, "cpu")
    c = seeded_state(ref, 2**40 + 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["backbone.conv1.weight"],
                           c["backbone.conv1.weight"])
    with f32_math():
        assert not torch.backends.cudnn.allow_tf32
