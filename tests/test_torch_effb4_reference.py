"""``deepv3.DeepV3PlusEffB4`` against the benchmark's plain reference
``portbench/reference/deepv3plus-effb4.py`` at full width on 2 x 64 x 64
crops, f32 on the CPU, from one seeded state: the state-dict keys and
shapes, eval logits, and one train step with drop path on and the same
seed (the program remat'd, the reference not): the loss, every leaf's
gradient, the parameters after SGD's step and the BN running statistics.
Two mutations of the program must break the step's agreement: the
squeeze-excite gate taken out, and one drop-path mask flipped."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuseg_torch.config import make_config
from tpuseg_torch.losses import get_loss
from tpuseg_torch.models import efficientnet, get_model
from tpuseg_torch.ops import device_normalize
from tpuseg_torch.train.optim import make_optimizer
from tpuseg_torch.train.step import make_train_step

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from portbench import core  # noqa: E402
from portbench.reference.common import seeded_state  # noqa: E402

torch.set_num_threads(1)

CONFIG = json.loads((core.HERE / "configs" / "deepv3plus-effb4.json")
                    .read_text())
M = CONFIG["model"]
SETS = {"model.arch": "deepv3.DeepV3PlusEffB4",
        "model.compute_dtype": "float32", "model.remat": True,
        "dataset.num_classes": 19, "loss.loss_type": "ce"}
STEP_SEED = 2**33 + 5
# f32 on both sides, summing in other orders: the loss agrees to ~2e-7,
# the BN statistics to ~2e-5; the widest leaf's gradient and change (of
# the larger of the leaf's norm and the median leaf's) lie 2.2e-3 and
# 7.8e-3 apart at 1 thread, 8.1e-3 and 8.7e-3 at 2, squeeze-excite's
# reduce convs among them (sums over every pixel that largely cancel), so
# a leaf is held at 3e-2 (a mutation reads over 1)
LOSS_REL, LEAF_REL, STAT_REL = 1e-5, 3e-2, 1e-3


def _reference():
    return core.load_module(core.HERE / "reference" / "deepv3plus-effb4.py")


@pytest.fixture(scope="module")
def setup():
    """(reference module, seeded state, uint8 images, labels)."""
    ref = _reference()
    with torch.device("meta"):
        shapes = ref.build(M)
    state = seeded_state(shapes, 2**40 + 19, "cpu", ref.tails(shapes),
                         CONFIG["weights"]["residual_tail_scale"])
    rng = np.random.RandomState(3)
    image = torch.from_numpy(rng.randint(0, 256, (2, 64, 64, 3),
                                         dtype=np.uint8))
    label = rng.randint(0, 19, (2, 64, 64)).astype(np.uint8)
    label[:, :8] = 255
    return ref, state, image, torch.from_numpy(label)


def _program(state):
    cfg = make_config(SETS)
    model = get_model(cfg).to(memory_format=torch.channels_last)
    model.load_state_dict(state)
    return cfg, model


def _norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def _leaf_gap(got: dict, want: dict) -> float:
    """The widest leaf's |got - want| over max(its reference norm, the
    median leaf's)."""
    med = float(np.median(list(_norms(want).values())))
    return max(float((got[k].double() - want[k].double()).norm())
               / max(float(want[k].double().norm()), med) for k in want)


def _grads(named: dict) -> dict:
    """Each parameter's gradient, zero where it got none."""
    return {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for k, p in named.items()}


def _program_step(state, image, label):
    cfg, model = _program(state)
    criterion, _ = get_loss(cfg)
    opt, schedule = make_optimizer(cfg, model.parameters(), 1)
    step = make_train_step(criterion, schedule)
    torch.manual_seed(STEP_SEED)
    loss = step(model.train(), opt, {"image": image, "label": label}, 0)
    named = dict(model.named_parameters())
    return (float(loss["loss"]), _grads(named),
            {k: p.detach().clone() for k, p in named.items()},
            {k: v.clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))},
            opt.param_groups[0])


def _reference_step(ref, state, image, label, group):
    model = ref.build(M)
    model.load_state_dict(state)
    model.train().set_remat(False)
    torch.manual_seed(STEP_SEED)
    loss = ref.train_loss(model, image, label, M)
    loss.backward()
    opt = torch.optim.SGD(model.parameters(), lr=group["lr"],
                          momentum=group["momentum"],
                          weight_decay=group["weight_decay"],
                          nesterov=group["nesterov"])
    named = dict(model.named_parameters())
    grads = _grads(named)
    opt.step()
    return (float(loss.detach()), grads,
            {k: p.detach().clone() for k, p in named.items()},
            {k: v.clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))})


def test_state_dict_keys_and_shapes_are_the_programs():
    with torch.device("meta"):
        want = _reference().build(M).state_dict()
        got = get_model(make_config(SETS)).state_dict()
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert len(got) == 743


def test_eval_logits_agree(setup):
    ref, state, image, _ = setup
    model = ref.build(M)
    model.load_state_dict(state)
    stats = ref.calibrate(model.eval(), image, M)
    _, program = _program({**state, **stats})
    with torch.no_grad():
        want = ref.eval_logits(model.eval(), image, M)
        got = program.eval()(device_normalize(image))["pred"]
    got = got.permute(0, 3, 1, 2)
    assert got.shape == want.shape == (2, 19, 64, 64)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def _flip_first_mask(monkeypatch):
    draw = efficientnet.drop_path
    calls = []

    def flipped(x, rate):
        calls.append(1)
        if len(calls) > 1:
            return draw(x, rate)
        keep = 1.0 - rate
        mask = torch.empty((x.shape[0], 1, 1, 1), dtype=x.dtype) \
            .bernoulli_(keep)
        mask[0] = 1 - mask[0]
        return x * mask / keep
    monkeypatch.setattr(efficientnet, "drop_path", flipped)


@pytest.mark.parametrize("mutation", ["none", "se_gate_removed",
                                      "drop_mask_flipped"])
def test_train_step_agrees_only_when_sound(setup, monkeypatch, mutation):
    ref, state, image, label = setup
    if mutation == "se_gate_removed":
        monkeypatch.setattr(efficientnet.SqueezeExcite, "forward",
                            lambda self, x: x)
    elif mutation == "drop_mask_flipped":
        _flip_first_mask(monkeypatch)
    loss, grads, params, stats, group = _program_step(state, image, label)
    monkeypatch.undo()
    r_loss, r_grads, r_params, r_stats = _reference_step(
        ref, state, image, label, group)
    gaps = {"loss": abs(loss - r_loss) / abs(r_loss),
            "grad": _leaf_gap(grads, r_grads),
            "change": _leaf_gap({k: params[k] - state[k] for k in params},
                                {k: r_params[k] - state[k]
                                 for k in r_params}),
            "stats": _leaf_gap({k: stats[k] - state[k] for k in stats},
                               {k: r_stats[k] - state[k] for k in r_stats})}
    within = (gaps["loss"] <= LOSS_REL and gaps["grad"] <= LEAF_REL
              and gaps["change"] <= LEAF_REL and gaps["stats"] <= STAT_REL)
    assert within == (mutation == "none"), gaps
