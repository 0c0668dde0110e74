"""The port's LR schedules and optimizers against tpuseg's optax chains:
schedules stepped across epoch boundaries, and SGD / Adam / RAdam
trajectories on a small parameter tree whose gradient is a fixed function
of the parameters. The trajectories run in float64 on both sides (JAX's
x64 mode inside the test): in f32 RAdam's rectification term, a
difference of two numbers near 2000, would be ~1e-2 apart between the two
packages."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import set_threads
from tpuseg.config import make_config as jax_make_config
from tpuseg.train.optim import make_optimizer as jax_make_optimizer
from tpuseg.train.optim import make_schedule as jax_make_schedule
from tpuseg_torch.config import make_config
from tpuseg_torch.train.optim import make_optimizer, make_schedule, set_lr

set_threads()

STEPS_PER_EPOCH = 2
# a short run, so the LR moves a lot at every epoch boundary
SETS = {"train.max_epoch": 5, "optim.lr": 0.05, "optim.weight_decay": 1e-2,
        "loss.reduce_border_epoch": 2, "optim.poly_step": 2}


@pytest.mark.parametrize("schedule", ["poly", "poly2", "scl-poly"])
def test_schedule_matches_tpuseg(schedule):
    sets = {**SETS, "optim.lr_schedule": schedule}
    got = make_schedule(make_config(sets), STEPS_PER_EPOCH)
    want = jax_make_schedule(jax_make_config(sets), STEPS_PER_EPOCH)
    values = [got(s) for s in range(12)]
    # constant within an epoch, moving at each boundary
    assert values[0] == values[1] and values[2] == values[3]
    assert values[1] != values[2]
    for s, v in enumerate(values):
        # tpuseg's jnp branches compute in f32
        assert abs(v - float(want(jnp.int32(s)))) <= 1e-6 * abs(v) + 1e-12


def _grad(params: dict) -> dict:
    """A fixed gradient field: linear in the parameters, nonzero at 0."""
    return {"w": 0.3 * params["w"] + np.linspace(-1.0, 1.0, 12).reshape(4, 3),
            "b": -0.5 * params["b"] + 0.2}


def _port_trajectory(cfg, p0: dict, steps: int) -> list:
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in p0.items()}
    opt, schedule = make_optimizer(cfg, list(params.values()),
                                   STEPS_PER_EPOCH)
    out = []
    for step in range(steps):
        g = _grad({k: p.detach().numpy() for k, p in params.items()})
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        set_lr(opt, schedule(step))        # as train_step sets it
        opt.step()
        out.append({k: p.detach().numpy().copy() for k, p in params.items()})
    return out


def _jax_trajectory(cfg, p0: dict, steps: int) -> list:
    tx, _ = jax_make_optimizer(cfg, STEPS_PER_EPOCH)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)
    out = []
    for _ in range(steps):
        g = _grad({k: np.asarray(v) for k, v in params.items()})
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, params)
        params = optax.apply_updates(params, updates)
        out.append({k: np.asarray(v) for k, v in params.items()})
    return out


@pytest.mark.parametrize("optimizer", ["sgd", "adam", "radam"])
def test_optimizer_trajectory_matches_tpuseg(optimizer):
    # 8 steps: 4 epoch boundaries, and RAdam's rectification starts at
    # step 6 (rho_t = 5.994 > 5; 4.996 at step 5) in both packages
    steps = 8
    sets = {**SETS, "optim.optimizer": optimizer, "optim.momentum": 0.9}
    rng = np.random.RandomState(0)
    p0 = {"w": rng.randn(4, 3), "b": rng.randn(3)}   # float64
    got = _port_trajectory(make_config(sets), p0, steps)
    with jax.enable_x64(True):
        want = _jax_trajectory(jax_make_config(sets), p0, steps)
    # float64 on both sides but tpuseg's LR, which its schedule computes in
    # f32 (int32 step): SGD and Adam agree to an f32 rounding of the LR,
    # measured 1.5e-8 of the distance moved. torch's RAdam adds eps to
    # sqrt(v) before the bias correction, optax after, which moves a
    # rectified step by ~eps / sqrt(v_t) (5e-7 here)
    tol = 1e-5 if optimizer == "radam" else 1e-7
    for k in range(steps):
        for name in p0:
            moved = np.abs(want[k][name] - p0[name]).sum()
            err = np.abs(got[k][name] - want[k][name]).sum()
            assert err <= tol * moved, (optimizer, k, name, err, moved)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="optimizer"):
        make_optimizer(make_config({"optim.optimizer": "lamb"}),
                       [torch.nn.Parameter(torch.zeros(1))])
