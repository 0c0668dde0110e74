"""The attention-scale family at full width: every factory of mscale,
mscale2, attnscale, basic and deeper built by the port's get_model, and
loaded strictly from tpuseg's variable tree of the same factory through
the port's key map (``state_dict_from_flax(..., arch=...)``), no key left
unused; and mscale.HRNet's two-scale eval logits vs tpuseg's on a seeded
64x64 image (the smallest side whose 0.5x pass the W48 trunk's stride-32
branch takes).

Only shapes are traced for the key map (``jax.eval_shape``), and each
trunk only once: a factory's tree is its trunk's (traced alone, once a
trunk) under ``backbone`` beside its heads', traced by tpuseg's own head
code over a stand-in trunk that returns zero taps of the trunk's
channels.
"""
import inspect

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import max_abs, quick_jit, randomize, set_threads
from tpuseg.config import make_config as jax_make_config
from tpuseg.models import attnscale as jattnscale
from tpuseg.models import basic as jbasic
from tpuseg.models import deeper as jdeeper
from tpuseg.models import get_model as jax_get_model
from tpuseg.models import mscale as jmscale
from tpuseg.models import mscale2 as jmscale2
from tpuseg.models import trunks as jtrunks
from tpuseg_torch.config import make_config
from tpuseg_torch.convert import state_dict_from_flax
from tpuseg_torch.models import (PORTED, attnscale, basic, deeper,
                                 get_model, mscale, mscale2)

set_threads()
FAMILY = ("mscale", "mscale2", "attnscale", "basic", "deeper")
ARCHS = [f"{m}.{f}" for m in FAMILY for f in PORTED[m]]
JAX_MODULES = (jmscale, jmscale2, jattnscale, jbasic, jdeeper)
FACTORIES = {m.__name__.rsplit(".", 1)[1]: m.FACTORIES
             for m in (mscale, mscale2, attnscale, basic, deeper)}


def sets(arch, **over):
    # tpuseg's EfficientNet trunk does not trace under model.remat
    return {"model.arch": arch, "model.compute_dtype": "float32",
            "model.remat": False, **over}


class _StandInTrunk(nn.Module):
    """Zero taps at strides 2, 4 and 8 of the trunk's channels."""

    channels: tuple

    @nn.compact
    def __call__(self, x, train=False):
        n, h, w, _ = x.shape
        return tuple(None if c == -1 else jnp.zeros((n, h // s, w // s, c))
                     for c, s in zip(self.channels, (2, 4, 8)))


_TRUNKS: dict = {}


def _trunk(name):
    """-> (variable shapes, tap channels) of tpuseg's trunk ``name``,
    traced once."""
    if name not in _TRUNKS:
        trunk, *channels = jtrunks.get_trunk(name, dtype=jnp.float32)
        shapes = jax.eval_shape(lambda: trunk.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), False))
        _TRUNKS[name] = (_plain(shapes), tuple(channels))
    return _TRUNKS[name]


def _stand_in_get_trunk(name, *args, **kw):
    channels = _trunk(name)[1]
    return (_StandInTrunk(channels), *channels)


def _plain(tree):
    return {k: _plain(v) if hasattr(v, "items") else v
            for k, v in tree.items()}


_SHAPES: dict = {}


def tpuseg_shapes(arch):
    """tpuseg's variable shapes of ``arch`` (the trunk's from its own
    trace, the rest from the factory's)."""
    if arch not in _SHAPES:
        module, factory = arch.split(".")
        trunk = _trunk(FACTORIES[module][factory][1])[0]
        with pytest.MonkeyPatch.context() as mp:
            for mod in JAX_MODULES:
                mp.setattr(mod, "get_trunk", _stand_in_get_trunk)
            model = jax_get_model(jax_make_config(sets(arch)))
            heads = _plain(jax.eval_shape(lambda: model.init(
                jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                train=False)))
        _SHAPES[arch] = {coll: {**heads.get(coll, {}), "backbone": tree}
                         for coll, tree in trunk.items()}
    return _SHAPES[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_factory_builds_and_loads_strictly(arch):
    """get_model builds the factory at full width, as tpuseg's class on
    tpuseg's trunk, and tpuseg's tree of it loads strictly."""
    with torch.device("meta"):
        model = get_model(make_config(sets(arch)))
    module, factory = arch.split(".")
    cls, trunk = FACTORIES[module][factory][:2]
    jm = jax_get_model(jax_make_config(sets(arch)))
    assert type(model) is cls and type(jm).__name__ == cls.__name__
    assert trunk == jm.trunk
    variables = jax.tree.map(
        lambda s: np.broadcast_to(np.float32(0), s.shape),
        tpuseg_shapes(arch))
    sd = state_dict_from_flax(variables["params"],
                              variables.get("batch_stats", {}), arch=arch)
    want = model.state_dict()
    assert set(sd) == set(want)  # every tpuseg leaf named, none left over
    assert all(tuple(sd[k].shape) == tuple(v.shape) for k, v in want.items())
    model.load_state_dict(sd, strict=True, assign=True)


def test_every_tpuseg_factory_is_ported():
    """The port registers exactly tpuseg's factories of the five modules."""
    for mod in JAX_MODULES:
        name = mod.__name__.rsplit(".", 1)[1]
        theirs = {f for f, obj in vars(mod).items()
                  if inspect.isfunction(obj) and f[0].isupper()
                  and obj.__module__ == mod.__name__}
        assert theirs == set(PORTED[name]) == set(FACTORIES[name]), name
    assert len(ARCHS) == 25


def test_mscale_hrnet_full_width_logits_match_tpuseg():
    """W48 MscaleBasic, eval, n-scale fusion over (0.5x, 1.0x) on 64x64."""
    arch = "mscale.HRNet"
    cfg = sets(arch, **{"model.n_scales": (0.5, 1.0)})
    x = np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32)
    v = randomize(tpuseg_shapes(arch), np.random.default_rng(1))
    jm = jax_get_model(jax_make_config(cfg))
    want = quick_jit(lambda v, x: jm.apply(v, x, train=False))(v, x)
    with torch.device("meta"):
        model = get_model(make_config(cfg))
    model.load_state_dict(state_dict_from_flax(
        v["params"], v["batch_stats"], arch=arch), strict=True, assign=True)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x))
    # tpuseg's random full-width weights grow the logits to |272| here:
    # held at 1e-4 of each output's largest value (f32 resolves ~2e-5 of
    # it through W48)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        assert max_abs(got[k], w) < 1e-4 * max(1.0, np.abs(w).max()), k
    assert got["pred"].shape == (1, 64, 64, 19)
