"""Checks of the attention-scale family (models/mscale.py, mscale2.py,
attnscale.py, basic.py, deeper.py) against tpuseg's, shared by
tests/test_torch_mscale.py and tests/test_torch_attnscale.py (split so
that xdist's --dist loadfile runs them side by side).

A case is one class with its arguments, on the tiny WRN38 trunk, f32, one
seeded 48x48 image. One jitted tpuseg call a case gives the eval forward
(n-scale where the class fuses scales), the train forward (BN in training
mode, dropout off), the BN statistics that forward leaves and the
attention head's outputs; the port runs the same from the converted
weights.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuseg.models.wider_resnet as jwrn
from _torch_port import LinenWithoutDropout, load_into, max_abs
from _torch_port import quick_jit, random_variables
from tpuseg_torch.convert import state_dict_from_flax
from tpuseg_torch.keymap import HEADS, PLAIN_SCALE_ATTN, seg_key_fn
from tpuseg_torch.models import attnscale

NC, SIDE, TRUNK = 7, 48, "wrn38_tiny"
# the train forward's outputs of the classes that fuse two scales, as the
# supervised mscale loss reads them; the Paired model's training scales
TWO_SCALE = {"pred", "pred_05x", "pred_10x", "attn_05x"}
TRAIN_KEYS = {"MscaleV3Plus": TWO_SCALE, "MscaleDeeper": TWO_SCALE,
              "MscaleBasic": TWO_SCALE, "MscaleASPP": TWO_SCALE,
              "ASDV3P_Paired": {"pred", "pred_0.5x", "pred_1.0x",
                                "attn_0.5x", "attn_1.0x"}}


def key_fn(port_cls, kw):
    heads = HEADS[port_cls.__name__]
    if issubclass(port_cls, attnscale.ASDV3P) and not kw.get("bn_head"):
        heads = {**heads, **PLAIN_SCALE_ATTN}
    return seg_key_fn(TRUNK, heads)


def image(seed=0):
    return np.random.RandomState(seed).randn(1, SIDE, SIDE, 3).astype(
        np.float32)


def no_dropout(port):
    """The port's WRN38 Dropout2d layers at p = 0 (tpuseg's are patched
    out for the same forward)."""
    drops = [m for m in port.modules() if isinstance(m, torch.nn.Dropout2d)]
    assert len(drops) == 2  # mod6 and mod7
    for m in drops:
        m.p = 0.0
    return port


_RUNS: dict = {}


def run_case(name, jcls, pcls, kw):
    """-> (port eval out, port train out, port BN stats after the train
    forward, the same three of tpuseg, the port's loaded weights, the
    attention head's outputs in the eval forward of the port, of tpuseg),
    each computed once."""
    if name in _RUNS:
        return _RUNS[name]
    x = image()
    jm = jcls(num_classes=NC, trunk=TRUNK, dtype=jnp.float32, **kw)
    v = random_variables(jm, np.random.RandomState(1), jnp.asarray(x))

    def both(v, x):
        ev, inter = jm.apply(v, x, train=False, capture_intermediates=(
            lambda m, _: m.name == "scale_attn"))
        tr, mutated = jm.apply(v, x, train=True, mutable=["batch_stats"])
        maps = inter.get("intermediates", {}).get("scale_attn", {})
        return ev, tr, mutated["batch_stats"], maps.get("__call__", ())

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwrn, "nn", LinenWithoutDropout())
        jev, jtr, jstats, jmaps = jax.tree.map(np.asarray,
                                               quick_jit(both)(v, x))
    kfn = key_fn(pcls, kw)
    want_stats = state_dict_from_flax({}, jstats, key_fn=kfn)

    port = no_dropout(load_into(pcls(NC, trunk=TRUNK, dtype=torch.float32,
                                     **kw), v, key_fn=kfn))
    state = {k: t.clone() for k, t in port.state_dict().items()}
    pmaps = []
    hook = port.scale_attn.register_forward_hook(
        lambda mod, args, out: pmaps.append(out)) if hasattr(
            port, "scale_attn") else None
    with torch.inference_mode():
        pev = port(torch.from_numpy(x))
    if hook is not None:
        hook.remove()
    port.train()
    with torch.no_grad():
        ptr = port(torch.from_numpy(x))
    pstats = {k: t for k, t in port.state_dict().items()
              if k.endswith(("running_mean", "running_var"))}
    _RUNS[name] = (pev, ptr, pstats, jev, jtr, want_stats, state, pmaps,
                   jmaps)
    return _RUNS[name]


def check(got, want, skip=()):
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        if k not in skip:
            assert max_abs(got[k], want[k]) < 1e-4, (
                k, max_abs(got[k], want[k]))


def tree_l1(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    num = sum(float((got[k].double() - want[k].double()).abs().sum())
              for k in want)
    return num / sum(float(want[k].double().abs().sum()) for k in want)


def check_eval(name, jcls, pcls, kw, skip=()):
    pev, _, _, jev, *_ = run_case(name, jcls, pcls, kw)
    check(pev, jev, skip)
    assert pev["pred"].shape == (1, SIDE, SIDE, NC)


def check_train(name, jcls, pcls, kw):
    _, ptr, pstats, _, jtr, jstats, *_ = run_case(name, jcls, pcls, kw)
    check(ptr, jtr)
    assert set(ptr) >= TRAIN_KEYS.get(pcls.__name__, {"pred"})
    assert tree_l1(pstats, {k: jstats[k] for k in pstats}) < 1e-5
