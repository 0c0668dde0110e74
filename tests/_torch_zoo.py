"""Checks of the port's DeepLabV3 / V3+ factories at full width against
tpuseg's (tests/test_torch_trunks.py and tests/test_torch_zoo.py split the
factories between them, so that xdist's --dist loadfile runs the two
halves side by side).

Each factory is built by ``tpuseg_torch.models.get_model``, loaded strictly
with tpuseg's random variables through the port's key map
(``tpuseg_torch/keymap.py``) and run f32 on one seeded 32x32 image. One
jitted tpuseg forward a network gives the logits and the trunk's three
taps (``capture_intermediates``); factories that build the same tpuseg
network share it.
"""
from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port import flax_shapes, max_abs, nhwc_np, randomize
from tpuseg.config import make_config as jax_make_config
from tpuseg.models import get_model as jax_get_model
from tpuseg_torch import keymap
from tpuseg_torch.config import make_config
from tpuseg_torch.convert import arch_key_fn, state_dict_from_flax
from tpuseg_torch.models import get_model
from tpuseg_torch.models.deepv3 import TRUNKS

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import convert_torch_ckpt as tools_map  # noqa: E402

SIDE = 32
# tpuseg builds the same network for these factories
SAME_NETWORK = {"deepv3.DeepV3PlusW38I": "deepv3.DeepV3PlusW38",
                "deepv3.DeepWV3Plus": "deepv3.DeepV3PlusW38"}
# the (s2, s4, high) channel contract of each factory's trunk
CONTRACT = {"seresnext-50": (256, -1, 2048), "seresnext-101": (256, -1, 2048),
            "resnet-50": (256, -1, 2048), "wrn38": (128, 256, 4096),
            "wrn38_tiny": (8, 16, 64), "xception71": (64, 128, 2048),
            "efficientnet_b4": (24, 32, 448)}


def sets(arch):
    # tpuseg's EfficientNet trunk does not trace under model.remat (its
    # nn.remat has no static train argument); these forwards are eval
    return {"model.arch": arch, "model.compute_dtype": "float32",
            "model.remat": False}


_FORWARDS: dict = {}
_PORT: dict = {}


def tpuseg_forward(arch):
    """-> (image, numpy variables, logits, trunk taps) of ``arch``'s tpuseg
    network, computed once."""
    arch = SAME_NETWORK.get(arch, arch)
    if arch not in _FORWARDS:
        model = jax_get_model(jax_make_config(sets(arch)))
        x = np.random.RandomState(0).randn(1, SIDE, SIDE, 3).astype(
            np.float32)
        v = randomize(flax_shapes(model, jnp.asarray(x), train=False),
                      np.random.default_rng(1))
        pred, inter = jax.jit(lambda v, x: model.apply(
            v, x, train=False,
            capture_intermediates=lambda m, _: m.name == "backbone"))(v, x)
        taps = inter["intermediates"]["backbone"]["__call__"][0]
        _FORWARDS[arch] = (x, v, np.asarray(pred["pred"]),
                           [None if t is None else np.asarray(t)
                            for t in taps])
    return _FORWARDS[arch]


def port_forward(arch):
    """-> (logits, trunk taps) of the port's factory, loaded with tpuseg's
    variables (strict), computed once."""
    if arch not in _PORT:
        x, v, _, _ = tpuseg_forward(arch)
        with torch.device("meta"):  # no init: every tensor is tpuseg's
            model = get_model(make_config(sets(arch)))
        model.load_state_dict(state_dict_from_flax(
            v["params"], v["batch_stats"], arch=arch), strict=True,
            assign=True)
        taps = []
        model.backbone.register_forward_hook(
            lambda mod, args, out: taps.extend(out))
        with torch.inference_mode():
            pred = model.eval()(torch.from_numpy(x))["pred"]
        _PORT[arch] = (pred, taps)
    return _PORT[arch]


def check_logits(arch):
    want = tpuseg_forward(arch)[2]
    got = port_forward(arch)[0]
    assert got.shape == want.shape == (1, SIDE, SIDE, 19)
    assert max_abs(got, want) < 1e-4


def check_taps(arch):
    """Every tap of the factory's trunk: max |delta| < 1e-4 of the tap's
    largest value; its shape tpuseg's, its channels the contract's."""
    want = tpuseg_forward(arch)[3]
    got = port_forward(arch)[1]
    for tap, g, w, ch in zip(("s2", "s4", "high"), got, want,
                             CONTRACT[TRUNKS[arch.split(".")[1]]]):
        assert (g is None) == (w is None) == (ch == -1), tap
        if w is None:
            continue
        assert nhwc_np(g).shape == w.shape and g.shape[1] == ch, tap
        assert max_abs(nhwc_np(g), w) < 1e-4 * float(np.abs(w).max()), tap


def _module_paths(variables):
    """Every module path of a flax variable tree, as the key map sees it
    (a Norm's inner 'bn' stripped)."""
    paths = set()
    for coll in variables.values():
        for flat in keymap.flatten(coll):
            mod = flat.split("/")[:-1]
            if mod and mod[-1] == "bn":
                mod = mod[:-1]
            paths.add("/".join(mod))
    return sorted(paths)


def check_keymap(arch):
    """The port's map names every module of the factory's tpuseg tree (the
    converted keys and shapes are exactly the port model's state dict, what
    a strict load checks), and agrees key by key with the JAX side's maps
    (full-model and trunk-only) wherever those name a path."""
    if arch.startswith("deepv3."):
        variables = tpuseg_forward(arch)[1]
    else:
        shapes = flax_shapes(jax_get_model(jax_make_config(sets(arch))),
                             jnp.zeros((1, SIDE, SIDE, 3)), train=False)
        variables = jax.tree.map(
            lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"],
                              arch=arch)
    with torch.device("meta"):
        port = get_model(make_config(sets(arch))).state_dict()
    assert set(sd) == set(port)
    assert all(tuple(sd[k].shape) == tuple(v.shape) for k, v in port.items())

    # the JAX side's map names the tiny trunks as their full ones
    trunk = ("hrnetv2" if arch.startswith("ocrnet.")
             else TRUNKS[arch.split(".")[1]].replace("_tiny", ""))
    theirs = (tools_map.flax_to_torch_key if arch.startswith("ocrnet.")
              else tools_map.deepv3_key_fn(trunk))
    ours = arch_key_fn(arch)
    trunk_theirs = tools_map.trunk_key_fn(trunk)
    paths = _module_paths(variables)
    named = [p for p in paths if theirs(p) is not None]
    assert named and all(ours(p) == theirs(p) for p in named)
    assert all(keymap.trunk_key_fn(trunk)(p) == trunk_theirs(p)
               for p in paths if trunk_theirs(p) is not None)
    # the JAX side names every path but DeepV3's seg head and OCRNetASPP's
    # aspp/ subtree, which the port's copy adds
    unnamed = {p.split("/")[0] for p in paths if theirs(p) is None}
    assert unnamed <= {"final", "aspp"}, unnamed
    if arch.startswith("ocrnet."):  # and the mscale archs' attention head
        head = [f"scale_attn/{m}" for m in ("conv0/conv", "conv0/norm",
                                            "conv1/conv", "conv1/norm",
                                            "cls")]
        assert all(ours(p) == theirs(p) is not None for p in head)
