"""Helpers for the tpuseg_torch parity tests (tests/test_torch_*.py).

The same seeded numpy inputs and the same weights go through ``tpuseg`` (the
reference, on the CPU) and its ``tpuseg_torch`` counterpart. Weights cross
over through ``tpuseg_torch.convert.state_dict_from_flax``.
"""
from __future__ import annotations

import contextlib

import flax.linen
import jax
import numpy as np
import torch

from tpuseg_torch.convert import state_dict_from_flax


# XLA's CPU backend optimisations off: the same program, compiled 3-5x
# faster; the tests' tiny shapes run in milliseconds either way
QUICK_XLA = {"xla_backend_optimization_level": 0}


def quick_jit(fn, **kw):
    """``jax.jit`` compiled with ``QUICK_XLA``."""
    return jax.jit(fn, compiler_options=QUICK_XLA, **kw)


@contextlib.contextmanager
def quick_xla():
    """Every ``jax.jit(...)`` made inside (tpuseg's own EvalRunner's, for
    one) compiles with ``QUICK_XLA``."""
    orig = jax.jit

    def jit(*args, **kw):
        kw.setdefault("compiler_options", QUICK_XLA)
        return orig(*args, **kw)

    jax.jit = jit
    try:
        yield
    finally:
        jax.jit = orig


def set_threads():
    # the suite runs in several xdist workers at once
    torch.set_num_threads(2)


def flax_shapes(model, *args, **kw):
    """``tpuseg`` variable shapes of ``model`` at the example inputs
    (``jax.eval_shape`` traces the init; nothing is compiled or run)."""
    return jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), *args, **kw))


def random_variables(model, rng, *args, **kw):
    """Seeded random ``tpuseg`` variables (numpy leaves) for ``model``."""
    return randomize(flax_shapes(model, *args, **kw), rng)


POOL = 4_194_301  # a prime


def randomize(variables, rng):
    """Random weights that keep activations O(1), and random BN affine
    parameters and running statistics, so the weight mapping is
    load-bearing (a swapped BN leaf or a wrong transpose shows). ``rng`` is
    a ``np.random.RandomState``, or a ``np.random.Generator`` for
    full-width trunks: each leaf is then a window, at a random offset, of
    one f32 draw of a prime length (so no period lines up with a kernel
    axis), many times faster than a fresh draw of every weight."""
    if isinstance(rng, np.random.Generator):
        pool = rng.standard_normal(POOL, dtype=np.float32)

        def randn(*shape):
            n, off = int(np.prod(shape)), int(rng.integers(POOL))
            reps = -(-(off + n) // POOL)
            src = pool if reps == 1 else np.tile(pool, reps)
            return src[off:off + n].reshape(shape)
        real = np.float32
    else:
        randn, real = rng.randn, np.float64

    def param(path, a):
        name = getattr(path[-1], "key", "")
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            return randn(*a.shape).astype(np.float32) / real(np.sqrt(fan_in))
        if name == "scale":
            return (1.0 + 0.2 * randn(*a.shape)).astype(np.float32)
        return (0.1 * randn(*a.shape)).astype(np.float32)  # biases

    def stat(path, a):
        if getattr(path[-1], "key", "") == "mean":
            return (0.1 * randn(*a.shape)).astype(np.float32)
        return (0.7 + 0.3 * np.abs(randn(*a.shape))).astype(np.float32)

    out = {"params": jax.tree_util.tree_map_with_path(
        param, variables["params"])}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            stat, variables["batch_stats"])
    return out


def load_into(module: torch.nn.Module, variables, flax_path: str = "",
              torch_prefix: str = "", key_fn=None) -> torch.nn.Module:
    """Load ``tpuseg`` variables into the port's module (strict) and put it
    in eval mode. A sub-module's variables are first placed at
    ``flax_path`` of the full model (e.g. "ocr/ocr_distri/object_context"),
    where the key map (``key_fn``, default the ``ocrnet`` archs' map) names
    them, and ``torch_prefix`` (the port's name of that sub-module, e.g.
    "ocr.ocr_distri_head.object_context_block.") is stripped from the
    converted keys."""
    trees = []
    for coll in ("params", "batch_stats"):
        tree = jax.tree.map(np.asarray, variables.get(coll, {}))
        for part in reversed([p for p in flax_path.split("/") if p]):
            tree = {part: tree}
        trees.append(tree)
    sd = state_dict_from_flax(*trees, key_fn=key_fn)
    assert all(k.startswith(torch_prefix) for k in sd), torch_prefix
    sd = {k[len(torch_prefix):]: v for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def nchw(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW torch (the port's internal layout)."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def nhwc_np(t: torch.Tensor) -> np.ndarray:
    return to_np(t.permute(0, 2, 3, 1))


def max_abs(a, b) -> float:
    return float(np.abs(to_np(a).astype(np.float64)
                        - to_np(b).astype(np.float64)).max())


def l1_rel(a, b) -> float:
    a, b = to_np(a).astype(np.float64), to_np(b).astype(np.float64)
    return float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))



class _NoDropout(flax.linen.Module):
    """flax Dropout's signature, computing the identity."""

    rate: float
    broadcast_dims: tuple = ()
    deterministic: bool | None = None

    @flax.linen.compact
    def __call__(self, x):
        return x


class LinenWithoutDropout:
    """A module's view of flax.linen with dropout off: set it as the
    ``nn`` of tpuseg's WRN38 module (its rates 0.3 / 0.5 are fixed in the
    trunk) to run a train-mode forward without dropout."""

    Dropout = _NoDropout

    def __getattr__(self, name):
        return getattr(flax.linen, name)
