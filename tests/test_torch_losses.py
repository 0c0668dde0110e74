"""The port's training losses and pools against tpuseg's, on seeded numpy
inputs: RMI (loss and logits gradient, on random labels and on structured
labels whose constant regions and ignore rows reach the Cholesky rescue),
its BCE-only aux form, image-weighted CE with and without batch weighting,
the loss factory, and the average / max pools."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import l1_rel, max_abs, nchw, nhwc_np, set_threads
from tpuseg.config import make_config as jax_make_config
from tpuseg.losses.ce import image_weighted_cross_entropy as jax_img_wt
from tpuseg.losses.factory import get_loss as jax_get_loss
from tpuseg.losses.rmi import rmi_loss as jax_rmi
from tpuseg.ops.resize import avg_pool2d as jax_avg_pool
from tpuseg.ops.resize import max_pool2d as jax_max_pool
from tpuseg_torch.config import make_config
from tpuseg_torch.losses import get_loss, image_weighted_cross_entropy
from tpuseg_torch.losses.rmi import _safe_cholesky, rmi_loss
from tpuseg_torch.ops import avg_pool2d, max_pool2d

set_threads()

B, H, W, C = 2, 64, 96, 19


def _labels(kind: str, rng) -> np.ndarray:
    if kind == "random":
        return rng.randint(0, C, (B, H, W)).astype(np.int32)
    # large constant regions, a thin object, ignore rows: rank-deficient
    # label covariances, the case tpuseg's f32 rescue exists for
    lab = np.zeros((B, H, W), np.int32)
    lab[:, H // 2:] = 3
    lab[:, :8] = 255
    lab[1, :, :40] = 7
    lab[0, 20:24, 30:70] = 11
    return lab


def _value_and_grad_port(fn, logits):
    t = torch.from_numpy(logits).requires_grad_()
    loss = fn(t)
    loss.backward()
    return float(loss.detach()), t.grad.numpy()


def _value_and_grad_jax(fn, logits):
    loss, grad = jax.value_and_grad(fn)(jnp.asarray(logits))
    return float(loss), np.asarray(grad)


# loss relative error and logits-gradient L1-relative error, port vs tpuseg
# (both f32): the random case agrees to f32 rounding; the structured case
# carries the f32 Cholesky / cho_solve chain's rounding, measured 5.9e-5
# (loss) and 1.1e-4 (gradient)
RMI_TOL = {"random": (1e-5, 1e-5), "structured": (2e-4, 5e-4)}


@pytest.mark.parametrize("do_rmi", [True, False], ids=["rmi", "bce_only"])
@pytest.mark.parametrize("kind", ["random", "structured"])
def test_rmi_loss_matches_tpuseg(kind, do_rmi):
    rng = np.random.RandomState(0)
    logits = (2.0 * rng.randn(B, H, W, C)).astype(np.float32)
    labels = _labels(kind, rng)
    got, ggot = _value_and_grad_port(
        lambda x: rmi_loss(x, torch.from_numpy(labels), num_classes=C,
                           do_rmi=do_rmi), logits)
    want, gwant = _value_and_grad_jax(
        lambda x: jax_rmi(x, jnp.asarray(labels), num_classes=C,
                          do_rmi=do_rmi), logits)
    loss_tol, grad_tol = RMI_TOL[kind] if do_rmi else (1e-5, 1e-5)
    assert np.isfinite(got) and np.isfinite(ggot).all()
    assert abs(got - want) / abs(want) < loss_tol, (got, want)
    assert l1_rel(ggot, gwant) < grad_tol


def test_safe_cholesky_rescues_without_nan():
    """A singular covariance: cholesky_ex flags it and the rescued matrix is
    factored instead; loss and gradient stay finite (torch.linalg.cholesky
    would raise here)."""
    eye = torch.eye(9)
    m = torch.zeros(2, 9, 9)
    m[1] = torch.ones(9, 9)              # rank 1, not PD after 1e-9 jitter
    m[0] = torch.eye(9) * 0.5
    m.requires_grad_()
    chol = _safe_cholesky(m, eye, jitter=-1e-3)
    assert torch.isfinite(chol).all()
    # the first matrix took its own jitter, the second the 1e-2 rescue
    torch.testing.assert_close(chol[0] @ chol[0].T, m[0] - 1e-3 * eye,
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(chol[1] @ chol[1].T, m[1] + 1e-2 * eye,
                               rtol=0, atol=1e-5)
    chol.sum().backward()
    assert torch.isfinite(m.grad).all()


@pytest.mark.parametrize("batch_weighting", [False, True])
@pytest.mark.parametrize("norm", [False, True])
def test_image_weighted_ce_matches_tpuseg(batch_weighting, norm):
    rng = np.random.RandomState(1)
    logits = rng.randn(3, 24, 40, C).astype(np.float32)
    labels = rng.randint(0, 6, (3, 24, 40)).astype(np.int32)
    labels[0, :5] = 255
    labels[2] = 4                                # one class only
    kw = dict(upper_bound=1.0, norm=norm, batch_weighting=batch_weighting)
    got, ggot = _value_and_grad_port(
        lambda x: image_weighted_cross_entropy(x, torch.from_numpy(labels),
                                               **kw), logits)
    want, gwant = _value_and_grad_jax(
        lambda x: jax_img_wt(x, jnp.asarray(labels), **kw), logits)
    # f32 sums over 3 x 960 pixels
    assert abs(got - want) / abs(want) < 1e-5
    assert l1_rel(ggot, gwant) < 1e-5


@pytest.mark.parametrize("loss_type", ["ce", "img_wt", "rmi"])
def test_get_loss_matches_tpuseg(loss_type):
    """The factory's criterion and val criterion, with do_rmi both ways."""
    sets = {"loss.loss_type": loss_type, "loss.batch_weighting": True}
    crit, val = get_loss(make_config(sets))
    jcrit, jval = jax_get_loss(jax_make_config(sets))
    rng = np.random.RandomState(2)
    logits = rng.randn(B, 32, 48, C).astype(np.float32)
    labels = _labels("structured", rng)[:, :32, :48]
    t, lab = torch.from_numpy(logits), torch.from_numpy(labels)
    j, jlab = jnp.asarray(logits), jnp.asarray(labels)
    for do_rmi in (True, False):
        got = float(crit(t, lab, do_rmi=do_rmi))
        want = float(jcrit(j, jlab, do_rmi=do_rmi))
        assert abs(got - want) / abs(want) < 2e-4, (do_rmi, got, want)
    assert abs(float(val(t, lab)) - float(jval(j, jlab))) < 1e-5


# pools: f32 window sums and maxima, equal up to summation order
@pytest.mark.parametrize("window,stride,pad", [(4, 4, 2), (3, 2, 1),
                                               (2, 2, 0)])
def test_avg_pool_matches_tpuseg(window, stride, pad):
    x = np.random.RandomState(3).randn(2, 21, 34, 5).astype(np.float32)
    got = avg_pool2d(nchw(x), window, stride, pad)
    want = jax_avg_pool(jnp.asarray(x), window, stride, pad)
    assert max_abs(nhwc_np(got), want) < 1e-6


@pytest.mark.parametrize("ceil_mode", [False, True])
@pytest.mark.parametrize("window,stride,pad", [(3, 2, 1), (3, 2, 0),
                                               (4, 4, 2)])
def test_max_pool_matches_tpuseg(window, stride, pad, ceil_mode):
    x = np.random.RandomState(4).randn(2, 21, 34, 5).astype(np.float32)
    got = max_pool2d(nchw(x), window, stride, pad, ceil_mode=ceil_mode)
    want = jax_max_pool(jnp.asarray(x), window, stride, pad,
                        ceil_mode=ceil_mode)
    assert got.shape[2:] == want.shape[1:3]
    assert max_abs(nhwc_np(got), want) == 0.0


def test_pools_keep_dtype():
    x = torch.randn(1, 3, 8, 8, dtype=torch.bfloat16)
    assert avg_pool2d(x, 2).dtype == torch.bfloat16
    assert max_pool2d(x, 2, ceil_mode=True).dtype == torch.bfloat16
