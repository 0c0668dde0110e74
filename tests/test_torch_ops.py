"""tpuseg_torch ops, metrics and the val loss vs tpuseg on the same inputs:
resize, on-device normalize, device labels, the device confusion matrix,
cross-entropy and the IoU table."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import max_abs, nchw, nhwc_np, set_threads
from tpuseg.evaluation import metrics as jm
from tpuseg.losses.ce import cross_entropy as jax_ce
from tpuseg.ops import device_label as jax_label
from tpuseg.ops import device_normalize as jax_normalize
from tpuseg.ops import resize_bilinear as jax_resize
from tpuseg.ops import resize_x as jax_resize_x
from tpuseg_torch.evaluation import metrics as tm
from tpuseg_torch.losses import cross_entropy
from tpuseg_torch.ops import (
    device_label,
    device_normalize,
    resize_bilinear,
    resize_x,
)

set_threads()

# sizes whose source-coordinate ratio is a power of two, the ratios the
# model's trunk and fusion use: in/out for align_corners=False,
# (in-1)/(out-1) for align_corners=True (up, down, 8x up, 4x down, identity)
SIZES = {False: [((16, 32), (32, 64)), ((32, 64), (16, 32)),
                 ((8, 16), (64, 128)), ((64, 128), (16, 32)),
                 ((9, 9), (9, 9))],
         True: [((9, 17), (17, 33)), ((17, 33), (9, 17)),
                ((3, 5), (17, 33)), ((33, 65), (9, 17)), ((9, 9), (9, 9))]}


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_bilinear_f32(case, align_corners):
    in_hw, out_hw = SIZES[align_corners][case]
    x = np.random.RandomState(0).randn(2, *in_hw, 5).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), out_hw, align_corners))
    got = nhwc_np(resize_bilinear(nchw(x), out_hw, align_corners))
    assert got.shape == want.shape
    assert max_abs(got, want) < 1e-6


@pytest.mark.parametrize("in_hw,out_hw", [((17, 51), (32, 64)),
                                          ((64, 128), (33, 65))])
def test_resize_bilinear_ragged_f32(in_hw, out_hw):
    """At ragged ratios torch computes the source coordinate in f32 where
    tpuseg uses f64: the lerp weights then differ by ~1e-7 relative to the
    coordinate, i.e. ~1e-5 absolute on unit-scale values."""
    x = np.random.RandomState(1).randn(1, *in_hw, 3).astype(np.float32)
    for ac in (False, True):
        want = np.asarray(jax_resize(jnp.asarray(x), out_hw, ac))
        got = nhwc_np(resize_bilinear(nchw(x), out_hw, ac))
        assert max_abs(got, want) < 5e-5


@pytest.mark.parametrize("in_hw,out_hw", SIZES[False][:4])
def test_resize_bilinear_bf16(in_hw, out_hw):
    """tpuseg rounds to bf16 after each axis, the port once after both:
    the two differ by at most 2 bf16 ulps of the input's magnitude."""
    x = np.random.RandomState(2).randn(1, *in_hw, 4).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_resize(xb, out_hw), np.float32)
    got = resize_bilinear(nchw(np.asarray(xb, np.float32)).bfloat16(), out_hw)
    assert got.dtype == torch.bfloat16
    bound = 2 * 2.0 ** -8 * float(np.abs(x).max())
    assert max_abs(nhwc_np(got), want) <= bound


@pytest.mark.parametrize("scale", [0.5, 2.0, 0.25, 1.5, 0.3333333])
def test_resize_x_floor_sizes(scale):
    x = np.random.RandomState(3).randn(1, 33, 65, 2).astype(np.float32)
    want = np.asarray(jax_resize_x(jnp.asarray(x), scale))
    got = nhwc_np(resize_x(nchw(x), scale))
    assert got.shape == want.shape
    assert max_abs(got, want) < 5e-5


def test_device_normalize_bitwise_uint8():
    from tpuseg.data.transforms import to_normalized_array
    from PIL import Image

    raw = np.random.RandomState(7).randint(0, 256, (2, 33, 47, 3),
                                           dtype=np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    got = device_normalize(torch.from_numpy(raw), mean, std).numpy()
    want = np.asarray(jax_normalize(jnp.asarray(raw), mean, std))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)  # bitwise
    host = to_normalized_array(Image.fromarray(raw[0]), mean, std)
    np.testing.assert_array_equal(got[0], host)
    # floats pass through untouched
    f = torch.from_numpy(host)
    assert device_normalize(f, mean, std) is f


def test_device_normalize_int32_arithmetic():
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    img = np.asarray([[[[-40, 300, 70], [0, 128, 255]]]], np.int32)
    got = device_normalize(torch.from_numpy(img), mean, std).numpy()
    want = np.asarray(jax_normalize(jnp.asarray(img), mean, std))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_device_label():
    lab = np.random.RandomState(4).randint(0, 256, (2, 5, 7)).astype(np.uint8)
    got = device_label(torch.from_numpy(lab))
    want = np.asarray(jax_label(jnp.asarray(lab)))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    i32 = torch.zeros(3, dtype=torch.int32)
    assert device_label(i32) is i32


def test_fast_hist_matches_jax():
    rng = np.random.RandomState(5)
    n = 19
    gt = rng.randint(0, n, (2, 40, 60))
    gt[:, :5] = 255                        # ignore
    gt[:, 5:7] = -1                        # below range
    pred = rng.randint(-3, n + 4, gt.shape)  # out-of-range preds are clipped
    want = np.asarray(jm.fast_hist_jax(jnp.asarray(pred), jnp.asarray(gt), n))
    got = tm.fast_hist_torch(torch.from_numpy(pred), torch.from_numpy(gt), n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tm.fast_hist(pred, gt, n), want)


def test_cross_entropy_matches_jax():
    rng = np.random.RandomState(6)
    logits = (3 * rng.randn(2, 16, 24, 19)).astype(np.float32)
    labels = rng.randint(0, 19, (2, 16, 24))
    labels[0, :3] = 255
    labels[1, :, :2] = 40
    want = float(jax_ce(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels)))
    # f32 sums over the pixels in another order: relative 1e-6
    assert abs(got - want) < 1e-6 * abs(want)


def test_format_evaluate_results_identical():
    rng = np.random.RandomState(8)
    hist = rng.randint(0, 1000, (19, 19)).astype(np.float64)
    hist[3] = 0                             # an absent class (nan IoU)
    scales = {0.5: rng.randint(0, 900, (19, 19)),
              2.0: rng.randint(0, 900, (19, 19))}
    names = [f"class{i}" for i in range(19)]
    assert tm.format_evaluate_results(hist, names, 3, scales) == \
        jm.format_evaluate_results(hist, names, 3, scales)
    a, b = tm.eval_metrics_from_hist(hist), jm.eval_metrics_from_hist(hist)
    assert (a.mean_iou, a.acc, a.acc_cls, a.fwavacc) == \
        (b.mean_iou, b.acc, b.acc_cls, b.fwavacc)
    assert tm.fmt_scale("pred", 0.5) == jm.fmt_scale("pred", 0.5)
