"""The readers' arithmetic on a fabricated profiler table: launches, device
milliseconds an image, the two kernels' rooflines, MFU and the idle share,
and the busy-time union of a trace."""
import math
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import core, costs

EVAL = "hrnet-w48-mscale.eval-3scale-bs4"
TRAIN = "deepv3plus-w38.train-800-bs8"
ATTN = "void (anonymous namespace)::attention_tc_kernel<2>(__nv_bfloat16)"
BNECK = "(anonymous namespace)::bottleneck_kernel(CUtensorMap_st, int)"


def _trace(cell_name, rows, images=8, busy=0.9, span=1.0):
    cell = core.cell(cell_name)
    return core.Trace(rows, busy, span, images, window_images=40,
                      window_s=5.0, cell=cell, flops_per_image=16.0e12)


def _read(trace, metric):
    return trace.cell.reader(metric).read(trace)


def test_launches_resize_and_idle():
    rows = {"void at::native::upsample_bilinear2d_nhwc_out_frame": (0.1, 40),
            "sm90_xmma_fprop": (0.5, 60), "Memcpy HtoD (Pageable -> Device)":
            (0.01, 8), "Memset (Device)": (0.001, 4)}
    t = _trace(EVAL, rows)
    assert _read(t, "launches_per_img.eval") == 100 / 8
    assert _read(t, "resize_ms_per_img.eval") == pytest.approx(12.5)
    assert _read(t, "device_idle_pct.eval") == pytest.approx(10.0)
    assert _read(t, "mfu_pct.eval") == pytest.approx(
        100 * 16e12 * 40 / 5.0 / 989e12)


def test_kernel_rooflines_count_whole_batches():
    m = core.cell(EVAL).config["model"]
    # two batches of 4: one attention launch a scale, three identity
    # blocks a scale for the bottleneck
    bound_a = sum(costs.attention_launch_s(
        4, costs.quarter(int(1024 * s)) * costs.quarter(int(2048 * s)), 19,
        256) for s in m["n_scales"])
    t = _trace(EVAL, {ATTN: (2 * bound_a / 0.8, 6)})
    assert _read(t, "ocr_attention_roofline") == pytest.approx(80.0)
    t = _trace(EVAL, {ATTN: (1.0, 5)})
    assert _read(t, "ocr_attention_roofline") is None
    bound_b = 3 * sum(costs.bottleneck_launch_s(
        4, costs.quarter(int(1024 * s)), costs.quarter(int(2048 * s)), 256,
        64) for s in m["n_scales"])
    t = _trace(EVAL, {BNECK: (2 * bound_b / 0.5, 18),
                      "bottleneck_any_kernel": (9.0, 9)})
    assert _read(t, "bottleneck_fused_roofline") == pytest.approx(50.0)
    assert _read(_trace(EVAL, {}), "bottleneck_fused_roofline") is None


def test_bounds_of_the_main_path_shapes():
    # the 1.0x attention launch at batch 1: 131072 queries of 256, memory
    # bound (PERF.md's 0.210 ms over the three scales)
    one = costs.attention_launch_s(1, 131072, 19, 256)
    assert one == pytest.approx((4 * 131072 * 256 + 4 * 19 * 256) / 3.35e12)
    total = sum(costs.attention_launch_s(1, n, 19, 256)
                for n in (32768, 131072, 524288))
    assert total * 1e3 == pytest.approx(0.210, abs=0.002)


def test_batch_norm_ms_per_image():
    rows = {"void at::native::batch_norm_collect_statistics_channels_last_"
            "kernel": (0.2, 10), "cudnn::bn_bw_1C11_kernel_new": (0.1, 5),
            "sm90_xmma_wgrad": (1.0, 3)}
    t = _trace(TRAIN, rows, images=4)
    assert _read(t, "bn_ms_per_img.train") == pytest.approx(75.0)
    assert _read(t, "launches_per_img.train") == 18 / 4


def test_union_of_busy_intervals():
    iv = np.array([[0, 10], [5, 20], [30, 40], [35, 36], [50, 60]], float)
    busy, gaps = core._union(iv)
    assert busy == pytest.approx(40e-6)
    assert gaps.tolist() == [[20, 30], [40, 50]]


def test_read_profile_names_idle_gaps():
    from torch.autograd import DeviceType

    def ev(name, a, b, dev):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(
            start=a, end=b), device_type=dev, is_user_annotation=False)

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    prof = SimpleNamespace(events=lambda: [
        ev("k1", 0, 100, cuda), ev("k2", 200, 300, cuda),
        ev("k2", 305, 400, cuda), ev("aten::conv", 90, 260, cpu),
        ev("cudaLaunchKernel", 140, 160, cpu)])
    rows, busy, idle = core.read_profile(prof)
    assert rows["k1"] == pytest.approx((100e-6, 1))
    assert rows["k2"] == pytest.approx((195e-6, 2))
    assert busy == pytest.approx(295e-6)
    assert dict(idle) == pytest.approx({"cudaLaunchKernel": 100e-6,
                                        "gaps under 20 us": 5e-6})
    assert math.isclose(sum(dict(idle).values()), 105e-6)
