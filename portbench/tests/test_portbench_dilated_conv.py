"""``dilated_conv_roofline``'s arithmetic on a fabricated profiler table:
the in-image taps of ASPP's three rates, whole batches only, with the
widths, rates and map read from the cell's frozen reference."""

import pytest

from portbench import core

TRAIN = "deepv3plus-w38.train-800-bs8"
KERNEL = "void (anonymous namespace)::dilated_conv_kernel<256>(CUtensorMap_st)"


def _read(rows, cell=None):
    cell = cell or core.cell(TRAIN)
    trace = core.Trace(rows, 0.9, 1.0, 16, window_images=40, window_s=5.0,
                       cell=cell)
    return cell.reader("dilated_conv_roofline").read(trace)


def test_aspp_convs_are_the_reference_aspps_alone():
    """ASPP's three rates at the cell's batch over the 100 x 100 map, and
    none of the trunk's dilated convs (rates 2 and 4)."""
    reader = core.cell(TRAIN).reader("dilated_conv_roofline")
    assert reader.aspp_convs(core.cell(TRAIN)) == [
        (8, 100, 100, 4096, 256, d) for d in (12, 24, 36)]


def test_reads_what_the_w38_formula_read():
    """The W38 cell's reading is the number the reader gave when it took
    Cin from W38's ``channels`` and the rates and Cout as constants."""
    reader = core.cell(TRAIN).reader("dilated_conv_roofline")
    sec, n = 0.0123, 6
    bound = sum(reader.launch_s(8, 800 // 8, 800 // 8, 4096, 256, d)
                for d in (12, 24, 36))
    assert _read({KERNEL: (sec, n)}) == 100.0 * bound * (n // 3) / sec


def test_in_image_taps_bound():
    # 8 x 100 x 100, 4096 -> 256: (300 - 2 d)^2 tap-pixel pairs at rate d
    flops = sum(2.0 * 8 * 4096 * 256 * (300 - 2 * d) ** 2
                for d in (12, 24, 36))
    assert flops == pytest.approx(3.22e12, rel=2e-3)  # PERF.md §6
    bound = flops / 989e12  # operations bound: bytes take 0.22 ms a conv
    assert _read({KERNEL: (2 * bound / 0.4, 6)}) == pytest.approx(40.0)


@pytest.mark.parametrize("rows", [
    {},                                     # the parent: no such kernel
    {KERNEL: (0.01, 5)},                    # not a whole number of batches
    {"implicit_convolve_sgemm<bf16>": (0.3, 6)}])
def test_reads_nothing(rows):
    assert _read(rows) is None


def test_reads_nothing_without_an_aspp():
    assert _read({KERNEL: (0.01, 6)},
                 core.cell("hrnet-w48-mscale.eval-3scale-bs4")) is None


def test_never_above_the_cell_bound():
    """Every tap of every rate at the peak is still under 100 %."""
    full = 3 * 2.0 * 8 * 4096 * 256 * 9 * 100 * 100 / 989e12
    assert _read({KERNEL: (full, 3)}) < 100.0
