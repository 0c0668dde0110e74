"""The port's trunks and ASPP / DPC heads vs tpuseg's, f32 on the CPU:
the DeepLabV3 / V3+ factories on the ResNet and SE-ResNeXt trunks and the
tiny WRN38 at full width (logits, every trunk tap, the key map; the checks
are in tests/_torch_zoo.py, the other trunks' factories in
tests/test_torch_zoo.py), the (s2, s4, high) channel contract of every
trunk, ASPP at output stride 8, DPC, and ASPP's batch-1 train step (a BN
over one value per channel)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import load_into, max_abs, nchw, nhwc_np, random_variables
from _torch_port import set_threads, to_np
from _torch_zoo import check_keymap, check_logits, check_taps
from tpuseg.models import heads as jheads
from tpuseg.models import trunks as jtrunks
from tpuseg_torch.keymap import deepv3_key_fn
from tpuseg_torch.models import heads
from tpuseg_torch.models.trunks import get_trunk

set_threads()
F32 = jnp.float32
ARCHS = ["deepv3.DeepV3PlusR50", "deepv3.DeepV3R50",
         "deepv3.DeepV3PlusSRNX50", "deepv3.DeepV3PlusSRNX101",
         "deepv3.DeepV3PlusW38Tiny"]


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_factory_logits_match_tpuseg(arch):
    check_logits(arch)


@pytest.mark.parametrize("arch", ["deepv3.DeepV3PlusR50",
                                  "deepv3.DeepV3PlusSRNX50",
                                  "deepv3.DeepV3PlusW38Tiny"])
def test_trunk_taps_match_tpuseg(arch):
    check_taps(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_keymap_covers_factory_and_agrees_with_tools(arch):
    check_keymap(arch)


@pytest.mark.parametrize("name", [
    "wrn38", "wrn38_tiny", "xception71", "xception71_tiny", "resnet-50",
    "resnet-101", "seresnext-50", "seresnext-101", "efficientnet_b4",
    "hrnetv2", "hrnetv2_tiny"])
def test_get_trunk_contract_matches_tpuseg(name):
    """get_trunk's (s2_ch, s4_ch, high_ch) for every trunk tpuseg names."""
    with torch.device("meta"):
        got = get_trunk(name, dtype=torch.float32)[1:]
    assert got == jtrunks.get_trunk(name, dtype=F32)[1:]


# ------------------------------------------------------------------ heads


def _head_case(jm, pm, x, seed):
    v = random_variables(jm, np.random.RandomState(seed), jnp.asarray(x))
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x)
    port = load_into(pm, v, "aspp", "aspp.", key_fn=deepv3_key_fn("wrn38"))
    with torch.inference_mode():
        got = port(nchw(x))
    return nhwc_np(got), np.asarray(want)


def test_aspp_stride8_matches_tpuseg():
    """Rates 12 / 24 / 36 and the image-pool branch, f32, eval."""
    x = _x(3, 2, 40, 48, 16)
    got, want = _head_case(jheads.ASPP(8, 8, dtype=F32),
                           heads.ASPP(16, 8, 8), x, 4)
    assert got.shape == want.shape == (2, 40, 48, 40)
    assert max_abs(got, want) < 1e-4


def test_dpc_matches_tpuseg():
    x = _x(5, 1, 40, 48, 16)
    got, want = _head_case(jheads.DPC(8, 8, dtype=F32), heads.DPC(16, 8, 8),
                           x, 6)
    assert got.shape == want.shape == (1, 40, 48, 40)
    assert max_abs(got, want) < 1e-4


def test_aspp_train_batch1_matches_tpuseg():
    """At batch 1 the image-pool branch's BN sees one value per channel:
    tpuseg returns the BN bias and updates the running variance with
    Bessel's factor 1; ``nn.BatchNorm2d`` would raise."""
    x = _x(7, 1, 24, 32, 16)
    jm = jheads.ASPP(8, 8, dtype=F32)
    v = random_variables(jm, np.random.RandomState(8), jnp.asarray(x))
    want, mutated = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, x)
    port = load_into(heads.ASPP(16, 8, 8), v, "aspp", "aspp.",
                     key_fn=deepv3_key_fn("wrn38")).train()
    got = port(nchw(x))
    assert max_abs(nhwc_np(got), want) < 1e-4
    # the image branch's output is its BN's bias, whatever the input
    bias = np.asarray(v["params"]["img_conv"]["norm"]["bn"]["bias"])
    np.testing.assert_allclose(nhwc_np(got)[0, 0, 0, :8], np.maximum(bias, 0),
                               atol=1e-6)
    stats = load_into(heads.ASPP(16, 8, 8), {
        "params": v["params"], "batch_stats": mutated["batch_stats"]},
        "aspp", "aspp.", key_fn=deepv3_key_fn("wrn38")).state_dict()
    for k, ref in stats.items():
        if k.endswith(("running_mean", "running_var")):
            assert max_abs(port.state_dict()[k], ref) < 1e-6, k
    assert int(port.img_conv[1].num_batches_tracked) == 1
    got.sum().backward()  # the n = 1 branch is differentiable
    assert float(port.img_conv[0].weight.grad.abs().max()) == 0.0
    assert to_np(port.img_conv[1].bias.grad).any()
