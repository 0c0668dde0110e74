"""The DeepLabV3+ factories on WRN38, Xception-71 and EfficientNet-B4 at
full width vs tpuseg's (logits, the trunk's three taps), and the port's own
key map vs tools/convert_torch_ckpt.py's for these factories and the
``ocrnet`` archs. The checks are in tests/_torch_zoo.py; the ResNet
family's factories are in tests/test_torch_trunks.py."""
import pytest

from _torch_port import set_threads
from _torch_zoo import check_keymap, check_logits, check_taps

set_threads()
ARCHS = ["deepv3.DeepV3PlusW38", "deepv3.DeepV3PlusW38I",
         "deepv3.DeepWV3Plus", "deepv3.DeepV3PlusX71",
         "deepv3.DeepV3PlusEffB4"]


@pytest.mark.parametrize("arch", ARCHS)
def test_factory_logits_match_tpuseg(arch):
    check_logits(arch)


@pytest.mark.parametrize("arch", ["deepv3.DeepV3PlusW38",
                                  "deepv3.DeepV3PlusX71",
                                  "deepv3.DeepV3PlusEffB4"])
def test_trunk_taps_match_tpuseg(arch):
    check_taps(arch)


@pytest.mark.parametrize("arch", ARCHS + ["ocrnet.HRNet_ASPP_OCR"])
def test_keymap_covers_factory_and_agrees_with_tools(arch):
    check_keymap(arch)
