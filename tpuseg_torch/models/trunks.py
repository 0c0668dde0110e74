"""Trunk registry (port of ``tpuseg/models/trunks.py``; reference get_trunk:
network/utils.py:102-141).

Every trunk takes an NCHW image and returns ``(s2, s4, high)`` (``None``
where the trunk has no such tap); the channel counts follow the
reference's contract (network/utils.py:108-135), ``-1`` where it gives
none.
"""
from __future__ import annotations

import torch

from tpuseg_torch.models.efficientnet import EfficientNetB4
from tpuseg_torch.models.hrnet import HRNetV2, TINY_SPEC, W48_SPEC
from tpuseg_torch.models.resnet import ResNet
from tpuseg_torch.models.seresnext import SEResNeXt
from tpuseg_torch.models.wider_resnet import (
    TINY_WRN_CHANNELS,
    TINY_WRN_STRUCTURE,
    WRN38,
)
from tpuseg_torch.models.xception import Xception71

def get_trunk(trunk_name: str, output_stride: int = 8, remat=False,
              dtype=torch.bfloat16, align_corners: bool = False,
              fused_stage1: bool = False):
    """-> (trunk module, s2_ch, s4_ch, high_level_ch)."""
    assert output_stride == 8, "only stride 8 supported (like the reference)"
    kw = dict(dtype=dtype, remat=remat)
    if trunk_name == "wrn38":
        return WRN38(**kw), 128, 256, 4096
    if trunk_name == "wrn38_tiny":
        return (WRN38(TINY_WRN_STRUCTURE, TINY_WRN_CHANNELS, stem_ch=8, **kw),
                8, 16, 64)
    if trunk_name == "xception71":
        return Xception71(output_stride, **kw), 64, 128, 2048
    if trunk_name == "xception71_tiny":
        return Xception71(output_stride, middle_blocks=2, **kw), 64, 128, 2048
    if trunk_name in ("resnet-50", "resnet-101"):
        layers = (3, 4, 6, 3) if trunk_name == "resnet-50" else (3, 4, 23, 3)
        return ResNet(layers, output_stride=output_stride, **kw), 256, -1, 2048
    if trunk_name in ("seresnext-50", "seresnext-101"):
        layers = ((3, 4, 6, 3) if trunk_name == "seresnext-50"
                  else (3, 4, 23, 3))
        return (SEResNeXt(layers, output_stride=output_stride, **kw),
                256, -1, 2048)
    if trunk_name == "efficientnet_b4":
        # the reference's own efficientnet_b4 path is dead code; this is
        # tpuseg's working trunk
        return EfficientNetB4(output_stride, **kw), 24, 32, 448
    if trunk_name in ("hrnetv2", "hrnetv2_tiny"):
        spec = W48_SPEC if trunk_name == "hrnetv2" else TINY_SPEC
        return (HRNetV2(spec, align_corners, dtype, fused_stage1, remat),
                -1, -1, spec.high_level_ch)
    raise ValueError(f"unknown trunk {trunk_name}")
