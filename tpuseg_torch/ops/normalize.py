"""On-device input normalization for the uint8 transfer path.

Port of ``tpuseg/ops/normalize.py:34-77``. A uint8 channel has only 256
values, so the host builds the (C, 256) table of normalized values with
the host loader's exact numpy op sequence
(``tpuseg.data.transforms.to_normalized_array``) and the device does one
gather at ``c * 256 + byte``. A gather of host constants is bitwise equal
to host normalization by construction (tests/test_torch_ops.py).

Non-uint8 integers take the ``(x / 255 - mean) / std`` arithmetic (the
table index would alias into a neighbouring channel for values outside
0..255); float images are returned unchanged (already host-normalized).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@lru_cache(maxsize=8)
def _normalize_lut(mean: tuple, std: tuple) -> np.ndarray:
    """(C, 256) f32 table: lut[c, v] = host-normalized value of byte v in
    channel c — the same numpy op sequence as to_normalized_array."""
    v = np.arange(256, dtype=np.float32)[None, :] / 255.0
    mean = np.asarray(mean, np.float32)[:, None]
    std = np.asarray(std, np.float32)[:, None]
    return (v - mean) / std


def device_normalize(image: torch.Tensor, mean=IMAGENET_MEAN,
                     std=IMAGENET_STD) -> torch.Tensor:
    """Normalize an integer NHWC image on its device; float images pass
    through unchanged."""
    if image.is_floating_point():
        return image
    dev = image.device
    if image.dtype != torch.uint8:
        x = image.float() / 255.0
        return ((x - torch.tensor(mean, dtype=torch.float32, device=dev))
                / torch.tensor(std, dtype=torch.float32, device=dev))
    lut = _normalize_lut(tuple(float(m) for m in mean),
                         tuple(float(s) for s in std))
    c = image.shape[-1]
    if lut.shape[0] != c:
        raise ValueError(f"normalize table has {lut.shape[0]} channels, "
                         f"image has {c}")
    lut_t = torch.from_numpy(lut.reshape(-1)).to(dev)
    idx = image.long() + torch.arange(c, device=dev) * 256
    return lut_t[idx]


def device_label(label: torch.Tensor) -> torch.Tensor:
    """Cast a uint8-wire label map to int32; int32 and float labels pass
    through."""
    if not label.is_floating_point() and label.dtype != torch.int32:
        return label.to(torch.int32)
    return label
