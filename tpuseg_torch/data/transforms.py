"""Image-only photometric transforms + tensor conversion (host-side).

Reference: transforms/transforms.py. PIL in, PIL out for photometric ops;
the final conversion produces normalized float32 HWC numpy (not CHW torch
tensors — batches are NHWC on TPU).
"""
from __future__ import annotations

import random
from typing import Sequence

import numpy as np
from PIL import Image, ImageEnhance


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img, rng: random.Random):
        for t in self.transforms:
            img = t(img, rng)
        return img


class ColorJitter:
    """brightness/contrast/saturation/hue jitter, torchvision-free
    (reference: transforms/transforms.py:297-362): random order of enhance
    ops with factors uniform in [1-x, 1+x]."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    @staticmethod
    def _enhance_hue(img, factor):
        if factor == 0:
            return img
        h, s, v = img.convert("HSV").split()
        np_h = np.array(h, dtype=np.int16)
        np_h = ((np_h + int(factor * 255)) % 256).astype(np.uint8)
        h = Image.fromarray(np_h, "L")
        return Image.merge("HSV", (h, s, v)).convert("RGB")

    def __call__(self, img, rng: random.Random):
        ops = []
        if self.brightness > 0:
            f = rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
            ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
        if self.contrast > 0:
            f = rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
            ops.append(lambda im: ImageEnhance.Contrast(im).enhance(f))
        if self.saturation > 0:
            f = rng.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
            ops.append(lambda im: ImageEnhance.Color(im).enhance(f))
        if self.hue > 0:
            f = rng.uniform(-self.hue, self.hue)
            ops.append(lambda im: self._enhance_hue(im, f))
        rng.shuffle(ops)
        for op in ops:
            img = op(img)
        return img


class RandomGaussianBlur:
    """sigma ~ U(0.15, 1.3) gaussian blur
    (reference: transforms/transforms.py:154-162)."""

    def __call__(self, img, rng: random.Random):
        from scipy.ndimage import gaussian_filter

        sigma = 0.15 + rng.random() * 1.15
        arr = np.asarray(img, dtype=np.float32)
        out = np.stack([gaussian_filter(arr[..., c], sigma)
                        for c in range(arr.shape[-1])], axis=-1)
        return Image.fromarray(np.clip(out, 0, 255).astype(np.uint8))


class RandomBilateralBlur:
    """sigma_spatial ~ U(0.05, 0.75) bilateral filter via OpenCV
    (reference: transforms/transforms.py:173-182 used skimage)."""

    def __call__(self, img, rng: random.Random):
        import cv2

        sigma = rng.uniform(0.05, 0.75)
        arr = np.asarray(img)
        out = cv2.bilateralFilter(arr, d=5, sigmaColor=30,
                                  sigmaSpace=sigma * 10)
        return Image.fromarray(out)


def to_normalized_array(img, mean, std) -> np.ndarray:
    """PIL -> float32 HWC in ImageNet-normalized space
    (replaces ToTensor+Normalize; reference: datasets/__init__.py:124-129)."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def to_uint8_array(img) -> np.ndarray:
    """PIL -> raw uint8 HWC for the uint8 wire format
    (``dataset.transfer_uint8``): normalization happens on device
    (tpuseg/ops/normalize.py) with arithmetic identical to
    :func:`to_normalized_array`, at 4x fewer host->device bytes."""
    return np.asarray(img, dtype=np.uint8)


def mask_to_array(mask, dtype=np.int32) -> np.ndarray:
    """PIL mask -> int32 HW (reference MaskToTensor:
    transforms/transforms.py:70-72). ``dtype=np.uint8`` is the wire
    format under ``dataset.transfer_uint8`` (labels and ignore_label all
    fit in a byte; jitted consumers cast back to int32 on device)."""
    return np.array(mask, dtype=dtype)
