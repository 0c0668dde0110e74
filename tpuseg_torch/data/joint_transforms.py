"""Paired image+mask geometric transforms (host-side, PIL/numpy).

Reference: transforms/joint_transforms.py. Each transform takes
``(img: PIL, mask: PIL, rng: random.Random)`` and returns transformed pair
(plus extras where noted). Randomness is an explicit per-sample ``Random``
instance — no global random state — so the pipeline is reproducible and
worker-shardable.
"""
from __future__ import annotations

import random
from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageOps


def _set_crop_size(crop_size):
    if isinstance(crop_size, (list, tuple)):
        return tuple(crop_size)
    return (int(crop_size), int(crop_size))


class RandomCrop:
    """Random crop with centroid support (reference: joint_transforms.py:73-181).

    - image >= crop: uniform placement; if a centroid is given, the crop is
      constrained to contain it (class-uniform sampling);
    - image < crop and nopad: crop size shrinks to the shorter side;
    - image < crop and pad: image is padded (ignore fill for the mask);
    - translate_aug_fix: image slides inside the crop with random margins.
    """

    def __init__(self, crop_size, nopad: bool = True, ignore_label: int = 255,
                 translate_aug_fix: bool = False):
        self.size = _set_crop_size(crop_size)
        self.nopad = nopad
        self.ignore_label = ignore_label
        self.translate_aug_fix = translate_aug_fix

    @staticmethod
    def crop_in_image(centroid, target_w, target_h, w, h, img, mask, rng):
        if centroid is not None:
            c_x, c_y = centroid
            max_x = w - target_w
            max_y = h - target_h
            x1 = rng.randint(int(c_x) - target_w, int(c_x))
            x1 = min(max_x, max(0, x1))
            y1 = rng.randint(int(c_y) - target_h, int(c_y))
            y1 = min(max_y, max(0, y1))
        else:
            x1 = 0 if w == target_w else rng.randint(0, w - target_w)
            y1 = 0 if h == target_h else rng.randint(0, h - target_h)
        box = (x1, y1, x1 + target_w, y1 + target_h)
        return img.crop(box), mask.crop(box)

    def image_in_crop(self, target_w, target_h, w, h, img, mask, rng):
        left = rng.randint(0, target_w - w)
        top = rng.randint(0, target_h - h)
        right = target_w - w - left
        bottom = target_h - h - top
        border = (left, top, right, bottom)
        img = ImageOps.expand(img, border=border, fill=(0, 0, 0))
        mask = ImageOps.expand(mask, border=border, fill=self.ignore_label)
        return img, mask

    def __call__(self, img, mask, rng: random.Random, centroid=None):
        w, h = img.size
        target_h, target_w = self.size
        if w == target_w and h == target_h:
            return img, mask

        if self.translate_aug_fix:
            if w < target_w and h < target_h:
                return self.image_in_crop(target_w, target_h, w, h, img,
                                          mask, rng)
            return self.crop_in_image(centroid, target_w, target_h, w, h,
                                      img, mask, rng)

        if self.nopad:
            if target_h > h or target_w > w:
                shorter = min(w, h)
                target_h, target_w = shorter, shorter
        else:
            pad_h = (target_h - h) // 2 + 1 if target_h > h else 0
            pad_w = (target_w - w) // 2 + 1 if target_w > w else 0
            if pad_h or pad_w:
                img = ImageOps.expand(img, (pad_w, pad_h, pad_w, pad_h),
                                      fill=(0, 0, 0))
                mask = ImageOps.expand(mask, (pad_w, pad_h, pad_w, pad_h),
                                       fill=self.ignore_label)
                w, h = img.size
        return self.crop_in_image(centroid, target_w, target_h, w, h, img,
                                  mask, rng)


class RandomSizeAndCrop:
    """Uniform random rescale in [scale_min, scale_max] then centroid-aware
    crop; returns the scale factor for scale-aware losses
    (reference: joint_transforms.py:425-471)."""

    def __init__(self, crop_size, nopad: bool = True, scale_min: float = 0.5,
                 scale_max: float = 2.0, full_size: bool = False,
                 pre_size: Optional[int] = None, ignore_label: int = 255,
                 translate_aug_fix: bool = False):
        self.crop = RandomCrop(crop_size, nopad, ignore_label,
                               translate_aug_fix)
        self.scale_min = scale_min
        self.scale_max = scale_max
        self.full_size = full_size
        self.pre_size = pre_size

    def __call__(self, img, mask, rng: random.Random, centroid=None):
        scale_amt = rng.uniform(self.scale_min, self.scale_max)
        if self.pre_size is not None:
            in_w, in_h = img.size
            scale_amt *= self.pre_size / max(in_w, in_h)
        if self.full_size:
            self.crop.size = (img.size[1], img.size[0])

        w, h = [int(i * scale_amt) for i in img.size]
        if centroid is not None:
            centroid = [int(c * scale_amt) for c in centroid]
        img = img.resize((w, h), Image.BICUBIC)
        mask = mask.resize((w, h), Image.NEAREST)
        img, mask = self.crop(img, mask, rng, centroid)
        return img, mask, scale_amt


class RandomHorizontallyFlip:
    """(reference: joint_transforms.py:276-281)"""

    def __call__(self, img, mask, rng: random.Random):
        if rng.random() < 0.5:
            return (img.transpose(Image.FLIP_LEFT_RIGHT),
                    mask.transpose(Image.FLIP_LEFT_RIGHT))
        return img, mask


class Scale:
    """Scale so the LONGER side equals ``size``
    (reference: joint_transforms.py:293-313)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img, mask, rng=None):
        w, h = img.size
        if w > h:
            long_edge = w
        else:
            long_edge = h
        if long_edge == self.size:
            return img, mask
        scale = self.size / long_edge
        target_w, target_h = int(w * scale), int(h * scale)
        return (img.resize((target_w, target_h), Image.BICUBIC),
                mask.resize((target_w, target_h), Image.NEAREST))


class ResizeHeight:
    """Resize to a target height, keeping aspect
    (reference: joint_transforms.py:184-196)."""

    def __init__(self, size: int):
        self.target_h = size

    def __call__(self, img, mask, rng=None):
        w, h = img.size
        target_w = int(w / h * self.target_h)
        return (img.resize((target_w, self.target_h), Image.BICUBIC),
                mask.resize((target_w, self.target_h), Image.NEAREST))


class CenterCropPad:
    """Center crop, padding (ignore-filled) when the image is smaller
    (reference: joint_transforms.py:212-242)."""

    def __init__(self, size, ignore_label: int = 255):
        self.size = _set_crop_size(size)
        self.ignore_label = ignore_label

    def __call__(self, img, mask, rng=None):
        w, h = img.size
        target_h, target_w = self.size
        if target_w > w:
            pad = (target_w - w) // 2
            img = ImageOps.expand(img, (pad + 1, 0, pad + 1, 0), fill=0)
            mask = ImageOps.expand(mask, (pad + 1, 0, pad + 1, 0),
                                   fill=self.ignore_label)
            w = img.size[0]
        if target_h > h:
            pad = (target_h - h) // 2
            img = ImageOps.expand(img, (0, pad + 1, 0, pad + 1), fill=0)
            mask = ImageOps.expand(mask, (0, pad + 1, 0, pad + 1),
                                   fill=self.ignore_label)
            h = img.size[1]
        x1 = int(round((w - target_w) / 2.0))
        y1 = int(round((h - target_h) / 2.0))
        box = (x1, y1, x1 + target_w, y1 + target_h)
        return img.crop(box), mask.crop(box)


class JointCompose:
    """Compose joint transforms, threading rng/centroid and collecting the
    scale factor if produced."""

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img, mask, rng: random.Random, centroid=None):
        scale_float = 1.0
        for t in self.transforms:
            if isinstance(t, RandomSizeAndCrop):
                img, mask, scale_float = t(img, mask, rng, centroid)
            elif isinstance(t, RandomCrop):
                img, mask = t(img, mask, rng, centroid)
            else:
                img, mask = t(img, mask, rng)
        return img, mask, scale_float


class FreeScale:
    """Resize to an exact (h, w) (reference: joint_transforms.py:284-291)."""

    def __init__(self, size):
        self.size = tuple(size)  # (h, w)

    def __call__(self, img, mask, rng=None):
        wh = (self.size[1], self.size[0])
        return img.resize(wh, Image.BICUBIC), mask.resize(wh, Image.NEAREST)


class RandomRotate:
    """Rotate both by a uniform angle in [-degree, degree]
    (reference: joint_transforms.py:304-312)."""

    def __init__(self, degree: float):
        self.degree = degree

    def __call__(self, img, mask, rng: random.Random):
        angle = rng.random() * 2 * self.degree - self.degree
        return (img.rotate(angle, Image.BICUBIC),
                mask.rotate(angle, Image.NEAREST))


class SlidingCrop:
    """Tile an oversized image into overlapping crop_size windows, returning
    slices + coordinates for re-assembly
    (reference: joint_transforms.py:526-576).

    -> (img_slices, mask_slices, slices_info) where each info entry is
    [sy, ey, sx, ex, sub_h, sub_w].
    """

    def __init__(self, crop_size: int, stride_rate: float,
                 ignore_label: int = 255):
        self.crop_size = crop_size
        self.stride_rate = stride_rate
        self.ignore_label = ignore_label

    def _pad(self, img, mask):
        h, w = img.shape[:2]
        pad_h = max(self.crop_size - h, 0)
        pad_w = max(self.crop_size - w, 0)
        img = np.pad(img, ((0, pad_h), (0, pad_w), (0, 0)))
        mask = np.pad(mask, ((0, pad_h), (0, pad_w)), mode="constant",
                      constant_values=self.ignore_label)
        return img, mask, h, w

    def __call__(self, img, mask, rng=None):
        import math

        w, h = img.size
        img = np.array(img)
        mask = np.array(mask)

        if max(h, w) <= self.crop_size:
            img, mask, sub_h, sub_w = self._pad(img, mask)
            return ([Image.fromarray(img.astype(np.uint8))],
                    [Image.fromarray(mask.astype(np.uint8))],
                    [[0, sub_h, 0, sub_w, sub_h, sub_w]])

        stride = int(math.ceil(self.crop_size * self.stride_rate))
        h_steps = int(math.ceil((h - self.crop_size) / float(stride))) + 1
        w_steps = int(math.ceil((w - self.crop_size) / float(stride))) + 1
        imgs, masks, infos = [], [], []
        for yy in range(h_steps):
            for xx in range(w_steps):
                sy, sx = yy * stride, xx * stride
                ey, ex = sy + self.crop_size, sx + self.crop_size
                sub_i, sub_m, sub_h, sub_w = self._pad(
                    img[sy:ey, sx:ex], mask[sy:ey, sx:ex])
                imgs.append(Image.fromarray(sub_i.astype(np.uint8)))
                masks.append(Image.fromarray(sub_m.astype(np.uint8)))
                infos.append([sy, ey, sx, ex, sub_h, sub_w])
        return imgs, masks, infos
