"""Paired RandAugment: geometric ops hit both image and mask (NEAREST,
ignore-filled), photometric ops hit the image only.

Reference: datasets/randaugment.py (itself from pytorch-randaugment).
Op set and magnitude ranges match augment_list (randaugment.py:179-203);
randomness is an explicit per-sample Random instance.
"""
from __future__ import annotations

import random

from PIL import Image, ImageEnhance, ImageOps

FILL_COLOR = (0, 0, 0)


def _affine(pair, params, ignore_label):
    img, mask = pair
    img = img.transform(img.size, Image.AFFINE, params,
                        resample=Image.BILINEAR, fillcolor=FILL_COLOR)
    mask = mask.transform(mask.size, Image.AFFINE, params,
                          resample=Image.NEAREST, fillcolor=ignore_label)
    return img, mask


def shear_x(pair, v, rng, ignore):
    if rng.random() > 0.5:
        v = -v
    return _affine(pair, (1, v, 0, 0, 1, 0), ignore)


def shear_y(pair, v, rng, ignore):
    if rng.random() > 0.5:
        v = -v
    return _affine(pair, (1, 0, 0, v, 1, 0), ignore)


def translate_x(pair, v, rng, ignore):
    if rng.random() > 0.5:
        v = -v
    return _affine(pair, (1, 0, v * pair[0].size[0], 0, 1, 0), ignore)


def translate_y(pair, v, rng, ignore):
    if rng.random() > 0.5:
        v = -v
    return _affine(pair, (1, 0, 0, 0, 1, v * pair[0].size[1]), ignore)


def rotate(pair, v, rng, ignore):
    if rng.random() > 0.5:
        v = -v
    img, mask = pair
    return (img.rotate(v, resample=Image.BILINEAR, fillcolor=FILL_COLOR),
            mask.rotate(v, resample=Image.NEAREST, fillcolor=ignore))


def _img_only(fn):
    def wrapped(pair, v, rng, ignore):
        img, mask = pair
        return fn(img, v), mask
    return wrapped


auto_contrast = _img_only(lambda im, v: ImageOps.autocontrast(im))
invert = _img_only(lambda im, v: ImageOps.invert(im))
equalize = _img_only(lambda im, v: ImageOps.equalize(im))
solarize = _img_only(lambda im, v: ImageOps.solarize(im, v))
posterize = _img_only(lambda im, v: ImageOps.posterize(im, max(1, int(v))))
color = _img_only(lambda im, v: ImageEnhance.Color(im).enhance(v))
brightness = _img_only(lambda im, v: ImageEnhance.Brightness(im).enhance(v))
sharpness = _img_only(lambda im, v: ImageEnhance.Sharpness(im).enhance(v))
identity = lambda pair, v, rng, ignore: pair


# (op, minval, maxval) — reference augment_list (randaugment.py:179-203)
AUGMENT_LIST = [
    (identity, 0.0, 1.0),
    (shear_x, 0.0, 0.3),
    (shear_y, 0.0, 0.3),
    (translate_x, 0.0, 0.33),
    (translate_y, 0.0, 0.33),
    (rotate, 0.0, 30.0),
    (auto_contrast, 0.0, 1.0),
    (invert, 0.0, 1.0),
    (equalize, 0.0, 1.0),
    (solarize, 0.0, 110.0),
    (posterize, 4.0, 8.0),
    (color, 0.1, 1.9),
    (brightness, 0.1, 1.9),
    (sharpness, 0.1, 1.9),
]


class RandAugment:
    """Apply N randomly chosen ops at magnitude M in [0, 30]
    (reference: randaugment.py:250-263)."""

    def __init__(self, n: int, m: float, ignore_label: int = 255):
        self.n = n
        self.m = m
        self.ignore_label = ignore_label

    def __call__(self, img, mask, rng: random.Random):
        pair = (img, mask)
        ops = rng.choices(AUGMENT_LIST, k=self.n)
        for op, minval, maxval in ops:
            val = (float(self.m) / 30.0) * float(maxval - minval) + minval
            pair = op(pair, val, rng, self.ignore_label)
        return pair
