"""Class-uniform sampling: tile centroids + per-epoch crop-list mixing.

Reference: datasets/uniform.py. Each mask is tiled (default 1024^2); for
every class present in a tile we record the class-region center of mass.
Each training epoch re-mixes (1 - pct) random images with pct
class-uniform centroid crops; the crop transform then constrains the random
crop to contain the centroid.

Differences: rank-0-builds-then-barrier (uniform.py:253-265) becomes
"process 0 of the host builds, others read" via an atomic file write —
multi-host coordination happens once at startup in the train driver.
Randomness is an explicit numpy Generator, not global state.
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from functools import partial
from multiprocessing.dummy import Pool
from typing import Mapping, Sequence

import numpy as np
from PIL import Image
from scipy.ndimage import center_of_mass

# centroid record: (image_fn, label_fn, (x, y), class_id)


def calc_tile_locations(tile_size: int, image_size) -> list:
    """(reference: uniform.py:67-81)"""
    image_size_y, image_size_x = image_size
    return [(x * tile_size, y * tile_size)
            for y in range(image_size_y // tile_size)
            for x in range(image_size_x // tile_size)]


def class_centroids_image(item, tile_size: int, num_classes: int,
                          id2trainid: Mapping[int, int] | None):
    """Per-class, per-tile centroids for one mask
    (reference: uniform.py:84-135), through the numpy/scipy helpers of
    tpuseg_torch/native.py."""
    from tpuseg_torch import native

    image_fn, label_fn = item
    centroids = defaultdict(list)
    mask = np.array(Image.open(label_fn))

    if id2trainid:
        table = np.full(256, 255, dtype=np.uint8)
        for k, v in id2trainid.items():
            if 0 <= k < 256:
                table[k] = v if v >= 0 else 255
        mask = native.remap(mask, table)

    per_class = native.tile_class_centroids(mask, tile_size, num_classes)
    for class_id, points in per_class.items():
        for centroid in points:
            centroids[class_id].append(
                (image_fn, label_fn, tuple(centroid), class_id))
    return centroids


def class_centroids_all(items: Sequence, num_classes: int, id2trainid,
                        tile_size: int = 1024, pool_size: int = 32):
    """Thread-pooled centroid extraction over all masks
    (reference: uniform.py:138-164)."""
    fn = partial(class_centroids_image, tile_size=tile_size,
                 num_classes=num_classes, id2trainid=id2trainid)
    with Pool(pool_size) as pool:
        per_image = pool.map(fn, items)
    centroids = defaultdict(list)
    for image_items in per_image:
        for class_id, recs in image_items.items():
            centroids[class_id].extend(recs)
    return centroids


def build_centroids(items, num_classes: int, centroid_root: str,
                    dataset_name: str, cv: int | None = None,
                    coarse: bool = False, custom_coarse: bool = False,
                    tile_size: int = 1024, id2trainid=None,
                    is_primary: bool = True) -> dict:
    """Build or load the centroid JSON (format-compatible with the
    reference cache, uniform.py:219-275)."""
    name = dataset_name
    if coarse or custom_coarse:
        name += "_coarse" if coarse else ""
        name += "_customcoarse_final" if custom_coarse else ""
    else:
        name += f"_cv{cv}"
    json_fn = os.path.join(centroid_root, f"{name}_tile{tile_size}.json")

    if os.path.isfile(json_fn):
        with open(json_fn) as f:
            centroids = json.load(f)
        return {int(k): v for k, v in centroids.items()}

    if not is_primary:
        # multi-host cold start: the primary is building the cache right
        # now (can take ~10 min on full Cityscapes). os.replace makes the
        # write atomic, so waiting for the path to appear is safe — a
        # partial file is never visible. Announce the wait immediately:
        # if centroid_root is NOT on a filesystem shared with the primary
        # this poll can never succeed, and a silent loop would read as a
        # frozen job.
        print(f"[uniform] waiting for primary to build centroid cache "
              f"{json_fn} (requires a SHARED filesystem; timeout 1h)",
              flush=True)
        deadline = time.monotonic() + 3600
        while not os.path.isfile(json_fn):
            if time.monotonic() > deadline:
                raise FileNotFoundError(
                    f"{json_fn} still missing after 1h: either the "
                    f"primary died mid-build, or centroid_root is not on "
                    f"a filesystem shared across hosts")
            time.sleep(5)
        with open(json_fn) as f:
            centroids = json.load(f)
        return {int(k): v for k, v in centroids.items()}

    os.makedirs(centroid_root, exist_ok=True)
    centroids = class_centroids_all(items, num_classes, id2trainid, tile_size)
    tmp = json_fn + ".tmp"
    with open(tmp, "w") as f:
        json.dump(centroids, f, indent=4)
    os.replace(tmp, json_fn)  # atomic: readers never see a partial file
    return dict(centroids)


def random_sampling(alist: Sequence, num: int, rng: np.random.Generator):
    """Sample ``num`` items, wrapping around a reshuffled list
    (reference: uniform.py:200-216)."""
    assert len(alist), "empty list in random_sampling"
    indices = rng.permutation(len(alist))
    return [alist[indices[i % len(alist)]] for i in range(num)]


def build_epoch(imgs: Sequence, centroids: Mapping[int, list],
                num_classes: int, class_uniform_pct: float,
                rng: np.random.Generator, train: bool = True,
                class_uniform_bias=None) -> list:
    """Per-epoch 50/50 mix of random images and class-uniform centroid
    crops (reference: uniform.py:278-324)."""
    if not (train and class_uniform_pct):
        return list(imgs)

    num_epoch = len(imgs)
    num_per_class = int((num_epoch * class_uniform_pct) / num_classes)
    num_rand = num_epoch - num_per_class * num_classes
    epoch_imgs = random_sampling(imgs, num_rand, rng)

    for class_id in range(num_classes):
        n = num_per_class
        if class_uniform_bias is not None:
            n = int(num_per_class * class_uniform_bias[class_id])
        class_centroids = centroids.get(class_id, [])
        if class_centroids:
            epoch_imgs.extend(random_sampling(class_centroids, n, rng))
    return epoch_imgs
