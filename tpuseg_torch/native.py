"""Host-side label helpers of the data pipeline, numpy/scipy only.

The port's copy of the numpy/scipy paths of ``tpuseg/native/__init__.py``
(``remap``, ``tile_class_centroids``). ``tpuseg``'s C++ accumulator
(``fasthist.cpp``) is not carried over: the eval path takes its confusion
matrix on the device, and the class-uniform sampler takes its centroids
from the numpy pass here (``data/uniform.py``).
"""
from __future__ import annotations

import numpy as np


def tile_class_centroids(mask: np.ndarray, tile: int, num_classes: int):
    """-> dict class_id -> list of (cx, cy), one per tile where present."""
    from scipy.ndimage import center_of_mass

    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    out: dict = {}
    for ty in range(h // tile):
        for tx in range(w // tile):
            patch = mask[ty * tile:(ty + 1) * tile,
                         tx * tile:(tx + 1) * tile]
            for c in np.unique(patch):
                if c >= num_classes:
                    continue
                cy, cx = center_of_mass((patch == c).astype(np.int32))
                out.setdefault(int(c), []).append(
                    (int(cx) + tx * tile, int(cy) + ty * tile))
    return out


def remap(mask: np.ndarray, table: np.ndarray) -> np.ndarray:
    """uint8 lookup-table remap."""
    mask = np.ascontiguousarray(mask, np.uint8)
    return np.ascontiguousarray(table, np.uint8)[mask]
