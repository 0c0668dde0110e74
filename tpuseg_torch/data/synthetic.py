"""Synthetic dataset — compile/throughput smoke backend.

Equivalent of the reference's ``nullloader`` (datasets/nullloader.py:41-74):
fixed-shape batches with zero images and random-but-deterministic labels,
nominal length 3000. Doubles as the perf-benchmark harness input.
"""
from __future__ import annotations

import numpy as np


class SyntheticDataset:
    def __init__(self, crop_size=(1024, 2048), num_classes: int = 19,
                 length: int = 3000, ignore_label: int = 255,
                 random_labels: bool = True, seed: int = 0):
        self.crop_size = tuple(crop_size)
        self.num_classes = num_classes
        self.length = length
        self.ignore_label = ignore_label
        self.random_labels = random_labels
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int):
        h, w = self.crop_size
        image = np.zeros((h, w, 3), dtype=np.float32)
        if self.random_labels:
            rng = np.random.RandomState(self.seed + idx)
            label = rng.randint(0, self.num_classes, (h, w)).astype(np.int32)
        else:
            label = np.zeros((h, w), dtype=np.int32)
        return {"image": image, "label": label,
                "name": f"synthetic_{idx:06d}",
                "scale_float": np.float32(1.0)}

    def batches(self, batch_size: int, steps: int):
        """Yield fixed-shape host batches."""
        for step in range(steps):
            items = [self[(step * batch_size + i) % self.length]
                     for i in range(batch_size)]
            yield {
                "image": np.stack([it["image"] for it in items]),
                "label": np.stack([it["label"] for it in items]),
            }
