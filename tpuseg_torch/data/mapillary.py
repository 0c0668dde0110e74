"""Mapillary Vistas dataset: 65 classes, ignore=65, colormap/names from the
dataset's own config.json (reference: datasets/mapillary.py:43-106)."""
from __future__ import annotations

import json
import os

import numpy as np

from tpuseg_torch.config import DatasetConfig
from tpuseg_torch.data import uniform
from tpuseg_torch.data.base import BaseDataset, make_dataset_folder


def find_images(img_root: str, mask_root: str, img_ext: str,
                mask_ext: str) -> list:
    """Pair images with same-basename masks
    (reference: base_loader.py:73-89)."""
    items = []
    for fn in sorted(os.listdir(img_root)):
        name, ext = os.path.splitext(fn)
        if ext.lstrip(".").lower() != img_ext:
            continue
        mask_fn = os.path.join(mask_root, f"{name}.{mask_ext}")
        items.append((os.path.join(img_root, fn), mask_fn))
    return items


class Mapillary(BaseDataset):
    num_classes = 65
    ignore_label = 65

    def __init__(self, dcfg: DatasetConfig, mode: str, joint_transform=None,
                 img_transform=None, label_transform=None,
                 eval_folder: str | None = None, seed: int = 0,
                 is_primary: bool = True):
        super().__init__(dcfg, mode, joint_transform, img_transform,
                         label_transform, seed)
        root = dcfg.mapillary_dir
        self.fill_colormap_and_names(os.path.join(root, "config.json"))

        if mode == "folder":
            self.all_imgs = make_dataset_folder(eval_folder)
        else:
            split_name = {"train": "training", "val": "validation",
                          "test": "testing"}[mode]
            self.all_imgs = find_images(
                os.path.join(root, split_name, "images"),
                os.path.join(root, split_name, "labels"), "jpg", "png")

        # mapillary masks are already trainId-encoded: no remap
        self.id_to_trainid = {}
        if self.train and dcfg.class_uniform_pct:
            self.centroids = {
                int(k): v for k, v in uniform.build_centroids(
                    self.all_imgs, self.num_classes, dcfg.centroid_root,
                    "mapillary", cv=dcfg.cv,
                    tile_size=dcfg.class_uniform_tile,
                    is_primary=is_primary).items()}
        self.build_epoch(0)

    def fill_colormap_and_names(self, config_fn: str):
        """(reference: mapillary.py:85-106)"""
        if not os.path.isfile(config_fn):
            self.trainid_to_name = {}
            self.palette = None
            return
        with open(config_fn) as f:
            config = json.load(f)
        labels = config["labels"]
        palette = np.zeros((256, 3), dtype=np.uint8)
        self.trainid_to_name = {}
        for i, lb in enumerate(labels):
            palette[i] = lb["color"]
            self.trainid_to_name[i] = lb["readable"].replace(" ", "_")
        self.palette = palette
