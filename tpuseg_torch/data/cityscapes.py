"""Cityscapes dataset: city-level CV splits, fine+coarse discovery,
class-uniform centroids, auto-labelled coarse boost.

Reference: datasets/cityscapes.py.
"""
from __future__ import annotations

import os
from os import path

import numpy as np
from PIL import Image

from tpuseg_torch.config import DatasetConfig
from tpuseg_torch.data import uniform
from tpuseg_torch.data.base import BaseDataset, make_dataset_folder
from tpuseg_torch.data.cityscapes_labels import (
    IGNORE_LABEL,
    NUM_CLASSES,
    PALETTE,
    label2trainid,
    trainid2name,
)


def cities_cv_split(root: str, split: str, cv_split: int,
                    cv_splits: int = 3) -> list[str]:
    """City-level 3-way CV split; cv=3 means train+val
    (reference: cityscapes.py:41-89)."""
    trn_path = path.join(root, "leftImg8bit_trainvaltest/leftImg8bit", "train")
    val_path = path.join(root, "leftImg8bit_trainvaltest/leftImg8bit", "val")
    trn_cities = sorted("train/" + c for c in os.listdir(trn_path))
    val_cities = ["val/" + c for c in os.listdir(val_path)]
    all_cities = val_cities + trn_cities

    if cv_split == 3:
        return all_cities

    num_val = len(val_cities)
    num_cities = len(all_cities)
    offset = cv_split * num_cities // cv_splits
    cities = []
    for j in range(num_cities):
        in_val_window = offset <= j < offset + num_val
        if (split == "val") == in_val_window:
            cities.append(all_cities[j])
    return cities


def coarse_cities(root: str) -> list[str]:
    """(reference: cityscapes.py:92-102)"""
    coarse_path = path.join(root, "leftImg8bit_trainextra/leftImg8bit",
                            "train_extra")
    return ["train_extra/" + c for c in os.listdir(coarse_path)]


class Cityscapes(BaseDataset):
    num_classes = NUM_CLASSES
    ignore_label = IGNORE_LABEL
    trainid_to_name = trainid2name
    palette = PALETTE

    def __init__(self, dcfg: DatasetConfig, mode: str, joint_transform=None,
                 img_transform=None, label_transform=None,
                 eval_folder: str | None = None, seed: int = 0,
                 is_primary: bool = True):
        super().__init__(dcfg, mode, joint_transform, img_transform,
                         label_transform, seed)
        self.root = dcfg.cityscapes_dir
        self.id_to_trainid = label2trainid
        # ego-vehicle/rectification-border drop mask
        # (reference: base_loader.py:59-60)
        self._drop_mask = np.zeros((1024, 2048))
        self._drop_mask[15:840, 14:2030] = 1.0

        img_root = path.join(self.root, "leftImg8bit_trainvaltest/leftImg8bit")
        mask_root = path.join(self.root, "gtFine_trainvaltest/gtFine")

        if mode == "folder":
            self.all_imgs = make_dataset_folder(eval_folder)
        else:
            self.fine_cities = cities_cv_split(self.root, mode, dcfg.cv,
                                               dcfg.cv_splits)
            self.all_imgs = self.find_cityscapes_images(
                self.fine_cities, img_root, mask_root)

        if self.train and dcfg.class_uniform_pct:
            self.fine_centroids = uniform.build_centroids(
                self.all_imgs, self.num_classes, dcfg.centroid_root,
                "cityscapes", cv=dcfg.cv, tile_size=dcfg.class_uniform_tile,
                id2trainid=self.id_to_trainid, is_primary=is_primary)
            self.centroids = {int(k): v
                              for k, v in self.fine_centroids.items()}
        else:
            self.fine_centroids = {}

        # coarse boost: auto-labelled (custom-coarse) or raw-coarse extras
        # for underrepresented classes (reference: cityscapes.py:145-165)
        if dcfg.coarse_boost_classes and mode == "train":
            self.coarse_cities_list = coarse_cities(self.root)
            c_img_root = path.join(self.root,
                                   "leftImg8bit_trainextra/leftImg8bit")
            c_mask_root = path.join(self.root, "gtCoarse", "gtCoarse")
            self.coarse_imgs = self.find_cityscapes_images(
                self.coarse_cities_list, c_img_root, c_mask_root,
                fine_coarse="gtCoarse")
            if dcfg.class_uniform_pct:
                custom = dcfg.custom_coarse_prob is not None
                self.coarse_centroids = uniform.build_centroids(
                    self.coarse_imgs, self.num_classes, dcfg.centroid_root,
                    "cityscapes", coarse=not custom, custom_coarse=custom,
                    tile_size=dcfg.class_uniform_tile,
                    id2trainid=self.id_to_trainid, is_primary=is_primary)
                for cid in dcfg.coarse_boost_classes:
                    self.centroids.setdefault(cid, []).extend(
                        self.coarse_centroids.get(cid, []))
            else:
                self.all_imgs.extend(self.coarse_imgs)

        self.build_epoch(0)

    def disable_coarse(self):
        """(reference: cityscapes.py:169-173)"""
        self.centroids = {int(k): v for k, v in self.fine_centroids.items()}

    def _coarse_dropout_merge(self, mask, mask_path):
        """For dataset.custom_coarse_dropout_classes, union the human
        gtCoarse annotation into the auto-labelled mask: any pixel gtCoarse
        marks as labelId k (trainId in the dropout set) joins that class
        before the trainId remap. Equivalent to the reference's in-place
        loop (base_loader.py:177-183 — its intermediate
        ``mask[binary]=gtCoarse[binary]`` write is dead, both writes cover
        the same index set); applied before the confidence threshold, so a
        low pseudo-label prob still drops these pixels, as in the
        reference (base_loader.py:213-224)."""
        dropout = self.dcfg.custom_coarse_dropout_classes
        cc_dir = self.dcfg.cityscapes_customcoarse
        if not dropout or not mask_path or not cc_dir or \
                cc_dir not in mask_path:
            return mask
        gt_path = mask_path.replace(
            cc_dir, path.join(self.root, "gtCoarse/gtCoarse")).replace(
            "leftImg8bit", "gtCoarse_labelIds")
        gt_coarse = np.array(Image.open(gt_path))
        mask = mask.copy()
        for k, v in self.id_to_trainid.items():
            # reference guard (base_loader.py:179): only merge gtCoarse
            # for k when the pseudo-label mask already contains >=1 pixel
            # of k — absent classes stay absent
            if v in dropout and (mask == k).any():
                mask[gt_coarse == k] = k
        return mask

    def only_coarse(self):
        """Train on the coarse centroid set only
        (reference: cityscapes.py:175-180)."""
        coarse = getattr(self, "coarse_centroids", None)
        if coarse is None:
            raise ValueError(
                "dataset.only_coarse needs the coarse set: configure "
                "coarse_boost_classes + class_uniform_pct "
                "(reference: train.py:434-437)")
        self.centroids = {int(k): v for k, v in coarse.items()}

    def find_cityscapes_images(self, cities, img_root, mask_root,
                               fine_coarse="gtFine"):
        """(reference: cityscapes.py:182-216)"""
        items = []
        for city in cities:
            img_dir = path.join(img_root, city)
            for file_name in sorted(os.listdir(img_dir)):
                basename = file_name.split("_leftImg8bit")[0]
                full_img_fn = path.join(img_dir, file_name)
                if self.dcfg.custom_coarse_prob and fine_coarse != "gtFine":
                    mask_fn = f"{basename}_leftImg8bit.png"
                    full_mask_fn = path.join(
                        self.dcfg.cityscapes_customcoarse, city, mask_fn)
                else:
                    mask_fn = f"{basename}_{fine_coarse}_labelIds.png"
                    full_mask_fn = path.join(mask_root, city, mask_fn)
                items.append((full_img_fn, full_mask_fn))
        return items
