"""Base dataset: file lists, id->trainId remap, transform orchestration.

Reference: datasets/base_loader.py. Index-addressable map-style dataset;
all randomness derives from (seed, epoch, index) so any worker can compute
any sample — the property that makes per-host sharding trivial.
"""
from __future__ import annotations

import os
import random
from typing import Callable, Optional, Sequence

import numpy as np
from PIL import Image

from tpuseg_torch.config import DatasetConfig
from tpuseg_torch.data import uniform
from tpuseg_torch.data.transforms import (
    mask_to_array,
    to_normalized_array,
    to_uint8_array,
)


class BaseDataset:
    num_classes: int = 19
    ignore_label: int = 255
    trainid_to_name: dict = {}
    palette: Optional[np.ndarray] = None

    def __init__(self, dcfg: DatasetConfig, mode: str,
                 joint_transform=None, img_transform=None,
                 label_transform: Optional[Callable] = None,
                 seed: int = 0):
        self.dcfg = dcfg
        self.mode = mode
        self.train = mode == "train"
        self.joint_transform = joint_transform
        self.img_transform = img_transform
        self.label_transform = label_transform
        self.seed = seed
        self.epoch = 0
        self.id_to_trainid: dict = {}
        self.centroids: dict = {}
        self.all_imgs: list = []
        self.imgs: list = []
        # cityscapes ego-vehicle/border drop mask
        # (reference: base_loader.py:59-60)
        self._drop_mask = None

    # -- epoch machinery ----------------------------------------------------
    def build_epoch(self, epoch: int = 0):
        """Re-mix class-uniform crops each epoch
        (reference: base_loader.py:62-71)."""
        self.epoch = epoch
        rng = np.random.default_rng((self.seed, epoch))
        self.imgs = uniform.build_epoch(
            self.all_imgs, self.centroids, self.num_classes,
            self.dcfg.class_uniform_pct if self.train else 0.0,
            rng, train=self.train)

    def __len__(self):
        return len(self.imgs)

    # -- IO ------------------------------------------------------------------
    def _remap(self, mask: np.ndarray) -> np.ndarray:
        if not self.id_to_trainid:
            return mask
        table = np.full(256, self.ignore_label, dtype=np.uint8)
        for k, v in self.id_to_trainid.items():
            if 0 <= k < 256:
                table[k] = v if v >= 0 else self.ignore_label
        return table[mask]

    def read_images(self, img_path: str, mask_path: Optional[str],
                    mask_out: bool = False):
        """(reference: base_loader.py:152-187)"""
        img = Image.open(img_path).convert("RGB")
        if not mask_path:
            mask = np.zeros((img.size[1], img.size[0]), dtype=np.uint8)
        else:
            mask = np.array(Image.open(mask_path))
        if mask_out and self._drop_mask is not None:
            mask = (self._drop_mask[:mask.shape[0], :mask.shape[1]] *
                    mask).astype(mask.dtype)
        mask = self._coarse_dropout_merge(mask, mask_path)
        mask = self._remap(mask)
        img_name = os.path.splitext(os.path.basename(img_path))[0]
        return img, Image.fromarray(mask.astype(np.uint8)), img_name

    def _coarse_dropout_merge(self, mask: np.ndarray,
                              mask_path: Optional[str]) -> np.ndarray:
        """Hook: merge human gtCoarse labels into auto-labelled masks for
        dataset.custom_coarse_dropout_classes (no-op outside cityscapes;
        reference: base_loader.py:177-183)."""
        return mask

    def threshold_custom_coarse(self, mask: Image.Image,
                                mask_path: str) -> Image.Image:
        """Auto-labelled masks: drop pixels below the confidence threshold
        (reference: base_loader.py:216-224)."""
        prob_path = mask_path.replace(".png", "_prob.png")
        arr = np.array(mask)
        prob = np.array(Image.open(prob_path)) / 255.0
        arr[prob < self.dcfg.custom_coarse_prob] = self.ignore_label
        return Image.fromarray(arr.astype(np.uint8))

    def _dump_augmentation(self, img, mask, img_name, centroid, class_id):
        """Visual sanity-check of the augmentation pipeline
        (reference dump_images: base_loader.py:102-118)."""
        outdir = f"dump_augmentation_images_{self.mode}"
        os.makedirs(outdir, exist_ok=True)
        name = img_name
        if centroid is not None and class_id is not None:
            name = f"{self.trainid_to_name.get(class_id, class_id)}_{name}"
        img.save(os.path.join(outdir, f"{name}.png"))
        arr = np.array(mask, dtype=np.int64)
        if self.palette is not None:
            colored = self.palette[arr % 256].astype(np.uint8)
            Image.fromarray(colored).save(
                os.path.join(outdir, f"{name}_mask.png"))
        Image.fromarray(np.array(mask, dtype=np.uint8)).save(
            os.path.join(outdir, f"{name}_mask_raw.png"))

    # -- sample assembly ------------------------------------------------------
    def __getitem__(self, index: int):
        rec = self.imgs[index]
        if len(rec) == 2:
            img_path, mask_path = rec
            centroid = class_id = None
        else:
            img_path, mask_path, centroid, class_id = rec

        is_custom_coarse = bool(
            mask_path and self.dcfg.cityscapes_customcoarse and
            self.dcfg.cityscapes_customcoarse in mask_path)
        # drop mask only under the explicit flag (reference:
        # base_loader.py:206-208: MASK_OUT_CITYSCAPES and custom_coarse)
        mask_out = bool(self.dcfg.mask_out_cityscapes and
                        self.dcfg.custom_coarse_prob and is_custom_coarse)

        img, mask, img_name = self.read_images(img_path, mask_path, mask_out)
        if is_custom_coarse and self.dcfg.custom_coarse_prob:
            mask = self.threshold_custom_coarse(mask, mask_path)

        rng = random.Random(self.seed * 1_000_003 + self.epoch * 10_007 +
                            index)
        scale_float = 1.0
        if self.joint_transform is not None:
            img, mask, scale_float = self.joint_transform(
                img, mask, rng, centroid)
        if self.img_transform is not None:
            img = self.img_transform(img, rng)

        if self.dcfg.dump_images:
            self._dump_augmentation(img, mask, img_name, centroid, class_id)

        if self.dcfg.transfer_uint8:
            # uint8 wire format: raw pixels / byte labels; the jitted
            # consumers normalize + cast on device (ops/normalize.py)
            image = to_uint8_array(img)
        else:
            image = to_normalized_array(img, self.dcfg.mean, self.dcfg.std)
        if self.label_transform is not None:
            # relaxed-label (float multi-hot) transforms keep their own
            # dtype regardless of the wire format
            label = self.label_transform(mask)
        elif self.dcfg.transfer_uint8:
            label = mask_to_array(mask, np.uint8)
        else:
            label = mask_to_array(mask)
        return {
            "image": image,
            "label": label,
            "name": img_name,
            "scale_float": np.float32(scale_float),
        }


def make_dataset_folder(folder: str) -> list:
    """Folder-inference mode: every image, no masks
    (reference: datasets/utils.py:4-18)."""
    items = [(os.path.join(folder, f), "")
             for f in sorted(os.listdir(folder))
             if f.lower().endswith((".png", ".jpg", ".jpeg"))]
    return items
