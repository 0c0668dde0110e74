"""Data factory: build transform stacks + datasets + loaders from config.

Reference: datasets.setup_loaders (datasets/__init__.py:45-199).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

from tpuseg_torch.config import Config
from tpuseg_torch.data import joint_transforms as jt
from tpuseg_torch.data import transforms as it
from tpuseg_torch.data.grain_loader import GrainLoader
from tpuseg_torch.data.loader import BatchLoader
from tpuseg_torch.data.randaugment import RandAugment
from tpuseg_torch.data.relaxed_labels import relaxed_onehot
from tpuseg_torch.data.sampler import ShardedEpochSampler
from tpuseg_torch.data.transforms import mask_to_array

DATASETS = {}


def register_dataset(name):
    def deco(cls):
        DATASETS[name] = cls
        return cls
    return deco


def _dataset_cls(name: str):
    if not DATASETS:
        from tpuseg_torch.data.cityscapes import Cityscapes
        from tpuseg_torch.data.mapillary import Mapillary
        from tpuseg_torch.data.synthetic import SyntheticDataset
        DATASETS.update({
            "cityscapes": Cityscapes,
            "mapillary": Mapillary,
            "synthetic": SyntheticDataset,
        })
    return DATASETS[name]


class _PairedRandAug:
    """Adapter: RandAugment as a joint transform inside JointCompose."""

    def __init__(self, n, m, ignore_label):
        self.ra = RandAugment(n, m, ignore_label)

    def __call__(self, img, mask, rng):
        return self.ra(img, mask, rng)


def build_train_joint_transform(cfg: Config, ignore_label: int):
    """(reference: datasets/__init__.py:72-87)"""
    d = cfg.dataset
    tfs = [jt.RandomSizeAndCrop(
        tuple(d.crop_size), nopad=False, scale_min=d.scale_min,
        scale_max=d.scale_max, full_size=d.full_crop_training,
        pre_size=d.pre_size, ignore_label=ignore_label,
        translate_aug_fix=d.translate_aug_fix)]
    tfs.append(jt.RandomHorizontallyFlip())
    if d.rand_augment:
        n, m = d.rand_augment
        tfs.append(_PairedRandAug(int(n), int(m), ignore_label))
    return jt.JointCompose(tfs)


def build_train_img_transform(cfg: Config):
    """(reference: datasets/__init__.py:92-108); normalization happens in
    BaseDataset so this is photometric-only."""
    d = cfg.dataset
    tfs = []
    if d.color_aug:
        tfs.append(it.ColorJitter(d.color_aug, d.color_aug, d.color_aug,
                                  d.color_aug))
    if d.bblur:
        tfs.append(it.RandomBilateralBlur())
    elif d.gblur:
        tfs.append(it.RandomGaussianBlur())
    return it.Compose(tfs) if tfs else None


def build_val_joint_transform(cfg: Config, ignore_label: int):
    """(reference: datasets/__init__.py:123-138)"""
    d = cfg.dataset
    if "mapillary" in d.name:
        eval_size = d.pre_size or 2177
        if d.mapillary_crop_val:
            return jt.JointCompose([jt.ResizeHeight(eval_size),
                                    jt.CenterCropPad(eval_size,
                                                     ignore_label)])
        return jt.JointCompose([jt.Scale(eval_size)])
    return None


def relaxed_label_transform(cfg: Config, ignore_label: int,
                            reduce_border: bool = False):
    """Label transform for --jointwtborder training, carrying the
    BORDER_WINDOW / STRICTBORDERCLASS knobs. After REDUCE_BORDER_EPOCH the
    Trainer swaps in the ``reduce_border=True`` variant (the reference
    reads the global cfg.EPOCH at call time instead,
    transforms/transforms.py:95-123)."""
    lc = cfg.loss
    strict = tuple(lc.strict_border_classes or ()) or None
    return partial(relaxed_onehot,
                   num_classes=cfg.dataset.num_classes,
                   ignore_label=ignore_label,
                   border=lc.border_window,
                   strict_classes=strict,
                   reduce_border=reduce_border)


def setup_data(cfg: Config, eval_mode: Optional[str] = None,
               num_shards: int = 1, shard: int = 0, seed: int = 0,
               is_primary: bool = True, val_shards: Optional[int] = None,
               val_shard: Optional[int] = None):
    """-> (train_loader | None, val_loader, train_set | None).

    ``eval_mode``: None (train+val), 'val', 'trn', or 'folder'
    (reference: datasets/__init__.py:140-147). The val split is sharded
    ``val_shards`` ways (``num_shards`` unless given): under dp x sp the
    train data is sharded over the dp groups and the val split over every
    rank.
    """
    if val_shards is None:
        val_shards, val_shard = num_shards, shard
    d = cfg.dataset
    if d.loader not in ("threaded", "grain"):
        raise ValueError(
            f"dataset.loader must be 'threaded' or 'grain', got "
            f"{d.loader!r}")
    if eval_mode is None and cfg.train.batch_size % max(num_shards, 1):
        raise ValueError(
            f"train.batch_size={cfg.train.batch_size} must be divisible by "
            f"the number of data shards ({num_shards}): the mesh data axis "
            f"is sized against the GLOBAL batch, so a truncated per-shard "
            f"batch would fail sharding with an opaque shape error")
    cls = _dataset_cls(d.name)
    ignore_label = getattr(cls, "ignore_label", d.ignore_label)

    if d.name == "synthetic":
        # same per-host sharding contract as the real datasets:
        # train.batch_size is the GLOBAL batch; each host loads its
        # 1/num_shards slice and shard_batch assembles the global array
        train_set = cls(tuple(d.crop_size), d.num_classes)
        val_set = cls(tuple(d.crop_size), d.num_classes, length=16)
        train_loader = BatchLoader(
            train_set, cfg.train.batch_size // max(num_shards, 1),
            sampler=ShardedEpochSampler(len(train_set), num_shards, shard,
                                        shuffle=True, pad=True, seed=seed),
            drop_last=True, num_workers=d.num_workers)
        val_loader = BatchLoader(
            val_set, cfg.eval.batch_size,
            sampler=ShardedEpochSampler(len(val_set), val_shards, val_shard,
                                        shuffle=False, pad=False,
                                        seed=seed),
            num_workers=2)
        return train_loader, val_loader, train_set

    val_name = {"val": "val", None: "val", "trn": "train",
                "folder": "folder"}[eval_mode]
    val_set = cls(
        d, mode=val_name,
        joint_transform=build_val_joint_transform(cfg, ignore_label),
        img_transform=None, label_transform=None,
        eval_folder=d.eval_folder, seed=seed, is_primary=is_primary)
    val_sampler = ShardedEpochSampler(len(val_set), val_shards, val_shard,
                                      shuffle=False, pad=False, seed=seed)
    # batched validation (reference --bs_val): requires fixed-res val
    # images; the final ragged batch compiles one extra eval graph
    val_loader = BatchLoader(val_set, cfg.eval.batch_size,
                             sampler=val_sampler,
                             num_workers=max(1, d.num_workers // 2))

    if eval_mode is not None:
        return None, val_loader, None

    if d.jointwtborder:
        label_transform = relaxed_label_transform(cfg, ignore_label)
    elif d.transfer_uint8:
        # engage BaseDataset's uint8 label wire (labels ship as 1 B/px
        # instead of int32's 4 B/px — more bytes than the image itself)
        label_transform = None
    else:
        label_transform = mask_to_array

    train_set = cls(
        d, mode="train",
        joint_transform=build_train_joint_transform(cfg, ignore_label),
        img_transform=build_train_img_transform(cfg),
        label_transform=label_transform, seed=seed, is_primary=is_primary)
    per_shard_bs = cfg.train.batch_size // max(num_shards, 1)
    if d.loader == "grain":
        # the train loader on worker processes (data/grain_loader.py)
        train_loader = GrainLoader(
            train_set, per_shard_bs, num_shards=num_shards, shard=shard,
            shuffle=True, drop_last=True, num_workers=d.num_workers,
            seed=seed)
    else:
        train_sampler = ShardedEpochSampler(len(train_set), num_shards,
                                            shard, shuffle=True, pad=True,
                                            seed=seed)
        train_loader = BatchLoader(
            train_set, per_shard_bs,
            sampler=train_sampler, drop_last=True, num_workers=d.num_workers)
    return train_loader, val_loader, train_set
