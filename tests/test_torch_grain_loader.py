"""The port's process loader (``dataset.loader: grain``): ``GrainLoader``
on worker processes against the threaded ``BatchLoader`` byte for byte,
``tests/test_grain_loader.py``'s three properties, a label transform
swapped between epochs reaching the workers, and ``setup_data`` routing
the recipe key to it on a Cityscapes miniature that trains through it."""
import json
import os

import numpy as np
import pytest
from PIL import Image

from _torch_port import set_threads
from tpuseg_torch.config import make_config
from tpuseg_torch.data.grain_loader import GrainLoader
from tpuseg_torch.data.loader import BatchLoader
from tpuseg_torch.data.setup import relaxed_label_transform, setup_data
from tpuseg_torch.data.synthetic import SyntheticDataset
from tpuseg_torch.train.loop import Trainer

set_threads()


@pytest.fixture(scope="module")
def cityscapes(tmp_path_factory):
    """A Cityscapes tree of 6 train and 2 val 96x96 scenes of random
    classes (tests/test_grain_loader.py's miniature, with structure)."""
    root = tmp_path_factory.mktemp("cs")
    rng = np.random.RandomState(0)
    for split, city, n in [("train", "aachen", 6), ("val", "lindau", 2)]:
        img_dir = root / "leftImg8bit_trainvaltest/leftImg8bit" / split / city
        msk_dir = root / "gtFine_trainvaltest/gtFine" / split / city
        img_dir.mkdir(parents=True)
        msk_dir.mkdir(parents=True)
        for i in range(n):
            base = f"{city}_{i:06d}_000019"
            Image.fromarray(rng.randint(0, 255, (96, 96, 3),
                                        dtype=np.uint8)).save(
                img_dir / f"{base}_leftImg8bit.png")
            # raw label ids of train classes, in 16-px squares
            ids = rng.choice([7, 8, 11, 17, 21, 24, 26], (6, 6))
            mask = np.repeat(np.repeat(ids, 16, 0), 16, 1).astype(np.uint8)
            Image.fromarray(mask).save(
                msk_dir / f"{base}_gtFine_labelIds.png")
    return root


def _cfg(root, **sets):
    return make_config({
        "dataset.name": "cityscapes",
        "dataset.cityscapes_dir": str(root),
        "dataset.centroid_root": os.path.join(str(root), "centroids"),
        "dataset.crop_size": (64, 64), "dataset.class_uniform_tile": 32,
        "dataset.num_workers": 2, "train.batch_size": 2, **sets})


def _equal(a: list, b: list) -> bool:
    """Two epochs' batches, equal key for key and byte for byte."""
    assert a and len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            u, v = np.asarray(x[k]), np.asarray(y[k])
            if u.dtype != v.dtype or u.shape != v.shape or \
                    u.tobytes() != v.tobytes():
                return False
    return True


def test_matches_batch_loader_bytewise(cityscapes):
    """Shuffled, class-uniform crops with flips and colour jitter, 2
    shards, two epochs: the same batches as the threaded loader's."""
    for shard in (0, 1):
        loaders = {kind: setup_data(
            _cfg(cityscapes, **{"dataset.color_aug": 0.25,
                                "dataset.loader": kind}),
            num_shards=2, shard=shard) for kind in ("threaded", "grain")}
        assert isinstance(loaders["grain"][0], GrainLoader)
        assert isinstance(loaders["threaded"][0], BatchLoader)
        for epoch in (0, 1):
            got = {}
            for kind, (loader, _, train_set) in loaders.items():
                train_set.build_epoch(epoch)
                loader.set_epoch(epoch)
                got[kind] = list(loader)
            assert _equal(got["grain"], got["threaded"]), (shard, epoch)


def test_batches_and_count():
    """Shapes and the batch count: 22 samples at batch 4 give 5 batches
    (the one partial batch is dropped, as BatchLoader drops it)."""
    ds = SyntheticDataset((32, 32), 19, length=22)
    loader = GrainLoader(ds, 4, shuffle=True, drop_last=True, num_workers=2)
    batches = list(loader)
    assert len(batches) == len(loader) == 5
    assert batches[0]["image"].shape == (4, 32, 32, 3)
    assert batches[0]["label"].shape == (4, 32, 32)

    loader.set_epoch(1)
    again = list(loader)
    assert any((a["label"] != b["label"]).any()
               for a, b in zip(batches, again))  # epoch-seeded reshuffle


def test_shards_disjoint_and_cover():
    ds = SyntheticDataset((16, 16), 19, length=16)
    seen = []
    for shard in range(2):
        for batch in GrainLoader(ds, 2, num_shards=2, shard=shard,
                                 num_workers=0):
            seen.extend(batch["name"])
    assert len(seen) == 16
    assert len(set(seen)) == 16  # disjoint shards cover everything


def test_label_transform_swap_reaches_workers(cityscapes):
    """The trainer's REDUCE_BORDER_EPOCH swap of the train set's label
    transform, made between two epochs, is what the worker processes
    apply next (workers are made anew each epoch)."""
    cfg = _cfg(cityscapes, **{"dataset.jointwtborder": True,
                              "dataset.loader": "grain"})
    loader, _, train_set = setup_data(cfg)
    before = list(loader)
    train_set.label_transform = relaxed_label_transform(
        cfg, train_set.ignore_label, reduce_border=True)
    after = list(loader)
    want = [train_set[i]["label"] for i in loader.batches()[0]]
    assert not _equal(before, after)
    assert np.array_equal(after[0]["label"], np.stack(want))


def test_setup_data_selects_grain_and_trains(cityscapes, tmp_path):
    """``dataset.loader=grain`` routes the train loader to GrainLoader, and
    a tiny Trainer.fit through it logs the same losses as through the
    threaded loader (the same batches into the same seeded model)."""
    sets = {"model.arch": "ocrnet.HRNet_Mscale_Tiny",
            "model.n_scales": (1.0,), "train.test_mode": True,
            "train.log_every": 1, "loss.loss_type": "ce"}
    losses = {}
    for kind in ("threaded", "grain"):
        logdir = tmp_path / kind
        trainer = Trainer(_cfg(cityscapes, **sets,
                               **{"dataset.loader": kind}),
                          logdir=str(logdir), device="cpu")
        assert isinstance(trainer.train_loader,
                          GrainLoader if kind == "grain" else BatchLoader)
        trainer.fit()
        lines = [json.loads(x) for x in
                 (logdir / "metrics.jsonl").read_text().splitlines()]
        losses[kind] = [x["loss"] for x in lines if x["phase"] == "train"]
    assert len(losses["grain"]) == 6  # 3 steps an epoch, 2 epochs
    assert all(np.isfinite(losses["grain"]))
    assert losses["grain"] == losses["threaded"]
