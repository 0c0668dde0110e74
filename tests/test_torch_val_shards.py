"""Validation over several ranks scores each val image exactly once.

The val split is sharded without padding: shard ``s`` of ``n`` takes
``indices[s::n]`` (``tpuseg_torch/data/sampler.py``), so shard lengths
differ by at most one and an empty shard stays empty (``BatchLoader``
takes the sampler it is given, even an empty one). ``tpuseg``'s unpadded
shards keep ``len // n`` indices each, skipping the last ``len % n``
images, and its loader swaps an empty sampler for the whole split.

The sampler is held on its own, and ``Trainer.validate`` runs on gloo
clusters on the CPU (tests/_torch_ddp_child.py's ``validate`` mode): 3 val
scenes over 2 ranks and 2 over 3 (one rank with none), each rank's scored
images and the summed confusion matrix against one process's.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpuseg_torch.cli.main import load_config
from tpuseg_torch.data.loader import BatchLoader
from tpuseg_torch.data.sampler import ShardedEpochSampler
from tpuseg_torch.train.loop import Trainer

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHILD = os.path.join(HERE, "_torch_ddp_child.py")
RECIPE = os.path.join(REPO, "tpuseg_torch", "cli", "recipes",
                      "train_cityscapes.yaml")
# (ranks, val scenes)
CLUSTERS = ((2, 3), (3, 2))
SETS = ["model.arch=ocrnet.HRNet_Mscale_Tiny", "model.remat=false",
        "dataset.name=cityscapes", "dataset.crop_size=[64,64]",
        "dataset.class_uniform_pct=0", "train.test_mode=true"]


@pytest.mark.parametrize("n,shards", [(3, 2), (2, 3), (500, 3), (7, 8),
                                      (0, 2)])
@pytest.mark.parametrize("shuffle", [False, True])
def test_unpadded_shards_cover_the_split_once(n, shards, shuffle):
    samplers = [ShardedEpochSampler(n, shards, s, shuffle=shuffle,
                                    pad=False, seed=3)
                for s in range(shards)]
    got = [list(s) for s in samplers]
    assert sorted(i for g in got for i in g) == list(range(n))
    assert [len(g) for g in got] == [len(s) for s in samplers]
    assert max(map(len, got)) - min(map(len, got)) <= 1
    # the permutation's strided shards
    order = list(ShardedEpochSampler(n, shuffle=shuffle, pad=False, seed=3))
    assert got == [order[s::shards] for s in range(shards)]


@pytest.mark.parametrize("n,shards", [(3, 2), (2, 3), (500, 3)])
def test_padded_shards_unchanged(n, shards):
    """The train sampler: every shard ``ceil(n / shards)`` long, the
    permutation padded with its own first indices."""
    size = -(-n // shards)
    for epoch in (0, 1):
        rng = np.random.default_rng((0, epoch))
        order = rng.permutation(n).tolist()
        order += order[:size * shards - n]
        for s in range(shards):
            sampler = ShardedEpochSampler(n, shards, s, shuffle=True,
                                          pad=True, seed=0)
            sampler.set_epoch(epoch)
            assert len(sampler) == size
            assert list(sampler) == order[s::shards]


def test_loader_keeps_an_empty_shard_empty():
    empty = ShardedEpochSampler(2, 3, 2, shuffle=False, pad=False)
    loader = BatchLoader(list(range(2)), 1, sampler=empty)
    assert len(empty) == 0 and len(loader) == 0
    assert list(loader) == []


def _write_cityscapes(root, n_val: int) -> None:
    """1 train and ``n_val`` val 64x64 scenes of train classes in 16-px
    squares."""
    from PIL import Image

    rng = np.random.RandomState(n_val)
    for split, city, n in [("train", "aachen", 1), ("val", "lindau", n_val)]:
        img_dir = root / "leftImg8bit_trainvaltest/leftImg8bit" / split / city
        msk_dir = root / "gtFine_trainvaltest/gtFine" / split / city
        img_dir.mkdir(parents=True)
        msk_dir.mkdir(parents=True)
        for i in range(n):
            base = f"{city}_{i:06d}_000019"
            Image.fromarray(rng.randint(0, 255, (64, 64, 3),
                                        dtype=np.uint8)).save(
                img_dir / f"{base}_leftImg8bit.png")
            ids = rng.choice([7, 8, 11, 17, 21, 24, 26], (4, 4))
            Image.fromarray(np.repeat(np.repeat(ids, 16, 0), 16, 1).astype(
                np.uint8)).save(msk_dir / f"{base}_gtFine_labelIds.png")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """Each cluster's ranks run ``Trainer.validate`` while this process
    runs it alone over the same tree."""
    procs, dirs, one = [], {}, {}
    try:
        for world, n_val in CLUSTERS:
            out = tmp_path_factory.mktemp(f"val_{world}x{n_val}")
            _write_cityscapes(out / "cityscapes", n_val)
            sets = SETS + [f"dataset.cityscapes_dir={out / 'cityscapes'}"]
            torch.save({"recipe": RECIPE,
                        "sets": sets + [f"train.batch_size={world}"]},
                       out / "val_inputs.pt")
            port = _free_port()
            for rank in range(world):
                env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                           WORLD_SIZE=str(world),
                           LOCAL_WORLD_SIZE=str(world),
                           MASTER_ADDR="localhost", MASTER_PORT=str(port))
                procs.append(subprocess.Popen(
                    [sys.executable, CHILD, str(out), "validate"],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, env=env, cwd=REPO))
            dirs[world, n_val] = out
            cfg = load_config(RECIPE, sets + ["train.batch_size=1"])
            trainer = Trainer(cfg, str(out / "one"), device="cpu")
            one[world, n_val] = trainer.validate(0).hist
        texts = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, texts):
        assert p.returncode == 0, text[-4000:]
    return {key: {"one": one[key],
                  "ranks": [torch.load(dirs[key] / f"val_rank{r}.pt",
                                       weights_only=False)
                            for r in range(key[0])]}
            for key in CLUSTERS}


@pytest.mark.parametrize("world,n_val", CLUSTERS)
def test_validate_scores_each_image_once(clusters, world, n_val):
    """Every val scene scored by exactly one rank (3 over 2: 2 + 1; 2 over
    3: 1 + 1 + 0), and every rank's summed matrix equal to one process's
    over the whole split."""
    ranks, one = clusters[world, n_val]["ranks"], clusters[world, n_val]["one"]
    names = [r["names"] for r in ranks]
    assert sorted(len(n) for n in names) == sorted(
        len(range(r, n_val, world)) for r in range(world))
    assert len({m for n in names for m in n}) == n_val == sum(map(len, names))
    assert one.sum() == n_val * 64 * 64
    for r in ranks:
        np.testing.assert_array_equal(r["hist"], one)
