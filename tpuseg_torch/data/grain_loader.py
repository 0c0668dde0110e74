"""Process-backed input pipeline (the port's ``dataset.loader: grain``).

The counterpart of ``tpuseg/data/grain_loader.py:41-102``, which runs
decode and augmentation in Google Grain's worker processes. Grain is not a
dependency of the port: this loader is ``torch.utils.data.DataLoader`` with
``num_workers`` worker processes, so host augmentation runs outside the
interpreter that dispatches the train step.

Indices come from the port's ``ShardedEpochSampler``, batched as
``BatchLoader`` batches them. Each worker makes one sample at a time, so
the samples of a batch are made in parallel as ``BatchLoader``'s threads
make them, and this process collates them with the same ``collate``.
Every random draw of a sample derives from (seed, epoch, index)
(``data/base.py``), so this loader yields ``BatchLoader``'s batches byte for
byte for the same seed, epoch and shard. With ``drop_last`` it drops the
one partial batch, as ``BatchLoader`` does (``tpuseg``'s Grain workers
batch on their own and drop up to ``num_workers - 1``).

The workers are started anew for every ``__iter__`` (never persistent):
each epoch's dataset state (the crop list ``build_epoch`` rebuilds, the
length ``set_dataset_len`` sets, a label transform the trainer swaps in)
reaches them with the pickled dataset. They fork from a ``forkserver``, a
fresh single-threaded interpreter that has imported torch and the
datasets once (``_PRELOAD``), so no worker is forked from the training
process's threads or CUDA context, and an epoch does not pay the imports
that ``spawn`` would repeat. Workers never touch CUDA.
"""
from __future__ import annotations

import multiprocessing
from typing import Iterator

from tpuseg_torch.data.loader import collate
from tpuseg_torch.data.sampler import ShardedEpochSampler


# what the forkserver imports before it forks a worker
_PRELOAD = ["torch", "tpuseg_torch.data.cityscapes",
            "tpuseg_torch.data.mapillary", "tpuseg_torch.data.synthetic"]


def _sample(sample: dict) -> dict:
    """A worker's sample as the dataset made it (numpy, not tensors)."""
    return sample


def _worker_context():
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(_PRELOAD)
    return ctx


class GrainLoader:
    """Drop-in for ``BatchLoader`` on worker processes.

    Args mirror ``tpuseg``'s ``GrainLoader``; ``num_workers`` is the number
    of worker PROCESSES (0: load in this process).
    """

    def __init__(self, dataset, batch_size: int, num_shards: int = 1,
                 shard: int = 0, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 4,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.sampler = ShardedEpochSampler(len(dataset), num_shards, shard,
                                           shuffle=shuffle, pad=True,
                                           seed=seed)

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)
        self.sampler.set_dataset_len(len(self.dataset))

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def batches(self) -> list:
        """This epoch's index batches, as ``BatchLoader`` forms them."""
        indices = list(self.sampler)
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def __iter__(self) -> Iterator[dict]:
        import torch
        from torch.utils.data import DataLoader

        batches = self.batches()
        if not batches:
            return iter(())
        indices = [i for b in batches for i in b]
        workers = min(self.num_workers, len(indices))
        samples = iter(DataLoader(
            self.dataset, sampler=indices, batch_size=None,
            collate_fn=_sample, num_workers=workers,
            multiprocessing_context=_worker_context() if workers else None,
            # the workers' seed comes from a generator of the loader's own:
            # drawing it from torch's default one would move the trainer's
            # dropout masks (the samples' draws come from (seed, epoch,
            # index) either way)
            generator=torch.Generator()))
        return (collate([next(samples) for _ in b]) for b in batches)
