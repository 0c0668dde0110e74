"""Threaded prefetching batch loader: index sampler -> worker transforms ->
fixed-shape NHWC numpy batches.

Replaces torch DataLoader + DistributedSampler (reference:
datasets/__init__.py:161-197). Decode/augment is PIL/numpy on host threads
(PIL releases the GIL for IO/codec work); the train loop overlaps the next
batch's host work with the current device step, double-buffered.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from tpuseg_torch.data.sampler import ShardedEpochSampler


def collate(samples: list[dict]) -> dict:
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]) or \
                isinstance(vals[0], (np.floating, np.integer)):
            out[key] = np.stack(vals) if isinstance(vals[0], np.ndarray) \
                else np.asarray(vals)
        else:
            out[key] = vals  # e.g. image names
    return out


class BatchLoader:
    """Map-style dataset -> prefetched batches.

    Args:
      dataset: indexable returning sample dicts.
      batch_size: per-host batch size.
      sampler: index source; defaults to a single-shard sampler.
      drop_last: drop the trailing partial batch (train).
      num_workers: transform threads.
      prefetch: number of batches assembled ahead.
    """

    def __init__(self, dataset, batch_size: int,
                 sampler: Optional[ShardedEpochSampler] = None,
                 shuffle: bool = False, drop_last: bool = False,
                 num_workers: int = 8, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or ShardedEpochSampler(
            len(dataset), shuffle=shuffle)
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)
        self.sampler.set_dataset_len(len(self.dataset))

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        indices = list(self.sampler)
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        if not batches:
            return iter(())

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__,
                                                batch_idx))
                        out_q.put(collate(samples))
                out_q.put(None)
            except BaseException as e:  # propagate to the consumer
                out_q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()

        def gen():
            try:
                while True:
                    batch = out_q.get()
                    if batch is None:
                        break
                    if isinstance(batch, BaseException):
                        raise batch
                    yield batch
            finally:
                stop.set()
                # unblock a producer stuck on a full queue
                try:
                    while True:
                        out_q.get_nowait()
                except queue.Empty:
                    pass

        return gen()
