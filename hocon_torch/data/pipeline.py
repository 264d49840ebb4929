"""Batching pipeline.

Port of ``BatchLoader``, ``_Prefetcher`` and ``probe_batch`` from
``hocon/data/pipeline.py``: a deterministic host-side loader with per-host
sharding that stacks dict samples into fixed-shape numpy batches
(``tree_stack`` takes the place of ``jax.tree_util.tree_map``). The
reference's Grain loaders become a torch ``DataLoader`` with the off-path
data (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


def tree_stack(samples: list):
    """Stack a list of (nested) dict samples leaf by leaf along a new
    leading axis; None leaves stay None."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: tree_stack([s[k] for s in samples]) for k in first}
    if first is None:
        return None
    return np.stack(samples)


class _Prefetcher:
    """Iterator wrapper that assembles up to ``depth`` items ahead in a
    background thread, so the host builds batch N+1 while the card runs
    step N; exceptions propagate to the consumer.

    The producer never blocks indefinitely: every put is stop-aware, and
    abandoning the iterator (``break`` mid-epoch, or dropping it after one
    ``next``) runs ``close()`` from the generator's ``finally`` when it is
    closed or collected, so the thread and its queued batches are released.
    """

    _DONE = object()

    def __init__(self, make_iter, depth: int):
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def run():
            try:
                for item in make_iter():
                    if not put(item):
                        return
            except BaseException as e:  # propagate, don't hang the consumer
                put(e)
            else:
                put(self._DONE)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def close(self):
        self._stop.set()
        # Drop queued batches so the producer's pending put unblocks fast.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __iter__(self):
        try:
            while True:
                item = self._q.get()
                if item is self._DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self.close()


def probe_batch(dataset, local_batch: int) -> dict:
    """One local batch assembled directly from the dataset, for shape
    probing and train-state init, without consuming a loader's batch."""
    samples = [dataset[i % len(dataset)] for i in range(local_batch)]
    batch = tree_stack(samples)
    if isinstance(batch, dict):
        batch["_valid"] = np.ones(local_batch, np.float32)
    return batch


class BatchLoader:
    """Deterministic shuffling batch loader with per-host sharding.

    Args:
      dataset: indexable dataset returning (possibly nested) dict samples.
      batch_size: GLOBAL batch size; each host yields batch_size/shard_count.
      shard_index / shard_count: this host's shard.
      prefetch: assemble up to N batches ahead in a background thread
        (0 = synchronous). Sample order and contents are identical either
        way.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        shard_index: int = 0,
        shard_count: int = 1,
        prefetch: int = 0,
    ):
        if batch_size % shard_count:
            raise ValueError("global batch size must divide by shard count")
        self.dataset = dataset
        self.batch_size = batch_size
        self.local_batch = batch_size // shard_count
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.prefetch = prefetch

    def epoch_indices(self, epoch: int) -> tuple[np.ndarray, np.ndarray]:
        """Returns (indices, valid) of shape (n_batches, local_batch);
        valid is 0 for wrap-around padding rows (drop_last=False tail)."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, epoch))
            rng.shuffle(idx)
        valid = np.ones(len(idx), np.float32)
        n_batches = len(idx) // self.batch_size
        if not self.drop_last and len(idx) % self.batch_size:
            pad = self.batch_size - len(idx) % self.batch_size
            # np.resize tiles: pad can exceed len(idx) (dataset smaller
            # than one global batch) and must still fill a whole batch.
            idx = np.concatenate([idx, np.resize(idx, pad)])
            valid = np.concatenate([valid, np.zeros(pad, np.float32)])
            n_batches += 1
        shape = (n_batches, self.shard_count, self.local_batch)
        n = n_batches * self.batch_size
        return (
            idx[:n].reshape(shape)[:, self.shard_index],
            valid[:n].reshape(shape)[:, self.shard_index],
        )

    def steps_per_epoch(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        if self.prefetch > 0:
            return iter(_Prefetcher(lambda: self._epoch(epoch), self.prefetch))
        return self._epoch(epoch)

    def _epoch(self, epoch: int) -> Iterator[dict]:
        indices, valids = self.epoch_indices(epoch)
        for batch_idx, batch_valid in zip(indices, valids):
            batch = tree_stack([self.dataset[int(i)] for i in batch_idx])
            if isinstance(batch, dict):
                batch["_valid"] = batch_valid
            yield batch

    def __iter__(self):
        return self.epoch(0)
