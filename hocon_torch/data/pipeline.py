"""Batching pipeline.

Port of ``BatchLoader``, ``_Prefetcher`` and ``probe_batch`` from
``hocon/data/pipeline.py``: a deterministic host-side loader with per-host
sharding that stacks dict samples into fixed-shape numpy batches
(``tree_stack`` takes the place of ``jax.tree_util.tree_map``).

The reference's Grain loaders (``GrainEvalLoader``, ``GrainEpochLoader``)
become ``WorkerEvalLoader`` and ``WorkerEpochLoader``: one record per whole
batch, taken from ``BatchLoader.epoch_indices``, assembled in
``torch.utils.data.DataLoader`` worker processes, so both give
``BatchLoader``'s batches and ``_valid`` masks bit for bit. The choices:

- Workers are forked from a ``forkserver``, never from the CLI's process:
  that process has CUDA up, and a child forked from it cannot use it (a
  JPEG frame decodes through nvJPEG on the card, ``images.read_image``).
  The server is a fresh interpreter that imports torch once and never
  touches CUDA; each worker imports the port's modules itself, after it
  has taken the parent's ``sys.path``. ``spawn`` would be as safe but
  starts the workers one after another: each start writes the pickled
  dataset into a pipe that the child drains only once it has imported
  torch, 7-16 s a worker on the H100 machine's host
  (``tools/worker_startup.py``). The workers see the environment of the
  CLI's process as it was when the server started.
- Workers receive no CUDA tensor. The datasets that keep the MANO model on
  the card (FPHAB, HO-3D, synthetic) drop it from their pickled state
  (``__getstate__``); their ``get_sample`` is host code. So a worker opens
  a CUDA context only when its dataset decodes JPEG on the card, and then
  its own nvJPEG contexts, one per thread (``images._context``). This
  takes the place of the reference's ``_data_worker_env`` /
  ``_WorkerEnvLoader``, which kept the TPU's environment out of the
  workers; nothing else of them is ported.
- ``batch_size=None`` with the identity ``collate_fn``: batches stay the
  numpy dicts the worker stacked (the default collate makes tensors).
- Workers persist across epochs (``persistent_workers``; the sampler's
  ``set_epoch`` picks the epoch), so their start is paid once per loader, and
  ``close()`` stops them; the CLIs close their loaders when they return.
  The forkserver and multiprocessing's resource tracker outlive the loaders
  and end only just after the process that started them; a caller that
  must leave no process behind calls ``stop_worker_server()``.
- No fallback: a worker's exception, or a worker that dies, raises in the
  parent. With ``worker_count == 0`` the loaders are ``BatchLoader``.
- The DataLoader draws its worker seeds from a generator of its own, not
  from torch's global one; the samples are seeded by their index anyway.
"""

from __future__ import annotations

import gc
import multiprocessing
import multiprocessing.forkserver
import multiprocessing.resource_tracker
import queue
import threading
from typing import Iterator

import numpy as np
import torch


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

    def close(self):
        """Nothing to stop: BatchLoader runs in this process."""

    def __iter__(self):
        return self.epoch(0)


def _identity(batch):
    """The workers' ``collate_fn``: a batch stays the numpy dict stacked by
    its worker."""
    return batch


class _EpochBatches:
    """Map-style DataLoader source: key (epoch, b) is batch b of that epoch's
    ``BatchLoader.epoch_indices``, stacked by ``tree_stack`` in a worker."""

    def __init__(self, inner: BatchLoader):
        self.inner = inner
        self._epoch, self._indices = None, None

    def __getitem__(self, key):
        epoch, b = key
        if epoch != self._epoch:
            self._epoch, self._indices = epoch, self.inner.epoch_indices(epoch)[0]
        return tree_stack([self.inner.dataset[int(i)] for i in self._indices[b]])


class _EpochSampler:
    """The keys (epoch, 0), ..., (epoch, n - 1) of the epoch last set."""

    def __init__(self, n_batches: int):
        self.n_batches = n_batches
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        return iter([(self.epoch, b) for b in range(self.n_batches)])

    def __len__(self):
        return self.n_batches


def _worker_context() -> multiprocessing.context.BaseContext:
    """The start method of the loaders' workers (see the module note): a
    forkserver that preloads torch."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch"])
    return ctx


def stop_worker_server() -> None:
    """Stop the workers' forkserver and multiprocessing's resource tracker,
    if this process started them, and wait until both have exited; close
    the loaders first. The next worker loader starts them again.

    Both otherwise end only after this process does. multiprocessing has no
    public call for either, so this uses the ``_stop`` that its own tests
    use."""
    gc.collect()  # closed loaders' queues unregister their semaphores first
    multiprocessing.forkserver._forkserver._stop()
    multiprocessing.resource_tracker._resource_tracker._stop()


class _WorkerLoader:
    """``inner``'s batches, assembled in ``worker_count`` worker processes
    (see the module note); in-process when ``worker_count`` is 0."""

    def __init__(self, inner: BatchLoader, worker_count: int):
        self._inner = inner
        self.dataset = inner.dataset
        self.batch_size = inner.batch_size
        self.local_batch = inner.local_batch
        self.worker_count = worker_count
        self._sampler = _EpochSampler(inner.steps_per_epoch())
        self._loader = None

    def steps_per_epoch(self) -> int:
        return self._inner.steps_per_epoch()

    def _workers(self) -> torch.utils.data.DataLoader:
        if self._loader is None:
            self._loader = torch.utils.data.DataLoader(
                _EpochBatches(self._inner), batch_size=None, sampler=self._sampler,
                num_workers=self.worker_count, collate_fn=_identity,
                multiprocessing_context=_worker_context(), persistent_workers=True,
                generator=torch.Generator().manual_seed(0),
            )
        return self._loader

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        if self.worker_count <= 0:
            yield from self._inner.epoch(epoch)
            return
        loader = self._workers()
        self._sampler.set_epoch(epoch)
        for batch, valid in zip(loader, self._inner.epoch_indices(epoch)[1]):
            if isinstance(batch, dict):
                batch["_valid"] = valid
            yield batch

    def close(self):
        """Stop the worker processes, if an epoch started them (DataLoader
        has no public call that stops persistent workers)."""
        if self._loader is not None and self._loader._iterator is not None:
            self._loader._iterator._shutdown_workers()
        self._loader = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self.epoch(0)


class WorkerEvalLoader(_WorkerLoader):
    """Eval loader with worker processes and every sample exactly once.

    Counterpart of ``hocon.data.pipeline.GrainEvalLoader``: the batches of
    ``BatchLoader(shuffle=False, drop_last=False)``, so batch composition,
    order and ``_valid`` masks are ``BatchLoader``'s bit for bit (the tail
    padded by wrap-around, its padding rows at ``_valid`` 0), and only the
    per-sample work (decode, crop, augment) moves into the workers. Eval
    metrics therefore do not depend on the worker count. ``shard_index`` /
    ``shard_count`` select this rank's shard of every global batch.
    """

    def __init__(self, dataset, batch_size: int, worker_count: int = 0,
                 shard_index: int = 0, shard_count: int = 1):
        super().__init__(BatchLoader(dataset, batch_size, shuffle=False, drop_last=False,
                                     shard_index=shard_index, shard_count=shard_count),
                         worker_count)


class WorkerEpochLoader(_WorkerLoader):
    """Train loader with worker processes.

    Counterpart of ``hocon.data.pipeline.GrainEpochLoader`` /
    ``grain_loader``: each sample once per epoch in a shuffled order, the
    remainder dropped, ``steps_per_epoch = len // batch_size``. Grain's
    sampler order is not reproduced (Grain is not a dependency of the
    port): the batches are ``BatchLoader(drop_last=True, shuffle=True,
    seed)``'s, bit for bit, so ``--workers N`` trains on ``--workers 0``'s
    batches.

    ``train_only``: ``train.loop.epoch_pass`` refuses it in an eval pass,
    which must score the dataset's tail.
    """

    train_only = True

    def __init__(self, dataset, batch_size: int, seed: int = 0, worker_count: int = 0,
                 shard_index: int = 0, shard_count: int = 1):
        super().__init__(BatchLoader(dataset, batch_size, shuffle=True, seed=seed,
                                     drop_last=True, shard_index=shard_index,
                                     shard_count=shard_count), worker_count)
