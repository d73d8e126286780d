"""Host input pipeline: threaded prefetch + per-rank index sharding.

A numpy copy of coocc_tpu/data/loader.py (tests/test_torch_data_path.py
holds the samplers and the batches against it). Replaces the reference's
worker-process DataLoader + DistributedGroupSampler stack (its datasets
package's loader construction and samplers/*): each process (a rank of
the data-parallel run, parallel/distributed.py) loads only its shard of the
global index space, worker THREADS decode samples ahead of the device step,
and a bounded buffer keeps batches ready so host decode overlaps device
compute. Shuffling reseeds per epoch like the reference's
DistributedSampler.set_epoch. Where JAX reads jax.process_index() and
process_count(), the port reads the default process group's rank and world
size (one process: rank 0 of 1). The batches are numpy: the train loop
copies each onto the card on its own thread after next() (a copy from
pageable memory synchronizes, and a worker thread must not stall the
card's stream).
"""
from __future__ import annotations

import threading
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np


def rank_and_world(process_index: Optional[int] = None,
                   process_count: Optional[int] = None):
    """(process_index, process_count) as given, or else this process's rank
    and the world size of the default process group (0 and 1 outside a
    data-parallel run; parallel/distributed.py)."""
    if process_index is None or process_count is None:
        from ..parallel.distributed import rank, world_size
        return rank(), world_size()
    return process_index, process_count


def shard_indices(n: int, epoch: int, shuffle: bool, seed: int,
                  process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> np.ndarray:
    """Deterministic per-host shard of [0, n) (same shuffle on every host,
    disjoint contiguous shards — the reference's DistributedSampler with
    round-robin replaced by striding)."""
    process_index, process_count = rank_and_world(process_index,
                                                  process_count)
    order = np.arange(n)
    if shuffle:
        order = np.random.RandomState(seed + epoch).permutation(n)
    # drop the tail so every host sees the same number of steps
    per = n // process_count
    return order[process_index * per:(process_index + 1) * per]


def group_shard_indices(flags: np.ndarray, batch_size: int, epoch: int,
                        seed: int,
                        process_index: Optional[int] = None,
                        process_count: Optional[int] = None) -> np.ndarray:
    """Group-aware per-host indices (DistributedGroupSampler semantics,
    reference samplers/group_sampler.py:61-103): per group, shuffle and pad
    by repetition to a multiple of batch_size*process_count; concatenate;
    shuffle at BATCH granularity (so every batch stays single-group); each
    host takes a contiguous run of whole batches. Every index appears at
    least once per epoch (oversampled, never dropped)."""
    process_index, process_count = rank_and_world(process_index,
                                                  process_count)
    flags = np.asarray(flags)
    rng = np.random.RandomState(seed + epoch)
    chunk = batch_size * process_count
    indices = []
    for g in np.unique(flags):
        idx = np.where(flags == g)[0]
        idx = idx[rng.permutation(len(idx))]
        extra = -len(idx) % chunk
        if extra:
            reps = np.concatenate([idx] * (extra // len(idx) + 1))
            idx = np.concatenate([idx, reps[:extra]])
        indices.append(idx)
    allidx = np.concatenate(indices) if indices else np.zeros(0, np.int64)
    n_batches = len(allidx) // batch_size
    order = rng.permutation(n_batches)
    allidx = allidx.reshape(n_batches, batch_size)[order].reshape(-1)
    per = n_batches // process_count * batch_size
    return allidx[process_index * per:(process_index + 1) * per]


class PrefetchIterator:
    """Wraps a sample-producing function with worker threads + a bounded
    output queue. Ordering is preserved (workers fill a ticketed buffer)."""

    def __init__(self, make_fn: Callable[[int], object],
                 indices: Sequence[int], num_workers: int = 2,
                 prefetch: int = 4):
        self._make = make_fn
        self._indices = list(indices)
        self._prefetch = max(prefetch, 1)
        self._workers = max(num_workers, 1)
        self._stop = threading.Event()
        self._threads = []

    def _producer(self, positions):
        for pos in positions:
            # backpressure: stay at most `prefetch` items ahead of consumption
            with self._cv:
                while (pos > self._consumed + self._prefetch
                       and not self._stop.is_set()):
                    self._cv.wait(timeout=1.0)
            if self._stop.is_set():
                return
            try:
                item = self._make(self._indices[pos])
            except Exception as e:  # surface in the consumer
                item = e
            with self._cv:
                self._results[pos] = item
                self._cv.notify_all()

    def __iter__(self) -> Iterator:
        n = len(self._indices)
        self._results = {}
        self._consumed = -1
        self._cv = threading.Condition()
        # stride positions over workers so completion order stays near the
        # consumption order (bounded skew = num_workers)
        for w in range(self._workers):
            t = threading.Thread(
                target=self._producer, args=(range(w, n, self._workers),),
                daemon=True)
            t.start()
            self._threads.append(t)
        try:
            for pos in range(n):
                with self._cv:
                    while pos not in self._results:
                        self._cv.wait(timeout=60.0)
                    item = self._results.pop(pos)
                    self._consumed = pos
                    self._cv.notify_all()
                if isinstance(item, Exception):
                    self._stop.set()
                    raise item
                yield item
        finally:
            with self._cv:
                self._stop.set()
                self._cv.notify_all()

    def close(self):
        self._stop.set()


def prefetch_batches(dataset, cfg, batch_size: int, epoch: int,
                     is_train: bool, seed: int = 0, num_workers: int = 2,
                     prefetch: int = 4,
                     process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> Iterable:
    """Yield collated Batches for this host's shard of `dataset`."""
    from .nuscenes_dataset import collate

    flags = getattr(dataset, "group_flags", None)
    if is_train and flags is not None:
        idx = group_shard_indices(flags, batch_size, epoch, seed,
                                  process_index=process_index,
                                  process_count=process_count)
    else:
        idx = shard_indices(len(dataset), epoch, shuffle=is_train, seed=seed,
                            process_index=process_index,
                            process_count=process_count)
    # group indices into batches; each work item decodes a full batch
    n_batches = len(idx) // batch_size
    groups = [idx[i * batch_size:(i + 1) * batch_size]
              for i in range(n_batches)]

    def make(group):
        rng = np.random.RandomState(
            (seed * 9973 + epoch * 131 + int(group[0])) % (2 ** 31))
        samples = [dataset.get_sample(int(j), rng) for j in group]
        return collate(samples, cfg)

    return PrefetchIterator(make, groups, num_workers=num_workers,
                            prefetch=prefetch)
