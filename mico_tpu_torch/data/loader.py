"""Loaders: the batch loader, the multi-task MetaLoader and the CUDA
prefetcher (counterpart of `mico_tpu/data/loader.py`).

  - DataLoader: a producer thread builds each batch from a sampler and
    collates it, a bounded queue ahead of the consumer. The items of a
    batch are read in index order, so every draw from the datasets' and
    mappers' generators happens in the order the JAX package's loader
    takes them with one worker, however many workers there are; the
    `num_workers` threads decode the batch's files ahead
    (`mappers.DecodeCache`: the pure decode functions, never a draw).
  - MetaLoader (reference loader.py:8-61): a weighted random task per
    accumulation window from `random.Random(seed)`; every rank of a run
    passes the run's seed (not its own host seed), so all draw the same
    task at every step (JAX's shared seed, loader.py:133-154).
  - CudaPrefetcher (in place of JAX's DevicePrefetcher, reference
    PrefetchLoader, loader.py:90-148): array leaves are staged in pinned
    host memory and copied to the card on a side stream one batch ahead;
    the consumer's stream waits on the copy's event before it uses the
    batch. On the CPU it hands batches through as they are.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch


class DataLoader:
    """Iterates a map-style dataset via a sampler, collates batches, and
    prefetches `prefetch_batches` of them on a producer thread."""

    def __init__(self, dataset, sampler=None, batch_size: int = 1,
                 num_workers: int = 4, drop_last: bool = False,
                 prefetch_batches: int = 2, collate_fn=None):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch_batches = prefetch_batches
        self.collate_fn = (collate_fn or getattr(dataset, "collate_fn", None)
                           or _default_collate)

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(
            self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches_of_indices(self):
        idx = (list(self.sampler) if self.sampler is not None
               else range(len(self.dataset)))
        batch = []
        for i in idx:
            batch.append(i)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def _read_batch(self, batch_idx, pool) -> Dict:
        prefetch = getattr(self.dataset, "prefetch", None)
        if pool is not None and prefetch is not None:
            prefetch(batch_idx, pool)
        try:
            return self.collate_fn([self.dataset[i] for i in batch_idx])
        finally:
            cache = getattr(self.dataset, "decode_cache", None)
            if cache is not None:
                cache.clear()

    def __iter__(self) -> Iterator[Dict]:
        if getattr(self.dataset, "use_sampler", True) is False:
            yield from self._iter_stream()
            return
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """put() that rechecks `stop`, so a consumer that stopped early
            (with the queue full) cannot leave the producer blocked."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            pool = (ThreadPoolExecutor(self.num_workers)
                    if self.num_workers > 1 else None)
            try:
                for batch_idx in self._batches_of_indices():
                    if stop.is_set():
                        return
                    if not put_or_stop(("batch", self._read_batch(batch_idx,
                                                                  pool))):
                        return
                put_or_stop(("end", None))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                put_or_stop(("error", e))
            finally:
                if pool is not None:
                    pool.shutdown(wait=True, cancel_futures=True)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                kind, item = out_q.get()
                if kind == "end":
                    break
                if kind == "error":
                    raise item
                yield item
        finally:
            stop.set()

    def _iter_stream(self) -> Iterator[Dict]:
        """Iterable (shard) datasets: batch the stream directly."""
        samples = []
        for s in self.dataset:
            samples.append(s)
            if len(samples) == self.batch_size:
                yield self.collate_fn(samples)
                samples = []
        if samples and not self.drop_last:
            yield self.collate_fn(samples)


def _default_collate(samples):
    first = samples[0]
    if isinstance(first, np.ndarray):
        return np.stack(samples)
    if isinstance(first, dict):
        return {k: _default_collate([s[k] for s in samples]) for k in first}
    return list(samples)


class MetaLoader:
    """Weighted random task sampling over named loaders.

    `loaders` maps name → loader or (loader, ratio). The task is redrawn at
    the start of each accumulation window and held fixed within it
    (reference loader.py:40-44), from `random.Random(seed)`."""

    def __init__(self, loaders: Dict, accum_steps: int = 1, seed: int = 0):
        assert isinstance(loaders, dict) and loaders
        self.name2loader = {}
        self.name2iter = {}
        self.sampling_pools = []
        for name, entry in loaders.items():
            loader, ratio = entry if isinstance(entry, tuple) else (entry, 1)
            self.name2loader[name] = loader
            self.name2iter[name] = iter(loader)
            self.sampling_pools.extend([name] * ratio)
        self.accum_steps = accum_steps
        self.step = 0
        self.epoch = 0
        self._rng = random.Random(seed)

    def __iter__(self):
        task = self.sampling_pools[0]
        while True:
            if self.step % self.accum_steps == 0:
                task = self._rng.choice(self.sampling_pools)
            self.step += 1
            it = self.name2iter[task]
            try:
                batch = next(it)
            except StopIteration:
                self.epoch += 1
                sampler = getattr(self.name2loader[task], "sampler", None)
                if sampler is not None and hasattr(sampler, "set_epoch"):
                    sampler.set_epoch(self.epoch)
                it = iter(self.name2loader[task])
                batch = next(it)
                self.name2iter[task] = it
            yield task, batch


class CudaPrefetcher:
    """Wraps a (name, batch) or batch iterator. On a CUDA device each
    ndarray leaf is staged in pinned host memory and copied on a side
    stream one batch ahead of the consumer; the consumer's current stream
    waits on that copy's event before the batch is handed over. On the CPU
    the batches pass through unchanged."""

    def __init__(self, loader, device="cuda"):
        self.loader = loader
        self.device = torch.device(device)

    def _stage(self, batch, stream):
        if (isinstance(batch, tuple) and len(batch) == 2
                and isinstance(batch[0], str)):
            return (batch[0], self._stage(batch[1], stream))
        if isinstance(batch, dict):
            return {k: self._stage(v, stream) for k, v in batch.items()}
        if isinstance(batch, np.ndarray):
            host = torch.from_numpy(np.ascontiguousarray(batch)).pin_memory()
            with torch.cuda.stream(stream):
                return host.to(self.device, non_blocking=True)
        return batch

    def _put(self, batch, stream):
        staged = self._stage(batch, stream)
        event = torch.cuda.Event()
        event.record(stream)
        return staged, event

    def _hand_over(self, staged, event):
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)

        def mark(x):
            if isinstance(x, torch.Tensor):
                x.record_stream(current)
            elif isinstance(x, dict):
                for v in x.values():
                    mark(v)
            elif isinstance(x, tuple):
                for v in x:
                    mark(v)

        mark(staged)
        return staged

    def __iter__(self):
        if self.device.type != "cuda":
            yield from self.loader
            return
        stream = torch.cuda.Stream(self.device)
        it = iter(self.loader)
        try:
            ahead = self._put(next(it), stream)
        except StopIteration:
            return
        for batch in it:
            nxt = self._put(batch, stream)  # its copy starts before the hand-over
            yield self._hand_over(*ahead)
            ahead = nxt
        yield self._hand_over(*ahead)

    def __len__(self):
        return len(self.loader)

    def __getattr__(self, name):
        return getattr(self.loader, name)
