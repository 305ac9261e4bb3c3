"""Input pipeline (counterpart of ``medsam2_tpu/data/loader.py``): a threaded
prefetching loader with shuffling and collate (the reference's torch
DataLoader workers, ``func_3d/dataset/__init__.py:29-49``), and
:func:`device_prefetch`, which copies upcoming batches to the card from
pinned memory while the current step runs."""

from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Iterator, List, Optional

import numpy as np
import torch


def device_prefetch(iterator, device, size: int = 2, host_keys=()):
    """Overlap host batch preparation and the host-to-device copy with
    compute: keeps up to ``size`` upcoming batches (dicts of arrays) in
    flight as device tensors, copied from pinned memory with
    ``non_blocking=True`` on a CUDA device. The arrays under ``host_keys``
    stay on the host (those the step reads for control flow)."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def to_device(batch):
        out = {}
        for k, v in batch.items():
            if k in host_keys:
                out[k] = np.asarray(v)
                continue
            t = torch.as_tensor(np.asarray(v))
            if pin:
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=pin)
        return out

    pending = collections.deque()
    iterator = iter(iterator)

    def enqueue(n):
        for _ in range(n):
            try:
                batch = next(iterator)
            except StopIteration:
                return
            pending.append(to_device(batch))

    enqueue(size)
    while pending:
        yield pending.popleft()
        enqueue(1)


class DataLoader:
    """Minimal map-style loader: dataset with __len__/__getitem__, optional
    batching collate, background prefetch threads."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 collate_fn: Optional[Callable] = None, num_workers: int = 2,
                 seed: int = 0, drop_last: bool = False, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.collate_fn = collate_fn or (lambda samples: samples)
        self.num_workers = max(num_workers, 0)
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.prefetch = prefetch
        # np.random.Generator is not thread-safe: serialize item fetch for
        # datasets that sample prompts with a shared rng (collate still runs
        # in parallel across workers)
        self._fetch_lock = threading.Lock() if hasattr(dataset, "rng") else None

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> List[List[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        batches = [idx[i:i + self.batch_size].tolist()
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator:
        batches = self._index_batches()
        if self.num_workers == 0:
            for b in batches:
                yield self.collate_fn([self.dataset[i] for i in b])
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def fetch(i):
            if self._fetch_lock is not None:
                with self._fetch_lock:
                    return self.dataset[i]
            return self.dataset[i]

        def worker(batch_list):
            try:
                for b in batch_list:
                    if stop.is_set():
                        return
                    q.put((None, self.collate_fn([fetch(i) for i in b])))
            except Exception as e:  # surface worker errors to the consumer
                q.put((e, None))

        shards = [batches[w::self.num_workers] for w in range(self.num_workers)]
        threads = [threading.Thread(target=worker, args=(s,), daemon=True)
                   for s in shards if s]
        for t in threads:
            t.start()
        try:
            for _ in range(len(batches)):
                err, item = q.get()
                if err is not None:
                    raise err
                yield item
        finally:
            stop.set()
