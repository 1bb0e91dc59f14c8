"""Batching with thread-pool prefetch, and the per-rank item split
(port of the JAX package's ``data/loader.py``). Batches are dicts of numpy
arrays; with ``shuffle`` each epoch's order draws from a ``torch.Generator``
seeded with ``seed + epoch``, else it is the dataset's; with ``drop_last``
the last partial batch is dropped, else it is yielded; two batches are
fetched ahead."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch


def shard_for_host(items: Sequence, rank: Optional[int] = None,
                   world_size: Optional[int] = None, mesh=None) -> list:
    """Strided split of the item list over the data ranks (the
    DistributedSampler's split without its padding): ``rank`` and
    ``world_size`` default to ``mesh``'s data index and size, so the view
    ranks of one data index read the same items (one process: all of
    them)."""
    if rank is None:
        rank = mesh.data_index if mesh is not None else 0
    if world_size is None:
        world_size = mesh.data_size if mesh is not None else 1
    return list(items)[rank::world_size]


def _collate(samples) -> Dict[str, np.ndarray]:
    out = {}
    for k in samples[0]:
        if k == "item":
            out[k] = [s[k] for s in samples]
        else:
            out[k] = np.stack([s[k] for s in samples])
    return out


class DataLoader:
    """Thread-pool prefetching loader over a map-style dataset."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.shuffle:
            g = torch.Generator().manual_seed(self.seed + self.epoch)
            order = torch.randperm(len(self.dataset), generator=g).numpy()
        else:
            order = np.arange(len(self.dataset))
        self.epoch += 1
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()
        pool = ThreadPoolExecutor(max_workers=self.num_workers)

        def producer():
            try:
                for idxs in batches:
                    if stop.is_set():
                        return
                    q.put(_collate(list(pool.map(
                        lambda i: self.dataset[int(i)], idxs))))
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                yield batch
        finally:
            stop.set()
            # unblock a producer waiting on a full queue, then wait for it
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.1)
            pool.shutdown(wait=True)
