"""Host-side batching, the counterpart of motif_tpu/data/pipeline.py's
`collate_stack` and `BatchLoader`: batches are collated on a background
thread, a few ahead of the consumer, and an error raised while loading is
raised again in the consumer.

The training collate (`collate_adobe_arbitrary`), `Subset` and the copy to
the device ahead of use are not ported (ROADMAP.md §A.6, §A.7).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


def collate_stack(items: list[dict]) -> dict:
    """Default collate: stack matching keys (drops non-array metadata)."""
    out = {}
    for k in items[0]:
        v = items[0][k]
        if isinstance(v, np.ndarray):
            out[k] = np.stack([it[k] for it in items], 0)
        else:
            out[k] = [it[k] for it in items]
    return out


class BatchLoader:
    """Iterates a dataset in batches on a background thread."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 collate: Callable = collate_stack, seed: int = 0,
                 drop_last: bool = True, epoch_ratio: int = 1,
                 queue_size: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.collate = collate
        self.seed = seed
        self.drop_last = drop_last
        self.epoch_ratio = epoch_ratio
        self.queue_size = queue_size

    def __len__(self):
        n = len(self.dataset) * self.epoch_ratio
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        """The batches of one epoch. A consumer that stops early (or closes
        the generator) also stops the loading thread."""
        if self.shuffle:
            g = np.random.default_rng(self.seed + epoch)
            order = g.permutation(len(self.dataset) * self.epoch_ratio) % len(self.dataset)
        else:
            order = np.arange(len(self.dataset))
        q: queue.Queue = queue.Queue(maxsize=self.queue_size)
        stop = threading.Event()
        n_batches = len(order) // self.batch_size if self.drop_last \
            else -(-len(order) // self.batch_size)

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for b in range(n_batches):
                    idx = order[b * self.batch_size:(b + 1) * self.batch_size]
                    if not put(self.collate([self.dataset[int(i)] for i in idx])):
                        return
                put(None)
            except Exception as e:  # surface loader errors to the consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
