"""Host-side batching, the counterpart of motif_tpu/data/pipeline.py's
`collate_stack`, `collate_adobe_arbitrary`, `BatchLoader` and
`device_prefetch`: batches are collated on a background thread, a few
ahead of the consumer, and an error raised while loading is raised again
in the consumer; `device_prefetch` copies them to the card ahead of use.

The arbitrary-scale collate resizes with the port's native C++ core
(`native.matlab_resize_batch`, as the JAX package resizes with its own),
or, where no compiler is found, with the numpy MATLAB bicubic
(`ops/resize.py::imresize_matlab_np`) image by image: each is the JAX
package's same path bit for bit (the two paths differ by up to 2e-5). `Subset` is one process's shard of a
data-parallel run (`parallel.host_shard_indices`).
"""

from __future__ import annotations

import queue
import random
import threading
from collections import deque
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from motif_tpu_torch import native


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


def collate_adobe_arbitrary(items: list[dict], lq_size: int = 64,
                            rng: random.Random | None = None,
                            size_buckets: int | None = 16) -> dict:
    """The arbitrary space-time collate (collate_function, data/__init__.py:
    91-131) over items with 'lq_raw' / 'gt_raw' frame lists: one d_scale ∈
    [2, 4] for the batch, a GT crop of floor(lq_size · d_scale) (rounded
    down to a multiple of `size_buckets`, at least one bucket, with
    d_scale recomputed from it, as the JAX package buckets it; None keeps
    the reference's continuous size) at one random corner, the LQ by
    MATLAB bicubic at 1 / (2 d_scale) of the crop and the GT at 1 / 2,
    then the same flips and transpose for the whole batch. Draws from
    `rng` (the `random` module when None), in the JAX package's order:
    d_scale, the corner, hflip, vflip, rot90. Returns {'lq' (B, 4, s, s,
    3), 'gt' (B, T, g, g, 3), 'times' (B, N), 'out_hw' (g, g)}."""
    rng = rng or random
    d_scale = rng.uniform(2, 4)
    gt_size = int(np.floor(lq_size * d_scale))
    if size_buckets:
        gt_size = max(size_buckets, gt_size // size_buckets * size_buckets)
        d_scale = gt_size / lq_size

    H, W = items[0]["gt_raw"][0].shape[:2]
    x = rng.randint(0, max(0, H - gt_size))
    y = rng.randint(0, max(0, W - gt_size))

    def resized(key, scale):
        stack = np.stack([np.stack([f[x:x + gt_size, y:y + gt_size]
                                    for f in it[key]], 0)
                          for it in items], 0) * 255.0
        B, n = stack.shape[:2]
        out = native.matlab_resize_batch(
            stack.reshape(B * n, *stack.shape[2:]), scale) / 255.0
        return out.reshape(B, n, *out.shape[1:])

    lqs = resized("lq_raw", 1 / (2 * d_scale))
    gts = resized("gt_raw", 0.5)
    if rng.random() < 0.5:                               # hflip
        lqs, gts = lqs[:, :, :, ::-1], gts[:, :, :, ::-1]
    if rng.random() < 0.5:                               # vflip
        lqs, gts = lqs[:, :, ::-1], gts[:, :, ::-1]
    if rng.random() < 0.5:                               # rot90
        lqs, gts = lqs.transpose(0, 1, 3, 2, 4), gts.transpose(0, 1, 3, 2, 4)
    return {"lq": np.ascontiguousarray(lqs, np.float32),
            "gt": np.ascontiguousarray(gts, np.float32),
            "times": np.stack([it["times"] for it in items], 0),
            "out_hw": (gts.shape[2], gts.shape[3])}


class Subset:
    """An index-restricted view of a dataset: one process's shard of the
    sample list in a data-parallel run (motif_tpu/data/pipeline.py:90-103,
    the reference's DistIterSampler rank striding)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[int(self.indices[i])]


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


def device_prefetch(it: Iterable[dict], device=None,
                    size: int = 2) -> Iterator[dict]:
    """The batches of `it` with their numpy arrays on `device`, `size`
    batches ahead of the consumer: each array goes through pinned host
    memory and is copied with `non_blocking`, on the current stream (the
    consumer's kernels wait for it there). On the CPU (`device` None or a
    CPU device) the batches pass through as they are."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        yield from it
        return

    def put(batch):
        return {k: (torch.from_numpy(v).pin_memory().to(dev, non_blocking=True)
                    if isinstance(v, np.ndarray) else v)
                for k, v in batch.items()}

    it = iter(it)
    buf: deque = deque()
    for batch in it:
        buf.append(put(batch))
        if len(buf) > size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
