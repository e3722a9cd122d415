"""LMDB frame packs, the counterpart of motif_tpu/data/lmdb_io.py (the
reference's data/util.py:34-83 path): a `meta_info.pkl` catalogue of keys
and 'C_H_W' sizes beside raw uint8 HWC BGR buffers under ascii keys.

Vimeo-90K is usually trained from such packs. The `lmdb` package is
imported at first use and raises with advice when it is missing; the
readers take any object with lmdb's `env.begin(write=False)` ->
`txn.get(key)` protocol.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle

import numpy as np


def open_lmdb(path: str):
    """An lmdb environment opened read-only (Vimeo7_dataset.py:79-84)."""
    try:
        import lmdb
    except ImportError as e:
        raise ImportError(
            "reading lmdb packs requires the 'lmdb' package "
            "(pip install lmdb); alternatively convert the pack to an image "
            "folder and use data_type='img'") from e
    return lmdb.open(path, readonly=True, lock=False, readahead=False,
                     meminit=False)


def read_meta(dataroot: str) -> tuple[list[str], list[str]]:
    """`meta_info.pkl` -> (keys, 'C_H_W' size per key); one size stands
    for every key (data/util.py:34-42)."""
    with open(osp.join(dataroot, "meta_info.pkl"), "rb") as f:
        meta = pickle.load(f)
    paths = meta["keys"]
    sizes = meta["resolution"]
    if len(sizes) == 1:
        sizes = sizes * len(paths)
    return paths, sizes


def parse_size(size) -> tuple[int, int, int]:
    """'3_256_448', '3x256x448' or (3, 256, 448) -> (C, H, W)."""
    if isinstance(size, (tuple, list)):
        c, h, w = size
        return int(c), int(h), int(w)
    c, h, w = (int(p) for p in size.replace("x", "_").split("_"))
    return c, h, w


def read_img_lmdb(env, key: str, size) -> np.ndarray:
    """One frame as float32 RGB [0, 1] HWC: the raw BGR uint8 buffer of
    `key` (the reference's _read_img_lmdb) divided by 255 and reindexed to
    RGB; a single channel is repeated to three. A missing key raises
    KeyError."""
    with env.begin(write=False) as txn:
        buf = txn.get(key.encode("ascii"))
    if buf is None:
        raise KeyError(f"lmdb key {key!r} not found")
    C, H, W = parse_size(size)
    img = np.frombuffer(buf, dtype=np.uint8).reshape(H, W, C)
    out = img.astype(np.float32) / 255.0
    if C == 3:
        out = out[:, :, ::-1]
    elif C == 1:
        out = np.repeat(out, 3, axis=2)
    return np.ascontiguousarray(out)


class LmdbFrameSource:
    """The frames of one pack under '{a}_{b}_{frame}' keys (the ZSM /
    Vimeo packing). The environment is opened at first read in each
    process: lmdb handles are not fork-safe (Vimeo7_dataset.py:70-84)."""

    def __init__(self, root: str):
        self.root = root
        self.keys, self.sizes = read_meta(root)
        self._size_by_key = dict(zip(self.keys, self.sizes))
        self._env = None
        self._pid = None

    def _ensure_env(self):
        if self._env is None or self._pid != os.getpid():
            self._env = open_lmdb(self.root)
            self._pid = os.getpid()
        return self._env

    def read(self, name_a: str, name_b: str, frame: int) -> np.ndarray:
        key = f"{name_a}_{name_b}_{frame}"
        size = self._size_by_key.get(key, self.sizes[0])
        return read_img_lmdb(self._ensure_env(), key, size)
