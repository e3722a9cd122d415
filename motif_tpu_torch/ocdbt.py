"""A read-only reader of the storage under the JAX package's orbax train
states: an OCDBT key-value store (tensorstore's "OCDBT on-disk format")
whose values are zarr v2 arrays. Plain host code (`struct`, `json`,
numpy and the system's zstd through `utils/zstd.py`); nothing of JAX,
orbax or tensorstore is imported.

An orbax step directory holds the database: `manifest.ocdbt`, B+tree
nodes and values in `d/<hex>` files, and the per-process trees it merged
under `ocdbt.process_<i>/` (reached through the data-file table's base
paths). Every file this reads starts with a magic number, its length, a
format version and a compression byte, and ends with a crc32c of what
precedes it; all four are checked, and a magic, version, compression or
manifest kind this reader does not know raises naming the file.

The manifest (kind "single", the only one orbax writes) holds the config
and the newest versions of the version tree; the newest version's root
B+tree node is followed down through interior nodes (keys prefix-coded
against the node's subtree prefix) to the leaves, whose values are inline
or (data file, offset, length) references.

`read_array(store, name)` assembles the zarr v2 array `name`: its
`.zarray`, its chunks `name/i.j.k` (`name/0` for a scalar) zstd-compressed
or raw, absent chunks filled with `fill_value`. The dtypes: `<f4`, `<i4`,
`<f8`, `<i8` (numpy arrays) and `bfloat16` (a torch.bfloat16 tensor).
"""

from __future__ import annotations

import json
import math
import os
import struct

import numpy as np
import torch

from motif_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
COMPRESSIONS = {0: "none", 1: "zstd"}
HEADER = 12            # magic (big-endian u32) + length (little-endian u64)

_CRC32C = []


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum OCDBT's files end with."""
    if not _CRC32C:
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            _CRC32C.append(c)
    tab, c = _CRC32C, 0xFFFFFFFF
    for b in data:
        c = tab[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class OcdbtError(ValueError):
    """A file of the store that this reader cannot take as it is."""


class _Cursor:
    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            short = self.pos + n - len(self.data)
            raise OcdbtError(f"{self.where}: ends {short} bytes early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.where}: a varint longer than 64 bits")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]


def decode_envelope(data: bytes, magic: int, where: str) -> bytes:
    """The body of one manifest or node (`data` is its bytes, exactly):
    magic, length, version, compression and crc32c checked, the body
    decompressed."""
    if len(data) < HEADER + 6:
        raise OcdbtError(f"{where}: {len(data)} bytes, too short for a header")
    got_magic, length = struct.unpack(">I", data[:4])[0], \
        struct.unpack("<Q", data[4:12])[0]
    if got_magic != magic:
        raise OcdbtError(f"{where}: magic {got_magic:#010x}, not "
                         f"{magic:#010x}")
    if length != len(data):
        raise OcdbtError(f"{where}: the header says {length} bytes, the file "
                         f"holds {len(data)}")
    stored = struct.unpack("<I", data[-4:])[0]
    if crc32c(data[:-4]) != stored:
        raise OcdbtError(f"{where}: crc32c mismatch")
    cur = _Cursor(data[:-4], where)
    cur.pos = HEADER
    version = cur.varint()
    if version != FORMAT_VERSION:
        raise OcdbtError(f"{where}: OCDBT format version {version}; this "
                         f"reader knows version {FORMAT_VERSION}")
    compression = cur.varint()
    if compression not in COMPRESSIONS:
        raise OcdbtError(f"{where}: compression {compression}; this reader "
                         f"knows {COMPRESSIONS}")
    body = data[cur.pos:-4]
    return zstd.decompress(body) if compression == 1 else body


def _data_file_table(cur: _Cursor) -> list:
    """[(base_path, relative_path)] of a manifest's or node's table: paths
    prefix-coded against the previous one, each split at its base length."""
    n = cur.varint()
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    base = cur.varints(n)
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f"{cur.where}: data file {i}'s prefix is longer "
                             "than the path before it")
        path = prev[:prefix[i]] + cur.take(suffix[i])
        if base[i] > len(path):
            raise OcdbtError(f"{cur.where}: data file {i}'s base path is "
                             "longer than its path")
        out.append((path[:base[i]].decode(), path[base[i]:].decode()))
        prev = path
    return out


def _file_of(files: list, i: int, where: str) -> str:
    if i >= len(files):
        raise OcdbtError(f"{where}: data file {i} of a table of {len(files)}")
    base, rel = files[i]
    return base + rel


class OcdbtStore:
    """The newest version of the OCDBT database at `root` (a directory):
    `list()` of its keys in order, `get(key)` → bytes, `config` (the
    manifest's), `stats` (the root's key and byte counts) and `nodes` (the
    B+tree nodes read, by kind)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        where = os.path.join(self.root, "manifest.ocdbt")
        if not os.path.exists(where):
            raise FileNotFoundError(f"{where}: no OCDBT manifest")
        with open(where, "rb") as f:
            cur = _Cursor(decode_envelope(f.read(), MANIFEST_MAGIC, where),
                          where)
        self.config = self._config(cur)
        root_ref, self.stats = self._newest_root(cur)
        self.entries: dict = {}     # key → bytes or (file, offset, length)
        self.nodes = {"leaf": 0, "interior": 0}
        if root_ref is not None:
            self._walk(root_ref, b"")

    def _config(self, cur: _Cursor) -> dict:
        cfg = {"uuid": cur.take(16).hex()}
        kind = cur.varint()
        if kind != 0:
            raise OcdbtError(f"{cur.where}: manifest kind {kind} (numbered); "
                             "this reader knows the single-file manifest, "
                             "which orbax writes")
        cfg["max_inline_value_bytes"] = cur.varint()
        cfg["max_decoded_node_bytes"] = cur.varint()
        cfg["version_tree_arity_log2"] = cur.u8()
        method = cur.varint()
        if method not in COMPRESSIONS:
            raise OcdbtError(f"{cur.where}: config compression {method}")
        cfg["compression"] = COMPRESSIONS[method]
        if method == 1:
            cfg["zstd_level"] = struct.unpack("<i", cur.take(4))[0]
        return cfg

    def _newest_root(self, cur: _Cursor):
        """The root node reference of the newest version in the manifest's
        version-tree leaf (the manifest always holds the newest versions;
        its version-tree nodes hold only older ones)."""
        files = _data_file_table(cur)
        n = cur.varint()
        if n == 0:
            raise OcdbtError(f"{cur.where}: a manifest with no version")
        gen = cur.varints(n)
        height = [cur.u8() for _ in range(n)]
        file_id, offset, length = cur.varints(n), cur.varints(n), \
            cur.varints(n)
        num_keys, tree_bytes, indirect = cur.varints(n), cur.varints(n), \
            cur.varints(n)
        i = max(range(n), key=gen.__getitem__)
        stats = {"generation": gen[i], "root_height": height[i],
                 "num_keys": num_keys[i], "num_tree_bytes": tree_bytes[i],
                 "num_indirect_value_bytes": indirect[i]}
        if num_keys[i] == 0:
            return None, stats
        ref = (_file_of(files, file_id[i], cur.where), offset[i], length[i])
        return (ref, height[i]), stats

    def _read(self, ref) -> bytes:
        rel, offset, length = ref
        path = os.path.normpath(os.path.join(self.root, rel))
        if os.path.commonpath([path, self.root]) != self.root:
            raise OcdbtError(f"{self.root}: data file {rel} lies outside the "
                             "database")
        with open(path, "rb") as f:
            f.seek(offset)
            out = f.read(length)
        if len(out) != length:
            raise OcdbtError(f"{path}: {length} bytes at {offset} asked, "
                             f"{len(out)} there")
        return out

    def _walk(self, node_ref, prefix: bytes) -> None:
        ref, height = node_ref
        where = f"{ref[0]}@{ref[1]}"
        cur = _Cursor(decode_envelope(self._read(ref), NODE_MAGIC,
                                      os.path.join(self.root, ref[0])), where)
        got_height = cur.u8()
        if got_height != height:
            raise OcdbtError(f"{where}: height {got_height}, its parent "
                             f"says {height}")
        files = _data_file_table(cur)
        n = cur.varint()
        key_prefix = [0] + cur.varints(n - 1) if n else []
        key_suffix = cur.varints(n)
        common = cur.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            k = prev[:key_prefix[i]] + cur.take(key_suffix[i])
            keys.append(k)
            prev = k
        if height:      # interior: children, each under its common prefix
            self.nodes["interior"] += 1
            file_id, offset, length = cur.varints(n), cur.varints(n), \
                cur.varints(n)
            cur.varints(3 * n)      # the children's statistics
            for i in range(n):
                child = ((_file_of(files, file_id[i], where), offset[i],
                          length[i]), height - 1)
                self._walk(child, prefix + keys[i][:common[i]])
            return
        self.nodes["leaf"] += 1
        lengths = cur.varints(n)
        kinds = cur.varints(n)
        if any(k not in (0, 1) for k in kinds):
            raise OcdbtError(f"{where}: a value kind other than inline (0) "
                             "or indirect (1)")
        indirect = [i for i in range(n) if kinds[i]]
        file_id = cur.varints(len(indirect))
        offset = cur.varints(len(indirect))
        refs = {i: (_file_of(files, f, where), o, lengths[i])
                for i, f, o in zip(indirect, file_id, offset)}
        for i in range(n):
            self.entries[prefix + keys[i]] = refs[i] if kinds[i] else \
                cur.take(lengths[i])
        if cur.pos != len(cur.data):
            raise OcdbtError(f"{where}: {len(cur.data) - cur.pos} bytes after "
                             "the last value")

    def list(self) -> list:
        return sorted(self.entries)

    def __contains__(self, key) -> bool:
        return _key(key) in self.entries

    def get(self, key) -> bytes:
        """The value of `key` (str or bytes); KeyError when absent."""
        v = self.entries[_key(key)]
        return v if isinstance(v, bytes) else self._read(v)


def _key(key) -> bytes:
    return key.encode() if isinstance(key, str) else bytes(key)


# zarr v2 dtype → numpy dtype; bfloat16 is read as uint16 and returned as
# a torch.bfloat16 tensor
DTYPES = {"<f4": np.float32, "<i4": np.int32, "<f8": np.float64,
          "<i8": np.int64, "bfloat16": np.uint16}


def _fill(value, dtype: str):
    """`fill_value` in the array's numpy type (null: 0)."""
    if value is None:
        return 0
    value = float(value) if isinstance(value, str) else value  # "NaN", ...
    if dtype == "bfloat16":
        return torch.tensor(value, dtype=torch.bfloat16).view(
            torch.int16).item() & 0xFFFF
    return value


def read_array(store: OcdbtStore, name: str):
    """The zarr v2 array `name` of `store`: a numpy array, or a
    torch.bfloat16 tensor for dtype `bfloat16`."""
    where = f"{store.root}:{name}"
    meta = json.loads(store.get(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise OcdbtError(f"{where}: zarr_format {meta.get('zarr_format')}")
    dtype = meta["dtype"]
    if dtype not in DTYPES:
        raise OcdbtError(f"{where}: dtype {dtype!r}; this reader knows "
                         f"{sorted(DTYPES)}")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise OcdbtError(f"{where}: order {meta.get('order')!r}, filters "
                         f"{meta.get('filters')!r}; this reader knows C order "
                         "without filters")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OcdbtError(f"{where}: compressor {comp.get('id')!r}; this "
                         "reader knows zstd and none")
    sep = meta.get("dimension_separator", ".")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    np_dtype = np.dtype(DTYPES[dtype])
    out = np.full(shape, _fill(meta.get("fill_value"), dtype), np_dtype)
    chunk_bytes = math.prod(chunks) * np_dtype.itemsize
    grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        if key not in store:
            continue
        raw = store.get(key)
        if comp is not None:
            raw = zstd.decompress(raw, chunk_bytes)
        if len(raw) != chunk_bytes:
            raise OcdbtError(f"{store.root}:{key}: {len(raw)} bytes, a "
                             f"chunk of {chunks} {dtype} holds {chunk_bytes}")
        chunk = np.frombuffer(raw, np_dtype).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]
    if dtype == "bfloat16":
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out
