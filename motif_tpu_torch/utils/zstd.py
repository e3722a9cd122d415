"""zstd decompression (RFC 8878) through the system's `libzstd.so.1`, bound
with ctypes: the frames of OCDBT's manifests and B+tree nodes and of
zarr's chunks in the JAX package's orbax train states (`ocdbt.py`).

The library is loaded at the first call. A machine without it raises
OSError naming `libzstd.so.1`; nothing else decodes in its place.

A frame whose header gives its content size is decoded by one
`ZSTD_decompress` into a buffer of that size; a frame without one (zarr's
chunks, which tensorstore writes as a stream) by the streaming API
(`ZSTD_decompressStream`) into pieces of `ZSTD_DStreamOutSize()` bytes, or
of `size` when the caller knows it, called until the frame is whole (it
may stop after a block with its output not full). Concatenated frames
decode one after the other, as RFC 8878 §3 allows.
"""

from __future__ import annotations

import ctypes

LIBRARY = "libzstd.so.1"
# ZSTD_getFrameContentSize's two answers that are not a size
CONTENTSIZE_UNKNOWN = 2 ** 64 - 1
CONTENTSIZE_ERROR = 2 ** 64 - 2

_lib = None


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def library() -> ctypes.CDLL:
    """The bound `libzstd.so.1` (loaded once)."""
    global _lib
    if _lib is None:
        try:
            lib = ctypes.CDLL(LIBRARY)
        except OSError as e:
            raise OSError(f"{LIBRARY} could not be loaded ({e}); reading an "
                          "orbax train state needs the system's zstd "
                          "library") from e
        size_t, vp = ctypes.c_size_t, ctypes.c_void_p
        for name, res, args in (
                ("ZSTD_decompress", size_t, [vp, size_t, vp, size_t]),
                ("ZSTD_getFrameContentSize", ctypes.c_ulonglong,
                 [vp, size_t]),
                ("ZSTD_findFrameCompressedSize", size_t, [vp, size_t]),
                ("ZSTD_isError", ctypes.c_uint, [size_t]),
                ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
                ("ZSTD_versionString", ctypes.c_char_p, []),
                ("ZSTD_createDStream", vp, []),
                ("ZSTD_initDStream", size_t, [vp]),
                ("ZSTD_freeDStream", size_t, [vp]),
                ("ZSTD_DStreamOutSize", size_t, []),
                ("ZSTD_decompressStream", size_t,
                 [vp, ctypes.POINTER(_OutBuffer),
                  ctypes.POINTER(_InBuffer)])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib = lib
    return _lib


def version() -> str:
    return library().ZSTD_versionString().decode()


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd: {what}: "
                         f"{lib.ZSTD_getErrorName(code).decode()}")
    return code


def decompress(data: bytes, size: int | None = None) -> bytes:
    """The content of the zstd frame(s) `data`. `size`, where the caller
    knows it, sizes the output; a frame that decodes to another size still
    decodes whole. Raises ValueError on a malformed or truncated frame."""
    lib = library()
    src = ctypes.c_char_p(data)
    n = len(data)
    if n == 0:
        raise ValueError("zstd: an empty input holds no frame")
    first = _check(lib, lib.ZSTD_findFrameCompressedSize(src, n),
                   "frame header")
    content = lib.ZSTD_getFrameContentSize(src, n)
    if content == CONTENTSIZE_ERROR:
        raise ValueError("zstd: not a zstd frame")
    if first == n and content != CONTENTSIZE_UNKNOWN:
        out = ctypes.create_string_buffer(max(int(content), 1))
        got = _check(lib, lib.ZSTD_decompress(out, content, src, n),
                     "decompress")
        if got != content:
            raise ValueError(f"zstd: {got} bytes decoded, the frame header "
                             f"says {content}")
        return ctypes.string_at(out, got)
    return _stream(lib, src, n, size)


def _stream(lib, src, n: int, size: int | None) -> bytes:
    ds = lib.ZSTD_createDStream()
    if not ds:
        raise MemoryError("zstd: ZSTD_createDStream failed")
    try:
        _check(lib, lib.ZSTD_initDStream(ds), "initDStream")
        cap = max(int(size or 0), int(lib.ZSTD_DStreamOutSize()), 1)
        buf = ctypes.create_string_buffer(cap)
        inb = _InBuffer(ctypes.cast(src, ctypes.c_void_p), n, 0)
        pieces = []
        while True:
            outb = _OutBuffer(ctypes.cast(buf, ctypes.c_void_p), cap, 0)
            pos = inb.pos
            left = _check(lib, lib.ZSTD_decompressStream(
                ds, ctypes.byref(outb), ctypes.byref(inb)), "decompressStream")
            pieces.append(ctypes.string_at(buf, outb.pos))
            if inb.pos == inb.size and not left:
                return b"".join(pieces)
            if inb.pos == pos and outb.pos == 0:     # no progress: no input
                raise ValueError("zstd: the input ends inside a frame")
    finally:
        lib.ZSTD_freeDStream(ds)
