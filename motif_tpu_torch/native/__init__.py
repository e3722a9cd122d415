"""The native (C++ / OpenMP) host core of the data pipeline, the
counterpart of motif_tpu/native: `matlab_resize_batch`, `u8bgr_to_f32rgb`
and `y_psnr_batch` through ctypes, over the port's own copy of
`preprocess.cpp`.

At first use the source is compiled with `g++ -O3 -fPIC -shared
-std=c++17 -fopenmp` (without OpenMP if that fails) into `build/native/`
at the repository root (listed in `.gitignore`), under a name that carries
a hash of the source and the flags. Where no compiler is found, or the
build fails, every function runs its numpy version, as the JAX package's
does; `available()` tells which. This is host code, not a device kernel.

The native resize differs from the numpy one (`ops/resize.py`) by up to
2e-5 (float32 sums in another order); the conversion multiplies by the
float32 1/255 where numpy divides by 255 (one float32 ulp apart for about
half of the byte values).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "preprocess.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
OPENMP = "-fopenmp"

_lib = None
_tried = False
BUILD_LOG = ""


def _library_path(flags) -> Path:
    h = hashlib.sha1(" ".join(flags).encode() + b"\0" + SRC.read_bytes())
    return BUILD_DIR / f"libpreprocess-{h.hexdigest()[:12]}.so"


def _build() -> Path | None:
    """The built library (compiled now unless it already is), with OpenMP
    or else without; None when no compiler is found or both builds fail
    (`BUILD_LOG` holds the compiler's output)."""
    global BUILD_LOG
    gxx = shutil.which("g++")
    if gxx is None:
        BUILD_LOG = "g++ not found"
        return None
    logs = []
    for flags in ((*FLAGS, OPENMP), FLAGS):
        out = _library_path(flags)
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([gxx, *flags, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode == 0:
            tmp.replace(out)
            BUILD_LOG = "\n".join(logs)
            return out
    BUILD_LOG = "\n".join(logs)
    return None


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.matlab_resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int]
    lib.matlab_resize_batch.restype = None
    lib.u8bgr_to_f32rgb.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64]
    lib.u8bgr_to_f32rgb.restype = None
    lib.y_psnr_batch.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int64, ctypes.POINTER(ctypes.c_double)]
    lib.y_psnr_batch.restype = None
    lib.native_num_threads.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native core is built and loaded (building it now if it
    was not tried yet)."""
    return _load() is not None


def num_threads() -> int:
    """OpenMP's thread count in the native core (1 without OpenMP); 0 when
    the core is not available."""
    lib = _load()
    return 0 if lib is None else int(lib.native_num_threads())


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def matlab_resize_batch(imgs: np.ndarray, scale: float,
                        antialias: bool = True) -> np.ndarray:
    """(N, H, W, C) float32 -> (N, ceil(H·s), ceil(W·s), C), MATLAB
    bicubic; the numpy `imresize_matlab_np` image by image without the
    core."""
    imgs = np.ascontiguousarray(imgs, np.float32)
    n, h, w, c = imgs.shape
    oh, ow = math.ceil(h * scale), math.ceil(w * scale)
    lib = _load()
    if lib is None:
        from motif_tpu_torch.ops.resize import imresize_matlab_np

        return np.stack([imresize_matlab_np(im, scale, antialias)
                         for im in imgs], 0)
    out = np.empty((n, oh, ow, c), np.float32)
    lib.matlab_resize_batch(_fptr(imgs), _fptr(out), n, h, w, c, oh, ow,
                            float(scale), int(antialias))
    return out


def u8bgr_to_f32rgb(img: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 BGR -> float32 RGB in [0, 1]."""
    img = np.ascontiguousarray(img, np.uint8)
    lib = _load()
    if lib is None:
        return img[..., ::-1].astype(np.float32) / 255.0
    out = np.empty(img.shape, np.float32)
    lib.u8bgr_to_f32rgb(img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        _fptr(out), img.size // 3)
    return out


def y_psnr_batch(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, H, W, 3) RGB [0, 1] pairs -> (N,) Y-channel PSNRs, float64."""
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    n = a.shape[0]
    hw = int(np.prod(a.shape[1:-1]))
    lib = _load()
    if lib is None:
        from motif_tpu_torch.utils.metrics import rgb_to_y

        ya, yb = rgb_to_y(a), rgb_to_y(b)
        mse = np.mean((ya - yb) ** 2, axis=tuple(range(1, ya.ndim)))
        return 10 * np.log10(1.0 / mse)
    out = np.empty(n, np.float64)
    lib.y_psnr_batch(_fptr(a), _fptr(b), n, hw,
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out
