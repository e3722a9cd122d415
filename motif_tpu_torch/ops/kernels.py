"""Build, load and count the package's CUDA kernels.

Each kernel is one CUDA C++ source under `motif_tpu_torch/csrc/` with a
plain C interface. At first use it is compiled with `nvcc` for `sm_90a`
into `build/kernels/` at the repository root (listed in `.gitignore`),
under a name that carries a hash of the source and flags, and loaded with
`ctypes`. Nothing is built or loaded at import time: the CPU tests import
every module on a machine without `nvcc`.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` raises when that is not 0. `LAUNCHES` counts
kernel launches per kernel; a wrapper adds one where it launches its
kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

KERNELS = ("splat_fused", "dcn_sample", "siren_mlp")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {name: 0 for name in KERNELS}
BUILD_LOGS: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def _library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=KERNELS) -> float:
    """Compile every named kernel that is not built yet, all `nvcc`s at
    once. Returns the wall seconds; raises with the compiler's output if
    one fails."""
    t0 = time.perf_counter()
    todo = [n for n in names if not _library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = _library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The kernel library `name`, built at first use, with `argtypes` set
    from `signatures` ({function: [ctypes types]}; every function returns
    a C int)."""
    if name not in _LIBS:
        build([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def require_cuda_float32(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is float32 on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device, got {[str(x.device) for x in tensors]}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
