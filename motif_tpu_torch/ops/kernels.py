"""Build, load and count the package's CUDA kernels.

Each kernel is one or more CUDA C++ sources under `motif_tpu_torch/csrc/`
(`SOURCES`; `siren_mlp` has three: the resident float32 kernel, the
streamed-weight float32 layer and the bfloat16 one; `preact_bf16` is the
fused decode's pre-activations, counted as `preact`) with a plain C
interface. At first use a source is compiled with `nvcc` for `sm_90a`
into `build/kernels/` at the repository root (listed in `.gitignore`),
under a name that carries a hash of the source, of every header under
`csrc/` (any of which it may include) and of the flags, and loaded with
`ctypes`. Nothing is built or loaded at import time: the CPU tests import
every module on a machine without `nvcc`.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` raises when that is not 0. A wrapper calls
`count` (`obs.launch`) where it launches its kernel and nowhere else: the
launches are counters of `motif_tpu_torch.obs`, which also keeps a
capture's tape of them (`obs.recording`, `obs.count_replay`), as is
`kernels.builds` (sources compiled). `obs.counters()` holds them under
`obs.LAUNCHES`, per kernel and per entry of a kernel (its element type and
variant, such as "siren_mlp/bfloat16/skip_first"). A build and a load are
the spans `kernels.build` and `kernels.load`.
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

from motif_tpu_torch import obs

KERNELS = ("splat_fused", "dcn_im2col", "siren_mlp")     # the counters
SOURCES = ("splat_fused", "dcn_im2col", "siren_mlp", "siren_layer",
           "siren_mlp_bf16", "preact_bf16")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

BUILD_LOGS: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}

count = obs.launch


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def _library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> float:
    """Compile every named source that is not built yet, all `nvcc`s at
    once. Returns the wall seconds; raises with the compiler's output if
    one fails."""
    t0 = time.perf_counter()
    todo = [n for n in names if not _library_path(n).exists()]
    if not todo:
        return 0.0
    with obs.span("kernels.build", sources=todo):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name in todo:
            out = _library_path(name)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
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
    obs.count("kernels.builds", len(todo))
    return time.perf_counter() - t0


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The kernel library `name`, built at first use, with `argtypes` set
    from `signatures` ({function: [ctypes types]}; every function returns
    a C int)."""
    if name not in _LIBS:
        build([name])
        with obs.span("kernels.load", kernel=name):
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


def require_cuda(name: str, dtypes, *tensors: torch.Tensor) -> torch.dtype:
    """Raise unless every tensor lies on one CUDA device and all share one
    of `dtypes`, the element types this kernel has an entry for; nothing is
    converted. Returns the shared dtype."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device, got {[str(x.device) for x in tensors]}")
    names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
    dtype = tensors[0].dtype
    for t in tensors:
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: the kernel takes {names}, got {t.dtype}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: all tensors must share one of {names}, "
                            f"got {[str(x.dtype) for x in tensors]}")
    return dtype


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on these tensors: a wrapper then
    runs its kernel inside an autograd Function with a plain backward."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def bfloat16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How many bfloat16 values lie between a and b, elementwise (0 where
    they are bit-equal, 1 for neighbours): their bit patterns mapped to
    integers in the values' order."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()
