"""The fused SIREN MLP — the counterpart of motif_tpu/ops/siren_kernel.py,
with the CUDA kernel `siren_mlp` (csrc/siren_mlp.cu), which replaces the TPU
kernel motif_tpu/ops/siren_kernel.py::_kernel.

Layout: x (..., Cin) row-major tokens; weights as torch stores them,
(out, in) per layer; biases (out,). Returns (..., Cout).

Entries: float32 or bfloat16 (tokens, weights and result share the type),
and the whole MLP or, with `skip_first`, the MLP from its first layer's
pre-activation (the caller has applied layer 0's linear map; the kernel
starts with sin(omega0 * x) and is given the layers after it). In bfloat16
the products accumulate in float32 and a value is rounded where the JAX
package's composed bfloat16 path rounds: after the product, after the
bias, after omega0 * and after the sine.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from motif_tpu_torch.ops import kernels

MAX_LAYERS = 8          # csrc/siren_mlp.cu MAX_LAYERS
TILE = 128              # csrc/siren_mlp.cu T: tokens per tile
CHUNK = 64              # csrc/siren_mlp.cu CHUNK: columns per register pass
SMEM_LIMIT = 232_448    # shared memory a block may use on Hopper

DTYPES = (torch.float32, torch.bfloat16)   # the kernel's entries

_SIGNATURES = {"siren_mlp_forward": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p]}


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def plan(dims, elem_size: int = 4):
    """The kernel's plan for layer widths `dims` (d[0] .. d[L]; for the
    skip-first entry the widths from the first hidden one on) and elements
    of `elem_size` bytes: (fused, rows, smem_bytes). fused[l] is 1 where
    layer l is wider than CHUNK and feeds a layer of at most CHUNK chunk by
    chunk; rows is the height of each of the two activation buffers;
    smem_bytes the shared memory of a block: the padded weights and biases
    plus the buffers."""
    L = len(dims) - 1
    fused = [0] * L
    rows = CHUNK
    l = 0
    while l < L:
        if l < L - 1 and dims[l + 1] > CHUNK and dims[l + 2] <= CHUNK:
            fused[l] = 1
            l += 2
        else:
            if l < L - 1:
                rows = max(rows, _pad8(dims[l + 1]))
            l += 1
    n_params = sum((k + 1) * _pad8(n) for k, n in zip(dims[:-1], dims[1:]))
    return fused, rows, elem_size * (n_params + 2 * rows * TILE)


def siren_mlp_plain(x: torch.Tensor, weights, biases, omega0: float = 30.0,
                    sine_last: bool = False,
                    skip_first: bool = False) -> torch.Tensor:
    """The plain version of `siren_mlp` (the JAX package's `_composed`):
    a linear layer per weight, sin(omega0 * .) between layers, the last
    layer linear unless `sine_last`. With `skip_first`, x is the first
    layer's pre-activation and `weights` / `biases` are the layers after
    it. In bfloat16 the product, the bias sum, omega0 * and the sine are
    four operations, each rounded, as in the JAX package; the product
    accumulates in float32 (a float32 matmul of the widened values, whose
    products are exact), in the order of the float32 entry."""
    if skip_first:
        x = torch.sin(omega0 * x)
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        if x.dtype == torch.bfloat16:
            x = torch.matmul(x.float(), w.float().t()).to(x.dtype) + b
        else:
            x = F.linear(x, w, b)
        if i < n - 1 or sine_last:
            x = torch.sin(omega0 * x)
    return x


def pack_params(weights, biases) -> torch.Tensor:
    """The kernel's parameter buffer: per layer the weight transposed to
    (in, out) and zero-padded to a multiple of 8 columns, then the bias
    zero-padded likewise."""
    parts = []
    for w, b in zip(weights, biases):
        n = w.shape[0]
        parts.append(F.pad(w.t(), (0, _pad8(n) - n)).reshape(-1))
        parts.append(F.pad(b, (0, _pad8(n) - n)))
    return torch.cat(parts).contiguous()


def siren_mlp(x: torch.Tensor, weights, biases, omega0: float = 30.0,
              sine_last: bool = False,
              skip_first: bool = False) -> torch.Tensor:
    """The whole SIREN MLP in one pass, or with `skip_first` the MLP from
    its first layer's pre-activation x (`weights` / `biases` are then the
    layers after the first). On CPU tensors: the plain version; on CUDA
    tensors: the `siren_mlp` kernel's float32 or bfloat16 entry, by the
    tensors' dtype."""
    if x.device.type == "cpu":
        return siren_mlp_plain(x, weights, biases, omega0, sine_last,
                               skip_first)
    dtype = kernels.require_cuda("siren_mlp", DTYPES, x, *weights, *biases)
    n_layers = len(weights)
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"siren_mlp takes 1..{MAX_LAYERS} layers, "
                         f"got {n_layers}")
    dims = [weights[0].shape[1]] + [w.shape[0] for w in weights]
    for i, w in enumerate(weights):
        if w.shape[1] != dims[i] or biases[i].shape != (dims[i + 1],):
            raise ValueError(f"siren_mlp: layer {i} shapes do not chain")
    if x.shape[-1] != dims[0]:
        raise ValueError(f"siren_mlp: x has {x.shape[-1]} features, the "
                         f"first layer takes {dims[0]}")
    if skip_first and dims[0] > CHUNK:
        raise ValueError(f"siren_mlp: a pre-activation of {dims[0]} features "
                         f"exceeds the {CHUNK} the skip-first entry stages")
    fused, rows, smem = plan(dims, x.element_size())
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"siren_mlp: widths {dims} need {smem} B of shared memory (the "
            f"weights resident plus two {rows}x{TILE} activation buffers), "
            f"more than the {SMEM_LIMIT} B a block may use")
    lead = x.shape[:-1]
    xf = x.reshape(-1, dims[0]).contiguous()
    params = pack_params(weights, biases)
    out = torch.empty((xf.shape[0], dims[-1]), dtype=x.dtype, device=x.device)
    c_dims = (ctypes.c_int * len(dims))(*dims)
    c_fused = (ctypes.c_int * n_layers)(*fused)
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    lib = kernels.load("siren_mlp", _SIGNATURES)
    err = lib.siren_mlp_forward(
        xf.data_ptr(), params.data_ptr(), out.data_ptr(), xf.shape[0], c_dims,
        c_fused, n_layers, rows, n_sm, float(omega0), int(sine_last),
        int(skip_first), int(dtype == torch.bfloat16),
        kernels.stream_handle(x.device))
    kernels.count("siren_mlp", str(dtype).removeprefix("torch.")
                  + ("/skip_first" if skip_first else "/whole"))
    kernels.check(err, "siren_mlp")
    return out.reshape(*lead, dims[-1])
