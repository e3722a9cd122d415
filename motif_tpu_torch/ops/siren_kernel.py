"""The fused SIREN MLP — the counterpart of motif_tpu/ops/siren_kernel.py,
with the CUDA kernel `siren_mlp` (csrc/siren_mlp.cu), which replaces the TPU
kernel motif_tpu/ops/siren_kernel.py::_kernel.

Layout: x (..., Cin) row-major tokens; weights as torch stores them,
(out, in) per layer; biases (out,). Returns (..., Cout).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from motif_tpu_torch.ops import kernels

MAX_LAYERS = 8  # csrc/siren_mlp.cu MAX_LAYERS

_SIGNATURES = {"siren_mlp_forward": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p]}


def siren_mlp_plain(x: torch.Tensor, weights, biases, omega0: float = 30.0,
                    sine_last: bool = False) -> torch.Tensor:
    """The plain version of `siren_mlp` (the JAX package's `_composed`):
    a linear layer per weight, sin(omega0 * .) between layers, the last
    layer linear unless `sine_last`."""
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = F.linear(x, w, b)
        if i < n - 1 or sine_last:
            x = torch.sin(omega0 * x)
    return x


def pack_params(weights, biases) -> torch.Tensor:
    """The kernel's parameter buffer: per layer the weight transposed to
    (in, out) and zero-padded to a multiple of 4 columns, then the bias
    zero-padded likewise."""
    parts = []
    for w, b in zip(weights, biases):
        n, k = w.shape
        n4 = -(-n // 4) * 4
        parts.append(F.pad(w.t(), (0, n4 - n)).reshape(-1))
        parts.append(F.pad(b, (0, n4 - n)))
    return torch.cat(parts).contiguous()


def siren_mlp(x: torch.Tensor, weights, biases, omega0: float = 30.0,
              sine_last: bool = False) -> torch.Tensor:
    """The whole SIREN MLP in one pass. On CPU tensors: the plain version;
    on CUDA tensors: the `siren_mlp` kernel (float32)."""
    if x.device.type == "cpu":
        return siren_mlp_plain(x, weights, biases, omega0, sine_last)
    kernels.require_cuda_float32("siren_mlp", x, *weights, *biases)
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
    lead = x.shape[:-1]
    xf = x.reshape(-1, dims[0]).contiguous()
    params = pack_params(weights, biases)
    out = torch.empty((xf.shape[0], dims[-1]), dtype=x.dtype, device=x.device)
    c_dims = (ctypes.c_int * len(dims))(*dims)
    lib = kernels.load("siren_mlp", _SIGNATURES)
    err = lib.siren_mlp_forward(xf.data_ptr(), params.data_ptr(),
                                out.data_ptr(), xf.shape[0], c_dims, n_layers,
                                float(omega0), int(sine_last),
                                kernels.stream_handle(x.device))
    kernels.LAUNCHES["siren_mlp"] += 1
    kernels.check(err, "siren_mlp")
    return out.reshape(*lead, dims[-1])
