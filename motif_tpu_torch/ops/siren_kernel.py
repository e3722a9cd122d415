"""The fused SIREN MLP — the counterpart of motif_tpu/ops/siren_kernel.py,
with the CUDA kernel `siren_mlp` (csrc/siren_mlp.cu and csrc/siren_layer.cu
for float32, csrc/siren_mlp_bf16.cu for bfloat16), which replaces the TPU
kernel motif_tpu/ops/siren_kernel.py::_kernel.

Layout: x (..., Cin) row-major tokens; weights as torch stores them,
(out, in) per layer; biases (out,). Returns (..., Cout).

Entries: float32 or bfloat16 (tokens, weights and result share the type),
and the whole MLP or, with `skip_first`, the MLP from its first layer's
pre-activation (the caller has applied layer 0's linear map; the kernel
starts with sin(omega0 * x) and is given the layers after it). In bfloat16
the products accumulate in float32 and a value is rounded where the JAX
package's composed bfloat16 path rounds: after the product, after the
bias, after omega0 * and after the sine. In float32 each output of a layer
is one chain of float32 FMAs in ascending k from 0, then the bias, then
sinf's arithmetic: the order cuBLAS's float32 GEMM takes at the shapes
checked, where a launch is bit-equal to `F.linear` + `sin`, but cuBLAS may
pick another (a split k) elsewhere. An MLP whose weights fit one block's
shared memory (every MoTIF SIREN) runs whole on the resident kernel
(siren_mlp.cu); a larger one is cut by `segments` into runs of at least
two layers on that kernel and single layers on the streamed-weight kernel
(siren_layer.cu, counted as the entry "float32/layer"), which keeps the
same chain; the card's checks hold a layer to that chain bit for bit and
to `F.linear` + `sin` by accuracy. The bfloat16 entries contract on the
tensor cores,
which sum in another order than the plain version: they are held to it by
accuracy against `siren_mlp_reference64` (`accuracy`, `layer_gate`,
`mlp_gate`), not by equality.

Gradients: `siren_mlp` on tensors that require grad runs through an
autograd Function whose forward is the kernel (the plain version on the
CPU) and whose backward is `siren_mlp_backward_plain`: autodiff of the
composed plain form recomputed from the input, as the JAX package's
`siren_fused` backward is (motif_tpu/ops/siren_kernel.py:117-125) and as its
`nn.remat` decoders recompute. The weights and biases are inputs of the
Function, so their gradients reach the parameters. The bfloat16 entries
(whole, skip-first, cut by `segments_bf16`) take the same backward in
their working type: autodiff of the bfloat16 plain form, whose products
accumulate in float32 and round where its forward rounds, as the JAX
package differentiates `_composed` in the input's dtype.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from motif_tpu_torch.ops import kernels

MAX_LAYERS = 8          # MAX_LAYERS of both sources
TILE = 128              # csrc/siren_mlp.cu T: tokens per tile
CHUNK = 64              # CHUNK of both sources: columns per register pass
SMEM_LIMIT = 232_448    # shared memory a block may use on Hopper
BF16_WARPS = 16         # csrc/siren_mlp_bf16.cu WARPS: warps per block
BF16_TILE = 16          # csrc/siren_mlp_bf16.cu M: tokens per warp tile

DTYPES = (torch.float32, torch.bfloat16)   # the kernel's entries

_SIGNATURES = {"siren_mlp_forward": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p]}
_SIGNATURES_LAYER = {"siren_layer_forward": [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}
_SIGNATURES_BF16 = {"siren_mlp_bf16_forward": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def plan(dims):
    """The float32 kernel's plan for layer widths `dims` (d[0] .. d[L]; for
    the skip-first entry the widths from the first hidden one on): (fused,
    rows, smem_bytes). fused[l] is 1 where layer l is wider than CHUNK and
    feeds a layer of at most CHUNK chunk by chunk; rows is the height of
    each of the two activation buffers; smem_bytes the shared memory of a
    block: the padded weights and biases plus the buffers."""
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
    return fused, rows, 4 * (layer_offsets(dims)[-1] + 2 * rows * TILE)


class Launch(NamedTuple):
    """One float32 launch within an MLP (`segments`): layers `first` ..
    `last` - 1 with widths `dims`. `layer`: one layer on the
    streamed-weight kernel (csrc/siren_layer.cu; `fused`, `rows` and `smem`
    are None); else a run of the resident kernel (csrc/siren_mlp.cu) with
    its `plan`: `fused`, `rows`, `smem`."""
    first: int
    last: int
    dims: list
    layer: bool
    fused: list | None
    rows: int | None
    smem: int | None


def _launch(dims, first, last):
    sub = dims[first:last + 1]
    if last == first + 1:
        return Launch(first, last, sub, True, None, None, None)
    return Launch(first, last, sub, False, *plan(sub))


def segments(dims):
    """The float32 launches for layer widths `dims` (d[0] .. d[L]; from the
    pre-activation for the skip-first entry): a list of `Launch`. A run of
    at least two layers goes to the resident kernel where its weights and
    buffers fit one block's shared memory (every MoTIF SIREN is one such
    launch); a layer launched alone goes to the streamed-weight kernel,
    which takes any width. The activation between two launches is written
    to and read from global memory. Of the covers, the one that moves the
    fewest activation elements per token (a cut at width d writes d and
    reads d), then the one of fewest launches, then the first found (a
    single layer before a resident run)."""
    L = len(dims) - 1
    best = [None] * (L + 1)     # (cost, launches) of the cheapest cover
    best[0] = (0, [])
    for j in range(1, L + 1):
        for i in range(j):
            run = _launch(dims, i, j)
            if not run.layer and run.smem > SMEM_LIMIT:
                continue
            cost = best[i][0] + (2 * dims[j] if j < L else 0)
            cand = (cost, best[i][1] + [run])
            if best[j] is None or (cand[0], len(cand[1])) < (
                    best[j][0], len(best[j][1])):
                best[j] = cand
    return best[L][1]


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
    """The float32 kernels' parameter buffer: per layer, the weight
    transposed to (in, out) and zero-padded to a multiple of 8 columns, then
    the bias zero-padded likewise, back to back. Each launch of `segments`
    reads its layers where they lie (`layer_offsets`): every layer starts
    on a 32-byte boundary."""
    parts = []
    for w, b in zip(weights, biases):
        n = w.shape[0]
        parts.append(F.pad(w.t(), (0, _pad8(n) - n)).reshape(-1))
        parts.append(F.pad(b, (0, _pad8(n) - n)))
    return torch.cat(parts).contiguous()


def layer_offsets(dims) -> list:
    """Where layer l of widths `dims` starts in `pack_params`' buffer, in
    elements, for each l, and the buffer's length last."""
    offs = [0]
    for k, n in zip(dims[:-1], dims[1:]):
        offs.append(offs[-1] + (k + 1) * _pad8(n))
    return offs


def layout_bf16(dims):
    """Where the bfloat16 kernel keeps layer l (K = dims[l] inputs,
    N = dims[l + 1] outputs) in its parameter buffer: a list of (weight
    offset, bias offset, NP, LD) in elements, and the buffer's length. The
    weight is (NP, LD) = (N up to 8, K up to 16 plus 8) in torch's own
    (out, in) order, which is the tensor cores' column-major B operand; LD
    is an odd multiple of 8 elements, so that the 8 rows one `ldmatrix`
    reads lie in 8 different 16-byte bank groups. The bias (NP) follows."""
    layers, off = [], 0
    for k, n in zip(dims[:-1], dims[1:]):
        np_, ld = _pad8(n), _pad16(k) + 8
        layers.append((off, off + np_ * ld, np_, ld))
        off += np_ * ld + np_
    return layers, off


def pack_params_bf16(weights, biases) -> torch.Tensor:
    """The bfloat16 kernel's parameter buffer (`layout_bf16`), zero-filled
    so that padded inputs and outputs contribute nothing."""
    dims = [weights[0].shape[1]] + [w.shape[0] for w in weights]
    layers, total = layout_bf16(dims)
    buf = torch.zeros(total, dtype=weights[0].dtype, device=weights[0].device)
    for w, b, (woff, boff, np_, ld) in zip(weights, biases, layers):
        n, k = w.shape
        buf[woff:boff].view(np_, ld)[:n, :k] = w
        buf[boff:boff + n] = b
    return buf


def pack(weights, biases) -> torch.Tensor:
    """The parameter buffer of the entry that takes these tensors' dtype. A
    caller that keeps it (`Siren.packed`) hands it to `siren_mlp`, which
    otherwise packs on every call."""
    if weights[0].dtype == torch.bfloat16:
        return pack_params_bf16(weights, biases)
    return pack_params(weights, biases)


def plan_bf16(dims, aligned: bool = True):
    """The bfloat16 kernel's plan for layer widths `dims`: (nbuf,
    smem_bytes). Each of a block's BF16_WARPS warps stages its BF16_TILE
    tokens in a slab of its own, rows `_pad16(dims[0]) + 8` elements apart;
    nbuf is 2 (filled by 16-byte asynchronous copies, double-buffered) when
    the rows are `aligned` (dims[0] % 8 == 0 and x on a 16-byte boundary)
    and two slabs fit beside the resident weights, else 1. Raises for an
    MLP the kernel does not take: a layer wider than CHUNK that feeds
    another one wider than CHUNK (a wide layer is made CHUNK columns at a
    time and must feed at most CHUNK accumulator columns, or be last)."""
    for l in range(1, len(dims) - 1):
        if dims[l] > CHUNK and dims[l + 1] > CHUNK:
            raise ValueError(
                f"siren_mlp: widths {dims}: in bfloat16 a layer wider than "
                f"{CHUNK} ({dims[l]}) must be last or feed one of at most "
                f"{CHUNK}, not {dims[l + 1]}")
    _, n_params = layout_bf16(dims)
    slab = BF16_WARPS * BF16_TILE * (_pad16(dims[0]) + 8)
    nbuf = 2 if aligned and dims[0] % 8 == 0 else 1
    if nbuf == 2 and 2 * (n_params + 2 * slab) > SMEM_LIMIT:
        nbuf = 1
    return nbuf, 2 * (n_params + nbuf * slab)


def segments_bf16(dims, aligned: bool = True):
    """The bfloat16 kernel's launches for layer widths `dims`: a list of
    (first, last, nbuf) runs of whole layers, in order. An MLP whose
    weights and warp slabs fit one block's shared memory is one launch;
    otherwise each run is the longest from where the last one ended that
    fits (MoTIF's warp_to_many synthesis net, 331 inputs: its first layer
    alone, then the other four). The activation between two runs is the
    bfloat16 one the kernel keeps between layers, written to global memory
    and read back 16-byte aligned. `aligned`: the first run's x (see
    `plan_bf16`). Raises where a layer does not fit alone."""
    L, runs, i = len(dims) - 1, [], 0
    while i < L:
        al = aligned if i == 0 else True
        for j in range(L, i, -1):
            nbuf, smem = plan_bf16(dims[i:j + 1], al)
            if smem <= SMEM_LIMIT:
                break
        else:
            raise ValueError(
                f"siren_mlp: widths {dims}: layer {i} needs {smem} B of "
                f"shared memory alone (the weights resident plus "
                f"{BF16_WARPS} warps' slabs of {BF16_TILE} tokens), more "
                f"than the {SMEM_LIMIT} B a block may use")
        runs.append((i, j, nbuf))
        i = j
    return runs


def _check_chain(x, weights, biases, skip_first):
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
    return dims


def siren_mlp_backward_plain(x: torch.Tensor, weights, biases,
                             g: torch.Tensor, omega0: float = 30.0,
                             sine_last: bool = False,
                             skip_first: bool = False):
    """The gradients (d x, d weights..., d biases...) of `siren_mlp` given
    its output's gradient `g`: `siren_mlp_plain` recomputed from x under
    autograd and differentiated."""
    with torch.enable_grad():
        xs = x.detach().requires_grad_()
        ws = [w.detach().requires_grad_() for w in weights]
        bs = [b.detach().requires_grad_() for b in biases]
        y = siren_mlp_plain(xs, ws, bs, omega0, sine_last, skip_first)
        return torch.autograd.grad(y, [xs, *ws, *bs], g)


class _SirenMlp(torch.autograd.Function):
    """siren_mlp under autograd: the kernel forward,
    `siren_mlp_backward_plain` backward."""

    @staticmethod
    def forward(ctx, x, packed, omega0, sine_last, skip_first, *params):
        n = len(params) // 2
        ctx.save_for_backward(x, *params)
        ctx.conf = (omega0, sine_last, skip_first)
        return _mlp_forward(x, params[:n], params[n:], omega0, sine_last,
                            skip_first, packed)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        n = len(params) // 2
        with torch.profiler.record_function("siren_mlp.backward"):
            grads = siren_mlp_backward_plain(x, params[:n], params[n:], g,
                                             *ctx.conf)
        return (grads[0], None, None, None, None, *grads[1:])


def siren_mlp(x: torch.Tensor, weights, biases, omega0: float = 30.0,
              sine_last: bool = False, skip_first: bool = False,
              packed: torch.Tensor | None = None) -> torch.Tensor:
    """The whole SIREN MLP in one pass, or with `skip_first` the MLP from
    its first layer's pre-activation x (`weights` / `biases` are then the
    layers after the first). On CPU tensors: the plain version; on CUDA
    tensors: the `siren_mlp` kernel's float32 or bfloat16 entry, by the
    tensors' dtype. `packed` is `pack(weights, biases)` where the caller
    keeps it; without it the parameters are packed on every call. Under
    autograd (a tensor requires grad): the same forward with
    `siren_mlp_backward_plain` as its backward, in either type."""
    if kernels.needs_grad(x, *weights, *biases):
        return _SirenMlp.apply(x, packed, float(omega0), bool(sine_last),
                               bool(skip_first), *weights, *biases)
    return _mlp_forward(x, weights, biases, omega0, sine_last, skip_first,
                        packed)


def _mlp_forward(x, weights, biases, omega0, sine_last, skip_first, packed):
    """The forward of `siren_mlp`: the plain version on CPU tensors, the
    kernel on CUDA tensors."""
    if x.device.type == "cpu":
        return siren_mlp_plain(x, weights, biases, omega0, sine_last,
                               skip_first)
    dtype = kernels.require_cuda("siren_mlp", DTYPES, x, *weights, *biases)
    dims = _check_chain(x, weights, biases, skip_first)
    lead = x.shape[:-1]
    xf = x.reshape(-1, dims[0]).contiguous()
    bf16 = dtype == torch.bfloat16
    if bf16:
        runs = segments_bf16(dims, xf.data_ptr() % 16 == 0)
    else:
        launches = segments(dims)
    if packed is None:
        packed = pack(weights, biases)
    elif packed.dtype != dtype or packed.device != x.device or \
            packed.numel() != pack_size(dims, dtype):
        raise ValueError("siren_mlp: `packed` is not pack(weights, biases)")
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    stream = kernels.stream_handle(x.device)
    entry = str(dtype).removeprefix("torch.") + (
        "/skip_first" if skip_first else "/whole")
    if bf16:
        lib = kernels.load("siren_mlp_bf16", _SIGNATURES_BF16)
        layers, _ = layout_bf16(dims)
        h, L = xf, len(weights)
        for first, last, nbuf in runs:
            # a run's layers lie back to back in the whole MLP's buffer
            out = torch.empty((xf.shape[0], dims[last]), dtype=dtype,
                              device=x.device)
            sub = dims[first:last + 1]
            err = lib.siren_mlp_bf16_forward(
                h.data_ptr(), packed.data_ptr() + 2 * layers[first][0],
                out.data_ptr(), xf.shape[0], (ctypes.c_int * len(sub))(*sub),
                last - first, n_sm, float(omega0),
                int(sine_last or last < L), int(skip_first and first == 0),
                nbuf, stream)
            kernels.count("siren_mlp", entry)
            kernels.check(err, "siren_mlp")
            h = out
        return out.reshape(*lead, dims[-1])
    offs = layer_offsets(dims)
    h, L = xf, len(weights)
    for s in launches:
        out = torch.empty((xf.shape[0], dims[s.last]), dtype=dtype,
                          device=x.device)
        sine = sine_last or s.last < L
        skip = skip_first and s.first == 0
        if s.layer:
            _layer_launch(h, packed, offs[s.first], out, omega0, sine, skip)
        else:
            lib = kernels.load("siren_mlp", _SIGNATURES)
            n = len(s.dims) - 1
            err = lib.siren_mlp_forward(
                h.data_ptr(), packed.data_ptr() + 4 * offs[s.first],
                out.data_ptr(), xf.shape[0], dims[s.last],
                (ctypes.c_int * len(s.dims))(*s.dims),
                (ctypes.c_int * n)(*s.fused), n, s.rows, n_sm,
                float(omega0), int(sine), int(skip), 0, stream)
            kernels.count("siren_mlp", entry)
            kernels.check(err, "siren_mlp")
        h = out
    return out.reshape(*lead, dims[-1])


def _pitch(t: torch.Tensor) -> int | None:
    """The row pitch of a 2-D tensor whose columns are adjacent and whose
    rows do not overlap, else None."""
    n, k = t.shape
    if k > 1 and t.stride(1) != 1:
        return None
    if n <= 1:
        return k
    return t.stride(0) if t.stride(0) >= k else None


def _layer_launch(x, packed, offset, out, omega0, sine, in_sine):
    """One launch of the streamed-weight kernel (csrc/siren_layer.cu) on
    float32 CUDA tensors: out = [sin(omega0 *)](x W^T + b), from sin(omega0
    * x) with `in_sine`, for the layer whose parameters start `offset`
    elements into `packed` (`pack_params`' layout). x (tokens, K) and out
    (tokens, N) are 2-D with adjacent columns; their rows may lie further
    apart (out may be columns of a wider activation), and the kernel reads
    and writes them at that pitch. Counted as the entry "float32/layer"."""
    ldx, ldo = _pitch(x), _pitch(out)
    if ldx is None or ldo is None or x.shape[0] != out.shape[0]:
        raise ValueError("siren_mlp: a layer launch takes 2-D rows of "
                         "adjacent columns, as many in as out")
    lib = kernels.load("siren_layer", _SIGNATURES_LAYER)
    err = lib.siren_layer_forward(
        x.data_ptr(), ldx, packed.data_ptr() + 4 * offset, out.data_ptr(),
        ldo, x.shape[0], x.shape[1], out.shape[1], float(omega0), int(sine),
        int(in_sine), kernels.stream_handle(x.device))
    kernels.count("siren_mlp", "float32/layer")
    kernels.check(err, "siren_mlp")


def pack_size(dims, dtype: torch.dtype) -> int:
    """The length of `pack`'s buffer for widths `dims`."""
    if dtype == torch.bfloat16:
        return layout_bf16(dims)[1]
    return layer_offsets(dims)[-1]


# ---------------------------------------------------------------------------
# The bfloat16 entries' gate. The tensor cores sum a product's terms in
# another order than the plain version, so a sum on a rounding boundary may
# round the other way; omega0 = 30 and the sines after it amplify one
# flipped rounding to many ulps at a few outputs while both results are
# equally far from the truth. So the kernel is held by accuracy.
# ---------------------------------------------------------------------------

def siren_mlp_reference64(x: torch.Tensor, weights, biases,
                          omega0: float = 30.0, sine_last: bool = False,
                          skip_first: bool = False) -> torch.Tensor:
    """The truth the gates measure against: the same inputs and weights
    widened to float64, no rounding anywhere."""
    h = x.double()
    if skip_first:
        h = torch.sin(omega0 * h)
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = F.linear(h, w.double(), b.double())
        if i < n - 1 or sine_last:
            h = torch.sin(omega0 * h)
    return h


def _ulp(scale: float) -> float:
    """One bfloat16 unit in the last place at magnitude `scale`."""
    return 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)


def layer_gate(got: torch.Tensor, want: torch.Tensor, pre_max: float,
               omega0: float = 30.0, sine: bool = False) -> dict:
    """Gate 1, for ONE layer on the same bfloat16 input, `want` the plain
    version's result and `pre_max` the largest magnitude of the layer's
    product and pre-activation: at least 99% of the outputs bit-equal (an
    accumulation order can only flip a value that sits on a rounding
    boundary), and no output further off than one flipped rounding can
    put it. A flip moves the product by one ulp at ITS magnitude; the bias
    sum rounds again (2 ulps at `pre_max` in all, which is several ulps of
    an output that the bias cancelled), and a sine layer multiplies that
    by omega0, rounds the argument and the sine. Catches a wrong fragment
    mapping, a missed padding column, a missing rounding point."""
    tol = 2.0 * _ulp(pre_max)
    if sine:
        tol = omega0 * tol + _ulp(omega0 * pre_max) + _ulp(1.0)
    finite = bool(torch.isfinite(got.float()).all())
    r = {"max_abs_diff": float((got.double() - want.double()).abs().max()),
         "tol": tol,
         "max_ulps": int(kernels.bfloat16_ulps(got, want).max()),
         "exact_share": float((got == want).float().mean())}
    r["ok"] = (finite and r["max_abs_diff"] <= tol
               and r["exact_share"] >= 0.99)
    return r


def mlp_gate(got: torch.Tensor, want: torch.Tensor,
             ref: torch.Tensor) -> dict:
    """Gate 2, for a whole MLP against `siren_mlp_reference64` (`ref`): the
    kernel's RMS error at most 1.25 x the plain version's, its mean signed
    error below 10% of its RMS error (no bias), its max abs error at most
    2 x the plain version's. Also reported, not gated: the bit-equal share
    and the max abs difference kernel-versus-plain."""
    g, w = got.double(), want.double()
    eg, ew = g - ref, w - ref
    r = {"rms_err": float(eg.pow(2).mean().sqrt()),
         "plain_rms_err": float(ew.pow(2).mean().sqrt()),
         "mean_err": float(eg.mean()),
         "max_err": float(eg.abs().max()),
         "plain_max_err": float(ew.abs().max()),
         "plain_mean_err": float(ew.mean()),
         "exact_share": float((got == want).float().mean()),
         "max_abs_diff": float((g - w).abs().max())}
    r["ok"] = (r["rms_err"] <= 1.25 * r["plain_rms_err"]
               and abs(r["mean_err"]) < 0.1 * r["rms_err"]
               and r["max_err"] <= 2.0 * r["plain_max_err"])
    return r
