"""The first-layer pre-activations of MoTIF's fused decode, each put
together in one pass: the CUDA kernel `preact` (csrc/preact_bf16.cu) on the
card, `preact_plain` on the CPU.

Under `fused_decode` MoTIF folds each SIREN's first linear layer through
the LIIF nearest takes: a channel product commutes with a spatial take, so
the products with the features run at low resolution (`lr`, the caller's
matmul) and the rest of the layer is added at high resolution. `w` is the
first layer's weight as the module stores it, (64, fan_in); `col_hr` and
`col_t` name the columns of the HR channels `hr` (K <= 3 of them) and of
the time. The four sites of `MoTIF.head` (SITES), take(a) = a's rows taken
at (iy, ix), rep_n = repeat_interleave(rep, 0):

    stinf    rep_n(take(lr)) + t * w[:, col_t] + hr @ w[:, col_hr:].T + bias
    sinf     take(lr) + hr @ w[:, col_hr:].T + bias
    payload  rep_n(dense + take(lr)).to(w.dtype) + hr @ w[:, col_hr:].T
    synth    dense.to(cd) + hr.to(cd) @ w[:, col_hr:].T + take(lr)
             + t * w[:, col_t] + bias        (cd: lr's dtype)

each sum taken left to right, every op in its operands' dtype: the JAX
package's order. The kernel gives the same values bit for bit: it rounds
each term and partial sum where the plain ops do, and sums the HR channels
as cuBLAS does (see the source).

`preact` runs the plain version on CPU tensors and the kernel on CUDA ones,
in bfloat16 compute (the types of `_BF16_TYPES`) or with every tensor
float32; it raises for any other type, a shape the kernel does not take or
a misaligned table. Under autograd the kernel is the forward of an autograd
Function whose backward is `preact_plain` recomputed and differentiated.
The launches count as `kernels.launches.preact/<site>`.
"""

from __future__ import annotations

import ctypes

import torch

from motif_tpu_torch import obs
from motif_tpu_torch.ops import kernels

SITES = ("stinf", "sinf", "payload", "synth")
_BF16, _F32 = torch.bfloat16, torch.float32
# per site the dtypes of the parts in bfloat16 compute (None: the site has
# no such part); the output is w's dtype
_BF16_TYPES = {
    "stinf": dict(lr=_BF16, w=_BF16, bias=_BF16, dense=None, hr=_BF16,
                  t=_BF16),
    "sinf": dict(lr=_BF16, w=_BF16, bias=_BF16, dense=None, hr=_BF16,
                 t=None),
    "payload": dict(lr=_BF16, w=_F32, bias=None, dense=_BF16, hr=_F32,
                    t=None),
    "synth": dict(lr=_BF16, w=_BF16, bias=_BF16, dense=_F32, hr=_F32,
                  t=_BF16)}
_C = 64              # the kernel's channels
_KMAX = 3            # its HR channels at most
_SIGNATURES = {"preact_forward": [
    ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 5, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, *[ctypes.c_int] * 3,
    *[ctypes.c_void_p] * 3, *[ctypes.c_int] * 6, ctypes.c_void_p]}


def take(a: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """a (M, H, W, c) at the nearest LR cell of each HR pixel:
    (M, len(iy), len(ix), c)."""
    return a.index_select(1, iy).index_select(2, ix)


def preact_plain(site: str, lr, iy, ix, w, *, bias=None, rep: int = 1,
                 dense=None, hr=None, col_hr: int = 0, t=None,
                 col_t: int = 0) -> torch.Tensor:
    """The pre-activation of `site` as plain PyTorch ops (the formulas of
    the module's docstring); t has one value a row, shaped (rows, 1, 1,
    1)."""
    wt = w.t()
    w_hr = wt[col_hr:col_hr + hr.shape[-1]]
    if site == "stinf":
        h0 = take(lr, iy, ix).repeat_interleave(rep, 0)
        return h0 + t * wt[col_t] + torch.matmul(hr, w_hr) + bias
    if site == "sinf":
        return take(lr, iy, ix) + torch.matmul(hr, w_hr) + bias
    if site == "payload":
        pay = (dense + take(lr, iy, ix)).repeat_interleave(rep, 0)
        return pay.to(w.dtype) + torch.matmul(hr, w_hr)
    if site == "synth":
        cd = lr.dtype
        return (dense.to(cd) + torch.matmul(hr.to(cd), w_hr)
                + take(lr, iy, ix) + t * wt[col_t] + bias)
    raise ValueError(f"preact: unknown site {site!r}, not one of {SITES}")


_PARTS = ("lr", "iy", "ix", "w", "bias", "dense", "hr", "t")


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type != "cpu"


class _Preact(torch.autograd.Function):
    """preact under autograd: the kernel forward, `preact_plain`
    recomputed and differentiated as the backward (the pre-activation is
    linear in its parts)."""

    @staticmethod
    def forward(ctx, site, rep, col_hr, col_t, *parts):
        ctx.save_for_backward(*parts)
        ctx.conf = dict(site=site, rep=rep, col_hr=col_hr, col_t=col_t)
        return _launch(**ctx.conf, **dict(zip(_PARTS, parts)))

    @staticmethod
    def backward(ctx, g):
        wants = ctx.needs_input_grad[4:]
        with obs.span("preact.backward"), torch.enable_grad():
            parts = {k: None if p is None else p.detach().requires_grad_(want)
                     for k, p, want in zip(_PARTS, ctx.saved_tensors, wants)}
            conf = dict(ctx.conf)
            y = preact_plain(conf.pop("site"), **conf, **parts)
            leaves = [k for k, want in zip(_PARTS, wants) if want]
            grads = dict(zip(leaves, torch.autograd.grad(
                y, [parts[k] for k in leaves], g)))
        return (None,) * 4 + tuple(grads.get(k) for k in _PARTS)


def preact(site: str, lr, iy, ix, w, *, bias=None, rep: int = 1,
           dense=None, hr=None, col_hr: int = 0, t=None,
           col_t: int = 0) -> torch.Tensor:
    """The pre-activation of `site` (module docstring): `preact_plain` on
    CPU tensors, the kernel on CUDA ones (under autograd with the plain
    version's backward)."""
    if not _on_card(lr):
        return preact_plain(site, lr, iy, ix, w, bias=bias, rep=rep,
                            dense=dense, hr=hr, col_hr=col_hr, t=t,
                            col_t=col_t)
    parts = (lr, iy, ix, w, bias, dense, hr, t)
    if kernels.needs_grad(*(p for p in parts if p is not None)):
        return _Preact.apply(site, rep, col_hr, col_t, *parts)
    return _launch(site, rep, col_hr, col_t, *parts)


def _checked(site, lr, iy, ix, w, bias, dense, hr, t, rows):
    """The parts as the kernel reads them (hr strided by pixel, the rest
    contiguous), or an error: every part on lr's CUDA device in the type
    the kernel takes (`_BF16_TYPES`, or float32 throughout; int64 tables),
    64 channels, at most 3 HR channels, lr and dense 16-byte aligned, 2**30
    work items at most."""
    if site not in SITES:
        raise ValueError(f"preact: unknown site {site!r}, not one of {SITES}")
    parts = dict(lr=lr, iy=iy, ix=ix, w=w, bias=bias, dense=dense, hr=hr, t=t)
    devices = [v.device for v in parts.values() if v is not None]
    if any(d != lr.device for d in devices) or not _on_card(lr):
        raise ValueError(f"preact: all tensors must be on one CUDA device, "
                         f"got {[str(d) for d in devices]}")
    want = _BF16_TYPES[site]
    if lr.dtype == _F32:
        want = {k: None if v is None else _F32 for k, v in want.items()}
    want = dict(want, iy=torch.int64, ix=torch.int64)
    got = {k: None if v is None else v.dtype for k, v in parts.items()}
    if got != want:
        raise TypeError(f"preact ({site}): the kernel takes {want}, got {got}")
    M, H, W, C = lr.shape
    HH, WW = iy.numel(), ix.numel()
    shapes = [C == _C, w.dim() == 2 and w.shape[0] == _C, hr.dim() == 4,
              0 < hr.shape[-1] <= _KMAX, hr.shape[1:3] == (HH, WW),
              hr.shape[0] in (1, rows),
              dense is None or dense.shape == (M, HH, WW, _C),
              bias is None or bias.shape == (_C,),
              t is None or t.numel() == rows,
              rows * HH * WW * (_C // 8) < 2 ** 30]
    if not all(shapes):
        raise ValueError(
            f"preact ({site}): the kernel does not take lr "
            f"{tuple(lr.shape)}, w {tuple(w.shape)}, hr {tuple(hr.shape)}, "
            f"dense {None if dense is None else tuple(dense.shape)} at "
            f"{HH}x{WW} and {rows} rows")
    if hr.stride(3) != 1 or hr.stride(1) != WW * hr.stride(2):
        hr = hr.contiguous()
    lr, iy, ix, w, bias, dense, t = (
        None if v is None else v.contiguous()
        for v in (lr, iy, ix, w, bias, dense, t))
    if any(v.data_ptr() % 16 for v in (lr, dense) if v is not None):
        raise ValueError(f"preact ({site}): lr and dense must be 16-byte "
                         f"aligned")
    return lr, iy, ix, w, bias, dense, hr, t


def _launch(site, rep, col_hr, col_t, lr, iy, ix, w, bias, dense, hr, t):
    """The kernel's entry for `site` on the checked parts, counted."""
    rows = lr.shape[0] * rep
    out = _kernel(site, rep, col_hr, col_t, *_checked(
        site, lr, iy, ix, w, bias, dense, hr, t, rows))
    kernels.count("preact", site)
    return out


def _kernel(site, rep, col_hr, col_t, lr, iy, ix, w, bias, dense, hr, t):
    """One launch of the kernel on the current stream."""
    M, H, W, _ = lr.shape
    rows, HH, WW = M * rep, iy.numel(), ix.numel()
    hs = hr.stride()
    out = torch.empty((rows, HH, WW, _C), dtype=w.dtype, device=lr.device)

    def ptr(x):
        return None if x is None else x.data_ptr()
    lib = kernels.load("preact_bf16", _SIGNATURES)
    err = lib.preact_forward(
        SITES.index(site), int(lr.dtype == _F32), lr.data_ptr(),
        iy.data_ptr(), ix.data_ptr(), ptr(dense), hr.data_ptr(),
        hs[0] if hr.shape[0] > 1 else 0, hs[2], hr.shape[-1], w.data_ptr(),
        w.shape[1], col_hr, col_t, ptr(t), ptr(bias), out.data_ptr(), rows,
        H, W, HH, WW, rep, kernels.stream_handle(lr.device))
    kernels.check(err, "preact")
    return out
