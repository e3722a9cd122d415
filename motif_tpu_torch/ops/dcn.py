"""Modulated deformable convolution (DCNv2) — the counterpart of
motif_tpu/ops/dcn.py, with its sampling stage as the CUDA kernel
`dcn_sample` (csrc/dcn_sample.cu), which replaces the TPU kernels
motif_tpu/ops/dcn_pallas.py::_kernel and ::_ywin_kernel.

dcn_v2 computes the sample positions from the offsets, samples with
`dcn_sample`, multiplies by the (already sigmoided) mask and contracts the
im2col tensor with the weights — the plain large product that the JAX
package leaves to XLA stays a torch einsum here.

Layouts: x (B, H, W, Cin) NHWC; offset (B, Ho, Wo, G*K*K*2) with layout
(g, k, [y, x]) fastest-last; mask (B, Ho, Wo, G*K*K) layout (g, k);
weight (Cout, Cin, K, K) as torch stores it.
"""

from __future__ import annotations

import ctypes

import torch

from motif_tpu_torch.ops import kernels

_SIGNATURES = {"dcn_sample_forward": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_void_p]}


def dcn_sample_plain(x: torch.Tensor, py: torch.Tensor,
                     px: torch.Tensor) -> torch.Tensor:
    """The plain version of `dcn_sample`: the gather form of the JAX
    package's _dcn_v2_gather (four corner gathers, each zero outside the
    image). x (B, H, W, G*cg); py/px (B, G, Q) → (B, Q, G, cg)."""
    B, H, W, Cin = x.shape
    G, Q = py.shape[1], py.shape[2]
    cg = Cin // G
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    ly = py - y0
    lx = px - x0
    iy0 = y0.long()
    ix0 = x0.long()
    xg = x.reshape(B, H * W, G, cg).permute(0, 2, 1, 3)        # (B, G, HW, cg)

    def corner(iy, ix, w):
        valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
        idx = torch.where(valid, iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1),
                          torch.zeros_like(iy))
        g = torch.gather(xg, 2, idx[..., None].expand(-1, -1, -1, cg))
        return g * (w * valid.to(w.dtype))[..., None].to(g.dtype)

    val = (corner(iy0, ix0, (1 - ly) * (1 - lx))
           + corner(iy0, ix0 + 1, (1 - ly) * lx)
           + corner(iy0 + 1, ix0, ly * (1 - lx))
           + corner(iy0 + 1, ix0 + 1, ly * lx))                # (B, G, Q, cg)
    return val.permute(0, 2, 1, 3)


def dcn_sample(x: torch.Tensor, py: torch.Tensor,
               px: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of grouped features: x (B, H, W, G*cg) NHWC,
    py/px (B, G, Q) positions in pixels → (B, Q, G, cg). On CPU tensors:
    the plain version; on CUDA tensors: the `dcn_sample` kernel."""
    if x.device.type == "cpu":
        return dcn_sample_plain(x, py, px)
    kernels.require_cuda_float32("dcn_sample", x, py, px)
    B, H, W, Cin = x.shape
    G, Q = py.shape[1], py.shape[2]
    if Cin % G or py.shape != (B, G, Q) or px.shape != (B, G, Q):
        raise ValueError(f"dcn_sample: bad shapes x {tuple(x.shape)}, "
                         f"py {tuple(py.shape)}, px {tuple(px.shape)}")
    x, py, px = x.contiguous(), py.contiguous(), px.contiguous()
    cg = Cin // G
    out = torch.empty((B, Q, G, cg), dtype=x.dtype, device=x.device)
    lib = kernels.load("dcn_sample", _SIGNATURES)
    err = lib.dcn_sample_forward(x.data_ptr(), py.data_ptr(), px.data_ptr(),
                                 out.data_ptr(), B, H, W, G, cg, Q,
                                 kernels.stream_handle(x.device))
    kernels.LAUNCHES["dcn_sample"] += 1
    kernels.check(err, "dcn_sample")
    return out


def sample_positions(offset: torch.Tensor, K: int, stride: int, padding: int,
                     dilation: int, G: int):
    """Sample rows / columns (B, G, Q), Q = Ho*Wo*K*K ordered (ho, wo, k),
    from offsets (B, Ho, Wo, G*K*K*2)."""
    B, Ho, Wo, _ = offset.shape
    dev = offset.device
    off = offset.reshape(B, Ho, Wo, G, K * K, 2)
    f32 = torch.float32
    oy = torch.arange(Ho, dtype=f32, device=dev) * stride - padding
    ox = torch.arange(Wo, dtype=f32, device=dev) * stride - padding
    ky = torch.arange(K, dtype=f32, device=dev).repeat_interleave(K) * dilation
    kx = (torch.arange(K, dtype=f32, device=dev) * dilation).repeat(K)
    py = (oy[None, :, None, None, None] + ky[None, None, None, None, :]
          + off[..., 0])
    px = (ox[None, None, :, None, None] + kx[None, None, None, None, :]
          + off[..., 1])
    Q = Ho * Wo * K * K
    py = py.permute(0, 3, 1, 2, 4).reshape(B, G, Q)
    px = px.permute(0, 3, 1, 2, 4).reshape(B, G, Q)
    return py, px


def dcn_v2(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
           weight: torch.Tensor, bias: torch.Tensor | None,
           kernel_size: int = 3, stride: int = 1, padding: int = 1,
           dilation: int = 1, deformable_groups: int = 1) -> torch.Tensor:
    """Modulated deformable conv; returns (B, Ho, Wo, Cout)."""
    B, H, W, Cin = x.shape
    K, G = kernel_size, deformable_groups
    if Cin % G:
        raise ValueError("input channels must divide deformable_groups")
    cg = Cin // G
    Ho = (H + 2 * padding - (dilation * (K - 1) + 1)) // stride + 1
    Wo = (W + 2 * padding - (dilation * (K - 1) + 1)) // stride + 1
    if offset.shape != (B, Ho, Wo, G * K * K * 2) or \
            mask.shape != (B, Ho, Wo, G * K * K):
        raise ValueError(f"dcn_v2: offset {tuple(offset.shape)} / mask "
                         f"{tuple(mask.shape)} do not match the output grid")
    py, px = sample_positions(offset, K, stride, padding, dilation, G)
    val = dcn_sample(x, py, px)                                # (B, Q, G, cg)
    val = val.reshape(B, Ho, Wo, K * K, G, cg).permute(0, 1, 2, 4, 3, 5)
    val = val * mask.reshape(B, Ho, Wo, G, K * K, 1).to(val.dtype)
    Cout = weight.shape[0]
    w = weight.permute(2, 3, 1, 0).reshape(K * K, G, cg, Cout).to(val.dtype)
    out = torch.einsum("bhwgkc,kgco->bhwo", val, w)
    if bias is not None:
        out = out + bias
    return out
