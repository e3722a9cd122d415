"""Modulated deformable convolution (DCNv2) — the counterpart of
motif_tpu/ops/dcn.py, with its im2col stage as the CUDA kernel
`dcn_im2col` (csrc/dcn_im2col.cu), which replaces the TPU kernels
motif_tpu/ops/dcn_pallas.py::_kernel and ::_ywin_kernel and the XLA ops
around them (sample positions, mask, transpose).

dcn_v2 builds the im2col matrix with `dcn_im2col` (positions from the
offsets, bilinear sampling, times the already sigmoided mask) and
contracts it with the weights in one `addmm` — the plain large product that
the JAX package leaves to XLA stays a torch call here. `dcn_v2_plain` is
the same composition on the plain im2col. (A kernel that fused the
contraction in for bfloat16, the columns kept in shared memory and
contracted by mma.sync, was built and measured on an H100: faster at the
PCD's L2 and L3, slower at L1, where most of the time is; it is not kept.)

Element types: float32 and bfloat16 on the card (float64 too on the CPU).
In bfloat16 x, the offsets, the mask and the columns are bfloat16; the
sample positions, the hat weights, the four-corner sum and the mask product
are formed in float32 and a column is rounded to bfloat16 once, when it is
stored. The JAX package's one-hot sampler rounds more often (its hat
weights, the row contraction, the sample and the masked sample are each
rounded to bfloat16), so the two agree to a few bfloat16 ulps, not bit for
bit; the port keeps the float32 weights because they cost its kernel
nothing. The weight contraction is then one bfloat16 `addmm`, which
accumulates in float32.

Layouts: x (B, H, W, Cin) NHWC; offset (B, Ho, Wo, G*K*K*2) with layout
(g, k, [y, x]) fastest-last; mask (B, Ho, Wo, G*K*K) layout (g, k);
weight (Cout, Cin, K, K) as torch stores it; the im2col matrix
(B*Ho*Wo, G*K*K*cg) with columns (g, k, c), c fastest.

Gradients: `dcn_im2col` on tensors that require grad runs through an
autograd Function whose forward is the kernel (the plain version on the
CPU) and whose backward is `dcn_im2col_backward_plain`, plain PyTorch: the
JAX package's `_sample_onehot_bwd` (motif_tpu/ops/dcn.py:147-177) in gather
form, with its floor-corner convention for the position gradient. The
weight and the bias take their gradients through `_contract`'s `addmm`.
The bfloat16 entry takes the same backward in its working type: float32
arithmetic on the bfloat16 values of x, the offsets, the mask and the
columns' gradient, each gradient rounded to bfloat16 once, as its forward
rounds a column once (the JAX package's VJP rounds its hat weights and
contraction inputs to bfloat16 as well, so the two agree by accuracy, not
bit for bit).
"""

from __future__ import annotations

import ctypes

import torch

from motif_tpu_torch import obs
from motif_tpu_torch.ops import kernels

_SIGNATURES = {"dcn_im2col_forward": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    *[ctypes.c_int] * 14, ctypes.c_void_p]}
DTYPES = (torch.float32, torch.bfloat16)    # the kernel's entries


def dcn_sample_plain(x: torch.Tensor, py: torch.Tensor,
                     px: torch.Tensor) -> torch.Tensor:
    """The bilinear sampler of `dcn_im2col_plain`: the gather form of the
    JAX package's _dcn_v2_gather (four corner gathers, each zero outside
    the image). x (B, H, W, G*cg); py/px (B, G, Q) → (B, Q, G, cg)."""
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


def output_size(H: int, W: int, K: int, stride: int, padding: int,
                dilation: int):
    Ho = (H + 2 * padding - (dilation * (K - 1) + 1)) // stride + 1
    Wo = (W + 2 * padding - (dilation * (K - 1) + 1)) // stride + 1
    return Ho, Wo


def dcn_im2col_plain(x: torch.Tensor, offset: torch.Tensor,
                     mask: torch.Tensor, K: int, stride: int, padding: int,
                     dilation: int, G: int) -> torch.Tensor:
    """The plain version of `dcn_im2col`: `sample_positions`, then
    `dcn_sample_plain`, times the mask, in the column order (g, k, c),
    all in at least float32 and rounded to x's dtype at the end (one
    rounding per column for bfloat16, none for float32 / float64).
    Returns (B*Ho*Wo, G*K*K*cg)."""
    B, H, W, Cin = x.shape
    Ho, Wo = offset.shape[1], offset.shape[2]
    cg = Cin // G
    acc = torch.promote_types(x.dtype, torch.float32)
    py, px = sample_positions(offset, K, stride, padding, dilation, G)
    val = dcn_sample_plain(x.to(acc), py, px)                  # (B, Q, G, cg)
    val = val.reshape(B, Ho, Wo, K * K, G, cg).permute(0, 1, 2, 4, 3, 5)
    val = val * mask.reshape(B, Ho, Wo, G, K * K, 1).to(acc)
    return val.reshape(B * Ho * Wo, G * K * K * cg).to(x.dtype)


def _pixel_rows(t: torch.Tensor, align: int):
    """t (B, Ho, Wo, n) as rows of n dense elements, one per pixel, `row`
    elements apart: read in place when its pixels are evenly spaced (a
    channel slice of one conv output, as DCNSep takes its offsets), else
    copied. `align` is the row and address alignment in elements (of 4 or
    2 bytes) that the kernel's vector loads need."""
    B, Ho, Wo, n = t.shape
    s = t.stride()
    row = s[2]
    even = (s[3] == 1 and row >= n and row % align == 0
            and t.data_ptr() % (t.element_size() * align) == 0
            and (Ho == 1 or s[1] == Wo * row)
            and (B == 1 or s[0] == Ho * Wo * row))
    if not even:
        t = t.contiguous()
        row = n
    return t, row


def dcn_im2col_backward_plain(x: torch.Tensor, offset: torch.Tensor,
                              mask: torch.Tensor, g_cols: torch.Tensor,
                              K: int, stride: int, padding: int,
                              dilation: int, G: int):
    """The gradients (d x, d offset, d mask) of `dcn_im2col` given its
    columns' gradient `g_cols` (B*Ho*Wo, G*K*K*cg), in at least float32 and
    returned in the inputs' dtypes and shapes. With gv = g_cols * mask the
    gradient of a sample and X_c its four corners (zero outside the image):
      d mask = sample . g_cols,
      d x    = the corners' bilinear weights times gv, added at the corners,
      d py   = (1 - lx) gv.(X_SW - X_NW) + lx gv.(X_SE - X_NE),
      d px   = (1 - ly) gv.(X_NE - X_NW) + ly gv.(X_SE - X_SW),
    ly, lx the fractional parts of the position: the floor corner weighs
    -1 and the ceil corner +1 in the position's gradient, at an integer
    position too (the JAX package's `_hat_grad`)."""
    B, H, W, Cin = x.shape
    Ho, Wo = offset.shape[1], offset.shape[2]
    KK, cg = K * K, Cin // G
    Q = Ho * Wo * KK
    acc = torch.promote_types(x.dtype, torch.float32)
    py, px = sample_positions(offset.to(acc), K, stride, padding, dilation,
                              G)                                # (B, G, Q)
    gc = g_cols.to(acc).reshape(B, Ho, Wo, G, KK, cg)
    m = mask.to(acc).reshape(B, Ho, Wo, G, KK, 1)
    gv = (gc * m).permute(0, 3, 1, 2, 4, 5).reshape(B, G, Q, cg)
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    ly = py - y0
    lx = px - x0
    # the four corners NW, NE, SW, SE on a new axis 2: (B, G, 4, Q)
    corner = torch.arange(4, device=x.device).view(1, 1, 4, 1)
    dy, dx = corner // 2, corner % 2
    iy = y0.long()[:, :, None] + dy
    ix = x0.long()[:, :, None] + dx
    sy = torch.where(dy == 1, ly[:, :, None], 1 - ly[:, :, None])
    sx = torch.where(dx == 1, lx[:, :, None], 1 - lx[:, :, None])
    valid = ((iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)).to(acc)
    idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(
        B, G, 4 * Q, 1).expand(-1, -1, -1, cg)
    xg = x.to(acc).reshape(B, H * W, G, cg).permute(0, 2, 1, 3)  # (B,G,HW,cg)
    xc = torch.gather(xg, 2, idx).view(B, G, 4, Q, cg) * valid[..., None]
    t = (xc * gv[:, :, None]).sum(-1)                          # (B, G, 4, Q)
    w = sy * sx * valid
    val = (xc * w[..., None]).sum(2)                            # (B, G, Q, cg)
    # d w / d ly is -sx on the floor row, +sx on the ceil row; likewise x
    d_ly = (torch.where(dy == 1, sx, -sx) * t).sum(2)
    d_lx = (torch.where(dx == 1, sy, -sy) * t).sum(2)
    d_xg = torch.zeros_like(xg).scatter_add_(
        2, idx, (gv[:, :, None] * w[..., None]).reshape(B, G, 4 * Q, cg))
    d_mask = (val.reshape(B, G, Ho, Wo, KK, cg).permute(0, 2, 3, 1, 4, 5)
              * gc).sum(-1).reshape(B, Ho, Wo, G * KK)
    d_off = torch.stack([d_ly, d_lx], -1).reshape(B, G, Ho, Wo, KK, 2)
    d_off = d_off.permute(0, 2, 3, 1, 4, 5).reshape(B, Ho, Wo, G * KK * 2)
    d_x = d_xg.permute(0, 2, 1, 3).reshape(B, H, W, Cin)
    return d_x.to(x.dtype), d_off.to(offset.dtype), d_mask.to(mask.dtype)


class _DcnIm2col(torch.autograd.Function):
    """dcn_im2col under autograd: the kernel forward,
    `dcn_im2col_backward_plain` backward."""

    @staticmethod
    def forward(ctx, x, offset, mask, K, stride, padding, dilation, G):
        ctx.save_for_backward(x, offset, mask)
        ctx.conv = (K, stride, padding, dilation, G)
        return _im2col_forward(x, offset, mask, K, stride, padding,
                               dilation, G)

    @staticmethod
    def backward(ctx, g_cols):
        x, offset, mask = ctx.saved_tensors
        with obs.span("dcn_im2col.backward"):
            grads = dcn_im2col_backward_plain(x, offset, mask, g_cols,
                                              *ctx.conv)
        return (*grads, None, None, None, None, None)


def dcn_im2col(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
               K: int, stride: int, padding: int, dilation: int,
               G: int) -> torch.Tensor:
    """The deformable im2col matrix (B*Ho*Wo, G*K*K*cg), columns (g, k, c).
    On CPU tensors: the plain version; on CUDA tensors: the `dcn_im2col`
    kernel's float32 or bfloat16 entry, by the tensors' dtype. offset and
    mask may be strided views. Under autograd (a tensor requires grad): the
    same forward with `dcn_im2col_backward_plain` as its backward, in
    either type."""
    if kernels.needs_grad(x, offset, mask):
        return _DcnIm2col.apply(x, offset, mask, K, stride, padding,
                                dilation, G)
    return _im2col_forward(x, offset, mask, K, stride, padding, dilation, G)


def _im2col_forward(x, offset, mask, K, stride, padding, dilation, G):
    """The forward of `dcn_im2col`: the plain version on CPU tensors, the
    kernel on CUDA tensors."""
    if x.device.type == "cpu":
        return dcn_im2col_plain(x, offset, mask, K, stride, padding,
                                dilation, G)
    dtype = kernels.require_cuda("dcn_im2col", DTYPES, x, offset, mask)
    B, H, W, Cin = x.shape
    Ho, Wo = output_size(H, W, K, stride, padding, dilation)
    if Cin % G or offset.shape != (B, Ho, Wo, G * K * K * 2) or \
            mask.shape != (B, Ho, Wo, G * K * K):
        raise ValueError(f"dcn_im2col: bad shapes x {tuple(x.shape)}, offset "
                         f"{tuple(offset.shape)}, mask {tuple(mask.shape)}")
    x = x.contiguous()
    offset, off_row = _pixel_rows(offset, 2)
    mask, mask_row = _pixel_rows(mask, 1)
    n_pix = B * Ho * Wo
    if max(x.numel(), n_pix * K * K * Cin,
           n_pix * max(off_row, mask_row)) >= 2 ** 31:
        raise ValueError("dcn_im2col: x, the columns or the offset / mask "
                         "rows span 2**31 elements or more (the kernel's "
                         "indices are 32-bit)")
    cg = Cin // G
    cols = torch.empty((B * Ho * Wo, G * K * K * cg), dtype=x.dtype,
                       device=x.device)
    lib = kernels.load("dcn_im2col", _SIGNATURES)
    err = lib.dcn_im2col_forward(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), cols.data_ptr(),
        B, H, W, Ho, Wo, G, cg, K, stride, padding, dilation, off_row,
        mask_row, int(dtype == torch.bfloat16),
        kernels.stream_handle(x.device))
    kernels.count("dcn_im2col", str(dtype).removeprefix("torch."))
    kernels.check(err, "dcn_im2col")
    return cols


def _contract(cols: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor | None, G: int) -> torch.Tensor:
    """The im2col matrix times the weight (Cout, Cin, K, K), whose columns
    are brought into the im2col's order (g, k, c), plus the bias, in one
    product in the columns' dtype."""
    Cout, Cin, K, _ = weight.shape
    cg = Cin // G
    w = weight.reshape(Cout, G, cg, K * K).transpose(2, 3).reshape(
        Cout, G * K * K * cg).to(cols.dtype)
    if bias is None:
        return cols @ w.t()
    return torch.addmm(bias.to(cols.dtype), cols, w.t())


def dcn_v2_plain(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor | None,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 dilation: int = 1, deformable_groups: int = 1
                 ) -> torch.Tensor:
    """The plain version of `dcn_v2`: `dcn_im2col_plain`, then one matrix
    product with the weights in x's dtype (in bfloat16 it accumulates in
    float32, adds the bias and rounds once). Returns (B, Ho, Wo, Cout)."""
    B = x.shape[0]
    Ho, Wo = offset.shape[1], offset.shape[2]
    cols = dcn_im2col_plain(x, offset, mask, kernel_size, stride, padding,
                            dilation, deformable_groups)
    return _contract(cols, weight, bias, deformable_groups).reshape(
        B, Ho, Wo, weight.shape[0])


def dcn_v2(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
           weight: torch.Tensor, bias: torch.Tensor | None,
           kernel_size: int = 3, stride: int = 1, padding: int = 1,
           dilation: int = 1, deformable_groups: int = 1) -> torch.Tensor:
    """Modulated deformable conv; returns (B, Ho, Wo, Cout)."""
    B, H, W, Cin = x.shape
    K, G = kernel_size, deformable_groups
    if Cin % G:
        raise ValueError("input channels must divide deformable_groups")
    Ho, Wo = output_size(H, W, K, stride, padding, dilation)
    if offset.shape != (B, Ho, Wo, G * K * K * 2) or \
            mask.shape != (B, Ho, Wo, G * K * K):
        raise ValueError(f"dcn_v2: offset {tuple(offset.shape)} / mask "
                         f"{tuple(mask.shape)} do not match the output grid")
    cols = dcn_im2col(x, offset, mask, K, stride, padding, dilation, G)
    return _contract(cols, weight, bias, G).reshape(B, Ho, Wo,
                                                    weight.shape[0])
