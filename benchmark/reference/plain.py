"""The three ops that the program runs as CUDA kernels, written as plain
PyTorch: the softmax splat with its count and max, the modulated
deformable convolution, and the SIREN MLP. Float32 (or float64) only:
the reference has no low-precision path. Autograd differentiates them,
so the reference's backward is worked out from these forwards."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .warp import pixel_grid


def _corners(flow: torch.Tensor, H: int, W: int):
    """Per corner (NW, NE, SW, SE) of each forward-warped pixel: the flat
    target index, the bilinear weight and whether it lies in the image."""
    gx, gy = pixel_grid(H, W, flow.device)
    fx = gx + flow[..., 0]
    fy = gy + flow[..., 1]
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    ix0, iy0 = x0.long(), y0.long()
    wx1, wy1 = fx - x0, fy - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    out = []
    for iy, ix, w in ((iy0, ix0, wy0 * wx0), (iy0, ix0 + 1, wy0 * wx1),
                      (iy0 + 1, ix0, wy1 * wx0),
                      (iy0 + 1, ix0 + 1, wy1 * wx1)):
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        idx = torch.where(valid, iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1),
                          torch.zeros_like(iy))
        out.append((idx, w, valid))
    return out


def splat_fused(img, flow, z, z_nonpositive: bool, scatter_dtype=None):
    """Softmax splat of img (B, H, W, C) along flow (B, H, W, 2) with
    importance z (B, H, W, 1): (sum of img * e^z, sum of e^z, the max of
    e^z * w over the hits and 1, the count of in-image corner hits), each
    (B, H, W, .). The max takes no gradient."""
    if scatter_dtype is not None:
        raise NotImplementedError("the reference sums in the input's dtype")
    B, H, W, C = img.shape
    HW = H * W
    ez = torch.exp(z)
    corners = _corners(flow, H, W)
    boff = (torch.arange(B, device=img.device) * HW)[:, None, None]
    ezf = ez.reshape(B, HW, 1)
    flat = torch.cat([img.reshape(B, HW, C) * ezf, ezf], dim=-1)
    acc = torch.zeros((B * HW, C + 2), dtype=img.dtype, device=img.device)
    for idx, w, valid in corners:
        wv = torch.where(valid, w, torch.zeros_like(w)).to(img.dtype)
        vals = torch.cat([flat * wv.reshape(B, HW, 1),
                          valid.to(img.dtype).reshape(B, HW, 1)], dim=-1)
        acc = acc.index_add(0, (idx + boff).reshape(-1),
                            vals.reshape(-1, C + 2))
    acc = acc.reshape(B, H, W, C + 2)
    if z_nonpositive:
        z_max = torch.ones((B, H, W, 1), dtype=img.dtype, device=img.device)
    else:
        with torch.no_grad():
            zm = torch.ones(B * HW, dtype=img.dtype, device=img.device)
            for idx, w, valid in corners:
                v = torch.where(valid, ez.reshape(B, H, W) * w.to(img.dtype),
                                torch.full_like(ez.reshape(B, H, W),
                                                -torch.inf))
                zm.scatter_reduce_(0, (idx + boff).reshape(-1),
                                   v.reshape(-1), "amax")
        z_max = zm.reshape(B, H, W, 1)
    return acc[..., :C], acc[..., C:C + 1], z_max, acc[..., C + 1:]


def _sample(x, py, px):
    """Bilinear samples of x (B, H, W, G*cg) at rows / columns (B, G, Q),
    zero outside the image: (B, Q, G, cg)."""
    B, H, W, Cin = x.shape
    G = py.shape[1]
    cg = Cin // G
    y0, x0 = torch.floor(py), torch.floor(px)
    ly, lx = py - y0, px - x0
    iy0, ix0 = y0.long(), x0.long()
    xg = x.reshape(B, H * W, G, cg).permute(0, 2, 1, 3)

    def corner(iy, ix, w):
        valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
        idx = torch.where(valid, iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1),
                          torch.zeros_like(iy))
        g = torch.gather(xg, 2, idx[..., None].expand(-1, -1, -1, cg))
        return g * (w * valid.to(w.dtype))[..., None]

    val = (corner(iy0, ix0, (1 - ly) * (1 - lx))
           + corner(iy0, ix0 + 1, (1 - ly) * lx)
           + corner(iy0 + 1, ix0, ly * (1 - lx))
           + corner(iy0 + 1, ix0 + 1, ly * lx))
    return val.permute(0, 2, 1, 3)


def dcn_v2(x, offset, mask, weight, bias, kernel_size: int = 3,
           stride: int = 1, padding: int = 1, dilation: int = 1,
           deformable_groups: int = 1):
    """Modulated deformable convolution (DCNv2), NHWC: x (B, H, W, Cin),
    offset (B, Ho, Wo, G*K*K*2) as (dy, dx) pairs, mask (B, Ho, Wo,
    G*K*K), weight (Cout, Cin, K, K). Returns (B, Ho, Wo, Cout)."""
    B, H, W, Cin = x.shape
    K, G = kernel_size, deformable_groups
    Ho, Wo = offset.shape[1], offset.shape[2]
    cg = Cin // G
    dev = x.device
    off = offset.reshape(B, Ho, Wo, G, K * K, 2)
    f32 = torch.float32
    oy = torch.arange(Ho, dtype=f32, device=dev) * stride - padding
    ox = torch.arange(Wo, dtype=f32, device=dev) * stride - padding
    ky = torch.arange(K, dtype=f32, device=dev).repeat_interleave(K) * dilation
    kx = (torch.arange(K, dtype=f32, device=dev) * dilation).repeat(K)
    py = oy[None, :, None, None, None] + ky + off[..., 0]
    px = ox[None, None, :, None, None] + kx + off[..., 1]
    Q = Ho * Wo * K * K
    py = py.permute(0, 3, 1, 2, 4).reshape(B, G, Q)
    px = px.permute(0, 3, 1, 2, 4).reshape(B, G, Q)
    val = _sample(x, py, px)                                    # (B, Q, G, cg)
    val = val.reshape(B, Ho, Wo, K * K, G, cg).permute(0, 1, 2, 4, 3, 5)
    val = val * mask.reshape(B, Ho, Wo, G, K * K, 1)
    cols = val.reshape(B * Ho * Wo, G * K * K * cg)
    Cout = weight.shape[0]
    w = weight.reshape(Cout, G, cg, K * K).transpose(2, 3).reshape(
        Cout, G * K * K * cg)
    out = cols @ w.t() if bias is None else torch.addmm(bias, cols, w.t())
    return out.reshape(B, Ho, Wo, Cout)


def siren_mlp(x, weights, biases, omega0: float = 30.0,
              sine_last: bool = False, skip_first: bool = False):
    """A SIREN MLP: a linear layer per weight with sin(omega0 * .) between
    layers, the last layer linear unless `sine_last`; with `skip_first`,
    x is the first layer's pre-activation and the layers given follow
    it."""
    if skip_first:
        x = torch.sin(omega0 * x)
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = F.linear(x, w, b)
        if i < n - 1 or sine_last:
            x = torch.sin(omega0 * x)
    return x
