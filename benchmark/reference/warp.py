"""Backward warping with torch grid_sample semantics — the counterpart of
motif_tpu/ops/warp.py (grid_sample, backwarp, bilinear_sampler).

Written as explicit corner gathers over NHWC images, in the JAX package's
float-op order, rather than through F.grid_sample: non-finite coordinates
must be skipped exactly as the JAX package skips them (they are routed far
out of bounds, so every corner drops).
"""

from __future__ import annotations

import torch


def _unnormalize(coord: torch.Tensor, size: int,
                 align_corners: bool) -> torch.Tensor:
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _reflect(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    span = hi - lo
    x = (x - lo).abs()
    frac = torch.remainder(x, 2.0 * span)
    return lo + torch.where(frac > span, 2.0 * span - frac, frac)


def _gather2d(img: torch.Tensor, iy: torch.Tensor,
              ix: torch.Tensor) -> torch.Tensor:
    """img[b, iy, ix, :] for in-bounds integer maps iy/ix of shape (B, ...)."""
    B, H, W, C = img.shape
    idx = (iy * W + ix).reshape(B, -1, 1).expand(-1, -1, C)
    out = torch.gather(img.reshape(B, H * W, C), 1, idx)
    return out.reshape(iy.shape + (C,))


def grid_sample(img: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                padding_mode: str = "zeros",
                align_corners: bool = False) -> torch.Tensor:
    """F.grid_sample for NHWC images. img (B, H, W, C); grid (B, Hg, Wg, 2)
    normalised (x, y). Returns (B, Hg, Wg, C)."""
    B, H, W, C = img.shape
    x = _unnormalize(grid[..., 0], W, align_corners)
    y = _unnormalize(grid[..., 1], H, align_corners)
    finite = torch.isfinite(x) & torch.isfinite(y)
    far = torch.full_like(x, -1e9)
    x = torch.where(finite, x, far)
    y = torch.where(finite, y, far)

    if padding_mode == "border":
        x = x.clamp(0.0, W - 1)
        y = y.clamp(0.0, H - 1)
    elif padding_mode == "reflection":
        if align_corners:
            x = _reflect(x, 0.0, float(W - 1))
            y = _reflect(y, 0.0, float(H - 1))
        else:
            x = _reflect(x, -0.5, W - 0.5).clamp(0.0, W - 1)
            y = _reflect(y, -0.5, H - 0.5).clamp(0.0, H - 1)
    elif padding_mode != "zeros":
        raise ValueError(f"unknown padding_mode {padding_mode!r}")

    if mode == "nearest":
        ix = torch.round(x).long()  # half to even, as torch's nearbyint
        iy = torch.round(y).long()
        out = _gather2d(img, iy.clamp(0, H - 1), ix.clamp(0, W - 1))
        if padding_mode == "zeros":
            valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            out = out * valid[..., None].to(img.dtype)
        return out
    if mode != "bilinear":
        raise ValueError(f"unknown mode {mode!r}")

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    ix0 = x0.long()
    iy0 = y0.long()
    ix1 = ix0 + 1
    iy1 = iy0 + 1

    out = None
    for iy_c, ix_c, w in ((iy0, ix0, wy0 * wx0), (iy0, ix1, wy0 * wx1),
                          (iy1, ix0, wy1 * wx0), (iy1, ix1, wy1 * wx1)):
        if padding_mode == "zeros":
            valid = (ix_c >= 0) & (ix_c < W) & (iy_c >= 0) & (iy_c < H)
            w = w * valid.to(w.dtype)
        v = _gather2d(img, iy_c.clamp(0, H - 1), ix_c.clamp(0, W - 1))
        term = v * w[..., None].to(img.dtype)
        out = term if out is None else out + term
    return out


def pixel_grid(H: int, W: int, device):
    """(gx (1, 1, W), gy (1, H, 1)) float32 pixel coordinates — the JAX
    package builds these in float32 too, whatever the flow's dtype."""
    gx = torch.arange(W, dtype=torch.float32, device=device)[None, None]
    gy = torch.arange(H, dtype=torch.float32, device=device)[None, :, None]
    return gx, gy


def backwarp(img: torch.Tensor, flow: torch.Tensor, clip: bool = True,
             mode: str = "bilinear"):
    """The reference BackWarp: img (B, H, W, C), flow (B, H, W, 2) pixel
    displacements (u, v); normalised by x/W, then sampled with
    align_corners=True; clip=True is border padding. Returns (warped,
    grid)."""
    B, H, W, _ = flow.shape
    gx, gy = pixel_grid(H, W, flow.device)
    x = gx + flow[..., 0]
    y = gy + flow[..., 1]
    x = (x / W) * 2.0 - 1.0
    y = (y / H) * 2.0 - 1.0
    grid = torch.stack([x, y], dim=-1)
    pad = "border" if clip else "zeros"
    return grid_sample(img, grid, mode=mode, padding_mode=pad,
                       align_corners=True), grid


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor,
                     mask: bool = False):
    """RAFT's bilinear_sampler: coords (B, Hg, Wg, 2) in pixels (x, y),
    normalised by size - 1, bilinear, align_corners=True, zero padding."""
    _, H, W, _ = img.shape
    xgrid = 2.0 * coords[..., 0] / (W - 1) - 1.0
    ygrid = 2.0 * coords[..., 1] / (H - 1) - 1.0
    grid = torch.stack([xgrid, ygrid], dim=-1)
    out = grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                      align_corners=True)
    if mask:
        m = (xgrid > -1) & (ygrid > -1) & (xgrid < 1) & (ygrid < 1)
        return out, m.to(img.dtype)
    return out


def flow_warp(x: torch.Tensor, flow: torch.Tensor,
              interp_mode: str = "bilinear", padding_mode: str = "zeros",
              align_corners: bool = False) -> torch.Tensor:
    """The reference's module_util.flow_warp (module_util.py:55): x (B, H,
    W, C) sampled at the pixel grid plus flow (B, H, W, 2) = (u, v) in
    pixels, normalised by max(size - 1, 1)."""
    _, H, W, _ = x.shape
    gx, gy = pixel_grid(H, W, flow.device)
    vx = gx + flow[..., 0]
    vy = gy + flow[..., 1]
    vx = 2.0 * vx / max(W - 1, 1) - 1.0
    vy = 2.0 * vy / max(H - 1, 1) - 1.0
    grid = torch.stack([vx, vy], dim=-1)
    return grid_sample(x, grid, mode=interp_mode, padding_mode=padding_mode,
                       align_corners=align_corners)
