"""RAFT correlation and PWC-Net's local cost volume — the counterpart of
motif_tpu/ops/corr.py (all_pairs_corr, corr_pyramid, corr_lookup,
local_corr). These are XLA, not Pallas, in
the JAX package, so plain PyTorch is their port.

The lookup keeps the reference's delta pairing: the window's first axis
displaces x and its second displaces y (meshgrid(dy, dx) added onto (x, y)
coordinates, RAFT corr.py). It is computed as the JAX package computes it,
with separable bilinear hat weights contracted against the correlation
rows and columns, which equals per-corner bilinear sampling with zero
padding.
"""

from __future__ import annotations

import math

import torch

from .resize import avg_pool2d


def all_pairs_corr(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """fmap1/fmap2 (B, H, W, C) → (B*H*W, H, W, 1), scaled by 1/sqrt(C).
    Accumulated and returned in at least float32, as the JAX package does
    (bfloat16 features are widened first: their products are exact in
    float32), so the pyramid and the lookup stay float32 under a bfloat16
    compute dtype."""
    B, H, W, C = fmap1.shape
    acc = torch.promote_types(fmap1.dtype, torch.float32)
    a = fmap1.reshape(B, H * W, C).to(acc)
    b = fmap2.reshape(B, H * W, C).to(acc)
    corr = torch.bmm(a, b.transpose(1, 2)) / math.sqrt(C)
    return corr.reshape(B * H * W, H, W, 1)


def corr_pyramid(corr: torch.Tensor, num_levels: int = 4) -> list:
    """Average-pool pyramid over the target dims."""
    min_dim = min(corr.shape[1], corr.shape[2])
    if min_dim < 2 ** (num_levels - 1):
        raise ValueError(
            f"correlation map {corr.shape[1]}x{corr.shape[2]} too small for "
            f"a {num_levels}-level pyramid; use inputs of at least "
            f"{8 * 2 ** (num_levels - 1)} px per side")
    pyr = [corr]
    for _ in range(num_levels - 1):
        corr = avg_pool2d(corr, 2)
        pyr.append(corr)
    return pyr


def _hat_weights(center: torch.Tensor, size: int,
                 offsets: torch.Tensor) -> torch.Tensor:
    """w[p, s, o] = max(0, 1 - |center[p] + offsets[o] - s|)."""
    s = torch.arange(size, dtype=torch.float32, device=center.device)
    pos = center[:, None] + offsets[None, :]
    d = (pos[:, None, :] - s[None, :, None]).abs()
    return torch.clamp(1.0 - d, min=0.0)


def corr_lookup(pyramid: list, coords: torch.Tensor,
                radius: int) -> torch.Tensor:
    """pyramid[i] (B*H*W, H/2^i, W/2^i, 1); coords (B, H, W, 2) pixel (x, y)
    → (B, H, W, levels * (2r+1)^2), level-major, then window x-major."""
    B, H, W, _ = coords.shape
    n = 2 * radius + 1
    offs = torch.linspace(-radius, radius, n, dtype=torch.float32,
                          device=coords.device)
    P = B * H * W
    cx = coords[..., 0].reshape(P)
    cy = coords[..., 1].reshape(P)
    out = []
    for i, corr in enumerate(pyramid):
        h2, w2 = corr.shape[1], corr.shape[2]
        c = corr.reshape(P, h2, w2)
        sc = 1.0 / (2 ** i)
        vx = _hat_weights(cx * sc, w2, offs).to(c.dtype)   # (P, w2, n)
        vy = _hat_weights(cy * sc, h2, offs).to(c.dtype)   # (P, h2, n)
        t1 = torch.bmm(c, vx)                              # (P, h2, n): x-disp a
        lvl = torch.bmm(t1.transpose(1, 2), vy)            # (P, n_a, n_b)
        out.append(lvl.reshape(B, H, W, n * n))
    return torch.cat(out, dim=-1)


def local_corr(f1: torch.Tensor, f2: torch.Tensor,
               max_disp: int = 4) -> torch.Tensor:
    """PWC-Net's local cost volume (OpticalFlow/correlation.py): f1, f2 (B,
    H, W, C) -> (B, H, W, (2d+1)²), channel (dy+d)·(2d+1) + (dx+d) =
    mean over c of f1[y, x, c] · f2[y+dy, x+dx, c], zero outside f2."""
    _, H, W, _ = f1.shape
    d = max_disp
    f2p = torch.nn.functional.pad(f2, (0, 0, d, d, d, d))
    outs = []
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            shifted = f2p[:, dy + d:dy + d + H, dx + d:dx + d + W]
            outs.append((f1 * shifted).mean(-1))
    return torch.stack(outs, dim=-1)
