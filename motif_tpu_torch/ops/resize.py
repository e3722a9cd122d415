"""Bilinear resize as two separable matrix products — the counterpart of
motif_tpu/ops/resize.py (interpolate_bilinear, avg_pool2d).

The (out, in) interpolation matrices are built on the host in float64 and
cast to the image dtype, exactly as the JAX package does, so both packages
apply the same weights in the same order (rows first, then columns).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def resize_matrix_linear(in_size: int, out_size: int,
                         align_corners: bool) -> np.ndarray:
    """(out_size, in_size) float64 matrix of torch 1-D linear interpolation
    (F.interpolate semantics, including the clamp of negative source
    positions when align_corners=False)."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if out_size == in_size:
        np.fill_diagonal(m, 1.0)
        return m
    for i in range(out_size):
        if align_corners:
            src = i * (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        else:
            src = max((i + 0.5) * in_size / out_size - 0.5, 0.0)
        x0 = min(int(math.floor(src)), in_size - 1)
        x1 = min(x0 + 1, in_size - 1)
        lam = src - x0
        m[i, x0] += 1.0 - lam
        m[i, x1] += lam
    return m


def interpolate_bilinear(img: torch.Tensor, out_hw,
                         align_corners: bool = False) -> torch.Tensor:
    """F.interpolate(mode='bilinear') for NHWC images: (B, H, W, C) →
    (B, OH, OW, C)."""
    _, H, W, _ = img.shape
    OH, OW = int(out_hw[0]), int(out_hw[1])
    if (OH, OW) == (H, W):
        return img
    mh = torch.as_tensor(resize_matrix_linear(H, OH, align_corners),
                         dtype=img.dtype, device=img.device)
    mw = torch.as_tensor(resize_matrix_linear(W, OW, align_corners),
                         dtype=img.dtype, device=img.device)
    out = torch.einsum("oh,bhwc->bowc", mh, img)
    return torch.einsum("ow,bhwc->bhoc", mw, out)


def avg_pool2d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """F.avg_pool2d(window, stride=window) for NHWC (floor output size)."""
    B, H, W, C = x.shape
    OH, OW = H // window, W // window
    x = x[:, :OH * window, :OW * window]
    return x.reshape(B, OH, window, OW, window, C).mean(dim=(2, 4))
