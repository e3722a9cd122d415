"""Bilinear resize as two separable matrix products — the counterpart of
motif_tpu/ops/resize.py (interpolate_bilinear, avg_pool2d) — and the
MATLAB antialiased bicubic resize of the data pipeline, on the host
(imresize_matlab_np).

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


@functools.lru_cache(maxsize=256)
def _matrix_on(in_size: int, out_size: int, align_corners: bool,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`resize_matrix_linear` as a tensor of `dtype` on `device`, kept so
    that a forward (which resizes some hundred times, at a handful of
    sizes) uploads each matrix once and not on every call. Read only. Made
    outside inference mode, so that a matrix first made by an eval serves
    a training step too (autograd saves it)."""
    with torch.inference_mode(False):
        return torch.as_tensor(resize_matrix_linear(in_size, out_size,
                                                    align_corners),
                               dtype=dtype, device=device)


def interpolate_bilinear(img: torch.Tensor, out_hw,
                         align_corners: bool = False) -> torch.Tensor:
    """F.interpolate(mode='bilinear') for NHWC images: (B, H, W, C) →
    (B, OH, OW, C)."""
    _, H, W, _ = img.shape
    OH, OW = int(out_hw[0]), int(out_hw[1])
    if (OH, OW) == (H, W):
        return img
    mh = _matrix_on(H, OH, align_corners, img.dtype, img.device)
    mw = _matrix_on(W, OW, align_corners, img.dtype, img.device)
    out = torch.einsum("oh,bhwc->bowc", mh, img)
    return torch.einsum("ow,bhwc->bhoc", mw, out)


def avg_pool2d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """F.avg_pool2d(window, stride=window) for NHWC (floor output size)."""
    B, H, W, C = x.shape
    OH, OW = H // window, W // window
    x = x[:, :OH * window, :OW * window]
    return x.reshape(B, OH, window, OW, window, C).mean(dim=(2, 4))


# ---------------------------------------------------------------------------
# MATLAB antialiased bicubic (imresize), reference data/util.py:261-392
# ---------------------------------------------------------------------------

def _cubic(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return ((1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0) * ((ax > 1) & (ax <= 2)))


@functools.lru_cache(maxsize=None)
def matlab_resize_matrix(in_size: int, out_size: int, scale: float,
                         antialiasing: bool = True) -> np.ndarray:
    """(out_size, in_size) float64 MATLAB bicubic matrix: the reference's
    calculate_weights_indices with its symmetric edge padding folded into
    the source index. Read only (cached)."""
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale
    x = np.arange(1, out_size + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    P = int(math.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(P)[None, :]  # 1-based positions
    dist = u[:, None] - indices
    if scale < 1 and antialiasing:
        weights = scale * _cubic(dist * scale)
    else:
        weights = _cubic(dist)
    weights = weights / np.sum(weights, axis=1, keepdims=True)
    # trim all-zero first/last columns (same rule as the reference)
    zero_cols = np.sum(weights == 0, axis=0)
    if not math.isclose(zero_cols[0], 0, rel_tol=1e-6):
        indices = indices[:, 1:P - 1]
        weights = weights[:, 1:P - 1]
    elif not math.isclose(zero_cols[-1], 0, rel_tol=1e-6):
        indices = indices[:, 0:P - 2]
        weights = weights[:, 0:P - 2]

    m = np.zeros((out_size, in_size), dtype=np.float64)
    # out-of-range positions mirror about the edge pixel (symmetric padding)
    idx0 = indices.astype(np.int64) - 1
    for i in range(out_size):
        for k in range(indices.shape[1]):
            j = idx0[i, k]
            if j < 0:
                j = -1 - j
            if j >= in_size:
                j = in_size - 1 - (j - in_size)
            j = min(max(j, 0), in_size - 1)
            m[i, j] += weights[i, k]
    return m


def imresize_matlab_np(img: np.ndarray, scale: float,
                       antialiasing: bool = True) -> np.ndarray:
    """MATLAB imresize of an (H, W, C) image on the host: out =
    ceil(in * scale) a side, the image taken as float32, rows then
    columns."""
    H, W = img.shape[:2]
    OH, OW = int(math.ceil(H * scale)), int(math.ceil(W * scale))
    mh = matlab_resize_matrix(H, OH, scale, antialiasing)
    mw = matlab_resize_matrix(W, OW, scale, antialiasing)
    out = np.tensordot(mh, img.astype(np.float32), axes=(1, 0))       # (OH, W, C)
    return np.moveaxis(np.tensordot(mw, out, axes=(1, 1)), 0, 1)      # (OH, OW, C)
