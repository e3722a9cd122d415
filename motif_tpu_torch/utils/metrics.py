"""Evaluation metrics, the counterpart of motif_tpu/utils/metrics.py:
Y-channel PSNR with the anchor / inter / center split of the reference
test.py, and MATLAB-style SSIM. numpy, float64, as there.

SSIM filters with the Gaussian window's two 1-D factors, one axis at a time,
where the JAX package convolves with the 2-D outer product; over the same
valid region the two agree to the last bits and the separable form is about
a hundred times faster at 256x448.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.ndimage import correlate1d


def rgb_to_y(img: np.ndarray) -> np.ndarray:
    """BT.601 Y channel from RGB in [0,1] → [0,1]-ish, exactly as
    test.py:212-217: Y = ((R*65.481 + G*128.553 + B*24.966)/255 + 16)/255
    applied to [0,255]-scaled inputs. img: (..., 3) channel-last."""
    x = img * 255.0
    y = (x[..., 0] * 65.481 + x[..., 1] * 128.553 + x[..., 2] * 24.966) / 255.0 + 16.0
    return y / 255.0


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * math.log10(peak ** 2 / mse)


def psnr_255(img1: np.ndarray, img2: np.ndarray) -> float:
    """PSNR of images in [0, 255]."""
    return psnr(img1, img2, peak=255.0)


def _gaussian_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """cv2.getGaussianKernel(11, 1.5): the factor of the SSIM window."""
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(ax ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The 2-D SSIM window: the outer product of `_gaussian_1d`."""
    k = _gaussian_1d(size, sigma)
    return np.outer(k, k)


def _filter_valid(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """x filtered by outer(k, k) over the valid region (each side loses
    len(k) // 2), one axis at a time. The window is symmetric, so
    correlation is convolution; the border mode never reaches the crop."""
    r = len(k) // 2
    x = correlate1d(x, k, axis=0, mode="constant")[r:-r]
    return correlate1d(x, k, axis=1, mode="constant")[:, r:-r]


def ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    """MATLAB-style SSIM of two 2-D images in [0, 255]: the filtered
    moments over the valid region (cv2.filter2D then the [5:-5] crop of
    the reference)."""
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    k = _gaussian_1d()

    mu1 = _filter_valid(img1, k)
    mu2 = _filter_valid(img2, k)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = _filter_valid(img1 ** 2, k) - mu1_sq
    s2 = _filter_valid(img2 ** 2, k) - mu2_sq
    s12 = _filter_valid(img1 * img2, k) - mu1_mu2
    m = ((2 * mu1_mu2 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return float(m.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """SSIM of a 2-D image, or the mean over the channels of an (H, W, C)
    one (one channel: that channel)."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    if img1.ndim == 2:
        return ssim_single(img1, img2)
    if img1.ndim == 3:
        if img1.shape[2] == 1:
            return ssim_single(img1[..., 0], img2[..., 0])
        return float(np.mean([ssim_single(img1[..., i], img2[..., i])
                              for i in range(img1.shape[2])]))
    raise ValueError("Wrong input image dimensions.")


def eval_psnr_split(real: np.ndarray, fake: np.ndarray):
    """The test.py:223-235 per-batch PSNR split on Y-channel images of
    shape (n, H, W): returns (anchor, inter, center, weighted, per_frame)."""
    n = real.shape[0]
    mse = np.mean((real.astype(np.float64) - fake.astype(np.float64)) ** 2,
                  axis=tuple(range(1, real.ndim)))
    per = 10 * np.log10(1.0 / mse)
    p_anchor = float(per[0])
    p_inter = float(np.mean(per[1:-1])) if n > 2 else float(np.mean(per[1:]))
    p_center = float(per[len(per) // 2])
    p = (p_anchor + p_inter * (n - 2)) / (n - 1)
    return p_anchor, p_inter, p_center, float(p), per
