"""Training losses, the counterpart of motif_tpu/losses.py (reference
models/modules/loss.py and VideoSR_base_model.py:48-59,127-158).

Every criterion is sum-reduced except `lap_loss`, whose levels are means,
as in the reference. Tensors are NHWC: (..., H, W, C).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def charbonnier(x: torch.Tensor, y: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """CharbonnierLoss (loss.py:7-17): sum(sqrt(diff^2 + eps)). The
    reference adds eps, not eps^2, inside the sqrt."""
    diff = x - y
    return torch.sum(torch.sqrt(diff * diff + eps))


def l1_sum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(x - y))


def l2_sum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum((x - y) ** 2)


def gauss_kernel5(sigma: float = 2.0) -> np.ndarray:
    """LapLoss's 5x5 kernel (loss.py:19-33), float32. The reference's
    `gaussian` squares exp((x - c)^2 / (-2 s^2)) and sums the two
    coordinates' terms instead of multiplying them; kept as it is."""
    size = 5
    grid = np.float32(np.mgrid[0:size, 0:size].T)
    gaussian = lambda x: np.exp((x - size // 2) ** 2 / (-2 * sigma ** 2)) ** 2  # noqa: E731
    kernel = np.sum(gaussian(grid), axis=2)
    kernel /= np.sum(kernel)
    return kernel.astype(np.float32)


def lap_loss(x: torch.Tensor, y: torch.Tensor,
             max_levels: int = 5) -> torch.Tensor:
    """LapLoss (loss.py:56-77): the mean L1 distance of the Laplacian
    pyramids' levels (blur with edge padding, 2x2 mean pool), plus the
    coarsest level's. Leading dims are flattened into the batch."""
    C = x.shape[-1]
    k = torch.as_tensor(gauss_kernel5(), device=x.device).to(x.dtype)
    kern = k[None, None].expand(C, 1, 5, 5)

    def blur(img):                                   # (B, H, W, C)
        p = F.pad(img.permute(0, 3, 1, 2), (2, 2, 2, 2), mode="replicate")
        return F.conv2d(p, kern, groups=C).permute(0, 2, 3, 1)

    def pool(img):
        B, H, W, _ = img.shape
        return img[:, :H // 2 * 2, :W // 2 * 2].reshape(
            B, H // 2, 2, W // 2, 2, C).mean((2, 4))

    xf = x.reshape((-1,) + tuple(x.shape[-3:]))
    yf = y.reshape((-1,) + tuple(y.shape[-3:]))
    loss = 0.0
    for _ in range(max_levels):
        bx, by = blur(xf), blur(yf)
        loss = loss + torch.mean(torch.abs((xf - bx) - (yf - by)))
        xf, yf = pool(bx), pool(by)
    return loss + torch.mean(torch.abs(xf - yf))


PIXEL_CRITERIA = {
    "l1": l1_sum,
    "l2": l2_sum,
    "cb": charbonnier,
    "lp": lap_loss,
}
