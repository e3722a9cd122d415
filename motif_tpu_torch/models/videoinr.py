"""VideoINR, the reference's `LIIF` model — the counterpart of
motif_tpu/models/videoinr.py: the ZSM trunk and three SIRENs, feat_imnet
(the HR feature field), flow_imnet (the motion field: two backward flows)
and encode_imnet (RGB from the doubly warped samples). NHWC, under the
reference module names; the upsampling head the reference checkpoints but
never runs (upconv1, upconv2, HRconv, conv_last) is kept, so that a
reference `.pth` loads with strict=True.

The SIRENs run whole through `siren_mlp` (the CUDA kernel on CUDA tensors):
at two LQ frames and nf 64 they are 201→64→64→256→64, 263→64→64→256→4 and
525→64→64→256→256→3 wide, which the kernel runs in several launches
(`siren_kernel.segments`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from motif_tpu_torch.models.encoder import ZSMEncoder
from motif_tpu_torch.models.layers import Conv2d
from motif_tpu_torch.models.motif import liif_nearest_axis, make_coord_1d
from motif_tpu_torch.models.siren import Siren
from motif_tpu_torch.ops.warp import grid_sample


@functools.lru_cache(maxsize=None)
def _linspace(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """np.linspace(-1, 1, n) as a tensor of `dtype` on `device`, uploaded
    once per (n, dtype, device) and not on every call (a forward captured
    into a CUDA graph may not upload, and reads it where it lies: kept for
    the process's life). Read only; made outside inference mode, as
    `ops/resize.py::_matrix_on`."""
    with torch.inference_mode(False):
        return torch.as_tensor(np.linspace(-1.0, 1.0, n), dtype=dtype,
                               device=device)


@functools.lru_cache(maxsize=None)
def _liif_tables(H: int, W: int, HH: int, WW: int, dtype: torch.dtype,
                 device: torch.device):
    """The LIIF nearest indices, the rel coords (float32, clamped HR cell
    centres, no eps shift, then `dtype`) and the bilinear grid of the HR
    cell centres (float32), as the JAX package builds them; built and
    uploaded once per shapes, dtype and device, as `_linspace`. Read
    only."""
    iy, _ = liif_nearest_axis(H, HH, 0.0)
    ix, _ = liif_nearest_axis(W, WW, 0.0)
    hy = np.clip(make_coord_1d(HH), -1 + 1e-6, 1 - 1e-6)
    hx = np.clip(make_coord_1d(WW), -1 + 1e-6, 1 - 1e-6)
    rel_y = ((hy - make_coord_1d(H)[iy]) * H).astype(np.float32)
    rel_x = ((hx - make_coord_1d(W)[ix]) * W).astype(np.float32)
    rel = np.stack(np.meshgrid(rel_y, rel_x, indexing="ij"), -1)
    grid = np.stack(np.meshgrid(hx, hy, indexing="xy"), -1)
    with torch.inference_mode(False):
        return (torch.as_tensor(iy, device=device),
                torch.as_tensor(ix, device=device),
                torch.as_tensor(rel, device=device).to(dtype),
                torch.as_tensor(grid, dtype=torch.float32, device=device))


def _warpgrid(flow: torch.Tensor) -> torch.Tensor:
    """The reference warplayer.warpgrid: the normalised backward grid, base
    plus flow / ((size - 1) / 2), channels (x, y). flow (B, HH, WW, 2)."""
    B, H, W, _ = flow.shape
    gx = _linspace(W, flow.dtype, flow.device)[None, None, :].expand(B, H, W)
    gy = _linspace(H, flow.dtype, flow.device)[None, :, None].expand(B, H, W)
    u = flow[..., 0] / ((W - 1.0) / 2.0)
    v = flow[..., 1] / ((H - 1.0) / 2.0)
    return torch.stack([gx + u, gy + v], dim=-1)


class VideoINR(ZSMEncoder):
    """forward(x (B, n_frames, H, W, 3), times (B, Nt), out_hw) → a list of
    Nt frames (B, HH, WW, 3), one per time, as the reference returns them.
    The SIRENs' input widths follow `nf` and `n_frames` (the reference
    takes 2 frames)."""

    def __init__(self, nf: int = 64, front_rbs: int = 5, back_rbs: int = 40,
                 groups: int = 8, n_frames: int = 2):
        super().__init__(nf, front_rbs, back_rbs, groups)
        self.n_frames = n_frames
        T = 2 * n_frames - 1
        self.upconv1 = Conv2d(nf, nf * 4, 3, 1, 1)
        self.upconv2 = Conv2d(nf, 64 * 4, 3, 1, 1)
        self.HRconv = Conv2d(64, 64, 3, 1, 1)
        self.conv_last = Conv2d(64, 3, 3, 1, 1)
        c_inp = 3 * n_frames
        self.feat_imnet = Siren(T * nf + c_inp + 3, [64, 64, 256], 2, 64)
        self.flow_imnet = Siren(64 + T * nf + c_inp + 1, [64, 64, 256], 2, 4)
        self.encode_imnet = Siren(2 * 64 + 2 * T * nf + 2 * c_inp + 1,
                                  [64, 64, 256, 256], 3, 3)

    def forward(self, x: torch.Tensor, times: torch.Tensor, out_hw):
        B, N, H, W, C = x.shape
        if N != self.n_frames:
            raise ValueError(f"VideoINR built for {self.n_frames} frames "
                             f"got {N}")
        HH, WW = out_hw
        feat_t = self.trunk(self.interleaved(x))          # (B, T, H, W, nf)
        T = feat_t.shape[1]
        feat = torch.cat([feat_t[:, i] for i in range(T)], dim=-1)
        inp = x.reshape(B, H, W, N * C)   # the frames' memory, as the JAX
        #                                   package reads it

        iy, ix, rel, grid = _liif_tables(H, W, HH, WW, x.dtype, x.device)
        rel = rel[None].expand(B, HH, WW, 2)
        grid = grid[None].expand(B, HH, WW, 2)

        def up_nearest(img):
            return img.index_select(1, iy).index_select(2, ix)

        def up_bilinear(img):
            return grid_sample(img, grid, "bilinear", "zeros", False)

        def mlp(net, v, width):
            return net(v.reshape(B, HH * WW, -1)).reshape(B, HH, WW, width)

        q_feat, q_inp = up_nearest(feat), up_nearest(inp)
        q_feat0, q_inp_b = up_bilinear(feat), up_bilinear(inp)
        preds = []
        for c in range(times.shape[1]):
            pe = times[:, c].reshape(B, 1, 1, 1).expand(B, HH, WW, 1).to(
                x.dtype)
            hr_feat = mlp(self.feat_imnet,
                          torch.cat([q_feat, q_inp, rel, pe], -1), 64)
            flow = mlp(self.flow_imnet,
                       torch.cat([hr_feat, q_feat0, q_inp_b, pe], -1), 4)
            g1 = _warpgrid(flow[..., :2]).clamp(-1 + 1e-6, 1 - 1e-6)
            g2 = _warpgrid(flow[..., 2:]).clamp(-1 + 1e-6, 1 - 1e-6)
            samples = [grid_sample(img, g, "bilinear", "zeros", False)
                       for img, g in ((hr_feat, g1), (hr_feat, g2),
                                      (feat, g1), (feat, g2), (inp, g1),
                                      (inp, g2))]
            preds.append(mlp(self.encode_imnet, torch.cat([*samples, pe], -1),
                             3))
        return preds
