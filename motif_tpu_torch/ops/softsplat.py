"""Forward (softmax) splatting — the counterpart of
motif_tpu/ops/softsplat.py::splat_fused, with the CUDA kernel `splat_fused`
(csrc/splat_fused.cu), which replaces the TPU kernel
motif_tpu/ops/softsplat_pallas.py::_splat_kernel and the ones-initialised
max splat. The kernel bins the sources by the target tiles their corners
reach and accumulates each tile in shared memory, max included, writing
every output once: no fill, no float atomic to device memory, one C call
per splat, no host synchronisation.

Layout: NHWC. img (B, H, W, C), flow (B, H, W, 2) = (dx, dy) in pixels,
z (B, H, W, 1). Source and target grids have the same shape.
"""

from __future__ import annotations

import ctypes

import torch

from motif_tpu_torch.ops import kernels
from motif_tpu_torch.ops.warp import pixel_grid

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"splat_fused_forward": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                        _I, _I, _I, _I, _P]}
TILE = (8, 8)            # the target tile at MoTIF's C = 130 (38 KB;
                         # faster than 4x16, 8x16, 16x8 and 4x8 on an H100)
STAGE_BYTES = 128 * 32   # the kernel's staged tile records (CHUNK of them)
SMEM_LIMIT = 232_448     # shared memory a block may use on Hopper


def _corner_data(flow: torch.Tensor, H: int, W: int):
    """Per-corner (flat index, bilinear weight, validity), NW NE SW SE, in
    the JAX package's float-op order."""
    gx, gy = pixel_grid(H, W, flow.device)
    fx = gx + flow[..., 0]
    fy = gy + flow[..., 1]
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    ix0 = x0.long()
    iy0 = y0.long()
    wx1 = fx - x0
    wy1 = fy - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    corners = []
    for iy, ix, w in ((iy0, ix0, wy0 * wx0), (iy0, ix0 + 1, wy0 * wx1),
                      (iy0 + 1, ix0, wy1 * wx0), (iy0 + 1, ix0 + 1, wy1 * wx1)):
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        idx = torch.where(valid, iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1),
                          torch.zeros_like(iy))
        corners.append((idx, w, valid))
    return corners


def splat_fused_plain(img: torch.Tensor, flow: torch.Tensor, z: torch.Tensor,
                      z_nonpositive: bool):
    """The plain version of `splat_fused`: one `index_add_` per corner into
    a (B*H*W, C + 2) accumulator, and `scatter_reduce("amax")` over ones for
    the max. Same contract as `splat_fused`."""
    B, H, W, C = img.shape
    HW = H * W
    ez = torch.exp(z)
    corners = _corner_data(flow, H, W)
    boff = (torch.arange(B, device=img.device) * HW)[:, None, None]
    ezf = ez.reshape(B, HW, 1)
    flat = torch.cat([img.reshape(B, HW, C) * ezf, ezf], dim=-1)
    acc = torch.zeros((B * HW, C + 2), dtype=img.dtype, device=img.device)
    for idx, w, valid in corners:
        wv = torch.where(valid, w, torch.zeros_like(w)).to(img.dtype)
        vals = torch.cat([flat * wv.reshape(B, HW, 1),
                          valid.to(img.dtype).reshape(B, HW, 1)], dim=-1)
        acc.index_add_(0, (idx + boff).reshape(-1), vals.reshape(-1, C + 2))
    acc = acc.reshape(B, H, W, C + 2)
    if z_nonpositive:
        z_max = torch.ones((B, H, W, 1), dtype=img.dtype, device=img.device)
    else:
        zm = torch.ones(B * HW, dtype=img.dtype, device=img.device)
        for idx, w, valid in corners:
            v = torch.where(valid, ez.reshape(B, H, W) * w.to(img.dtype),
                            torch.full_like(ez.reshape(B, H, W), -torch.inf))
            zm.scatter_reduce_(0, (idx + boff).reshape(-1), v.reshape(-1),
                               "amax")
        z_max = zm.reshape(B, H, W, 1)
    return acc[..., :C], acc[..., C:C + 1], z_max, acc[..., C + 1:]


def plan(C: int) -> tuple[int, int]:
    """The kernel's target tile (th, tw) for C payload channels: the first
    of 8x8, 4x8, 2x8, 1x8, 1x4, 1x2, 1x1 whose [th * tw, C + 3] float
    tile (the sums, norm, count and max) fits in a block's shared memory
    beside the staged records. Raises when not even one pixel fits."""
    th, tw = TILE
    while th * tw * (C + 3) * 4 + STAGE_BYTES > SMEM_LIMIT:
        if th > 1:
            th //= 2
        elif tw > 1:
            tw //= 2
        else:
            raise ValueError(f"splat_fused: C = {C} channels of one pixel "
                             f"exceed the {SMEM_LIMIT} B of shared memory a "
                             f"block may use")
    return th, tw


def splat_fused(img: torch.Tensor, flow: torch.Tensor, z: torch.Tensor,
                z_nonpositive: bool):
    """Fused softmax splat + count splat, and the max splat unless
    `z_nonpositive` (z <= 0 everywhere makes e^z * w <= 1, so the
    ones-initialised max is identically 1 — exact). The caller decides
    `z_nonpositive` from what it knows of z (MoTIF: from alpha).

    Returns (out, norm, z_max, count):
      out   = splat_sum(img * e^z)          (B, H, W, C)
      norm  = splat_sum(e^z)                (B, H, W, 1)
      z_max = max(1, max-splat(e^z * w))    (B, H, W, 1)
      count = unweighted in-image corner hits (B, H, W, 1)
    On CPU tensors: the plain version; on CUDA tensors: the kernel, which
    sums in an order that varies from run to run (the count and z_max are
    exact).
    """
    if img.device.type == "cpu":
        return splat_fused_plain(img, flow, z, z_nonpositive)
    kernels.require_cuda_float32("splat_fused", img, flow, z)
    B, H, W, C = img.shape
    if flow.shape != (B, H, W, 2) or z.shape != (B, H, W, 1):
        raise ValueError(f"splat_fused: bad shapes img {tuple(img.shape)}, "
                         f"flow {tuple(flow.shape)}, z {tuple(z.shape)}")
    if 4 * B * H * W >= 2 ** 31:
        raise ValueError(f"splat_fused: {B * H * W} pixels exceed the "
                         f"kernel's 32-bit tile lists")
    th, tw = plan(C)
    n_pix = B * H * W
    n_tiles = B * -(-H // th) * -(-W // tw)
    img, flow = img.contiguous(), flow.contiguous()
    ez = torch.exp(z).contiguous()
    # acc and z_max in one allocation; in the other the tile lists (each
    # source in at most 4 tiles, a 32-byte record each), the counters and
    # the offsets. One C call: a memset and four kernels on the current
    # stream, no host synchronisation.
    buf = torch.empty(n_pix * (C + 3), dtype=img.dtype, device=img.device)
    work = torch.empty(32 * n_pix + 2 * n_tiles + 1, dtype=torch.int32,
                       device=img.device)
    acc = buf[:n_pix * (C + 2)].view(B, H, W, C + 2)
    z_max = buf[n_pix * (C + 2):].view(B, H, W, 1)
    lib = kernels.load("splat_fused", _SIGNATURES)
    err = lib.splat_fused_forward(
        img.data_ptr(), flow.data_ptr(), ez.data_ptr(), acc.data_ptr(),
        z_max.data_ptr(), work.data_ptr(), B, H, W, C, th, tw,
        int(not z_nonpositive), kernels.stream_handle(img.device))
    kernels.LAUNCHES["splat_fused"] += 1
    kernels.check(err, "splat_fused")
    return acc[..., :C], acc[..., C:C + 1], z_max, acc[..., C + 1:]
