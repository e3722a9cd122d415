"""The three kernel ops of the serving configuration in its working types,
as plain PyTorch: the modulated deformable convolution and the SIREN MLP
in bfloat16, and the softmax splat with its sums in float16 (or another
16-bit type). Each takes the arguments of its float32 counterpart in
`plain.py` and runs that counterpart where the tensors are float32 or
float64, so the serving reference (`serve.py`) can put these in the
plain ops' place for a whole forward.

Where a value is rounded, and to what, is the contract; it follows the
JAX package's `motif_tpu` jnp paths, with these departures (each also
said at its op):

- `dcn_v2`: the sample positions, the bilinear hat weights, the four
  taps' sum and the mask product are float32, and a column is rounded to
  bfloat16 once. The JAX one-hot sampler (`motif_tpu/ops/dcn.py::
  _sample_onehot`) rounds its hat weights, its row contraction, the
  sample and the masked sample to bfloat16, each on its own; its gather
  path rounds each corner's weight and product and each partial sum.
  Both agree with the one rounding here to a few bfloat16 ulps.
- `siren_mlp`: none. The products are exact in float32 and accumulate in
  float32 (a float32 matrix product, TF32 off), then the product, the
  bias sum, omega0 * and the sine are each rounded to bfloat16, as
  `motif_tpu/ops/siren_kernel.py::_composed` rounds in bfloat16.
- `splat_fused`: none in the sums (`motif_tpu/ops/softsplat.py::
  _splat_fused_base` with `scatter_dtype`): the fractional positions,
  their complements, the four corner weights, e^z and img * e^z rounded
  to the sums' type, each corner kind summed on its own in that type,
  the four sums added NW + NE + SW + SE in it, the result widened to the
  input's type. The order in which one corner kind's contributions to a
  pixel are added is the scatter's (`index_add_`), as it is XLA's. The
  max stays in the input's type (`plain.splat_fused`).
"""

from __future__ import annotations

import torch

from . import plain
from .warp import pixel_grid

BF16 = torch.bfloat16
HALF = (torch.bfloat16, torch.float16)
# the float32 ops this module stands beside (taken at import, so that a
# forward that puts these functions in `plain`'s place still reaches them)
_PLAIN = {"dcn_v2": plain.dcn_v2, "siren_mlp": plain.siren_mlp,
          "splat_fused": plain.splat_fused}


def dcn_v2(x, offset, mask, weight, bias, kernel_size: int = 3,
           stride: int = 1, padding: int = 1, dilation: int = 1,
           deformable_groups: int = 1):
    """`plain.dcn_v2` in bfloat16 (x, offset, mask, weight and bias in
    bfloat16, the result too): the columns formed in float32 from the
    bfloat16 values and rounded to bfloat16 once, then the contraction of
    the bfloat16 columns and weights accumulated in float32, the bias added
    in float32, rounded once. Float32 or float64 tensors run the plain
    op."""
    if x.dtype != BF16:
        return _PLAIN["dcn_v2"](x, offset, mask, weight, bias, kernel_size,
                                stride, padding, dilation, deformable_groups)
    B, H, W, Cin = x.shape
    K, G = kernel_size, deformable_groups
    Ho, Wo = offset.shape[1], offset.shape[2]
    cg = Cin // G
    dev, f32 = x.device, torch.float32
    off = offset.float().reshape(B, Ho, Wo, G, K * K, 2)
    oy = torch.arange(Ho, dtype=f32, device=dev) * stride - padding
    ox = torch.arange(Wo, dtype=f32, device=dev) * stride - padding
    ky = torch.arange(K, dtype=f32, device=dev).repeat_interleave(K) * dilation
    kx = (torch.arange(K, dtype=f32, device=dev) * dilation).repeat(K)
    py = oy[None, :, None, None, None] + ky + off[..., 0]
    px = ox[None, None, :, None, None] + kx + off[..., 1]
    Q = Ho * Wo * K * K
    py = py.permute(0, 3, 1, 2, 4).reshape(B, G, Q)
    px = px.permute(0, 3, 1, 2, 4).reshape(B, G, Q)
    val = plain._sample(x.float(), py, px)                   # (B, Q, G, cg)
    val = val.reshape(B, Ho, Wo, K * K, G, cg).permute(0, 1, 2, 4, 3, 5)
    val = val * mask.float().reshape(B, Ho, Wo, G, K * K, 1)
    cols = val.reshape(B * Ho * Wo, G * K * K * cg).to(BF16)
    Cout = weight.shape[0]
    w = weight.reshape(Cout, G, cg, K * K).transpose(2, 3).reshape(
        Cout, G * K * K * cg)
    out = cols.float() @ w.float().t()
    if bias is not None:
        out = out + bias.float()
    return out.to(BF16).reshape(B, Ho, Wo, Cout)


def _sine(a: torch.Tensor, omega0: float) -> torch.Tensor:
    """sin(omega0 * a) of a bfloat16 tensor: the product rounded, the sine
    taken in float32 and rounded."""
    arg = (omega0 * a.float()).to(BF16)
    return torch.sin(arg.float()).to(BF16)


def siren_mlp(x, weights, biases, omega0: float = 30.0,
              sine_last: bool = False, skip_first: bool = False):
    """`plain.siren_mlp` in bfloat16 (x, weights and biases in bfloat16,
    the result too): each layer's product accumulated in float32 from the
    bfloat16 values and rounded, the bias added and rounded, then omega0 *
    and the sine, each rounded. Float32 or float64 tensors run the plain
    op."""
    if x.dtype != BF16:
        return _PLAIN["siren_mlp"](x, weights, biases, omega0, sine_last,
                                   skip_first)
    h = _sine(x, omega0) if skip_first else x
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = (h.float() @ w.float().t()).to(BF16)
        h = (h.float() + b.float()).to(BF16)
        if i < n - 1 or sine_last:
            h = _sine(h, omega0)
    return h


def splat_fused(img, flow, z, z_nonpositive: bool, scatter_dtype=None):
    """`plain.splat_fused` with its sums (the payload's, the weights' and
    the count) in `scatter_dtype`, or in img's dtype where that is a 16-bit
    type: see the module's note for every rounding. Returns (sum of img *
    e^z, sum of e^z, the max, the count) in img's dtype; the max in img's
    dtype by `plain.splat_fused`. With float32 or float64 sums (no
    `scatter_dtype` and img in float32 or float64) it is the plain op."""
    sdt = img.dtype if scatter_dtype is None else scatter_dtype
    if sdt not in HALF:
        if sdt != img.dtype:
            raise ValueError(f"splat_fused: sums in {sdt} for {img.dtype} "
                             f"inputs")
        return _PLAIN["splat_fused"](img, flow, z, z_nonpositive)
    B, H, W, C = img.shape
    HW = H * W
    ez = torch.exp(z)
    gx, gy = pixel_grid(H, W, flow.device)
    fx = gx + flow[..., 0]
    fy = gy + flow[..., 1]
    x0, y0 = torch.floor(fx), torch.floor(fy)
    ix0, iy0 = x0.long(), y0.long()
    wx1 = (fx - x0).to(sdt)
    wy1 = (fy - y0).to(sdt)
    wx0 = (1.0 - wx1.float()).to(sdt)
    wy0 = (1.0 - wy1.float()).to(sdt)
    ezs = ez.to(sdt)
    u = torch.cat([img.to(sdt) * ezs, ezs], -1).reshape(B * HW, C + 1)
    boff = (torch.arange(B, device=img.device) * HW)[:, None, None]
    total = None
    for iy, ix, w in ((iy0, ix0, wy0 * wx0), (iy0, ix0 + 1, wy0 * wx1),
                      (iy0 + 1, ix0, wy1 * wx0),
                      (iy0 + 1, ix0 + 1, wy1 * wx1)):
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        idx = torch.where(valid, iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1),
                          torch.zeros_like(iy))
        vals = torch.cat([u * w.reshape(-1, 1), torch.ones_like(u[:, :1])],
                         -1)
        vals = torch.where(valid.reshape(-1, 1), vals, torch.zeros_like(vals))
        part = torch.zeros((B * HW, C + 2), dtype=sdt, device=img.device)
        part.index_add_(0, (idx + boff).reshape(-1), vals)
        total = part if total is None else total + part
    acc = total.to(img.dtype).reshape(B, H, W, C + 2)
    if z_nonpositive:
        z_max = torch.ones((B, H, W, 1), dtype=img.dtype, device=img.device)
    else:
        z_max = _PLAIN["splat_fused"](img, flow, z, False)[2]
    return acc[..., :C], acc[..., C:C + 1], z_max, acc[..., C + 1:]
