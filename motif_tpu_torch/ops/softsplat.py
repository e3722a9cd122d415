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

Entries: sums in the inputs' float32, or with `scatter_dtype=float16` in
float16 (the JAX package's `_splat_fused_base(scatter_dtype=float16)`): the
corner weights' factors, e^z and img * e^z rounded to float16, the products
and the sums (norm and count too) in float16, the results returned in the
input dtype; the max stays float32.

Gradients: under autograd the kernel's forward (either sums) runs in an
autograd Function whose backward is `splat_fused_backward_plain`, plain
PyTorch in gather form, in the sums' type: float32, or for the float16 sums
the float16 arithmetic that autodiff of the JAX package's float16 scatter
does (`_half_backward`).
"""

from __future__ import annotations

import ctypes

import torch

from motif_tpu_torch import obs
from motif_tpu_torch.ops import kernels
from motif_tpu_torch.ops.warp import pixel_grid

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"splat_fused_forward": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                        _I, _I, _I, _I, _I, _P]}
# The target tile (th, tw) by (C, bytes per sum) for the compiled widths,
# the fastest of the smoke's tile sweep (chip_smoke.py, `splat_tiles`) on an
# H100; any other width starts from 8x8 (MoTIF's C = 130: 38 KB, faster
# than 4x16, 8x16, 16x8, 16x16 and 4x8).
TILE = {(64, 4): (8, 4), (64, 2): (8, 8)}
STAGE_BYTES = 128 * 32   # the kernel's staged tile records (the most of its
                         # two designs: 128 of 32 B, or 64 of 48 B at C = 64)
SMEM_LIMIT = 232_448     # shared memory a block may use on Hopper
COMPILED_C = (130, 64)   # payload widths the kernel is specialised for:
                         # MoTIF's reference order and its fused decode


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


def _half_sums(img, flow, ez, corners, boff):
    """The float16 sums of `splat_fused_plain`, in the JAX package's
    `_splat_fused_base` order: the fractional positions rounded to float16,
    their complements and the four products in float16, the payload
    [img * e^z | e^z] in float16, each corner kind (NW, NE, SW, SE) summed
    on its own in float16 (norm and count too), the four sums added in
    that order in float16, and the result widened to img's dtype."""
    B, H, W, C = img.shape
    h = torch.float16
    gx, gy = pixel_grid(H, W, flow.device)
    fx = gx + flow[..., 0]
    fy = gy + flow[..., 1]
    wx1 = (fx - torch.floor(fx)).to(h)
    wy1 = (fy - torch.floor(fy)).to(h)
    wx0 = (1.0 - wx1.float()).to(h)
    wy0 = (1.0 - wy1.float()).to(h)
    ezh = ez.to(h)
    u = torch.cat([img.to(h) * ezh, ezh], dim=-1).reshape(B * H * W, C + 1)
    total = None
    for (idx, _, valid), w in zip(corners, (wy0 * wx0, wy0 * wx1, wy1 * wx0,
                                            wy1 * wx1)):
        ok = valid.reshape(-1, 1)
        vals = torch.cat([u * w.reshape(-1, 1), torch.ones_like(u[:, :1])], -1)
        vals = torch.where(ok, vals, torch.zeros_like(vals))
        part = torch.zeros((B * H * W, C + 2), dtype=h, device=img.device)
        part.index_add_(0, (idx + boff).reshape(-1), vals)
        total = part if total is None else total + part
    return total.to(img.dtype)


def splat_fused_plain(img: torch.Tensor, flow: torch.Tensor, z: torch.Tensor,
                      z_nonpositive: bool, scatter_dtype=None):
    """The plain version of `splat_fused`: one `index_add_` per corner into
    a (B*H*W, C + 2) accumulator (with `scatter_dtype=float16`: float16
    sums, see `_half_sums`), and `scatter_reduce("amax")` over ones for the
    max. Same contract as `splat_fused`."""
    B, H, W, C = img.shape
    HW = H * W
    ez = torch.exp(z)
    corners = _corner_data(flow, H, W)
    boff = (torch.arange(B, device=img.device) * HW)[:, None, None]
    if _half(scatter_dtype, img):
        acc = _half_sums(img, flow, ez, corners, boff)
    else:
        ezf = ez.reshape(B, HW, 1)
        flat = torch.cat([img.reshape(B, HW, C) * ezf, ezf], dim=-1)
        acc = torch.zeros((B * HW, C + 2), dtype=img.dtype, device=img.device)
        for idx, w, valid in corners:
            wv = torch.where(valid, w, torch.zeros_like(w)).to(img.dtype)
            vals = torch.cat([flat * wv.reshape(B, HW, 1),
                              valid.to(img.dtype).reshape(B, HW, 1)], dim=-1)
            acc.index_add_(0, (idx + boff).reshape(-1),
                           vals.reshape(-1, C + 2))
    acc = acc.reshape(B, H, W, C + 2)
    if z_nonpositive:
        z_max = torch.ones((B, H, W, 1), dtype=img.dtype, device=img.device)
    else:
        # the max takes no gradient, as in the JAX package (its
        # stop_gradient) and the kernel's autograd Function
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


def _half(scatter_dtype, img: torch.Tensor) -> bool:
    """Whether the sums are float16: `scatter_dtype` is None or img's dtype
    (sums as the inputs) or float16."""
    if scatter_dtype in (None, img.dtype):
        return False
    if scatter_dtype != torch.float16:
        raise ValueError(f"splat_fused: the sums are kept in the inputs' "
                         f"dtype or in float16, not {scatter_dtype}")
    return True


def plan(C: int, elem_size: int = 4) -> tuple[int, int]:
    """The kernel's target tile (th, tw) for C payload channels summed in
    elements of `elem_size` bytes (4, or 2 for float16 sums): `TILE`'s for
    a compiled (C, elem_size), else the first of 8x8, 4x8, 2x8, 1x8, 1x4,
    1x2, 1x1 whose tile ([th * tw, C + 2] sums, norm and count, rounded up
    to 4 bytes, and th * tw floats of the max) fits in a block's shared
    memory beside the staged records (a compiled width's tile is halved
    the same way if it does not fit). Raises when not even one pixel
    fits."""
    th, tw = TILE.get((C, elem_size), (8, 8))

    def tile_bytes():
        return -(-th * tw * (C + 2) * elem_size // 4) * 4 + th * tw * 4
    while tile_bytes() + STAGE_BYTES > SMEM_LIMIT:
        if th > 1:
            th //= 2
        elif tw > 1:
            tw //= 2
        else:
            raise ValueError(f"splat_fused: C = {C} channels of one pixel "
                             f"exceed the {SMEM_LIMIT} B of shared memory a "
                             f"block may use")
    return th, tw


def splat_fused_backward_plain(img: torch.Tensor, flow: torch.Tensor,
                               ez: torch.Tensor, g_out: torch.Tensor | None,
                               g_norm: torch.Tensor | None,
                               scatter_dtype=None):
    """The gradients (d img, d flow, d z) of `splat_fused`'s out and norm
    given theirs (`g_out` (B, H, W, C), `g_norm` (B, H, W, 1), either None
    for zero), with ez = e^z. Gather form: each source pixel reads the
    output gradient at its four corners (no scatter). With G_c the
    gradient at corner c (zero where c is outside the image) and
    a_c = e^z (img . G_c[:C] + g_norm_c):
      d img = e^z sum_c w_c G_c,   d z = sum_c w_c a_c,
      d fx = wy0 (a_NE - a_NW) + wy1 (a_SE - a_SW),
      d fy = wx0 (a_SW - a_NW) + wx1 (a_SE - a_NE).
    With float16 sums (`scatter_dtype`, see `_half`): the same terms in
    float16, `_half_backward`."""
    if _half(scatter_dtype, img):
        return _half_backward(img, flow, ez, g_out, g_norm)
    B, H, W, C = img.shape
    n = B * H * W
    gx, gy = pixel_grid(H, W, flow.device)
    fx = gx + flow[..., 0]
    fy = gy + flow[..., 1]
    wx1 = (fx - torch.floor(fx)).reshape(n)
    wy1 = (fy - torch.floor(fy)).reshape(n)
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    boff = (torch.arange(B, device=img.device) * H * W)[:, None, None]
    img_f = img.reshape(n, C)
    go = None if g_out is None else g_out.reshape(n, C)
    gn = None if g_norm is None else g_norm.reshape(n)
    d_pay = torch.zeros_like(img_f)            # sum_c w_c G_c
    d_ez = torch.zeros(n, dtype=img.dtype, device=img.device)
    a = []
    for idx, w, valid in _corner_data(flow, H, W):
        at = (idx + boff).reshape(n)
        v = valid.reshape(n).to(img.dtype)
        wv = w.reshape(n).to(img.dtype) * v
        dot = torch.zeros_like(d_ez)
        if go is not None:
            g = go.index_select(0, at)
            d_pay.addcmul_(g, wv[:, None])
            dot = torch.einsum("pc,pc->p", img_f, g)
        if gn is not None:
            dot = dot + gn.index_select(0, at)
        dot = dot * v
        d_ez.addcmul_(dot, wv)
        a.append(dot)
    ezf = ez.reshape(n)
    a = [ezf * t for t in a]
    d_fx = wy0 * (a[1] - a[0]) + wy1 * (a[3] - a[2])
    d_fy = wx0 * (a[2] - a[0]) + wx1 * (a[3] - a[1])
    d_flow = torch.stack([d_fx, d_fy], -1).reshape(B, H, W, 2)
    return ((d_pay * ezf[:, None]).reshape(B, H, W, C),
            d_flow.to(flow.dtype), (d_ez * ezf).reshape(B, H, W, 1))


def _half_backward(img, flow, ez, g_out, g_norm):
    """`splat_fused_backward_plain` for the float16 sums: what autodiff of
    the JAX package's `_splat_fused_base(scatter_dtype=float16)` computes.
    The output gradient is rounded to float16 (the backward of the sums'
    widening); with the forward's float16 fractional weights wx, wy, their
    complements and products w_c, u = [img * e^z | e^z] in float16 and
    G_c the float16 gradient at corner c:
      d u = sum_c w_c G_c,   d w_c = u . G_c         (float16),
      d img = e^z d u[:C],   d e^z = img . d u[:C] + d u[C],
      d wx1 = wy0 d w_NE + wy1 d w_SE,   d wx0 = wy0 d w_NW + wy1 d w_SW,
      d fx = d wx1 - d wx0 (the complement's gradient goes back through
    its float32 form), likewise fy; each widened to the inputs' dtype, and
    d z = d e^z * e^z there."""
    B, H, W, C = img.shape
    n, h = B * H * W, torch.float16
    gx, gy = pixel_grid(H, W, flow.device)
    fx = gx + flow[..., 0]
    fy = gy + flow[..., 1]
    wx1 = (fx - torch.floor(fx)).to(h).reshape(n, 1)
    wy1 = (fy - torch.floor(fy)).to(h).reshape(n, 1)
    wx0 = (1.0 - wx1.float()).to(h)
    wy0 = (1.0 - wy1.float()).to(h)
    ezh = ez.to(h).reshape(n, 1)
    imgh = img.to(h).reshape(n, C)
    u = torch.cat([imgh * ezh, ezh], -1)                    # (n, C + 1)
    zero = img.new_zeros(())
    g = torch.cat([(g_out if g_out is not None else zero.expand(B, H, W, C)),
                   (g_norm if g_norm is not None
                    else zero.expand(B, H, W, 1))], -1).to(h).reshape(
                        n, C + 1)
    boff = (torch.arange(B, device=img.device) * H * W)[:, None, None]
    d_u = torch.zeros_like(u)
    d_w = []
    for (idx, _, valid), w in zip(_corner_data(flow, H, W),
                                  (wy0 * wx0, wy0 * wx1, wy1 * wx0,
                                   wy1 * wx1)):
        gc = g.index_select(0, (idx + boff).reshape(n))
        gc = gc * valid.reshape(n, 1).to(h)
        d_u = d_u + gc * w
        d_w.append((u * gc).sum(-1, keepdim=True))
    d_ezh = (d_u[:, :C] * imgh).sum(-1, keepdim=True) + d_u[:, C:]
    d_wx = (wy0 * d_w[1] + wy1 * d_w[3]).float() - \
        (wy0 * d_w[0] + wy1 * d_w[2]).float()
    d_wy = (wx0 * d_w[2] + wx1 * d_w[3]).float() - \
        (wx0 * d_w[0] + wx1 * d_w[1]).float()
    dt = img.dtype
    return ((d_u[:, :C] * ezh).to(dt).reshape(B, H, W, C),
            torch.cat([d_wx, d_wy], -1).to(flow.dtype).reshape(B, H, W, 2),
            (d_ezh.to(dt) * ez.reshape(n, 1)).reshape(B, H, W, 1))


class _SplatFused(torch.autograd.Function):
    """splat_fused under autograd: the kernel forward (float32 or float16
    sums), `splat_fused_backward_plain` backward in the same sums' type."""

    @staticmethod
    def forward(ctx, img, flow, z, z_nonpositive, scatter_dtype):
        outs = _splat_forward(img, flow, z, z_nonpositive, scatter_dtype)
        ctx.save_for_backward(img, flow, z)
        ctx.scatter_dtype = scatter_dtype
        ctx.mark_non_differentiable(outs[2], outs[3])
        return outs

    @staticmethod
    def backward(ctx, g_out, g_norm, _g_max, _g_count):
        img, flow, z = ctx.saved_tensors
        with obs.span("splat_fused.backward"):
            d_img, d_flow, d_z = splat_fused_backward_plain(
                img, flow, torch.exp(z), g_out, g_norm, ctx.scatter_dtype)
        return d_img, d_flow, d_z, None, None


def splat_fused(img: torch.Tensor, flow: torch.Tensor, z: torch.Tensor,
                z_nonpositive: bool, scatter_dtype=None):
    """Fused softmax splat + count splat, and the max splat unless
    `z_nonpositive` (z <= 0 everywhere makes e^z * w <= 1, so the
    ones-initialised max is identically 1 — exact). The caller decides
    `z_nonpositive` from what it knows of z (MoTIF: from alpha).

    Returns (out, norm, z_max, count):
      out   = splat_sum(img * e^z)          (B, H, W, C)
      norm  = splat_sum(e^z)                (B, H, W, 1)
      z_max = max(1, max-splat(e^z * w))    (B, H, W, 1)
      count = unweighted in-image corner hits (B, H, W, 1)
    `scatter_dtype=torch.float16` keeps the sums (out, norm, count) in
    float16 and returns them in the input dtype; z_max stays float32.
    On CPU tensors: the plain version; on CUDA tensors: the kernel's
    float32-sum or float16-sum entry (float32 tensors either way), which
    sums in an order that varies from run to run (the count and z_max are
    exact; float16 sums then differ by about 1e-3 relative).
    Under autograd (a tensor requires grad): the same forward with
    `splat_fused_backward_plain` as its backward, with either sums.
    """
    if kernels.needs_grad(img, flow, z):
        return _SplatFused.apply(img, flow, z, z_nonpositive, scatter_dtype)
    return _splat_forward(img, flow, z, z_nonpositive, scatter_dtype)


def _splat_forward(img, flow, z, z_nonpositive, scatter_dtype):
    """The forward of `splat_fused`: the plain version on CPU tensors, the
    kernel on CUDA tensors."""
    if img.device.type == "cpu":
        return splat_fused_plain(img, flow, z, z_nonpositive, scatter_dtype)
    kernels.require_cuda("splat_fused", (torch.float32,), img, flow, z)
    half = _half(scatter_dtype, img)
    B, H, W, C = img.shape
    if flow.shape != (B, H, W, 2) or z.shape != (B, H, W, 1):
        raise ValueError(f"splat_fused: bad shapes img {tuple(img.shape)}, "
                         f"flow {tuple(flow.shape)}, z {tuple(z.shape)}")
    if 4 * B * H * W >= 2 ** 31:
        raise ValueError(f"splat_fused: {B * H * W} pixels exceed the "
                         f"kernel's 32-bit tile lists")
    th, tw = plan(C, 2 if half else 4)
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
        int(not z_nonpositive), int(half), kernels.stream_handle(img.device))
    kernels.count("splat_fused", ("float16" if half else "float32")
                  + (f"/C={C}" if C in COMPILED_C else "/generic"))
    kernels.check(err, "splat_fused")
    return acc[..., :C], acc[..., C:C + 1], z_max, acc[..., C + 1:]


# ---- the public splat ops of the JAX package (motif_tpu/ops/softsplat.py:
# 78-121, 340-379): XLA scatters there, plain PyTorch here on any device.
# They are not routed through `splat_fused`, whose contract (the fused sum,
# norm, count and max) is another function.

def _scatter_rows(values, flow, fill, reduce):
    """values (B, H, W, C) times each corner's weight, scattered to the
    corners' targets of `flow` with `reduce` ("sum" or "amax") into a (B,
    H, W, C) output filled with `fill`; an out-of-image corner adds 0 to a
    sum and -inf to a max."""
    B, H, W, C = values.shape
    corners = _corner_data(flow, H, W)
    boff = (torch.arange(B, device=values.device) * (H * W))[:, None, None]
    out = torch.full((B * H * W, C), fill, dtype=values.dtype,
                     device=values.device)
    drop = 0.0 if reduce == "sum" else -torch.inf
    for idx, w, valid in corners:
        vals = values * w[..., None].to(values.dtype)
        vals = torch.where(valid[..., None], vals,
                           torch.full_like(vals, drop)).reshape(-1, C)
        rows = (idx + boff).reshape(-1)
        if reduce == "sum":
            out.index_add_(0, rows, vals)
        else:
            out.scatter_reduce_(0, rows[:, None].expand(-1, C), vals, "amax")
    return out.reshape(B, H, W, C)


def splat_sum(values: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear scatter-add forward warp: values (B, H, W, C), flow (B, H,
    W, 2) -> (B, H, W, C)."""
    return _scatter_rows(values, flow, 0.0, "sum")


def splat_max(values: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear scatter-max forward warp into an output of ones:
    out[q] = max(1, max_p values(p) · w(p, q)) (softsplat_max_cp.py); no
    gradient, as the reference detaches it."""
    with torch.no_grad():
        return _scatter_rows(values, flow, 1.0, "amax")


def splat_count(flow: torch.Tensor) -> torch.Tensor:
    """In-image corner hits per target, unweighted (softsplat_count_cp.py):
    (B, H, W, 1) float32, no gradient."""
    B, H, W, _ = flow.shape
    with torch.no_grad():
        corners = _corner_data(flow, H, W)
        boff = (torch.arange(B, device=flow.device) * (H * W))[:, None, None]
        out = torch.zeros(B * H * W, dtype=torch.float32, device=flow.device)
        for idx, _, valid in corners:
            out.index_add_(0, (idx + boff).reshape(-1),
                           valid.to(torch.float32).reshape(-1))
    return out.reshape(B, H, W, 1)


def function_softsplat(img: torch.Tensor, flow: torch.Tensor,
                       z: torch.Tensor | None, mode: str = "softmax"):
    """The reference's four-mode splat (FunctionSoftsplat,
    softsplat_cp.py:320-347); img (B, H, W, C), flow (B, H, W, 2), z (B, H,
    W, 1) (None for summation and average):

      summation: splat_sum(img), None
      average:   the splat of [img | 1]:         (out, normaliser)
      linear:    the splat of [img · z | z]:     (out, normaliser)
      softmax:   the splat of [img · e^z | e^z]: (out, normaliser)

    Unnormalised, as the reference (its division is commented out)."""
    assert mode in ("summation", "average", "linear", "softmax")
    if mode == "summation":
        return splat_sum(img, flow), None
    if mode == "average":
        w = torch.ones_like(img[..., :1])
    else:
        assert z is not None and z.shape[-1] == 1
        w = z if mode == "linear" else torch.exp(z)
    out = splat_sum(torch.cat([img * w, w], dim=-1), flow)
    return out[..., :-1], out[..., -1:]


def softmax_splat(img: torch.Tensor, flow: torch.Tensor, z: torch.Tensor):
    """The reference's Softsplat module in softmax mode
    (softsplat_cp.py:349): (the splat of img · e^z, the splat of e^z),
    both unnormalised."""
    return function_softsplat(img, flow, z, "softmax")
