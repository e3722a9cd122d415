"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and `nvcc` (marked `cuda`; skipped
where torch.cuda.is_available() is false). The file imports neither JAX nor
motif_tpu, so it runs on a GPU machine without them (`--noconftest`: the
suite's conftest.py sets up JAX):

    python -m pytest -q -m cuda --noconftest tests/test_torch_kernels.py

TF32 is off for the plain versions' matrix products and convolutions.
"""

import numpy as np
import pytest
import torch

from motif_tpu_torch.models.siren import hidden_bound
from motif_tpu_torch.ops import dcn, kernels, siren_kernel, softsplat

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _launches(name, fn):
    before = kernels.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.LAUNCHES[name] - before


@pytest.mark.parametrize("z_nonpositive", [True, False])
def test_splat_fused(dev, z_nonpositive):
    """Out-of-image flows included. Atomics sum in a varying order: atol
    1e-4 on out / norm; z_max and the count exact."""
    g = torch.Generator(device=dev).manual_seed(0)
    B, H, W, C = 3, 40, 56, 130
    img = torch.randn((B, H, W, C), device=dev, generator=g)
    flow = torch.randn((B, H, W, 2), device=dev, generator=g) * 3.0
    flow[0, 0, :, 1] = -30.0
    z = torch.randn((B, H, W, 1), device=dev, generator=g) * 0.5
    if z_nonpositive:
        z = -z.abs()
    got, n = _launches("splat_fused", lambda: softsplat.splat_fused(
        img, flow, z, z_nonpositive=z_nonpositive))
    assert n == (1 if z_nonpositive else 2)
    want = softsplat.splat_fused_plain(img, flow, z, z_nonpositive)
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=0)


def _dcn_inputs(dev, B, H, W, G, cg, K, stride, pad, dil, strided):
    """x, offsets to ±10 px with some at ±1e6 px (zeros out), the sigmoided
    mask; `strided`: offsets and mask sliced from one conv-like output, as
    DCNSep takes them."""
    g = torch.Generator(device=dev).manual_seed(1)
    Ho = (H + 2 * pad - (dil * (K - 1) + 1)) // stride + 1
    Wo = (W + 2 * pad - (dil * (K - 1) + 1)) // stride + 1
    n_off, n_mask = G * K * K * 2, G * K * K
    x = torch.randn((B, H, W, G * cg), device=dev, generator=g)
    com = torch.rand((B, Ho, Wo, n_off + n_mask), device=dev, generator=g)
    com[..., :n_off] = com[..., :n_off] * 20.0 - 10.0
    far = torch.rand((B, Ho, Wo, n_off), device=dev, generator=g) < 0.01
    com[..., :n_off] = torch.where(far, torch.sign(com[..., :n_off]) * 1e6,
                                   com[..., :n_off])
    com[..., n_off:] = torch.sigmoid(com[..., n_off:] * 4.0 - 2.0)
    off, mask = com[..., :n_off], com[..., n_off:]
    if not strided:
        off, mask = off.contiguous(), mask.contiguous()
    return x, off, mask


@pytest.mark.parametrize("H,W,G,cg,K,stride,pad,dil,strided", [
    (64, 112, 8, 8, 3, 1, 1, 1, False), (64, 112, 8, 8, 3, 1, 1, 1, True),
    (30, 28, 8, 8, 3, 1, 1, 1, True), (30, 28, 8, 8, 3, 2, 1, 1, False),
    (30, 28, 4, 8, 3, 1, 2, 2, True), (30, 28, 8, 2, 3, 1, 1, 1, False),
    (30, 28, 2, 12, 5, 1, 2, 1, True), (17, 9, 1, 4, 1, 1, 0, 1, False)])
def test_dcn_im2col(dev, H, W, G, cg, K, stride, pad, dil, strided):
    """Against the plain version at the L1 shape and an H % 8 != 0 one,
    stride 2 / dilation 2, strided offset / mask views, a cg that takes
    the scalar path, and K = 5 / K = 1 with cg = 12 / 4 (the kernel's
    general geometry). atol 1e-5."""
    x, off, mask = _dcn_inputs(dev, 2, H, W, G, cg, K, stride, pad, dil,
                               strided)
    got, n = _launches("dcn_im2col", lambda: dcn.dcn_im2col(
        x, off, mask, K, stride, pad, dil, G))
    assert n == 1
    want = dcn.dcn_im2col_plain(x, off, mask, K, stride, pad, dil, G)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_dcn_v2_through_the_kernel(dev):
    """dcn_v2 (kernel + addmm) against the same contraction of the plain
    im2col, TF32 off. atol 1e-5."""
    G, cg, K = 8, 8, 3
    x, off, mask = _dcn_inputs(dev, 2, 30, 28, G, cg, K, 1, 1, 1, True)
    g = torch.Generator(device=dev).manual_seed(3)
    w = torch.randn((64, G * cg, K, K), device=dev, generator=g) * 0.05
    b = torch.randn((64,), device=dev, generator=g)
    got, n = _launches("dcn_im2col", lambda: dcn.dcn_v2(
        x, off, mask, w, b, K, 1, 1, 1, G))
    assert n == 1
    cols = dcn.dcn_im2col_plain(x, off, mask, K, 1, 1, 1, G)
    wm = w.reshape(64, G, cg, K * K).transpose(2, 3).reshape(64, -1)
    want = (cols @ wm.t() + b).reshape(got.shape)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _siren(dev, dims):
    g = torch.Generator(device=dev).manual_seed(2)
    ws = [(torch.rand((o, i), device=dev, generator=g) * 2 - 1)
          * hidden_bound(i, 30.0) for i, o in zip(dims[:-1], dims[1:])]
    bs = [torch.rand((o,), device=dev, generator=g) * 0.2 - 0.1
          for o in dims[1:]]
    return ws, bs, g


MOTIF_MLPS = [[67, 64, 64, 256, 3], [66, 64, 64, 256, 64],
              [198, 64, 64, 64, 256, 3]]


@pytest.mark.parametrize("dims", MOTIF_MLPS + [[5, 7]])
@pytest.mark.parametrize("sine_last", [False, True])
def test_siren_mlp(dev, dims, sine_last):
    """The three MoTIF MLPs (and a one-layer odd-width one) over a token
    count that is not a tile multiple. atol 1e-5: fp32 FMA and sinf, as the
    plain version with TF32 off (TF32 products or a fast __sinf would miss
    it)."""
    ws, bs, g = _siren(dev, dims)
    x = torch.rand((5001, dims[0]), device=dev, generator=g) * 2 - 1
    got, n = _launches("siren_mlp", lambda: siren_kernel.siren_mlp(
        x, ws, bs, 30.0, sine_last))
    assert n == 1
    torch.testing.assert_close(
        got, siren_kernel.siren_mlp_plain(x, ws, bs, 30.0, sine_last),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("dims", MOTIF_MLPS)
@pytest.mark.parametrize("tokens", ["one", "tile-1", "grid*tile*3+7"])
def test_siren_mlp_ragged_tiles(dev, dims, tokens):
    """The persistent loop's edges: 1 token, a tile less one, and three
    rounds of the grid (one block per SM at these MLPs' shared memory)
    plus a ragged tile of 7. atol 1e-5."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n = {"one": 1, "tile-1": siren_kernel.TILE - 1,
         "grid*tile*3+7": n_sm * siren_kernel.TILE * 3 + 7}[tokens]
    ws, bs, g = _siren(dev, dims)
    x = torch.rand((n, dims[0]), device=dev, generator=g) * 2 - 1
    got, launches = _launches("siren_mlp", lambda: siren_kernel.siren_mlp(
        x, ws, bs))
    assert launches == 1
    torch.testing.assert_close(got, siren_kernel.siren_mlp_plain(x, ws, bs),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("dims", [[48, 128, 96, 8], [32, 64, 64, 80, 3],
                                  [100, 72, 3], [5, 20, 3], [16, 70],
                                  [16, 100]])
@pytest.mark.parametrize("sine_last", [False, True])
def test_siren_mlp_other_widths(dev, dims, sine_last):
    """Widths that take the kernel's other paths: a stored activation wider
    than 64; a fused pair with a ragged second chunk; a first layer wider
    than 64 both in and out (x restaged per chunk); a stored layer of 20
    (partly idle tiles); last layers of 70 and 100 (two chunks, scalar and
    float4 stores). atol 1e-5."""
    ws, bs, g = _siren(dev, dims)
    x = torch.rand((3001, dims[0]), device=dev, generator=g) * 2 - 1
    fused, rows, smem = siren_kernel.plan(dims)
    if smem > siren_kernel.SMEM_LIMIT:
        pytest.fail(f"{dims} must fit: {smem} B")
    got = siren_kernel.siren_mlp(x, ws, bs, 30.0, sine_last)
    torch.testing.assert_close(
        got, siren_kernel.siren_mlp_plain(x, ws, bs, 30.0, sine_last),
        rtol=0, atol=1e-5)


def test_siren_mlp_too_wide_raises(dev):
    ws, bs, g = _siren(dev, [64, 256, 256, 3])
    x = torch.zeros((10, 64), device=dev)
    before = kernels.LAUNCHES["siren_mlp"]
    with pytest.raises(ValueError, match="shared memory"):
        siren_kernel.siren_mlp(x, ws, bs)
    assert kernels.LAUNCHES["siren_mlp"] == before


def test_wrappers_reject_float64(dev):
    x = torch.zeros((2, 4, 4, 8), device=dev, dtype=torch.float64)
    off = torch.zeros((2, 4, 4, 36), device=dev, dtype=torch.float64)
    mask = torch.zeros((2, 4, 4, 18), device=dev, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        dcn.dcn_im2col(x, off, mask, 3, 1, 1, 1, 2)


def test_kernels_build_from_the_sources(dev):
    kernels.build()
    for name in kernels.KERNELS:
        assert kernels._library_path(name).exists()
    assert np.isfinite(kernels.build())  # all built: nothing to do
