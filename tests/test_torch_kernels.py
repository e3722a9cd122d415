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


@pytest.mark.parametrize("H,W", [(64, 112), (30, 28)])
def test_dcn_sample(dev, H, W):
    """Offsets up to ±10 px; 30 is an H % 8 != 0 height. atol 1e-5."""
    g = torch.Generator(device=dev).manual_seed(1)
    B, G, cg, K = 2, 8, 8, 3
    x = torch.randn((B, H, W, G * cg), device=dev, generator=g)
    off = torch.rand((B, H, W, G * K * K * 2), device=dev, generator=g)
    py, px = dcn.sample_positions(off * 20.0 - 10.0, K, 1, 1, 1, G)
    got, n = _launches("dcn_sample", lambda: dcn.dcn_sample(x, py, px))
    assert n == 1
    torch.testing.assert_close(got, dcn.dcn_sample_plain(x, py, px), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("dims", [[67, 64, 64, 256, 3], [66, 64, 64, 256, 64],
                                  [198, 64, 64, 64, 256, 3], [5, 7]])
@pytest.mark.parametrize("sine_last", [False, True])
def test_siren_mlp(dev, dims, sine_last):
    """The three MoTIF MLPs (and a one-layer odd-width one) over a token
    count that is not a tile multiple. atol 1e-5: fp32 FMA and sinf, as the
    plain version with TF32 off (TF32 products or a fast __sinf would miss
    it)."""
    g = torch.Generator(device=dev).manual_seed(2)
    ws = [(torch.rand((o, i), device=dev, generator=g) * 2 - 1)
          * hidden_bound(i, 30.0) for i, o in zip(dims[:-1], dims[1:])]
    bs = [torch.rand((o,), device=dev, generator=g) * 0.2 - 0.1
          for o in dims[1:]]
    x = torch.rand((5001, dims[0]), device=dev, generator=g) * 2 - 1
    got, n = _launches("siren_mlp", lambda: siren_kernel.siren_mlp(
        x, ws, bs, 30.0, sine_last))
    assert n == 1
    torch.testing.assert_close(
        got, siren_kernel.siren_mlp_plain(x, ws, bs, 30.0, sine_last),
        rtol=0, atol=1e-5)


def test_wrappers_reject_float64(dev):
    x = torch.zeros((2, 4, 4, 8), device=dev, dtype=torch.float64)
    p = torch.zeros((2, 2, 5), device=dev, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        dcn.dcn_sample(x, p, p)


def test_kernels_build_from_the_sources(dev):
    kernels.build()
    for name in kernels.KERNELS:
        assert kernels._library_path(name).exists()
    assert np.isfinite(kernels.build())  # all built: nothing to do
