"""The port's plain ops (motif_tpu_torch.ops: resize, warp, corr) against
their motif_tpu counterparts on the same numpy inputs, in float64.

Tolerance: atol 1e-10. Both sides run the same formulas in float64, so
they differ only by summation order (~1e-15 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motif_tpu.models import motif as jmotif
from motif_tpu.ops import corr as jcorr
from motif_tpu.ops import resize as jresize
from motif_tpu.ops import warp as jwarp
from motif_tpu_torch.models import motif as tmotif
from motif_tpu_torch.ops import corr as tcorr
from motif_tpu_torch.ops import resize as tresize
from motif_tpu_torch.ops import warp as twarp

ATOL = 1e-10


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("out_hw,align", [((21, 13), False), ((5, 4), False),
                                          ((24, 32), True), ((6, 3), True)])
def test_interpolate_bilinear(rng, out_hw, align):
    img = rng.standard_normal((2, 9, 11, 3))
    with jax.enable_x64(True):
        want = jresize.interpolate_bilinear(jnp.asarray(img), out_hw, align)
    got = tresize.interpolate_bilinear(torch.from_numpy(img), out_hw, align)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align", [False, True])
def test_grid_sample_with_nonfinite_coords(rng, mode, padding_mode, align):
    img = rng.standard_normal((2, 7, 9, 4))
    grid = rng.uniform(-1.4, 1.4, (2, 5, 6, 2))
    grid[0, 0, 0, 0] = np.inf
    grid[0, 1, 2, 1] = -np.inf
    grid[1, 3, 3, :] = np.nan
    with jax.enable_x64(True):
        want = jwarp.grid_sample(jnp.asarray(img), jnp.asarray(grid), mode,
                                 padding_mode, align)
    got = twarp.grid_sample(torch.from_numpy(img), torch.from_numpy(grid),
                            mode, padding_mode, align)
    assert np.isfinite(got.numpy()).all()
    _close(got, want)


@pytest.mark.parametrize("clip", [True, False])
def test_backwarp(rng, clip):
    img = rng.standard_normal((2, 8, 10, 3))
    flow = rng.standard_normal((2, 8, 10, 2)) * 4.0
    with jax.enable_x64(True):
        want, want_grid = jwarp.backwarp(jnp.asarray(img), jnp.asarray(flow),
                                         clip=clip)
    got, got_grid = twarp.backwarp(torch.from_numpy(img),
                                   torch.from_numpy(flow), clip=clip)
    _close(got, want)
    _close(got_grid, want_grid)


@pytest.mark.parametrize("hw", [(6, 8), (1, 1)])
def test_bilinear_sampler(rng, hw):
    """(1, 1) is RAFT's coarsest pyramid level: the size - 1 = 0 divide
    gives non-finite coordinates, which must sample zeros."""
    img = rng.standard_normal((2,) + hw + (3,))
    coords = rng.uniform(-2, 9, (2, 4, 5, 2))
    with jax.enable_x64(True):
        want, want_m = jwarp.bilinear_sampler(jnp.asarray(img),
                                              jnp.asarray(coords), mask=True)
    got, got_m = twarp.bilinear_sampler(torch.from_numpy(img),
                                        torch.from_numpy(coords), mask=True)
    _close(got, want)
    _close(got_m, want_m)


def test_corr_pyramid_and_lookup(rng):
    B, H, W, C = 2, 8, 12, 16
    f1 = rng.standard_normal((B, H, W, C))
    f2 = rng.standard_normal((B, H, W, C))
    coords = (np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1)[None]
              + rng.standard_normal((B, H, W, 2)) * 3.0)
    with jax.enable_x64(True):
        jc = jcorr.all_pairs_corr(jnp.asarray(f1), jnp.asarray(f2))
        jpyr = jcorr.corr_pyramid(jc, 4)
        want = jcorr.corr_lookup(jpyr, jnp.asarray(coords), 3)
    tc = tcorr.all_pairs_corr(torch.from_numpy(f1), torch.from_numpy(f2))
    _close(tc, jc)
    tpyr = tcorr.corr_pyramid(tc, 4)
    for a, b in zip(tpyr, jpyr):
        _close(a, b)
    got = tcorr.corr_lookup(tpyr, torch.from_numpy(coords), 3)
    assert got.shape == (B, H, W, 4 * 49)
    _close(got, want)


def test_gauss_blur_reflect(rng):
    x = rng.standard_normal((3, 6, 7, 2))
    with jax.enable_x64(True):
        want = jmotif._gauss_blur_reflect(jnp.asarray(x))
    _close(tmotif._gauss_blur_reflect(torch.from_numpy(x)), want)


@pytest.mark.parametrize("src,dst", [(16, 64), (15, 60), (28, 112),
                                     (64, 256), (112, 448)])
def test_liif_tables(src, dst):
    """Index tables equal exactly; relative coordinates stay float64."""
    jidx, jrel = jmotif.liif_nearest_axis(src, dst)
    tidx, trel = tmotif.liif_nearest_axis(src, dst)
    np.testing.assert_array_equal(tidx, jidx)
    assert trel.dtype == np.float64
    np.testing.assert_array_equal(trel, jrel)
