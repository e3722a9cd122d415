"""K1 — the port's splat (motif_tpu_torch.ops.softsplat) against motif_tpu.

On the CPU the wrapper runs its plain version (index_add_ and
scatter_reduce("amax") over ones); it is held against the Pallas ring-sweep
kernel in interpret mode and against the XLA scan backend, with flows that
throw pixels out of the image. The count must match exactly.
The CUDA kernel is held against it on the card in test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motif_tpu.ops.softsplat import splat_fused as jsplat_fused
from motif_tpu.ops.softsplat_pallas import _splat_pallas_fast, splat_violation
from motif_tpu_torch.ops import softsplat as tsplat


def _inputs(seed, B=2, H=16, W=20, C=5, flow_scale=3.0, z_scale=0.3,
            dtype=np.float64):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, H, W, C)).astype(dtype)
    flow = (rng.standard_normal((B, H, W, 2)) * flow_scale).astype(dtype)
    flow[0, 0, :, 1] = -30.0                   # thrown off the top
    flow[1, :, -2:, 0] = 2.5                   # pushed past the right edge
    z = (rng.standard_normal((B, H, W, 1)) * z_scale).astype(dtype)
    return img, flow, z


@pytest.mark.parametrize("seed,flow_scale", [(0, 3.0), (1, 0.0), (2, 8.0)])
def test_plain_matches_pallas_kernel(seed, flow_scale):
    """Against _splat_pallas_fast in interpret mode, H % 8 == 0 and
    max_dy = 18 >= H + 2 (the ring reaches every in-image row, so the
    kernel alone is exact for any flow). The Pallas kernel runs in float32
    only (its loop counters are int32), so both sides run float32:
    atol 2e-5 for the differing summation order; the count exact."""
    img, flow, z = _inputs(seed, flow_scale=flow_scale, dtype=np.float32)
    assert not bool(splat_violation(jnp.asarray(flow), 18))
    out_p, norm_p, cnt_p = _splat_pallas_fast(
        jnp.asarray(img), jnp.asarray(flow), jnp.exp(jnp.asarray(z)),
        max_dy=18, compute_dtype=None, interpret=True)
    out, norm, _, cnt = tsplat.splat_fused(
        torch.from_numpy(img), torch.from_numpy(flow), torch.from_numpy(z),
        z_nonpositive=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_p), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(norm.numpy(), np.asarray(norm_p), rtol=0,
                               atol=2e-5)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_p))


@pytest.mark.parametrize("z_nonpositive", [False, True])
@pytest.mark.parametrize("seed", [3, 4])
def test_plain_matches_scan_backend(seed, z_nonpositive):
    """All four outputs against splat_fused(method="scan") in float64:
    z > 0 in places (the max splat runs) and z <= 0 everywhere with the
    z_nonpositive shortcut. Tolerance: atol 1e-10; count exact."""
    img, flow, z = _inputs(seed, z_scale=1.0)
    if z_nonpositive:
        z = -np.abs(z)
    with jax.enable_x64(True):
        want = jsplat_fused(jnp.asarray(img), jnp.asarray(flow),
                            jnp.asarray(z),
                            z_nonpositive=jnp.asarray(z_nonpositive),
                            method="scan")
    got = tsplat.splat_fused(torch.from_numpy(img), torch.from_numpy(flow),
                             torch.from_numpy(z), z_nonpositive=z_nonpositive)
    for name, g, w in zip(("out", "norm", "z_max"), got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-10, err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    if not z_nonpositive:
        assert (got[2].numpy() > 1.0).any(), "the max splat was not exercised"


def test_z_nonpositive_shortcut_is_exact():
    """With z <= 0 everywhere, skipping the max splat gives the z_max that
    running it gives: ones, since e^z * w <= 1."""
    img, flow, z = _inputs(5, z_scale=1.0)
    args = [torch.from_numpy(a) for a in (img, flow, -np.abs(z))]
    skipped = tsplat.splat_fused(*args, z_nonpositive=True)
    computed = tsplat.splat_fused(*args, z_nonpositive=False)
    for s, c in zip(skipped, computed):
        np.testing.assert_array_equal(s.numpy(), c.numpy())
    assert (skipped[2] == 1.0).all()


def test_all_out_of_image_is_zero():
    img, flow, z = _inputs(6)
    flow[..., 0] = 1e6
    out, norm, z_max, cnt = tsplat.splat_fused(
        *(torch.from_numpy(a) for a in (img, flow, z)), z_nonpositive=False)
    assert not out.any() and not norm.any() and not cnt.any()
    assert (z_max == 1.0).all()
