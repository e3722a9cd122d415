"""The public ops that motif_tpu exports and the port had not (XLA there,
plain PyTorch here): flow_warp, splat_sum, splat_max, splat_count,
function_softsplat (four modes), softmax_splat and imresize_matlab, in
float64 against motif_tpu.ops on the same seeded inputs, within 1e-12;
and the names of motif_tpu.ops all exported by the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import motif_tpu.ops as jops
import motif_tpu_torch.ops as ops

B, H, W, C = 2, 9, 11, 4


def _inputs(seed, scale=2.5):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, H, W, C))
    flow = rng.standard_normal((B, H, W, 2)) * scale
    flow[0, 0, 0] = (40.0, -3.0)                  # a source off the image
    z = rng.standard_normal((B, H, W, 1))
    return img, flow, z


def _t(*a):
    return [torch.from_numpy(x) for x in a]


def _close(got, want, atol=1e-12):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


def test_exports_match_motif_tpu():
    names = [n for n in dir(jops) if not n.startswith("_")
             and callable(getattr(jops, n))]
    assert sorted(n for n in names if not hasattr(ops, n)) == []


@pytest.mark.parametrize("mode,pad,align", [
    ("bilinear", "zeros", False), ("bilinear", "border", True),
    ("nearest", "zeros", False), ("bilinear", "reflection", False)])
def test_flow_warp_matches_motif_tpu(mode, pad, align):
    img, flow, _ = _inputs(0)
    got = ops.flow_warp(*_t(img, flow), mode, pad, align)
    with jax.enable_x64(True):
        want = jops.flow_warp(jnp.asarray(img), jnp.asarray(flow), mode, pad,
                              align)
    _close(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_splats_match_motif_tpu(seed):
    img, flow, _ = _inputs(seed)
    ti, tf = _t(img, flow)
    with jax.enable_x64(True):
        ji, jf = jnp.asarray(img), jnp.asarray(flow)
        want = (jops.splat_sum(ji, jf), jops.splat_max(ji, jf),
                jops.splat_count(jf))
    got = (ops.splat_sum(ti, tf), ops.splat_max(ti, tf),
           ops.splat_count(tf))
    for g, w in zip(got, want):
        _close(g, w)
    assert got[2].dtype == torch.float32 and got[2].shape == (B, H, W, 1)
    assert float(got[1].min()) >= 1.0           # ones-initialised


def test_splat_max_and_count_take_no_gradient():
    img, flow, _ = _inputs(2)
    ti, tf = _t(img, flow)
    ti.requires_grad_(True)
    tf.requires_grad_(True)
    assert not ops.splat_max(ti, tf).requires_grad
    assert not ops.splat_count(tf).requires_grad
    s = ops.splat_sum(ti, tf).sum()
    s.backward()
    assert ti.grad is not None and tf.grad is not None


@pytest.mark.parametrize("mode", ["summation", "average", "linear",
                                  "softmax"])
def test_function_softsplat_matches_motif_tpu(mode):
    from motif_tpu.ops.softsplat import function_softsplat as jfs
    from motif_tpu_torch.ops.softsplat import function_softsplat

    img, flow, z = _inputs(3)
    zz = None if mode in ("summation", "average") else z
    got = function_softsplat(*_t(img, flow),
                             None if zz is None else torch.from_numpy(zz),
                             mode)
    with jax.enable_x64(True):
        want = jfs(jnp.asarray(img), jnp.asarray(flow),
                   None if zz is None else jnp.asarray(zz), mode)
    _close(got[0], want[0])
    if mode == "summation":
        assert got[1] is None and want[1] is None
    else:
        _close(got[1], want[1])


def test_softmax_splat_matches_motif_tpu():
    img, flow, z = _inputs(4)
    got = ops.softmax_splat(*_t(img, flow, z))
    with jax.enable_x64(True):
        want = jops.softmax_splat(jnp.asarray(img), jnp.asarray(flow),
                                  jnp.asarray(z))
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("scale,aa", [(0.25, True), (0.37, False),
                                      (2.0, True)])
def test_imresize_matlab_matches_motif_tpu(scale, aa):
    img = np.random.default_rng(5).random((2, 17, 23, 3))
    got = ops.imresize_matlab(torch.from_numpy(img), scale, aa)
    with jax.enable_x64(True):
        want = jops.imresize_matlab(jnp.asarray(img), scale, aa)
    assert tuple(got.shape) == np.asarray(want).shape
    _close(got, want)
