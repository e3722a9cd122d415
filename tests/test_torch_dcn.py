"""K2/K3 — the port's DCN im2col and deformable conv
(motif_tpu_torch.ops.dcn) against motif_tpu.

On the CPU `dcn_im2col` runs its plain version, built on the sampler
`dcn_sample_plain` (the gather form). The sampler is held against both TPU
kernels in interpret mode (sample_pallas, exact MXU passes;
sample_pallas_ywin in float64 at H % 8 == 0 with |offset| <= 8, the only
regime where that kernel is exact) and against the XLA one-hot sampler;
the im2col matrix against motif_tpu's own (positions, one-hot sampler,
mask); dcn_v2 against dcn_v2(backend="gather" and "onehot").
The CUDA kernel is held against the plain version on the card in
test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motif_tpu.ops import dcn as jdcn
from motif_tpu.ops.dcn_pallas import sample_pallas, sample_pallas_ywin
from motif_tpu_torch.ops import dcn as tdcn


def _positions(rng, B, G, Q, H, W, dtype=np.float64):
    py = rng.uniform(-3, H + 2, (B, G, Q)).astype(dtype)
    px = rng.uniform(-3, W + 2, (B, G, Q)).astype(dtype)
    py[0, 0, :4] = [-1.0, 0.0, H - 1.0, float(H)]   # exact integer rows
    px[0, 0, 4:8] = [-1.0, 0.0, W - 1.0, float(W)]
    return py, px


@pytest.mark.parametrize("shape", [(2, 16, 28, 4, 8, 700), (1, 9, 13, 8, 8, 512)])
def test_sample_plain_matches_pallas_kernel(rng, shape):
    """Against sample_pallas(exact=True) in interpret mode, float32 (the
    kernel's one-hot matmuls then run in the input dtype): atol 1e-5."""
    B, H, W, G, cg, Q = shape
    x = rng.random((B, H, W, G * cg), dtype=np.float32)
    py, px = _positions(rng, B, G, Q, H, W, np.float32)
    with jax.default_matmul_precision("highest"):
        want = sample_pallas(jnp.asarray(x), jnp.asarray(py), jnp.asarray(px),
                             interpret=True, exact=True)
    got = tdcn.dcn_sample_plain(*(torch.from_numpy(a) for a in (x, py, px)))
    assert got.shape == (B, Q, G, cg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("H,W", [(16, 12), (24, 20)])
def test_sample_plain_matches_ywin_kernel(rng, H, W):
    """Against sample_pallas_ywin in interpret mode, float64 (its passes
    are bf16 otherwise), H % 8 == 0 and |offset| <= 8. The kernel rounds
    the positions to float32, so both sides get float32-valued positions;
    it also forms its hat weights in float32 arithmetic, which bounds the
    agreement at atol 1e-6 on O(1) features."""
    B, G, cg, K, pad = 2, 4, 8, 3, 1
    offset = rng.uniform(-8, 8, (B, H, W, G * K * K * 2))
    x = rng.standard_normal((B, H, W, G * cg))
    py, px = (p.float().double() for p in tdcn.sample_positions(
        torch.from_numpy(offset), K, 1, pad, 1, G))
    with jax.enable_x64(True):
        want = sample_pallas_ywin(jnp.asarray(x), jnp.asarray(py.numpy()),
                                  jnp.asarray(px.numpy()), row_len=W * K * K,
                                  pad=pad, dilation=1, K=K, max_dy=8,
                                  interpret=True)
    got = tdcn.dcn_sample_plain(torch.from_numpy(x), py, px)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_sample_plain_matches_onehot(rng):
    B, H, W, G, cg, Q = 2, 11, 7, 8, 8, 300
    x = rng.standard_normal((B, H, W, G * cg))
    py, px = _positions(rng, B, G, Q, H, W)
    with jax.enable_x64(True):
        want = jdcn._sample_onehot(jnp.asarray(x), jnp.asarray(py),
                                   jnp.asarray(px))
    got = tdcn.dcn_sample_plain(*(torch.from_numpy(a) for a in (x, py, px)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("backend,atol", [("gather", 1e-6), ("onehot", 1e-10)])
@pytest.mark.parametrize("H,W,G,stride,pad,dil", [(12, 10, 2, 1, 1, 1),
                                                  (9, 13, 8, 1, 1, 1),
                                                  (10, 10, 2, 2, 2, 2)])
def test_dcn_v2_matches_motif_tpu(rng, H, W, G, stride, pad, dil, backend,
                                  atol):
    """The whole deformable conv against motif_tpu's dcn_v2 with float64
    inputs, offsets up to a few pixels past the border. The gather backend
    accumulates its weight contraction in float32 (atol 1e-6 on O(1)
    outputs); the one-hot backend keeps float64 (atol 1e-10)."""
    B, K, Cin, Cout = 2, 3, 16, 6
    Ho = (H + 2 * pad - (dil * (K - 1) + 1)) // stride + 1
    Wo = (W + 2 * pad - (dil * (K - 1) + 1)) // stride + 1
    x = rng.standard_normal((B, H, W, Cin))
    offset = rng.standard_normal((B, Ho, Wo, G * K * K * 2)) * 3.0
    mask = rng.random((B, Ho, Wo, G * K * K))
    w_hwio = rng.standard_normal((K, K, Cin, Cout)) * 0.2
    bias = rng.standard_normal((Cout,))
    with jax.enable_x64(True):
        want = jdcn.dcn_v2(*(jnp.asarray(a) for a in (x, offset, mask, w_hwio,
                                                       bias)),
                           kernel_size=K, stride=stride, padding=pad,
                           dilation=dil, deformable_groups=G, backend=backend)
    got = tdcn.dcn_v2(*(torch.from_numpy(a) for a in (
        x, offset, mask, w_hwio.transpose(3, 2, 0, 1), bias)),
        kernel_size=K, stride=stride, padding=pad, dilation=dil,
        deformable_groups=G)
    assert got.shape == (B, Ho, Wo, Cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def _dcn_case(rng, H, W, G, stride, pad, dil, B=2, K=3, Cin=16):
    Ho, Wo = tdcn.output_size(H, W, K, stride, pad, dil)
    x = rng.standard_normal((B, H, W, Cin))
    offset = rng.standard_normal((B, Ho, Wo, G * K * K * 2)) * 3.0
    mask = rng.random((B, Ho, Wo, G * K * K))
    return x, offset, mask, Ho, Wo


def _motif_tpu_im2col(x, offset, mask, K, stride, pad, dil, G):
    """motif_tpu's im2col tensor as _dcn_v2_onehot forms it
    (dcn.py:268-282): positions, the one-hot sampler, the transpose to
    (g, k, c) and the mask."""
    B, H, W, Cin = x.shape
    Ho, Wo = offset.shape[1:3]
    cg = Cin // G
    with jax.enable_x64(True):
        py, px = jdcn._sample_positions(jnp.asarray(offset), B, Ho, Wo, G, K,
                                        stride, pad, dil)
        Q = Ho * Wo * K * K
        py = py.transpose(0, 3, 1, 2, 4).reshape(B, G, Q)
        px = px.transpose(0, 3, 1, 2, 4).reshape(B, G, Q)
        val = jdcn._sample_onehot(jnp.asarray(x), py, px)
        val = val.reshape(B, Ho, Wo, K * K, G, cg).transpose(0, 1, 2, 4, 3, 5)
        val = val * jnp.asarray(mask).reshape(B, Ho, Wo, G, K * K, 1)
        return np.asarray(val.reshape(B * Ho * Wo, G * K * K * cg))


@pytest.mark.parametrize("H,W,G,stride,pad,dil", [(12, 10, 2, 1, 1, 1),
                                                  (9, 13, 8, 1, 1, 1),
                                                  (10, 10, 2, 2, 2, 2)])
def test_im2col_plain_matches_motif_tpu(rng, H, W, G, stride, pad, dil):
    """The plain im2col matrix against motif_tpu's, float64: atol 1e-10."""
    K = 3
    x, offset, mask, Ho, Wo = _dcn_case(rng, H, W, G, stride, pad, dil)
    want = _motif_tpu_im2col(x, offset, mask, K, stride, pad, dil, G)
    got = tdcn.dcn_im2col(*(torch.from_numpy(a) for a in (x, offset, mask)),
                          K, stride, pad, dil, G)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("G", [2, 8])
def test_im2col_takes_strided_offset_and_mask_views(rng, G):
    """Offsets and mask sliced from one conv-like output as DCNSep does,
    against motif_tpu's im2col of the same values, and dcn_v2 on the views
    against dcn_v2 on contiguous copies: float64, atol 1e-10."""
    K, H, W = 3, 11, 9
    x, _, _, Ho, Wo = _dcn_case(rng, H, W, G, 1, 1, 1)
    com = torch.from_numpy(rng.standard_normal((2, Ho, Wo, G * K * K * 3)))
    off = com[..., :2 * G * K * K] * 3.0
    com[..., :2 * G * K * K] = off
    off = com[..., :2 * G * K * K]
    mask = torch.sigmoid(com[..., 2 * G * K * K:])
    assert not off.is_contiguous()
    want = _motif_tpu_im2col(x, off.numpy(), mask.numpy(), K, 1, 1, 1, G)
    xt = torch.from_numpy(x)
    got = tdcn.dcn_im2col(xt, off, mask, K, 1, 1, 1, G)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
    w = torch.from_numpy(rng.standard_normal((6, 16, K, K)))
    b = torch.from_numpy(rng.standard_normal((6,)))
    np.testing.assert_allclose(
        tdcn.dcn_v2(xt, off, mask, w, b, K, 1, 1, 1, G).numpy(),
        tdcn.dcn_v2(xt, off.contiguous(), mask.contiguous(), w, b, K, 1, 1,
                    1, G).numpy(), rtol=0, atol=1e-10)


def test_dcn_v2_without_bias(rng):
    """bias=None: the product alone, against motif_tpu (onehot), float64."""
    K, G = 3, 2
    x, offset, mask, _, _ = _dcn_case(rng, 8, 7, G, 1, 1, 1)
    w_hwio = rng.standard_normal((K, K, 16, 5)) * 0.2
    with jax.enable_x64(True):
        want = jdcn.dcn_v2(*(jnp.asarray(a) for a in (x, offset, mask,
                                                       w_hwio)), None,
                           kernel_size=K, deformable_groups=G,
                           backend="onehot")
    got = tdcn.dcn_v2(*(torch.from_numpy(a) for a in (
        x, offset, mask, w_hwio.transpose(3, 2, 0, 1))), None,
        kernel_size=K, deformable_groups=G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10)
