"""The port's baselines against motif_tpu's on one flax init each, bridged
with motif_tpu_torch.checkpoint, in float64 on the CPU (plain kernel
versions): the NHWC layers (pixel_shuffle, max_pool2d, avg_pool2d_padded),
TMB and the time-modulated PCDAlign, ZSM, TMNet, EDVR and Super-SloMo. At
small size, as tests/test_baselines.py builds them: nf 16, 1 / 1 residual
blocks, EDVR at 3 frames, Super-SloMo at 32x64. Every conv_offset_mask is
perturbed, so the DCN offsets are real (they are zero at init).

Tolerance: atol 1e-9 (1e-12 for the layers). Both sides compute the same
float64 formulas; the recurrent alignment amplifies the summation-order
differences (~1e-15) by a few orders at most.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motif_tpu.models import baselines as jb
from motif_tpu.models import layers as jlayers
from motif_tpu.models.pcd import PCDAlign as JPCDAlign
from motif_tpu.models.pcd import TMB as JTMB
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch.models import baselines as tb
from motif_tpu_torch.models import layers as tlayers
from motif_tpu_torch.models.pcd import TMB, PCDAlign


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU forwards here are many small ops: one thread runs them
    as fast and does not contend with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-9
NF = 16


def _perturb_offsets(tree, rng):
    out = {}
    for k, v in tree.items():
        if k == "conv_offset_mask":
            out[k] = {"kernel": rng.standard_normal(v["kernel"].shape) * 0.05,
                      "bias": rng.standard_normal(v["bias"].shape) * 1.5}
        elif isinstance(v, dict):
            out[k] = _perturb_offsets(v, rng)
        else:
            out[k] = v
    return out


def _init64(module, *args, **kw):
    params = jax.jit(lambda k: module.init(k, *args, **kw))(
        jax.random.PRNGKey(0))["params"]
    params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    return _perturb_offsets(params, np.random.default_rng(11))


def _port(module, params):
    module = module.double()
    tckpt.load_flax_params(module, params)
    return module.eval()


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("name,args", [
    ("pixel_shuffle", (2,)), ("max_pool2d", ()), ("avg_pool2d_padded", ()),
    ("avg_pool2d_padded", (2, 2, 0))])
def test_layer(rng, name, args):
    """The NHWC layers on odd sizes (the pools' padded edges), 1e-12."""
    x = rng.standard_normal((2, 7, 9, 16))
    with jax.enable_x64(True):
        want = getattr(jlayers, name)(jnp.asarray(x), *args)
    got = getattr(tlayers, name)(torch.from_numpy(x), *args)
    assert got.shape == want.shape
    _close(got, want, 1e-12)


def test_tmb(rng):
    x = rng.standard_normal((2, 6, 5, NF))
    t = rng.uniform(-1, 1, (2, 1, 1, 1))
    jm = JTMB(NF)
    params = _init64(jm, jnp.zeros(x.shape, jnp.float32),
                     jnp.zeros(t.shape, jnp.float32))
    with jax.enable_x64(True):
        want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = _port(TMB(NF), params)(torch.from_numpy(x), torch.from_numpy(t))
    _close(got, want)


def _pyramid(rng, B, H, W):
    return [rng.standard_normal((B, H // s, W // s, NF)) for s in (1, 2, 4)]


def test_pcd_align_with_time(rng):
    """TMNet's PCD: each branch's offsets modulated by its own time code."""
    fea1, fea2 = _pyramid(rng, 2, 16, 20), _pyramid(rng, 2, 16, 20)
    t = rng.uniform(-1, 1, (2, 1, 1, 1))
    tb_ = rng.uniform(-1, 1, (2, 1, 1, 1))
    jm = JPCDAlign(NF, groups=8, use_time=True)
    zeros = lambda arrs: [jnp.zeros(a.shape, jnp.float32) for a in arrs]  # noqa: E731
    params = _init64(jm, zeros(fea1), zeros(fea2), jnp.zeros(t.shape),
                     jnp.zeros(t.shape))
    assert "TMB_B_l1" in params
    with jax.enable_x64(True):
        want = jm.apply({"params": params}, [jnp.asarray(a) for a in fea1],
                        [jnp.asarray(a) for a in fea2], jnp.asarray(t),
                        jnp.asarray(tb_))
    m = _port(PCDAlign(NF, 8, use_time=True), params)
    with torch.no_grad():
        got = m([torch.from_numpy(a) for a in fea1],
                [torch.from_numpy(a) for a in fea2], torch.from_numpy(t),
                torch.from_numpy(tb_))
        with pytest.raises(ValueError, match="use_time"):
            m([torch.from_numpy(a) for a in fea1],
              [torch.from_numpy(a) for a in fea2])
    assert got.shape == (2, 16, 20, 2 * NF)
    _close(got, want)


def test_pcd_align_without_time_has_no_tmb():
    """MoTIF's PCD keeps its parameters: no TMB unless asked for."""
    assert not any("TMB" in k for k in PCDAlign(NF, 8).state_dict())
    assert sum("TMB" in k for k in
               PCDAlign(NF, 8, use_time=True).state_dict()) == 6 * 7


@pytest.mark.parametrize("n_frames", [2, 3])
def test_zsm(rng, n_frames):
    x = rng.random((1, n_frames, 16, 12, 3))
    jm = jb.ZSM(nf=NF, front_rbs=1, back_rbs=1)
    params = _init64(jm, jnp.zeros(x.shape, jnp.float32))
    with jax.enable_x64(True):
        want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = _port(tb.ZSM(NF, 1, 1), params)(torch.from_numpy(x))
    assert got.shape == (1, 2 * n_frames - 1, 64, 48, 3)
    _close(got, want)


@pytest.mark.parametrize("n_frames,times", [(2, [[0.5]]),
                                            (3, [[0.25, 0.6]])])
def test_tmnet(rng, n_frames, times):
    """Interior times mapped to t = times / 0.5 - 1; N + (N - 1) Nt
    frames out."""
    x = rng.random((1, n_frames, 16, 12, 3))
    tt = np.asarray(times)
    jm = jb.TMNet(nf=NF, front_rbs=1, back_rbs=1)
    params = _init64(jm, jnp.zeros(x.shape, jnp.float32),
                     jnp.full(tt.shape, 0.5, jnp.float32))
    with jax.enable_x64(True):
        want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(tt))
    m = _port(tb.TMNet(NF, 1, 1), params)
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(tt))
    T = n_frames + (n_frames - 1) * tt.shape[1]
    assert got.shape == (1, T, 64, 48, 3)
    _close(got, want)
    with pytest.raises(ValueError, match="interior times"):
        m(torch.from_numpy(x))


@pytest.mark.parametrize("with_tsa", [True, False])
def test_edvr(rng, with_tsa):
    """EDVR at 3 frames, the DCNs at 8 groups of 2 channels."""
    x = rng.random((1, 3, 16, 12, 3))
    jm = jb.EDVR(nf=NF, num_frame=3, extract_blocks=1, recon_blocks=1,
                 with_tsa=with_tsa)
    params = _init64(jm, jnp.zeros(x.shape, jnp.float32))
    with jax.enable_x64(True):
        want = jm.apply({"params": params}, jnp.asarray(x))
    m = _port(tb.EDVR(NF, 3, 8, 1, 1, with_tsa), params)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
        with pytest.raises(ValueError, match="3 frames"):
            m(torch.from_numpy(x[:, :2]))
    assert got.shape == (1, 64, 48, 3)
    _close(got, want)
    keys = m.state_dict()
    assert "pcd_align.offset_conv1.l3.weight" in keys
    assert "reconstruction.0.conv1.weight" in keys


@pytest.mark.parametrize("factor", [1, 3])
def test_supersloMo(rng, factor):
    """Super-SloMo on LR 16x24 frames, sized to 32x64 outputs (the UNets at
    32x64); its flows are perturbed by the init only."""
    x = rng.random((1, 2, 16, 24, 3))
    jm = jb.SuperSloMo(h0=32, w0=64)
    params = _init64(jm, jnp.zeros(x.shape, jnp.float32), 2)
    with jax.enable_x64(True):
        want = jm.apply({"params": params}, jnp.asarray(x), factor)
    with torch.no_grad():
        got = _port(tb.SuperSloMo(), params)(torch.from_numpy(x), factor,
                                             (32, 64))
    assert got.shape == (1, factor + 1, 32, 64, 3)
    _close(got, want)


def test_sslomo_backwarp_normalises_by_the_width(rng):
    """The grid normalised by W and H (not W - 1, H - 1), zeros padding,
    align_corners=False. 1e-12."""
    img = rng.random((1, 4, 6, 3))
    flow = rng.standard_normal((1, 4, 6, 2)) * 2.0
    with jax.enable_x64(True):
        want = jb._sslomo_backwarp(jnp.asarray(img), jnp.asarray(flow))
    got = tb._sslomo_backwarp(torch.from_numpy(img), torch.from_numpy(flow))
    _close(got, want, 1e-12)
