"""VideoINR (the reference's `LIIF`) against motif_tpu's on one flax init,
bridged with motif_tpu_torch.checkpoint, in float64 on the CPU (plain kernel
versions), at nf 16 with 1 / 1 residual blocks; and the float32
`siren_mlp`'s cut of an MLP too large for one block (`segments`: runs of
the resident kernel and single layers on the streamed-weight kernel) at
VideoINR's full widths, replayed launch by launch with the plain version on
the parameters as the kernels read them from the packed buffer.

Tolerances: the model 1e-9 (the same float64 formulas on both sides, the
recurrent alignment amplifying summation-order differences of ~1e-15 a few
orders at most); the replayed launches 1e-12 (float64 products of other
shapes, so BLAS may sum them in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motif_tpu.models import videoinr as jv
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch.models import videoinr as tv
from motif_tpu_torch.models.siren import hidden_bound
from motif_tpu_torch.ops import siren_kernel as sk


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
# VideoINR's three SIRENs at two LQ frames and nf 64
FULL = {"feat_imnet": [201, 64, 64, 256, 64],
        "flow_imnet": [263, 64, 64, 256, 4],
        "encode_imnet": [525, 64, 64, 256, 256, 3]}
# the same at the four LQ frames every training mode gives (LIIF training)
TRAIN = {"train_feat_imnet": [463, 64, 64, 256, 64],
         "train_flow_imnet": [525, 64, 64, 256, 4],
         "train_encode_imnet": [1049, 64, 64, 256, 256, 3]}
# single layers no block could hold 8 columns of before the
# streamed-weight kernel
WIDE = {"wide_6000": [6000, 8], "wide_64_6000": [64, 6000, 8]}
MOTIF = [[67, 64, 64, 256, 3], [66, 64, 64, 256, 64],
         [198, 64, 64, 64, 256, 3], [64, 64, 256, 3]]


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


@pytest.mark.parametrize("B,hw,out_hw,times", [
    (1, (8, 12), (32, 48), [[0.0, 0.5, 1.0]]),
    (2, (8, 8), (24, 40), [[0.25, 0.75], [0.1, 0.9]])],
    ids=["x4", "arbitrary-scale"])
def test_videoinr(rng, B, hw, out_hw, times):
    """The frames of every time; the LIIF tables at a 4x and at an
    arbitrary scale (3x and 5x)."""
    x = rng.random((B, 2, *hw, 3))
    tt = np.asarray(times)
    jm = jv.VideoINR(nf=NF, front_rbs=1, back_rbs=1)
    params = jax.jit(lambda k: jm.init(
        k, jnp.zeros(x.shape, jnp.float32), jnp.zeros(tt.shape, jnp.float32),
        out_hw))(jax.random.PRNGKey(0))["params"]
    params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    params = _perturb_offsets(params, np.random.default_rng(11))
    with jax.enable_x64(True):
        want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(tt),
                        out_hw)
    m = tv.VideoINR(NF, 1, 1).double()
    tckpt.load_flax_params(m, params)
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x), torch.from_numpy(tt), out_hw)
        with pytest.raises(ValueError, match="2 frames"):
            m(torch.from_numpy(x[:, :1]), torch.from_numpy(tt), out_hw)
    assert len(got) == len(want) == tt.shape[1]
    for g, w in zip(got, want):
        assert g.shape == (B, *out_hw, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


def test_warpgrid(rng):
    flow = rng.standard_normal((2, 5, 7, 2)) * 3.0
    with jax.enable_x64(True):
        want = jv._warpgrid(jnp.asarray(flow))
    got = tv._warpgrid(torch.from_numpy(flow))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


def test_full_width_sirens_have_the_planned_widths():
    """nf 64 and two frames give the widths `segments` is held to here."""
    m = tv.VideoINR()
    for name, dims in FULL.items():
        lins = getattr(m, name)._linears()
        assert [lins[0].in_features] + [lin.out_features for lin in lins] \
            == dims


@pytest.mark.parametrize("dims", MOTIF, ids=lambda d: "-".join(map(str, d)))
def test_segments_keep_a_motif_mlp_in_one_launch(dims):
    """Every MoTIF SIREN fits one block: one launch of the resident kernel,
    its plan unchanged."""
    (s,) = sk.segments(dims)
    assert (s.first, s.last, s.dims, s.layer) == (0, len(dims) - 1, dims,
                                                  False)
    assert (s.fused, s.rows, s.smem) == sk.plan(dims)
    assert sk.pack_size(dims, torch.float32) == sum(
        (k + 1) * (-(-n // 8) * 8) for k, n in zip(dims[:-1], dims[1:]))


@pytest.mark.parametrize("name", list(FULL) + list(TRAIN))
def test_segments_take_videoinr_widths(name):
    """Each resident launch fits a block, each other launch is one layer on
    the streamed-weight kernel; the launches cover every layer once, in
    order. feat_imnet: its first layer alone, then the fused rest;
    flow_imnet: one launch at two frames, its first layer alone then the
    rest at four; encode_imnet: the first layer, the next two, the
    256 -> 256 layer and the last, each alone."""
    dims = {**FULL, **TRAIN}[name]
    launches = sk.segments(dims)
    L, W = "layer", "resident"
    want = {"feat_imnet": [(0, 1, L), (1, 4, W)],
            "flow_imnet": [(0, 4, W)],
            "encode_imnet": [(0, 1, L), (1, 3, W), (3, 4, L), (4, 5, L)],
            "train_feat_imnet": [(0, 1, L), (1, 4, W)],
            "train_flow_imnet": [(0, 1, L), (1, 4, W)],
            "train_encode_imnet": [(0, 1, L), (1, 3, W), (3, 4, L),
                                   (4, 5, L)]}[name]
    assert [(s.first, s.last, L if s.layer else W) for s in launches] == want
    assert sk.plan(dims)[2] > sk.SMEM_LIMIT or len(launches) == 1
    layer = 0
    for s in launches:
        assert s.first == layer and s.dims == dims[s.first:s.last + 1]
        if s.layer:
            assert s.last == s.first + 1
            assert (s.fused, s.rows, s.smem) == (None, None, None)
        else:
            assert s.last >= s.first + 2
            assert (s.fused, s.rows, s.smem) == sk.plan(s.dims)
            assert s.smem <= sk.SMEM_LIMIT
        layer = s.last
    assert layer == len(dims) - 1


def _unpack(buf, dims):
    """The (weight (out, in), bias) of each layer, read back from the packed
    buffer at the offsets `layer_offsets` gives."""
    offs = sk.layer_offsets(dims)
    ws, bs = [], []
    for l, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        np_ = -(-n // 8) * 8
        off = offs[l]
        assert offs[l + 1] == off + (k + 1) * np_
        w = buf[off:off + k * np_].view(k, np_)
        assert not w[:, n:].any() and not buf[off + k * np_ + n:
                                              off + (k + 1) * np_].any()
        ws.append(w[:, :n].t())
        bs.append(buf[off + k * np_:off + k * np_ + n])
    return ws, bs


@pytest.mark.parametrize("sine_last", [False, True])
@pytest.mark.parametrize("name", list(FULL) + list(TRAIN) + list(WIDE))
def test_segments_reproduce_the_plain_mlp(name, sine_last):
    """The launches of `segments` replayed with `siren_mlp_plain`: each on
    its input (x, or the previous launch's activation), with the weights
    read from the packed buffer, a sine after its last layer unless that
    is the MLP's last linear one. Equals the plain MLP to 1e-12."""
    dims = {**FULL, **TRAIN, **WIDE}[name]
    g = torch.Generator().manual_seed(2)
    ws = [(torch.rand((o, i), generator=g, dtype=torch.float64) * 2 - 1)
          * hidden_bound(i, 30.0) for i, o in zip(dims[:-1], dims[1:])]
    bs = [torch.rand((o,), generator=g, dtype=torch.float64) * 0.2 - 0.1
          for o in dims[1:]]
    x = torch.rand((257, dims[0]), generator=g, dtype=torch.float64) * 2 - 1
    buf = sk.pack(ws, bs)
    assert buf.numel() == sk.pack_size(dims, torch.float32)
    lws, lbs = _unpack(buf, dims)
    h, L = x, len(ws)
    for s in sk.segments(dims):
        h = sk.siren_mlp_plain(h, lws[s.first:s.last], lbs[s.first:s.last],
                               30.0, sine_last or s.last < L)
    want = sk.siren_mlp_plain(x, ws, bs, 30.0, sine_last)
    np.testing.assert_allclose(h.numpy(), want.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", list(WIDE))
def test_segments_refuse_what_cannot_be_cut(name):
    """What no launch could hold before the streamed-weight kernel (a layer
    whose input is too wide for 8 columns of weights in a block, which
    raised) now plans: each such layer one launch of that kernel, which
    streams its weights; nothing raises."""
    dims = WIDE[name]
    launches = sk.segments(dims)
    assert [(s.first, s.last, s.layer) for s in launches] == [
        (l, l + 1, True) for l in range(len(dims) - 1)]
    assert sk.plan(dims)[2] > sk.SMEM_LIMIT
