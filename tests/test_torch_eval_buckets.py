"""`Evaluator.infer` through its shape buckets (the counterpart of
motif_tpu/eval.py's compiled forward per bucket): one bucket per key,
reused by a second request, a new one for another LQ shape, output size,
knob set or sign of alpha; the bucketed request bit for bit equal to the
eager per-chunk path (`_infer_eager`) on the CPU, where a bucket runs the
eager forward, for Ours, Ours_44, LIIF and Super_SloMo; and `infer`
against `motif_tpu.eval.Evaluator.infer` in float64 for the same four
families (frames and flow statistics, 1e-9: both sides compute the same
float64 formulas). Also the tables VideoINR and Super-SloMo keep per
shape instead of uploading them on every call, bit-equal to the per-call
ones.

The models are cut to width 16 (MoTIF 1 / 2 residual blocks, the
baselines 1 / 1), one flax init per family bridged into the port with the
DCN offsets perturbed; the JAX Evaluator pads into float32, so its module's
numpy is swapped for one whose float32 is float64 (motif_tpu itself is
unchanged).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motif_tpu import eval as jeval
from motif_tpu.models import factory as jfactory
from motif_tpu.models.motif import MoTIF as JMoTIF
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch.eval import Evaluator
from motif_tpu_torch.models import baselines, factory, videoinr
from motif_tpu_torch.models.motif import (MoTIF, liif_nearest_axis,
                                          make_coord_1d)

NF = 16
TOL = 1e-9
LQ_HW = (15, 22)                        # padded to 16 x 24, frames 64 x 96
ANCHORS = {"Ours": 2, "Ours_44": 4}     # MoTIF at 1 / 2 residual blocks
NET = {"LIIF": dict(which_model_G="LIIF", nf=NF, front_RBs=1, back_RBs=1,
                    setting=5, groups=8),
       "Super_SloMo": dict(which_model_G="Super_SloMo")}
FAMILIES = ("Ours", "Ours_44", "LIIF", "Super_SloMo")
N_IN = {"Ours": 4, "Ours_44": 4, "LIIF": 2, "Super_SloMo": 2}
# Ours: 7 times in chunks of 3 (the last padded); Ours_44 one a forward
TIMES = {"Ours": np.linspace(0, 1, 7)[None],
         "Ours_44": np.asarray([[1 / 6, 0.5, 5 / 6]]),
         "LIIF": np.linspace(0, 1, 3)[None],
         "Super_SloMo": np.linspace(0, 1, 3)[None]}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU forwards are many small ops: one thread runs them as
    fast and does not contend with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _init_args(family):
    x0 = jnp.zeros((1, N_IN[family], 16, 16, 3), jnp.float32)
    if family in ("Ours", "Ours_44"):
        return x0, jnp.zeros((1, 3), jnp.float32), (64, 64)
    if family == "LIIF":
        return x0, jnp.zeros((1, 2), jnp.float32), (64, 64)
    return x0, 2


def _np64():
    np64 = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                    if not k.startswith("__")})
    np64.float32 = np.float64
    return np64


def _inputs(family, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((1, N_IN[family], *LQ_HW, 3)), TIMES[family]


def _jmodel(name):
    if name in ANCHORS:
        return JMoTIF(setting=5, channel=NF, front_rbs=1, back_rbs=2,
                      n_anchors=ANCHORS[name])
    return jfactory.define_g(NET[name])


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(family, float64 params, motif_tpu's frames and flow statistics of
    `_inputs(family)` in float64): one JAX compile per family."""
    name = request.param
    jm = _jmodel(name)
    kw = {"iters": 1} if name in ANCHORS else {}
    params = jax.jit(lambda k: jm.init(k, *_init_args(name), **kw))(
        jax.random.PRNGKey(0))["params"]
    params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    params = _perturb_offsets(params, np.random.default_rng(7))
    lq, times = _inputs(name)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jeval, "np", _np64())
        jev = jeval.Evaluator(jm, params, iters=2,
                              chunk=factory.EVAL_CHUNK.get(name, 3),
                              family=name)
        want = jev.infer(lq, times, (60, 88))
    return name, params, want


def _port(name, params=None):
    if name in ANCHORS:
        m = MoTIF(NF, 1, 2, n_anchors=ANCHORS[name])
    else:
        m = factory.define_g(NET[name], device="cpu")
    if params is not None:
        m = m.double()
        tckpt.load_flax_params(m, params)
    return m.eval()


def _evaluator(name, model):
    return Evaluator(model, iters=2, chunk=factory.EVAL_CHUNK.get(name, 3),
                     family=name, device="cpu")


def test_infer_matches_motif_tpu(family):
    """The bucketed `infer` against motif_tpu's jitted one, frames and flow
    statistics, in float64 (Ours: 7 times in 3 chunks, the last padded;
    Ours_44: 3 forwards of one time)."""
    name, params, (want, want_stats) = family
    lq, times = _inputs(name)
    got, stats = _evaluator(name, _port(name, params)).infer(lq, times,
                                                             (60, 88))
    assert got.shape == want.shape == (times.shape[1], 1, 60, 88, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if name in ANCHORS:
        np.testing.assert_allclose(stats, want_stats, rtol=0, atol=TOL)
    else:
        assert stats is None and want_stats is None


def test_buckets_equal_the_eager_path_bit_for_bit(family):
    """Two requests through the bucket (the second reusing it) against the
    eager per-chunk path: the same frames and flow statistics, bit for
    bit."""
    name, params, _ = family
    ev = _evaluator(name, _port(name, params))
    lq, times = _inputs(name, seed=1)
    want, want_stats = ev._infer_eager(lq, times, (60, 88))
    for _ in range(2):
        got, stats = ev.infer(lq, times, (60, 88))
        np.testing.assert_array_equal(got, want)
        assert stats == want_stats
    assert len(ev._buckets) == 1


def test_a_request_reuses_its_bucket():
    ev = _evaluator("Ours", _port("Ours"))
    lq, times = _inputs("Ours")
    a, _ = ev.infer(lq, times, (60, 88))
    (bucket,) = ev._buckets.values()
    b, _ = ev.infer(lq, times, (58, 80))        # another crop, same bucket
    assert list(ev._buckets.values()) == [bucket]
    np.testing.assert_array_equal(a[:, :, :58, :80], b)


def _change(ev, change):
    """The inputs of a request after `change`: a new LQ shape, output size
    (the scale), knob set, or a loaded state with alpha's other sign."""
    lq, times = _inputs("Ours")
    if change == "lq_shape":
        lq = np.pad(lq, ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0)))
    elif change == "out_hw":
        ev.scale = 5
    elif change == "knobs":
        ev.model.configure(fused_decode=True)
    else:
        sd = dict(ev.model.state_dict())
        sd["alpha"] = torch.full((1,), 0.25)
        ev.model.load_state_dict(sd)
    return lq, times


@pytest.mark.parametrize("change", ["lq_shape", "out_hw", "knobs",
                                    "alpha_sign"])
def test_another_key_gets_another_bucket(change):
    """A new bucket for another padded LQ shape, output size (the scale)
    or knob set, the first one kept; a load (here of a state whose alpha is
    positive) drops every bucket, as their graphs hold what the old weights
    made, and the new bucket's key has the other sign. Each request equal
    to the eager path's, bit for bit."""
    ev = _evaluator("Ours", _port("Ours"))
    lq, times = _inputs("Ours")
    ev.infer(lq, times, (60, 88))
    (first,) = ev._buckets
    lq, times = _change(ev, change)
    got, stats = ev.infer(lq, times, (32, 44))
    keys = list(ev._buckets)
    if change == "alpha_sign":
        assert first[-1] is True and len(keys) == 1 and keys[0][-1] is False
        assert keys[0][:-1] == first[:-1]
    else:
        assert len(keys) == 2 and keys[0] == first and keys[1] != first
    want, want_stats = ev._infer_eager(lq, times, (32, 44))
    np.testing.assert_array_equal(got, want)
    assert stats == want_stats


def test_padded_last_chunk():
    """7 times in chunks of 3: three replays of one bucket, the last chunk
    padded with its last time and cropped; each time's frame equals the
    same time asked alone in a chunk of its own."""
    ev = _evaluator("Ours", _port("Ours"))
    lq, times = _inputs("Ours")
    got, _ = ev.infer(lq, times, (60, 88))
    assert got.shape == (7, 1, 60, 88, 3) and len(ev._buckets) == 1
    alone = _evaluator("Ours", ev.model)
    alone.chunk = 1
    want, _ = alone.infer(lq, times, (60, 88))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_videoinr_tables_are_the_per_call_ones():
    """`_linspace` and `_liif_tables`, kept per shape, are bit-equal to
    the tables built and uploaded anew, and the same objects on a second
    call."""
    for n, dtype in ((96, torch.float32), (64, torch.float64)):
        got = videoinr._linspace(n, dtype, torch.device("cpu"))
        assert got is videoinr._linspace(n, dtype, torch.device("cpu"))
        torch.testing.assert_close(got, torch.as_tensor(
            np.linspace(-1.0, 1.0, n), dtype=dtype), rtol=0, atol=0)
    H, W, HH, WW = 16, 24, 64, 96
    tabs = videoinr._liif_tables(H, W, HH, WW, torch.float64,
                                 torch.device("cpu"))
    assert tabs is videoinr._liif_tables(H, W, HH, WW, torch.float64,
                                         torch.device("cpu"))
    iy, _ = liif_nearest_axis(H, HH, 0.0)
    ix, _ = liif_nearest_axis(W, WW, 0.0)
    hy = np.clip(make_coord_1d(HH), -1 + 1e-6, 1 - 1e-6)
    hx = np.clip(make_coord_1d(WW), -1 + 1e-6, 1 - 1e-6)
    rel = np.stack(np.meshgrid(
        ((hy - make_coord_1d(H)[iy]) * H).astype(np.float32),
        ((hx - make_coord_1d(W)[ix]) * W).astype(np.float32),
        indexing="ij"), -1)
    grid = np.stack(np.meshgrid(hx, hy, indexing="xy"), -1)
    for a, b in zip(tabs, (torch.as_tensor(iy), torch.as_tensor(ix),
                           torch.as_tensor(rel).double(),
                           torch.as_tensor(grid, dtype=torch.float32))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_superslomo_mean_is_the_per_call_one():
    for dtype in (torch.float32, torch.float64):
        got = baselines._sslomo_mean(dtype, torch.device("cpu"))
        assert got is baselines._sslomo_mean(dtype, torch.device("cpu"))
        torch.testing.assert_close(got, torch.tensor(
            [0.429, 0.431, 0.397], dtype=dtype), rtol=0, atol=0)
