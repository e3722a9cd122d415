"""The port's slice end to end against motif_tpu: the weight bridge, the
MoTIF forward and Evaluator.infer.

One flax init of MoTIF(setting=5, channel=16, front_rbs=1, back_rbs=2) is
bridged into the port (motif_tpu_torch.checkpoint) with conv_offset_mask
perturbed, so the DCN offsets are not the zeros of init. Both packages then
run LR 16x16 → HR 64x64, N=3, iters=2 in float64, the port on the CPU
(plain kernel versions). Tolerance on frames: atol 1e-6; both sides
compute the same float64 formulas, so they agree far inside it unless a
floor or a rounding flips, which the tolerance would catch.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motif_tpu import checkpoint as jckpt
from motif_tpu import eval as jeval
from motif_tpu.models.motif import MoTIF as JMoTIF
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch.eval import Evaluator
from motif_tpu_torch.models.motif import MoTIF, build_motif

CH, FRONT, BACK = 16, 1, 2
H = W = 16
HH = WW = 64
ITERS = 2
ATOL = 1e-6


def _perturb_offsets(tree, rng):
    """Random conv_offset_mask params: offsets of a few pixels, some of
    them out of the image."""
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


@pytest.fixture(scope="module")
def init_tree():
    model = JMoTIF(setting=5, channel=CH, front_rbs=FRONT, back_rbs=BACK)
    params = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 4, H, W, 3), jnp.float32),
        jnp.zeros((1, 3), jnp.float32), (HH, WW), iters=1))(
            jax.random.PRNGKey(0))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def params64(init_tree):
    tree = jax.tree.map(lambda a: np.asarray(a, np.float64), init_tree)
    return _perturb_offsets(tree, np.random.default_rng(7))


@pytest.fixture(scope="module")
def jax_apply():
    model = JMoTIF(setting=5, channel=CH, front_rbs=FRONT, back_rbs=BACK)
    with jax.enable_x64(True):
        f = jax.jit(lambda p, x, t: model.apply({"params": p}, x, t, (HH, WW),
                                                iters=ITERS))
    return f


def _port(params):
    m = MoTIF(CH, FRONT, BACK).double()
    tckpt.load_flax_params(m, params)
    return m.eval()


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_bridge_round_trip_is_identity(init_tree):
    """flax → port state_dict → motif_tpu.checkpoint.port_torch_state_dict
    gives back the same tree, and the port loads it with strict=True."""
    m = MoTIF(CH, FRONT, BACK)
    sd = tckpt.state_dict_from_flax(init_tree, m.state_dict().keys())
    m.load_state_dict(sd, strict=True)
    back = jckpt.port_torch_state_dict(m.state_dict())
    want = dict(_flat(init_tree))
    got = dict(_flat(jax.tree.map(np.asarray, back)))
    assert set(got) == set(want)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a, err_msg="/".join(path))


def test_bridge_names_missing_leaves(init_tree):
    m = MoTIF(CH, FRONT, BACK)
    tree = dict(init_tree)
    tree.pop("imnet")
    with pytest.raises(KeyError, match="imnet"):
        tckpt.state_dict_from_flax(tree, m.state_dict().keys())


@pytest.mark.parametrize("alpha", [None, 0.5])
def test_forward_matches_motif_tpu(params64, jax_apply, alpha):
    """alpha at init (-20: z <= 0, the max splat is skipped) and alpha > 0
    (the max splat runs)."""
    params = dict(params64)
    if alpha is not None:
        params["alpha"] = np.full((1,), alpha)
    rng = np.random.default_rng(3)
    x = rng.random((1, 4, H, W, 3))
    tt = np.asarray([[0.2, 0.5, 0.875]])
    with jax.enable_x64(True):
        want = jax_apply(params, jnp.asarray(x), jnp.asarray(tt))
    with torch.no_grad():
        got = _port(params)(torch.from_numpy(x), torch.from_numpy(tt),
                            (HH, WW), iters=ITERS)
    frames = got[0].numpy()
    assert frames.shape == (3, 1, HH, WW, 3)
    assert np.isfinite(frames).all()
    np.testing.assert_allclose(frames, np.asarray(want[0]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_evaluator_infer_matches_motif_tpu(params64, monkeypatch):
    """A non-/4 LQ (15x14 → padded 16x16) with 4 times: two chunks, the
    last padded by repetition and cropped. The JAX Evaluator pads into
    float32; for a float64 comparison its module's numpy is swapped for one
    whose float32 is float64 (motif_tpu itself is unchanged)."""
    np64 = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                    if not k.startswith("__")})
    np64.float32 = np.float64
    monkeypatch.setattr(jeval, "np", np64)
    rng = np.random.default_rng(5)
    lq = rng.random((1, 4, 15, 14, 3))
    times = np.asarray([[0.125, 0.375, 0.625, 0.875]])
    out_hw = (60, 56)
    with jax.enable_x64(True):
        jev = jeval.Evaluator(JMoTIF(setting=5, channel=CH, front_rbs=FRONT,
                                     back_rbs=BACK), params64, iters=ITERS)
        want, want_stats = jev.infer(lq, times, out_hw)
    got, got_stats = Evaluator(_port(params64), iters=ITERS,
                               device="cpu").infer(lq, times, out_hw)
    assert got.shape == (4, 1, 60, 56, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_stats, want_stats, rtol=0, atol=ATOL)


def test_build_motif_on_cpu_is_finite():
    m = build_motif(CH, FRONT, BACK, device="cpu", seed=1)
    assert next(m.parameters()).device.type == "cpu"
    x = torch.rand(1, 4, H, W, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        frames, _, _ = m(x, torch.tensor([[0.5]]), (HH, WW), iters=1)
    assert frames.shape == (1, 1, HH, WW, 3)
    assert torch.isfinite(frames).all()
    assert 0.0 <= frames.min() and frames.max() <= 1.0
