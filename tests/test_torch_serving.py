"""The port's serving knobs (fused_decode, compute_dtype, splat_dtype,
raft_resolution, decode_chunks) against motif_tpu with the same knobs.

One flax init of MoTIF(setting=5, channel=16, front_rbs=1, back_rbs=2) is
bridged into the port with conv_offset_mask perturbed, as in
test_torch_motif.py. The exact-math knobs (decode_chunks, raft_resolution,
fused_decode) run in float64 on both sides, LR 16x16 -> HR 64x64 (LR 32x40
-> HR 128x160 for the reduced RAFT grid, where both the 64-pixel floor and
the per-component rescale show), and agree to atol 1e-6. The low-precision
knobs run in float32 with bfloat16 / float16 inside and are held by the JAX
package's own gate: max abs < 6e-2 on frames in [0, 1].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motif_tpu.models.motif import MoTIF as JMoTIF
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch.eval import Evaluator
from motif_tpu_torch.models.motif import MoTIF, build_motif


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU forwards here are many small ops: one thread runs them
    as fast and does not contend with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CH, FRONT, BACK = 16, 1, 2
H = W = 16
HH = WW = 64
ITERS = 2
ATOL = 1e-6
SERVING = dict(fused_decode=True, compute_dtype="bfloat16",
               splat_dtype="float16", raft_resolution=0.5, decode_chunks=3)


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


@pytest.fixture(scope="module")
def params64():
    model = JMoTIF(setting=5, channel=CH, front_rbs=FRONT, back_rbs=BACK)
    params = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 4, H, W, 3), jnp.float32),
        jnp.zeros((1, 3), jnp.float32), (HH, WW), iters=1))(
            jax.random.PRNGKey(0))["params"]
    tree = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    return _perturb_offsets(tree, np.random.default_rng(7))


_JITTED = {}     # one compiled motif_tpu forward per (knobs, size, dtype)


def _jax_forward(params, x, tt, out_hw, dtype, **knobs):
    if "splat_dtype" in knobs:
        knobs["splat_method"] = "base"   # the backend that takes the dtype
    key = (tuple(sorted(knobs.items())), out_hw, np.dtype(dtype).name)
    if key not in _JITTED:
        model = JMoTIF(setting=5, channel=CH, front_rbs=FRONT, back_rbs=BACK,
                       **knobs)
        _JITTED[key] = jax.jit(lambda p, x, t: model.apply(
            {"params": p}, x, t, out_hw, iters=ITERS))
    with jax.enable_x64(dtype == np.float64):
        p = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
        out = _JITTED[key](p, jnp.asarray(x, dtype), jnp.asarray(tt, dtype))
        return [np.asarray(o) for o in out]


def _port(params, dtype=torch.float64, **knobs):
    m = MoTIF(CH, FRONT, BACK, **knobs).to(dtype)
    tckpt.load_flax_params(m, params)
    return m.eval()


def _port_forward(params, x, tt, out_hw, dtype=torch.float64, **knobs):
    with torch.no_grad():
        out = _port(params, dtype, **knobs)(
            torch.from_numpy(x).to(dtype), torch.from_numpy(tt).to(dtype),
            out_hw, iters=ITERS)
    return [o.numpy() for o in out]


def _inputs(seed=3, h=H, w=W):
    rng = np.random.default_rng(seed)
    return rng.random((1, 4, h, w, 3)), np.asarray([[0.2, 0.5, 0.875]])


def _with_alpha(params, alpha):
    params = dict(params)
    if alpha is not None:
        params["alpha"] = np.full((1,), alpha)
    return params


@pytest.mark.parametrize("fused", [False, True], ids=["reference", "fused"])
def test_decode_chunks_is_exact(params64, fused):
    """decode_chunks=3 gives bit for bit what decode_chunks=1 gives, in
    both decode orders: the SIRENs are pointwise over tokens (float32: the
    exactness does not depend on the dtype)."""
    x, tt = _inputs()
    one = _port_forward(params64, x, tt, (HH, WW), torch.float32,
                        fused_decode=fused)
    three = _port_forward(params64, x, tt, (HH, WW), torch.float32,
                          fused_decode=fused, decode_chunks=3)
    for a, b in zip(one, three):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("knobs,hw", [
    (dict(decode_chunks=3), (H, W)),
    (dict(raft_resolution=0.5), (32, 40)),
], ids=["decode_chunks", "raft_resolution"])
def test_exact_knobs_match_motif_tpu(params64, knobs, hw):
    """float64, atol 1e-6, frames and flow, in the reference decode order
    (the fused order with decode_chunks=3: the next test).
    raft_resolution=0.5 at HR 128x160 runs RAFT on 64x80: the height is
    held by the 64-pixel floor and the width is halved, so the flow's two
    components are rescaled by different factors."""
    x, tt = _inputs(4, *hw)
    out_hw = (hw[0] * 4, hw[1] * 4)
    want = _jax_forward(params64, x, tt, out_hw, np.float64, **knobs)
    got = _port_forward(params64, x, tt, out_hw, **knobs)
    assert got[0].shape == (3, 1) + out_hw + (3,)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[2], want[2])


def test_raft_resolution_changes_the_flow(params64):
    """The reduced grid is really taken: the flow differs from the full
    grid's (else the comparison above would hold trivially)."""
    x, tt = _inputs(4, 32, 40)
    full = _port_forward(params64, x, tt, (128, 160), torch.float32)
    half = _port_forward(params64, x, tt, (128, 160), torch.float32,
                         raft_resolution=0.5)
    assert np.abs(full[1] - half[1]).max() > 1e-4


@pytest.mark.parametrize("alpha", [None, 0.5], ids=["alpha<=0", "alpha>0"])
def test_fused_decode_matches_motif_tpu(params64, alpha):
    """fused_decode=True against motif_tpu's, both with decode_chunks=3
    (which is exact, see above), float64, atol 1e-6, frames and flow;
    alpha at init (-20: the max splat is skipped) and alpha > 0 (it
    runs)."""
    params = _with_alpha(params64, alpha)
    x, tt = _inputs()
    knobs = dict(fused_decode=True, decode_chunks=3)
    want = _jax_forward(params, x, tt, (HH, WW), np.float64, **knobs)
    got = _port_forward(params, x, tt, (HH, WW), **knobs)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=ATOL)


def test_fused_decode_matches_reference_order_float32(params64):
    """fused_decode is the same math in another float-op order: in float32
    frames and flow stay within 5e-3 of the port's own reference order (the
    JAX package's gate for its fused path)."""
    x, tt = _inputs()
    ref = _port_forward(params64, x, tt, (HH, WW), torch.float32)
    fused = _port_forward(params64, x, tt, (HH, WW), torch.float32,
                          fused_decode=True)
    assert np.abs(fused[0] - ref[0]).max() < 5e-3
    assert np.abs(fused[1] - ref[1]).max() < 5e-3


@pytest.mark.parametrize("knobs,tol", [
    (dict(compute_dtype="bfloat16"), 2e-2),
    (dict(fused_decode=True, compute_dtype="bfloat16"), None),
    (dict(splat_dtype="float16"), None),
    (SERVING, 2e-2),
], ids=["bf16", "bf16+fused", "f16-splat", "serving"])
def test_low_precision_knobs(params64, knobs, tol):
    """float32 in and out with bfloat16 / float16 inside: the port against
    its own float32 path by the JAX package's gate (finite float32 frames,
    max abs < 6e-2; measured 7.5e-3, and 5.7e-5 for the float16 splat
    alone), and, for bfloat16 in the reference order and for all knobs
    together, against motif_tpu with the same knobs within `tol` on frames
    and flow (measured 4.8e-3 and 2.2e-3; the knobs in between were
    measured once at 4.4e-3 and, the float16 splat alone, 7.3e-6, and are
    left out of the lane for its time). The two packages round at the
    same points but do not sum in the same order, and a bfloat16 ulp in a
    motion SIREN moves a splatted pixel across a floor(), so bfloat16 is
    not held tighter than 2e-2."""
    x, tt = _inputs()
    ref = _port_forward(params64, x, tt, (HH, WW), torch.float32)
    got = _port_forward(params64, x, tt, (HH, WW), torch.float32, **knobs)
    for o in got:
        assert o.dtype == np.float32 and np.isfinite(o).all()
    assert np.abs(got[0] - ref[0]).max() < 6e-2
    if tol is not None:
        want = _jax_forward(params64, x, tt, (HH, WW), np.float32, **knobs)
        assert np.abs(got[0] - want[0]).max() < tol
        assert np.abs(got[1] - want[1]).max() < tol


def test_serving_evaluator_infer(params64):
    """All knobs on through Evaluator.infer(device="cpu"), the knobs given
    to the Evaluator: a non-/4 LQ with 4 times (two chunks, the last
    padded and cropped), against the float32 path by the 6e-2 gate."""
    rng = np.random.default_rng(5)
    lq = rng.random((1, 4, 15, 14, 3)).astype(np.float32)
    times = np.asarray([[0.125, 0.375, 0.625, 0.875]], np.float32)
    ref, _ = Evaluator(_port(params64, torch.float32), iters=ITERS,
                       device="cpu").infer(lq, times, (60, 56))
    ev = Evaluator(_port(params64, torch.float32), iters=ITERS, device="cpu",
                   **SERVING)
    assert ev.model.fused_decode and ev.model.decode_chunks == 3
    got, stats = ev.infer(lq, times, (60, 56))
    assert got.shape == (4, 1, 60, 56, 3) and got.dtype == np.float32
    assert np.isfinite(got).all() and np.isfinite(stats).all()
    assert np.abs(got - ref).max() < 6e-2


def test_knobs_do_not_change_the_parameters():
    """One checkpoint loads in every mode: same keys, shapes and float32
    dtypes with all knobs on, and build_motif's weights do not depend on
    them."""
    plain = build_motif(CH, FRONT, BACK, device="cpu", seed=2)
    serving = build_motif(CH, FRONT, BACK, device="cpu", seed=2, **SERVING)
    a, b = plain.state_dict(), serving.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == torch.float32
        assert torch.equal(a[k], b[k]), k


def test_unknown_dtype_knob_raises():
    with pytest.raises(ValueError, match="compute_dtype"):
        MoTIF(CH, FRONT, BACK, compute_dtype="float16")
    with pytest.raises(ValueError, match="splat_dtype"):
        MoTIF(CH, FRONT, BACK, splat_dtype="bfloat16")


def test_cast_weights_follow_a_load(params64):
    """The bfloat16 copies of the weights are cached on the modules; a
    load_state_dict into the same model must not leave stale copies."""
    x, tt = _inputs()
    xt, ttt = torch.from_numpy(x).float(), torch.from_numpy(tt).float()
    m = _port(params64, torch.float32, **SERVING)
    with torch.no_grad():
        first = m(xt, ttt, (HH, WW), iters=ITERS)[0]
        other = build_motif(CH, FRONT, BACK, device="cpu", seed=9)
        m.load_state_dict(other.state_dict())
        second = m(xt, ttt, (HH, WW), iters=ITERS)[0]
        fresh = build_motif(CH, FRONT, BACK, device="cpu", seed=9, **SERVING)
        want = fresh(xt, ttt, (HH, WW), iters=ITERS)[0]
    assert not torch.equal(first, second)
    assert torch.equal(second, want)


def test_alpha_sign_is_read_once_per_state(params64, monkeypatch):
    """alpha's sign is read from the device once, and again only after
    alpha was written; the shape tables are built once per shape."""
    x, tt = _inputs()
    xt, ttt = torch.from_numpy(x).float(), torch.from_numpy(tt).float()
    m = _port(params64, torch.float32)
    reads = []
    orig = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda self: reads.append(1) or orig(self))
    with torch.no_grad():
        m(xt, ttt, (HH, WW), iters=1)
        m(xt, ttt, (HH, WW), iters=1)
        assert len(reads) == 1 and len(m._tables) == 1
        assert m._alpha_nonpositive()
        m.alpha.fill_(0.5)
        assert not m._alpha_nonpositive()
        m(xt, ttt, (HH, WW), iters=1)
    assert len(reads) == 2 and len(m._tables) == 1
