"""The port's training pieces below the trainer against motif_tpu: the
losses (float64, 1e-12 relative), the lr schedules (float32, bit for bit)
and the backward of each kernel wrapper, in float64 on the CPU.

On the CPU a wrapper given tensors that require grad runs the same
autograd Function as on the card, with the plain forward in place of the
kernel: its backward is the plain backward (`splat_fused_backward_plain`,
`dcn_im2col_backward_plain`, `siren_mlp_backward_plain`). Each is held
against jax.vjp of motif_tpu's counterpart: the XLA `scan` splat (the
Pallas splat has no VJP and fails under x64), the one-hot DCN (the
`gather` backend sums its contraction in float32 even in float64) and the
composed SIREN; and against autograd through the port's plain forward.
Each backward is also called directly. Tolerance: 1e-10 of the largest
gradient of each tensor (the readings are ~1e-15). Also: the
lower-precision entries raise under grad, and `Siren.packed` follows an
optimiser step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motif_tpu import losses as jlosses
from motif_tpu import schedules as jschedules
from motif_tpu import trainer as jtrainer
from motif_tpu.ops import dcn as jdcn
from motif_tpu.ops import siren_kernel as jsiren
from motif_tpu.ops import softsplat as jsplat
from motif_tpu_torch import losses, schedules
from motif_tpu_torch.models.layers import Conv2d, cast_param
from motif_tpu_torch.models.motif import MoTIF
from motif_tpu_torch.models.siren import Siren
from motif_tpu_torch.ops import dcn, siren_kernel, softsplat
from motif_tpu_torch.trainer import TrainerConfig, make_schedule


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU forwards here are many small ops: one thread runs them
    as fast and does not contend with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GRAD_TOL = 1e-10


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, want, tol=GRAD_TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (what, err)


# --------------------------------------------------------------- losses ---

@pytest.mark.parametrize("name", sorted(losses.PIXEL_CRITERIA))
@pytest.mark.parametrize("shape", [(2, 64, 48, 3), (3, 2, 40, 36, 3)])
def test_loss_matches_motif_tpu(rng, name, shape, monkeypatch):
    """motif_tpu's LapLoss kernel is a float32 array, which its float64
    convolution refuses: the test hands it the same float32 values widened
    to float64, as the port widens them."""
    kernel = jlosses._gauss_kernel5
    monkeypatch.setattr(jlosses, "_gauss_kernel5",
                        lambda: kernel().astype(jnp.float64))
    x, y = rng.random(shape), rng.random(shape)
    with jax.enable_x64(True):
        want = float(jlosses.PIXEL_CRITERIA[name](jnp.asarray(x),
                                                  jnp.asarray(y)))
    got = float(losses.PIXEL_CRITERIA[name](_t(x), _t(y)))
    assert np.isfinite(want)
    assert got == pytest.approx(want, rel=1e-12, abs=0)


def test_lap_kernel_keeps_the_reference_quirk():
    np.testing.assert_array_equal(losses.gauss_kernel5(),
                                  np.asarray(jlosses._gauss_kernel5()))


# ------------------------------------------------------------ schedules ---

STEPS = [0, 1, 75000, 149999, 150000, 150001, 300000, 450000, 599999]


def _bits(v):
    return np.float32(v).tobytes()


def test_cosine_restart_is_bit_equal_on_the_test_yml_recipe():
    args = (4e-4, [150000] * 4, [150000, 300000, 450000], [1, 1, 1], 1e-7)
    want = jschedules.cosine_annealing_restart(*args)
    got = schedules.cosine_annealing_restart(*args)
    steps = STEPS + list(np.random.default_rng(0).integers(0, 600000, 500))
    for s in steps:
        assert isinstance(got(s), np.float32)
        assert _bits(got(s)) == _bits(want(s)), s


@pytest.mark.parametrize("gamma", [0.5, 0.1])
def test_multistep_restart_is_bit_equal(gamma):
    args = (2e-4, [10, 20, 30, 60], gamma, [0, 25, 50], [1, 0.5, 0.25])
    want = jschedules.multistep_restart(*args)
    got = schedules.multistep_restart(*args)
    for s in range(80):
        assert _bits(got(s)) == _bits(want(s)), s


@pytest.mark.parametrize("scheme", ["CosineAnnealingLR_Restart",
                                    "MultiStepLR_Restart"])
def test_warmup_schedule_is_bit_equal(scheme):
    cfg = dict(lr=3e-4, warmup_iter=40, lr_scheme=scheme, lr_steps=(60, 90),
               t_period=(100, 100), restarts=(100,), restart_weights=(0.5,))
    want = jtrainer.make_schedule(jtrainer.TrainerConfig(**cfg))
    got = make_schedule(TrainerConfig(**cfg))
    for s in list(range(0, 45)) + [60, 99, 100, 101, 150, 199]:
        assert _bits(got(s)) == _bits(want(s)), s


# ---------------------------------------------------------------- splat ---

def _splat_inputs(rng, B=2, H=9, W=11, C=5, positive=False):
    img = rng.standard_normal((B, H, W, C))
    flow = rng.standard_normal((B, H, W, 2)) * 3.0     # corners leave the image
    flow[0, 0, 0] = (-0.5, -0.25)                      # and straddle its edge
    flow[0, 1, 2] = (float(W), 0.0)
    z = rng.standard_normal((B, H, W, 1))
    z = np.abs(z) if positive else -np.abs(z)
    g = (rng.standard_normal((B, H, W, C)), rng.standard_normal((B, H, W, 1)))
    return img, flow, z, g


@pytest.mark.parametrize("positive", [False, True], ids=["z<=0", "z>0"])
def test_splat_backward_matches_jax_vjp(rng, positive):
    img, flow, z, (g_out, g_norm) = _splat_inputs(rng, positive=positive)
    with jax.enable_x64(True):
        def f(i, fl, zz):
            out, norm, _, _ = jsplat.splat_fused(
                i, fl, zz, z_nonpositive=jnp.asarray(not positive),
                method="scan")
            return out, norm
        _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (img, flow, z)))
        want = vjp((jnp.asarray(g_out), jnp.asarray(g_norm)))
    # the backward alone
    got = softsplat.splat_fused_backward_plain(
        _t(img), _t(flow), torch.exp(_t(z)), _t(g_out), _t(g_norm))
    for what, a, b in zip(("img", "flow", "z"), got, want):
        _close(a, b, what=what)
    # through the wrapper's autograd Function
    ts = [_t(a, True) for a in (img, flow, z)]
    out, norm, z_max, count = softsplat.splat_fused(*ts, not positive)
    assert not z_max.requires_grad and not count.requires_grad
    got = torch.autograd.grad((out * _t(g_out)).sum()
                              + (norm * _t(g_norm)).sum(), ts)
    for what, a, b in zip(("img", "flow", "z"), got, want):
        _close(a, b, what=what)


@pytest.mark.parametrize("positive", [False, True], ids=["z<=0", "z>0"])
def test_splat_backward_matches_autograd_of_the_plain_splat(rng, positive):
    img, flow, z, (g_out, g_norm) = _splat_inputs(rng, 1, 12, 7, 130,
                                                  positive)
    grads = []
    for fn in (softsplat.splat_fused, softsplat.splat_fused_plain):
        ts = [_t(a, True) for a in (img, flow, z)]
        out, norm, _, _ = fn(*ts, not positive)
        grads.append(torch.autograd.grad(
            (out * _t(g_out)).sum() + (norm * _t(g_norm)).sum(), ts))
    for what, a, b in zip(("img", "flow", "z"), *grads):
        _close(a, b.numpy(), what=what)


def test_splat_backward_takes_one_cotangent(rng):
    """Only `out` in the loss (norm's cotangent None) or only `norm`."""
    img, flow, z, (g_out, g_norm) = _splat_inputs(rng)
    for use in ("out", "norm"):
        grads = []
        for fn in (softsplat.splat_fused, softsplat.splat_fused_plain):
            ts = [_t(a, True) for a in (img, flow, z)]
            out, norm, _, _ = fn(*ts, True)
            loss = (out * _t(g_out)).sum() if use == "out" \
                else (norm * _t(g_norm)).sum()
            grads.append(torch.autograd.grad(loss, ts))
        for a, b in zip(*grads):
            _close(a, b.numpy(), what=use)


# ------------------------------------------------------------------ DCN ---

def _dcn_inputs(rng, B, H, W, G, cg, K, scale):
    x = rng.standard_normal((B, H, W, G * cg))
    com = rng.standard_normal((B, H, W, G * K * K * 3)) * scale
    if scale:
        com[0, 0, 0, :4] = (-1.0, 0.0, float(H), 2.5)   # integer, outside
    w = rng.standard_normal((G * cg + 3, G * cg, K, K)) * 0.2
    b = rng.standard_normal(G * cg + 3)
    g = rng.standard_normal((B, H, W, G * cg + 3))
    return x, com, w, b, g


def _dcn_jax(x, com, w, b, g, K, G):
    KK2 = G * K * K * 2

    def f(xx, off, mask, ww, bb):
        return jdcn._dcn_v2_onehot(xx, off, mask, ww, bb, K, 1, K // 2, 1, G)
    with jax.enable_x64(True):
        off = jnp.asarray(com[..., :KK2])
        mask = jax.nn.sigmoid(jnp.asarray(com[..., KK2:]))
        whwio = jnp.asarray(np.transpose(w, (2, 3, 1, 0)))
        _, vjp = jax.vjp(f, jnp.asarray(x), off, mask, whwio,
                         jnp.asarray(b))
        dx, doff, dmask, dw, db = vjp(jnp.asarray(g))
        dmask = dmask * mask * (1 - mask)           # through the sigmoid
        dcom = np.concatenate([np.asarray(doff), np.asarray(dmask)], -1)
        return (np.asarray(dx), dcom, np.transpose(np.asarray(dw),
                                                   (3, 2, 0, 1)),
                np.asarray(db))


@pytest.mark.parametrize("scale", [0.0, 2.0], ids=["zero_offsets",
                                                   "offsets"])
@pytest.mark.parametrize("shape", [(2, 9, 7, 2, 4, 3), (1, 6, 10, 8, 8, 3)])
def test_dcn_backward_matches_jax_vjp(rng, shape, scale):
    """dcn_v2 through the autograd Function (offset and mask as strided
    views of one conv output, as DCNSep takes them) against jax.vjp of the
    one-hot DCN; zero offsets put every sample on an integer position,
    where the floor-corner convention decides the position gradient."""
    B, H, W, G, cg, K = shape
    x, com, w, b, g = _dcn_inputs(rng, B, H, W, G, cg, K, scale)
    want = _dcn_jax(x, com, w, b, g, K, G)
    ts = [_t(a, True) for a in (x, com, w, b)]
    KK2 = G * K * K * 2
    out = dcn.dcn_v2(ts[0], ts[1][..., :KK2], torch.sigmoid(ts[1][..., KK2:]),
                     ts[2], ts[3], K, 1, K // 2, 1, G)
    got = torch.autograd.grad((out * _t(g)).sum(), ts)
    for what, a, bb in zip(("x", "offset|mask", "weight", "bias"), got, want):
        _close(a, bb, what=what)


@pytest.mark.parametrize("scale", [0.0, 2.0])
def test_dcn_im2col_backward_matches_autograd_of_the_plain_im2col(rng, scale):
    B, H, W, G, cg, K = 2, 8, 6, 2, 3, 3
    x, com, _, _, _ = _dcn_inputs(rng, B, H, W, G, cg, K, scale)
    g = rng.standard_normal((B * H * W, G * K * K * cg))
    KK2 = G * K * K * 2
    grads = []
    for fn in (dcn.dcn_im2col, dcn.dcn_im2col_plain):
        ts = [_t(x, True), _t(com, True)]
        cols = fn(ts[0], ts[1][..., :KK2], torch.sigmoid(ts[1][..., KK2:]),
                  K, 1, 1, 1, G)
        grads.append(torch.autograd.grad((cols * _t(g)).sum(), ts))
    for a, b in zip(*grads):
        _close(a, b.numpy())
    # the backward alone, on the views it is given
    xt, ct = _t(x), _t(com)
    off, mask = ct[..., :KK2], torch.sigmoid(ct[..., KK2:])
    dx, doff, dmask = dcn.dcn_im2col_backward_plain(xt, off, mask, _t(g), K,
                                                    1, 1, 1, G)
    assert doff.shape == off.shape and dmask.shape == mask.shape
    _close(dx, grads[1][0].numpy())
    _close(torch.cat([doff, dmask * mask * (1 - mask)], -1),
           grads[1][1].numpy())


# ---------------------------------------------------------------- SIREN ---

SIRENS = {"stinf": (67, [64, 64, 256], 3), "sinf": (66, [64, 64, 256], 64),
          "synth": (198, [64, 64, 64, 256], 3)}


def _siren_params(rng, dims):
    ws = [rng.uniform(-1, 1, (o, i)) * (1 / i if k == 0 else
                                        np.sqrt(6 / i) / 30)
          for k, (i, o) in enumerate(zip(dims[:-1], dims[1:]))]
    bs = [rng.uniform(-0.1, 0.1, o) for o in dims[1:]]
    return ws, bs


@pytest.mark.parametrize("skip_first", [False, True])
@pytest.mark.parametrize("name", sorted(SIRENS))
def test_siren_backward_matches_jax_vjp(rng, name, skip_first):
    cin, hidden, cout = SIRENS[name]
    dims = [cin] + hidden + [cout]
    ws, bs = _siren_params(rng, dims)
    if skip_first:
        ws, bs = ws[1:], bs[1:]
    x = rng.standard_normal((3, 40, dims[1] if skip_first else cin)) * 0.3
    g = rng.standard_normal((3, 40, cout))

    def f(xx, ww, bb):
        if skip_first:
            xx = jnp.sin(30.0 * xx)
        return jsiren._composed(xx, ww, bb, 30.0, False)
    with jax.enable_x64(True):
        _, vjp = jax.vjp(f, jnp.asarray(x), [jnp.asarray(w.T) for w in ws],
                         [jnp.asarray(b) for b in bs])
        dx, dw, db = vjp(jnp.asarray(g))
        want = [np.asarray(dx)] + [np.asarray(a).T for a in dw] \
            + [np.asarray(a) for a in db]
    direct = siren_kernel.siren_mlp_backward_plain(
        _t(x), [_t(w) for w in ws], [_t(b) for b in bs], _t(g), 30.0, False,
        skip_first)
    ts = [_t(x, True)] + [_t(w, True) for w in ws] + [_t(b, True) for b in bs]
    y = siren_kernel.siren_mlp(ts[0], ts[1:1 + len(ws)], ts[1 + len(ws):],
                               30.0, False, skip_first)
    through = torch.autograd.grad((y * _t(g)).sum(), ts)
    for k, w in enumerate(want):
        _close(direct[k], w, what=k)
        _close(through[k], w, what=k)


def test_siren_module_gradients_reach_its_parameters(rng):
    net = Siren(67, [64, 64, 256], 2, 3).double()
    x = _t(rng.standard_normal((2, 30, 67)) * 0.3, True)
    g = _t(rng.standard_normal((2, 30, 3)))
    params = [x] + list(net.parameters())
    got = torch.autograd.grad((net(x) * g).sum(), params)
    lins = net._kernel_linears()
    y = siren_kernel.siren_mlp_plain(x, [m.weight for m in lins],
                                     [m.bias for m in lins])
    want = torch.autograd.grad((y * g).sum(), params)
    for a, b in zip(got, want):
        _close(a, b.numpy())


@pytest.mark.parametrize("foreach", [False, True])
def test_siren_packed_follows_an_optimiser_step(rng, foreach):
    """The kernel's parameter buffer is rebuilt after an in-place optimiser
    step (the parameters' version counters move) and carries no graph."""
    torch.manual_seed(0)
    net = Siren(67, [64, 64, 256], 2, 3)
    buf = net.packed(torch.float32)
    assert not buf.requires_grad and net.packed(torch.float32) is buf
    opt = torch.optim.Adam(net.parameters(), lr=1e-3, foreach=foreach)
    x = torch.rand(50, 67)
    net(x).sum().backward()
    assert net.packed(torch.float32) is buf      # no step yet
    opt.step()
    new = net.packed(torch.float32)
    assert new is not buf and not torch.equal(new, buf)
    lins = net._kernel_linears()
    assert torch.equal(new, siren_kernel.pack([m.weight.detach() for m in lins],
                                              [m.bias.detach() for m in lins]))


# ---------------------------------------------- lower precision and grad ---

def test_lower_precision_entries_raise_under_grad(rng):
    f = lambda shape, dt=torch.float32: torch.tensor(  # noqa: E731
        rng.random(shape), dtype=dt, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        softsplat.splat_fused(f((1, 4, 4, 3)), f((1, 4, 4, 2)),
                              f((1, 4, 4, 1)), True,
                              scatter_dtype=torch.float16)
    bf = torch.bfloat16
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dcn.dcn_im2col(f((1, 4, 4, 8), bf), f((1, 4, 4, 36), bf),
                       f((1, 4, 4, 18), bf), 3, 1, 1, 1, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        siren_kernel.siren_mlp(f((5, 3), bf), [f((4, 3), bf)], [f((4,), bf)])
    conv = Conv2d(3, 4, 3, 1, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cast_param(conv, "weight", bf)
    with torch.no_grad():                       # serving casts as before
        assert cast_param(conv, "weight", bf).dtype == bf
    m = MoTIF(8, 1, 1, compute_dtype="bfloat16")
    x = torch.rand(1, 4, 16, 16, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        m(x, torch.rand(1, 2), (64, 64), iters=1)


def test_float32_entries_keep_their_no_grad_path(rng):
    """Without grad the wrappers return what they returned before: no
    autograd Function, the plain version on the CPU."""
    img, flow, z, _ = _splat_inputs(rng)
    a = softsplat.splat_fused(_t(img), _t(flow), _t(z), True)
    b = softsplat.splat_fused_plain(_t(img), _t(flow), _t(z), True)
    assert all(torch.equal(p, q) and p.grad_fn is None for p, q in zip(a, b))


def test_precomputed_flows_raise():
    """What still raises around the four-anchor path: an anchor count the
    port does not have, and four anchors given other than four frames (the
    precomputed flows themselves run: test_precomputed_flows_skip_raft)."""
    with pytest.raises(ValueError, match="n_anchors=3"):
        MoTIF(8, 1, 1, n_anchors=3)
    m = MoTIF(8, 1, 1, n_anchors=4)
    with pytest.raises(ValueError, match="4 input frames"):
        m(torch.rand(1, 3, 16, 16, 3), torch.rand(1, 2), (64, 64),
          flows=(None, None))


@pytest.mark.parametrize("n_anchors", [2, 4])
def test_precomputed_flows_skip_raft(n_anchors):
    """With both flows given a training forward never runs RAFT, its
    output's teacher flow is the given one, and the gradient reaches no
    flow: the flows are data, as motif_tpu's stop_gradient makes them."""
    m = MoTIF(8, 1, 1, n_anchors=n_anchors)
    calls = []
    m.flow_predictor.register_forward_hook(lambda *a: calls.append(1))
    n = n_anchors
    g = torch.Generator().manual_seed(0)
    lr = torch.randn(1, n * n, 16, 16, 2, generator=g, requires_grad=True)
    fg = torch.randn(1, 2, n, 64, 64, 2, generator=g, requires_grad=True)
    frames, flow, flow_gt = m(torch.rand(1, 4, 16, 16, 3, generator=g),
                              torch.tensor([[0.3, 0.7]]), (64, 64),
                              train=True, use_gt=True, flows=(lr, fg))
    assert calls == []
    torch.testing.assert_close(
        flow_gt, fg.detach().permute(2, 0, 1, 3, 4, 5).reshape(
            n * 2, 64, 64, 2) / 20.0 / 4.0, rtol=0, atol=0)
    (frames.sum() + flow.sum()).backward()
    assert lr.grad is None and fg.grad is None
    assert float(m.imnet.net[0].linear.weight.grad.abs().max()) > 0
