"""Training under the precision knobs (`compute_dtype="bfloat16"`,
`splat_dtype="float16"`): the backward of each kernel entry in its working
type against motif_tpu's autodiff, and a whole MoTIF step under the knobs
(with `fused_decode`) against the port's own float64 step
(tests/test_torch_train_bf16_jax.py holds that step against motif_tpu's
under the same knobs).

A low-precision gradient is held by accuracy, not bit for bit: the two
packages round at the same points but sum in other orders (XLA's one-hot
DCN sampler also rounds its hat weights to bfloat16, the port's does not).
Each gradient of an entry is measured against the float64 gradient of the
same function at the same (rounded) inputs, the truth, in units of the
truth's largest |g|: the port's RMS error at most 1.25 x motif_tpu's, its
largest error at most 2 x motif_tpu's, its mean error at most motif_tpu's
plus a tenth of motif_tpu's RMS error (`accuracy`). A whole step
(`step_gate`): every parameter's gradient within 0.5 of the float64
step's in L2, relative to its norm (readings up to 0.19, at the PCD's
offset convs, whose gradient runs through the bfloat16 sample positions;
1.3-3.6e-2 a module), and the loss within 1e-2 (2.8e-4). Each gate refuses
a backward with a term dropped or its sign flipped
(`test_*_gate_refuses_*`). The step gate cannot see the splat's flow
gradient dropped: it moves the flow-context convs by 0.10 of their
gradient, under the offset convs' bfloat16 noise; the entry gate does
(`splat/drop_dflow`).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motif_tpu.ops import dcn as jdcn
from motif_tpu.ops import siren_kernel as jsk
from motif_tpu.ops.softsplat import _splat_fused_base
from motif_tpu_torch.models.motif import MoTIF
from motif_tpu_torch.ops import dcn as tdcn
from motif_tpu_torch.ops import siren_kernel as tsk
from motif_tpu_torch.ops import softsplat as tss
from motif_tpu_torch.trainer import Trainer, TrainerConfig

BF = torch.bfloat16
KNOBS = dict(fused_decode=True, compute_dtype="bfloat16",
             splat_dtype="float16")
CH, FRONT, BACK = 16, 1, 2
STEP_L2 = 0.5
STEP_LOSS = 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


def accuracy(got, ref, truth) -> dict:
    """The port's gradient `got` and motif_tpu's `ref` against the float64
    `truth`, in units of the truth's largest |g|."""
    got, ref, truth = (np.asarray(a, np.float64) for a in (got, ref, truth))
    s = max(float(np.abs(truth).max()), 1e-300)
    eg, er = (got - truth) / s, (ref - truth) / s
    r = {"rms": _rms(eg), "ref_rms": _rms(er),
         "max": float(np.abs(eg).max()), "ref_max": float(np.abs(er).max()),
         "mean": float(eg.mean()), "ref_mean": float(er.mean())}
    r["ok"] = (np.isfinite(got).all() and r["rms"] <= 1.25 * r["ref_rms"]
               and r["max"] <= 2.0 * r["ref_max"]
               and abs(r["mean"]) <= abs(r["ref_mean"]) + 0.1 * r["ref_rms"])
    return r


def _bf(a):
    """numpy -> bfloat16 tensor (rounded once)."""
    return torch.tensor(np.asarray(a, np.float32)).to(BF)


def _jbf(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _np(t):
    return np.asarray(t.detach().float().numpy() if isinstance(
        t, torch.Tensor) else np.asarray(t, np.float32), np.float64)


# ---------------------------------------------------------------------------
# the entries: DCN (bfloat16), SIREN (bfloat16 whole, skip-first, cut), the
# splat (float16 sums)
# ---------------------------------------------------------------------------

DCN = dict(B=1, H=8, W=9, G=2, cg=4, K=3, Cout=8)


def _dcn_case():
    """x, offset, mask, weight, bias and the output's cotangent, bfloat16."""
    rng = np.random.default_rng(0)
    c = DCN
    Cin, KK = c["G"] * c["cg"], c["K"] ** 2
    hw = (c["B"], c["H"], c["W"])
    return [_bf(a) for a in (
        rng.standard_normal((*hw, Cin)),
        rng.standard_normal((*hw, c["G"] * KK * 2)) * 1.5,
        rng.random((*hw, c["G"] * KK)),
        rng.standard_normal((c["Cout"], Cin, c["K"], c["K"])) * 0.2,
        rng.standard_normal(c["Cout"]) * 0.1,
        rng.standard_normal((*hw, c["Cout"])))]


def _port_grads(fn, inputs, cot, dtype=None):
    ins = [(t.to(dtype) if dtype else t.clone()).requires_grad_()
           for t in inputs]
    out = fn(*ins)
    out.backward(cot.to(dtype) if dtype else cot)
    return [_np(t.grad) if dtype is None else t.grad.numpy() for t in ins]


def _dcn_port(x, off, mask, w, b):
    c = DCN
    return tdcn.dcn_v2(x, off, mask, w, b, c["K"], 1, 1, 1, c["G"])


def _dcn_jax(inputs, cot):
    c = DCN

    def f(x, off, mask, w, b):       # torch's (Cout, Cin, K, K) as HWIO
        return jdcn.dcn_v2(x, off, mask, jnp.transpose(w, (2, 3, 1, 0)), b,
                           c["K"], 1, 1, 1, c["G"], backend="onehot")
    _, vjp = jax.vjp(f, *[_jbf(t) for t in inputs])
    return [_np(np.asarray(g, np.float32)) for g in vjp(_jbf(cot))]


# (in, hidden, out, skip_first): MoTIF's STINF whole at channel 16, the
# SINF from its pre-activation, setting 6's synthesis net (331 inputs, cut
# into two launches on the card by `segments_bf16`)
SIRENS = {"whole": ([19, 64, 64, 256, 3], False),
          "skip_first": ([64, 64, 256, 64], True),
          "cut": ([331, 64, 64, 64, 256, 3], False)}


def _siren_case(name):
    dims, skip = SIRENS[name]
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.05, 0.05, (50, dims[0])) if skip else \
        rng.uniform(-1, 1, (50, dims[0]))
    ws = [rng.uniform(-1, 1, (o, i)) * (1 / i if (l == 0 and not skip)
                                       else np.sqrt(6 / i) / 30)
          for l, (i, o) in enumerate(zip(dims[:-1], dims[1:]))]
    bs = [rng.uniform(-1, 1, o) / np.sqrt(i)
          for i, o in zip(dims[:-1], dims[1:])]
    cot = rng.standard_normal((50, dims[-1]))
    return [_bf(a) for a in (x, *ws, *bs, cot)]


def _siren_port(name):
    skip = SIRENS[name][1]

    def f(x, *p):
        n = len(p) // 2
        return tsk.siren_mlp(x, p[:n], p[n:], 30.0, False, skip)
    return f


def _siren_jax(name, inputs, cot):
    skip = SIRENS[name][1]
    n = (len(inputs) - 1) // 2

    def f(x, ws, bs):
        if skip:
            x = jnp.sin(30.0 * x)
        return jsk._composed(x, ws, bs, 30.0, False)
    x, ws, bs = inputs[0], inputs[1:1 + n], inputs[1 + n:]
    _, vjp = jax.vjp(f, _jbf(x), [_jbf(w.t()) for w in ws],
                     [_jbf(b) for b in bs])
    dx, dw, db = vjp(_jbf(cot))
    return [_np(np.asarray(dx, np.float32))] + \
        [_np(np.asarray(g, np.float32)).T for g in dw] + \
        [_np(np.asarray(g, np.float32)) for g in db]


def _splat_case():
    """img, flow, z (float32) and the cotangents of out and norm."""
    rng = np.random.default_rng(2)
    B, H, W, C = 2, 8, 9, 6
    f32 = np.float32
    return [torch.tensor(a.astype(f32)) for a in (
        rng.random((B, H, W, C)), rng.standard_normal((B, H, W, 2)) * 2,
        rng.standard_normal((B, H, W, 1)) * 0.3,
        rng.standard_normal((B, H, W, C)), rng.standard_normal((B, H, W, 1)))]


def _splat_port(scatter_dtype):
    def f(img, flow, z, g_out, g_norm):
        out, norm, _, _ = tss.splat_fused(img, flow, z, False, scatter_dtype)
        return (out * g_out).sum() + (norm * g_norm).sum()
    return f


def _splat_grads(scatter_dtype, dtype=torch.float32):
    img, flow, z, g_out, g_norm = _splat_case()
    ins = [t.to(dtype).requires_grad_() for t in (img, flow, z)]
    _splat_port(scatter_dtype)(*ins, g_out.to(dtype), g_norm.to(dtype)
                               ).backward()
    return [t.grad.double().numpy() for t in ins]


def _splat_jax():
    img, flow, z, g_out, g_norm = (jnp.asarray(t.numpy())
                                   for t in _splat_case())

    def f(img, flow, z):
        out, norm, _ = _splat_fused_base(img, flow, z, jnp.exp(z),
                                         scatter_dtype=jnp.float16)
        return out, norm
    _, vjp = jax.vjp(f, img, flow, z)
    return [np.asarray(g, np.float64) for g in vjp((g_out, g_norm))]


def entry_grads(entry):
    """(the port's gradients in the working type, motif_tpu's, the float64
    truth) of one entry."""
    if entry == "dcn":
        *ins, cot = _dcn_case()
        return (_port_grads(_dcn_port, ins, cot),
                _dcn_jax(ins, cot),
                _port_grads(_dcn_port, ins, cot, torch.float64))
    if entry == "splat":
        return (_splat_grads(torch.float16), _splat_jax(),
                _splat_grads(None, torch.float64))
    name = entry.split("/")[1]
    *ins, cot = _siren_case(name)
    fn = _siren_port(name)
    return (_port_grads(fn, ins, cot), _siren_jax(name, ins, cot),
            _port_grads(fn, ins, cot, torch.float64))


ENTRIES = ["dcn", "siren/whole", "siren/skip_first", "siren/cut", "splat"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_backward_matches_motif_tpu_by_accuracy(entry):
    """Every gradient of the entry (the DCN's x, offset, mask, weight,
    bias; the SIREN's x, weights, biases; the splat's img, flow, z)."""
    got, ref, truth = entry_grads(entry)
    assert len(got) == len(ref) == len(truth)
    for i, (g, r, t) in enumerate(zip(got, ref, truth)):
        acc = accuracy(g, r, t)
        assert acc["ok"], (entry, i, acc)
        assert acc["rms"] > 0          # the working type did round


@contextlib.contextmanager
def _patched(mod, name, wrap):
    real = getattr(mod, name)
    setattr(mod, name, wrap(real))
    try:
        yield
    finally:
        setattr(mod, name, real)


def _flip_offset_x(real):       # the position gradient's x term, negated
    def f(*a):
        dx, doff, dmask = real(*a)
        doff = doff.clone()
        doff[..., 1::2] = -doff[..., 1::2]
        return dx, doff, dmask
    return f


def _drop_mask(real):
    def f(*a):
        dx, doff, dmask = real(*a)
        return dx, doff, torch.zeros_like(dmask)
    return f


def _drop_bias(real):           # the biases' gradients dropped
    def f(x, weights, biases, *a):
        g = real(x, weights, biases, *a)
        n = len(weights)
        return (*g[:1 + n], *[torch.zeros_like(b) for b in g[1 + n:]])
    return f


def _flip_dx(real):
    def f(*a):
        g = real(*a)
        return (-g[0], *g[1:])
    return f


def _drop_dz(real):
    def f(*a, **kw):
        d_img, d_flow, d_z = real(*a, **kw)
        return d_img, d_flow, torch.zeros_like(d_z)
    return f


def _drop_dflow(real):
    def f(*a, **kw):
        d_img, d_flow, d_z = real(*a, **kw)
        return d_img, torch.zeros_like(d_flow), d_z
    return f


def _flip_fy(real):
    def f(*a, **kw):
        d_img, d_flow, d_z = real(*a, **kw)
        return d_img, d_flow * torch.tensor([1.0, -1.0], dtype=d_flow.dtype), \
            d_z
    return f


FAULTS = {
    "dcn/flip_offset_x": ("dcn", tdcn, "dcn_im2col_backward_plain",
                          _flip_offset_x, 1),
    "dcn/drop_mask": ("dcn", tdcn, "dcn_im2col_backward_plain", _drop_mask,
                      2),
    "siren/drop_bias": ("siren/cut", tsk, "siren_mlp_backward_plain",
                        _drop_bias, -1),
    "siren/flip_dx": ("siren/skip_first", tsk, "siren_mlp_backward_plain",
                      _flip_dx, 0),
    "splat/drop_dz": ("splat", tss, "splat_fused_backward_plain", _drop_dz,
                      2),
    "splat/flip_fy": ("splat", tss, "splat_fused_backward_plain", _flip_fy,
                      1),
    "splat/drop_dflow": ("splat", tss, "splat_fused_backward_plain",
                         _drop_dflow, 1),
}


@pytest.mark.parametrize("fault", FAULTS)
def test_entry_gate_refuses_a_dropped_or_flipped_term(fault):
    """The same gate on a backward with one term dropped or its sign
    flipped: the gradient it reaches fails."""
    entry, mod, name, wrap, which = FAULTS[fault]
    _, ref, truth = entry_grads(entry)
    with _patched(mod, name, wrap):
        got, _, _ = entry_grads(entry)
    assert not accuracy(got[which], ref[which], truth[which])["ok"]


# ---------------------------------------------------------------------------
# a whole MoTIF step under the knobs
# ---------------------------------------------------------------------------

def _perturbed(model):
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if "conv_offset_mask" in n:
                scale = 0.05 if n.endswith("weight") else 1.5
                p.copy_(torch.randn(p.shape, generator=g) * scale)
        model.alpha.fill_(0.5)
    return model


def _batch():
    rng = np.random.default_rng(0)
    return {"lq": rng.random((1, 4, 16, 16, 3)),
            "gt": rng.random((1, 4, 64, 64, 3)),
            "times": np.asarray([[0.25, 0.625]])}


def _cfg(cls=TrainerConfig):
    return cls(teacher_forcing_steps=1)


def port_step(state, dtype, **knobs):
    """(aux, {name: gradient}) of one use_gt=False step of the port."""
    model = MoTIF(CH, FRONT, BACK, **knobs).to(dtype)
    model.load_state_dict({k: v.to(dtype) for k, v in state.items()})
    tr = Trainer(model, _cfg(), out_hw=None, iters=1)
    tr.step_count = 1
    batch = {k: v.astype(np.float64 if dtype == torch.float64
                         else np.float32) for k, v in _batch().items()}
    aux = tr.compute_grads(batch, tr.draw_use_gt())
    return aux, {k: p.grad.double().clone()
                 for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def state():
    torch.manual_seed(5)
    return _perturbed(MoTIF(CH, FRONT, BACK)).state_dict()


@pytest.fixture(scope="module")
def steps(state):
    """The port's step under the knobs and its float64 step
    (`fused_decode` alone: exact math)."""
    return {"knobs": port_step(state, torch.float32, **KNOBS),
            "float64": port_step(state, torch.float64, fused_decode=True)}


def _groups(grads):
    out = {}
    for k, g in grads.items():
        out.setdefault(k.split(".")[0], []).append(g.reshape(-1))
    return {k: torch.cat(v) for k, v in out.items()}


def step_gate(got, want) -> dict:
    """Each parameter's gradient's L2 distance from the float64 step's,
    relative to its L2 norm (a gradient the float64 step leaves at zero
    must stay zero), the largest of them, and the loss relative."""
    (aux, grads), (aux64, grads64) = got, want
    rel = {k: (float((g - grads64[k]).norm() / grads64[k].norm())
               if grads64[k].norm() > 0 else
               (0.0 if float(g.abs().max()) == 0 else np.inf))
           for k, g in grads.items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(float(aux["loss"]) / float(aux64["loss"]) - 1)
    return {"l2_rel": rel, "worst": (worst, rel[worst]),
            "loss_rel": loss_rel,
            "ok": rel[worst] <= STEP_L2 and loss_rel <= STEP_LOSS}


def test_bfloat16_step_trains_every_module(steps):
    """Under the knobs every parameter the float64 step reaches takes a
    finite gradient (the casts carry it to the float32 parameters), and no
    other."""
    _, grads = steps["knobs"]
    _, grads64 = steps["float64"]
    for k, g in grads.items():
        assert g.dtype == torch.float64 and torch.isfinite(g).all(), k
        assert (float(g.abs().max()) > 0) == \
            (float(grads64[k].abs().max()) > 0), k


def test_bfloat16_step_matches_the_float64_step(steps):
    gate = step_gate(steps["knobs"], steps["float64"])
    assert gate["ok"], (gate["worst"], gate["loss_rel"])


def _drop_dimg(real):
    def f(*a, **kw):
        d_img, d_flow, d_z = real(*a, **kw)
        return torch.zeros_like(d_img), d_flow, d_z
    return f


STEP_FAULTS = {
    "splat/drop_dimg": (tss, "splat_fused_backward_plain", _drop_dimg),
    "dcn/flip_offset_x": (tdcn, "dcn_im2col_backward_plain", _flip_offset_x),
    "dcn/drop_mask": (tdcn, "dcn_im2col_backward_plain", _drop_mask),
    "siren/drop_bias": (tsk, "siren_mlp_backward_plain", _drop_bias),
    "siren/flip_dx": (tsk, "siren_mlp_backward_plain", _flip_dx)}


@pytest.mark.parametrize("fault", STEP_FAULTS)
def test_step_gate_refuses_a_dropped_or_flipped_term(state, steps, fault):
    mod, name, wrap = STEP_FAULTS[fault]
    with _patched(mod, name, wrap):
        bad = port_step(state, torch.float32, **KNOBS)
    assert not step_gate(bad, steps["float64"])["ok"]
