"""The fused decode's first-layer pre-activations (`ops/preact.py`) on the
CPU: `preact_plain` against the inline PyTorch expressions MoTIF.head ran
before them, bit for bit; the kernel's arithmetic (csrc/preact_bf16.cu:
each term and partial sum rounded to bfloat16 where the plain ops round,
the bfloat16 HR terms as the H100's tensor cores sum them, the float32
ones as FMA chains from 0 in ascending k) written out elementwise
against `preact_plain`, bit for bit; `preact`'s dispatch (the plain
version on the CPU; on CUDA the kernel, under grad with the plain
backward, in bfloat16 or float32 compute, and an error for what it does
not take); and a serving forward's four calls. The card holds the
kernel itself (`tests/test_torch_kernels.py -k preact`).

Shapes: the serving bucket's (two anchors, N = 2 and 3), the four-anchor
knobs request (n = 4, N = 1) and an HR size whose token count is no
multiple of 8 or 256, all at LR 16x24 or less (width 64 at the SIRENs, 16
features)."""

import pytest
import torch

from _launches import by_entry
from _preact_inputs import preact_inputs

from motif_tpu_torch.models.motif import build_motif
from motif_tpu_torch.ops import preact

BF, F32 = torch.bfloat16, torch.float32
CH = 16
# name: (anchors n, times N, LR (H, W), HR (HH, WW))
SHAPES = {"serve_N2": (2, 2, (16, 24), (64, 96)),
          "serve_N3": (2, 3, (16, 24), (64, 96)),
          "anchors4_N1": (4, 1, (16, 24), (64, 96)),
          "ragged": (2, 3, (13, 17), (51, 67))}


def _inputs(site, shape, seed=0):
    n, N, lr_hw, hr_hw = SHAPES[shape]
    return preact_inputs(site, n, N, lr_hw, hr_hw, CH, seed)


def _inline(site, a):
    """The expressions MoTIF.head ran in place of `preact` (bfloat16
    compute, x float32), as they were written there."""
    lr, iy, ix = a["lr"], a["iy"], a["ix"]

    def up(img):
        return img.index_select(1, iy).index_select(2, ix)

    def rep_n(x):
        return x.repeat_interleave(a.get("rep", 1), 0)
    if site == "stinf":
        wq = a["w"].t()
        h0 = rep_n(up(lr))
        return (h0 + a["t"] * wq[CH] + torch.matmul(a["hr"], wq[CH + 1:])
                + a["bias"])
    if site == "sinf":
        wi = a["w"].t()
        g0 = up(lr)
        return g0 + torch.matmul(a["hr"], wi[CH:]) + a["bias"]
    if site == "payload":
        ws_raw = a["w"].t()
        pay = rep_n(a["dense"] + up(lr))
        return pay.to(F32) + torch.matmul(a["hr"], ws_raw[64:66])
    ws = a["w"].t()
    off = 66 + CH
    w_e, w_t = ws[off:off + 3], ws[off + 3 + CH]
    N, HH, WW = a["dense"].shape[:3]
    return (a["dense"].to(BF).reshape(N, HH, WW, 64)
            + torch.matmul(a["hr"].to(BF).reshape(N, HH, WW, -1), w_e)
            + up(lr)
            + a["t"].reshape(N, 1, 1, 1) * w_t[None, None, None]
            + a["bias"])


def _r16(v):
    return v.to(BF).float()


def _fma(a, b, c):
    """float32 fma(a, b, c): the exact product and sum in float64 (a
    bfloat16 or float32 product is exact there), rounded once."""
    return (a.double() * b.double() + c.double()).float()


def _tensor_core_dot(h, w):
    """The kernel's `tensor_core_dot`, cuBLAS's bfloat16 product on the
    H100's tensor cores: h (..., K) and w (K, 64) hold bfloat16 values;
    each product cut toward zero to a multiple of 2^(E - 25), E the largest
    sum of the factors' exponents, the cut products summed exactly, the sum
    cut toward zero to float32."""
    def exponent(v):
        _, e = torch.frexp(v)
        return torch.where(v == 0, torch.full_like(e, -30000), e - 1)
    K = h.shape[-1]
    eh, ew = exponent(h), exponent(w)
    e = torch.stack([eh[..., k:k + 1] + ew[k] for k in range(K)]).amax(0)
    s = sum(torch.trunc(torch.ldexp((h[..., k:k + 1] * w[k]).double(),
                                    (25 - e).double())) for k in range(K))
    f = s.float()                  # cut toward zero to float32
    f = torch.where(f.double().abs() > s.abs(),
                    torch.nextafter(f, torch.zeros_like(f)), f)
    return torch.where(e < -15000, torch.zeros_like(f),
                       torch.ldexp(f, (e - 25).float()))


def _kernel_arithmetic(site, a, r16=_r16):
    """csrc/preact_bf16.cu's arithmetic on whole tensors: per element of
    (rows, HH, WW, 64), the terms in the plain version's order, each
    bfloat16 op as float32 then one rounding (`r16`), the HR term as
    cuBLAS forms it on the card: the bfloat16 ones by `_tensor_core_dot`
    (the synthesis' extras rounded to bfloat16 first), the payload's
    float32 one an FMA chain from 0 in ascending k."""
    rep = a.get("rep", 1)
    lr = a["lr"].float()
    l_t = lr[:, a["iy"]][:, :, a["ix"]].repeat_interleave(rep, 0)
    w = a["w"].float()
    hr = a["hr"].float()
    if site == "synth":
        hr = r16(hr)
    k = a["hr"].shape[-1]
    w_hr = w[:, a["col_hr"]:a["col_hr"] + k].t()
    if site == "payload":
        acc = torch.zeros(())
        for j in range(k):
            acc = _fma(hr[..., j:j + 1], w_hr[j], acc)
    else:
        acc = _tensor_core_dot(hr, w_hr)
    if site in ("stinf", "synth"):
        tw = r16(a["t"].float().reshape(-1, 1, 1, 1) * w[:, a["col_t"]])
    if site == "stinf":
        s = r16(l_t + tw)
        s = r16(s + r16(acc))
        return r16(s + a["bias"].float()).to(BF)
    if site == "sinf":
        s = r16(l_t + r16(acc))
        return r16(s + a["bias"].float()).to(BF)
    if site == "payload":
        d = a["dense"].float().repeat_interleave(rep, 0)
        return r16(d + l_t) + acc
    s = r16(r16(a["dense"].float()) + r16(acc))
    s = r16(s + l_t)
    s = r16(s + tw)
    return r16(s + a["bias"].float()).to(BF)


def _call(fn, site, a):
    return fn(site, a["lr"], a["iy"], a["ix"], a["w"],
              **{k: v for k, v in a.items() if k not in ("lr", "iy", "ix",
                                                        "w")})


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("site", preact.SITES)
def test_plain_equals_the_inline_glue(site, shape):
    a = _inputs(site, shape)
    got = _call(preact.preact_plain, site, a)
    want = _inline(site, a)
    assert got.dtype == want.dtype == (F32 if site == "payload" else BF)
    assert got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("site", preact.SITES)
def test_kernel_arithmetic_is_the_plain_versions(site, shape):
    """The kernel's rounding order reproduces the plain ops bit for bit on
    the CPU, whose matmul sums the K terms in float32 rounded to nearest:
    where a bfloat16 K-sum is not exact in float32 (1-2% of the
    synthesis' here) the tensor cores' cut differs from it by under a
    float32 ulp, which the bfloat16 rounding after it hides on these
    inputs (the card holds the kernel against cuBLAS: `test_preact_*`)."""
    a = _inputs(site, shape, seed=1)
    want = _call(preact.preact_plain, site, a)
    got = _kernel_arithmetic(site, a)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("K", [2, 3])
def test_tensor_core_dot_cuts_what_a_rounded_sum_rounds(K):
    """The tensor cores' sum (`_tensor_core_dot`, the kernel's model of
    cuBLAS): on factors of one binade no product has bits to cut and the
    sum fits in float32, so it equals the float32 sum rounded to nearest;
    on products over many binades the two, rounded to bfloat16, part in a
    few sums (on the card cuBLAS matched the cut on 22M sums, the rounded
    sum missed ~7e-5 of them)."""
    g = torch.Generator().manual_seed(K)

    def rounded_sum(h, w):
        return sum(h[:, k:k + 1].double() * w[k].double()
                   for k in range(K)).float()
    h = (1 + torch.rand((20000, K), generator=g)).to(BF).float()
    w = ((1 + torch.rand((K, 64), generator=g)) * torch.sign(
        torch.randn((K, 64), generator=g))).to(BF).float()
    assert torch.equal(_tensor_core_dot(h, w), rounded_sum(h, w))
    h = torch.rand((20000, K), generator=g) * 2
    h[:, 0] *= torch.rand((20000,), generator=g) ** 8
    h = h.to(BF).float()
    w = torch.randn((K, 64), generator=g).to(BF).float()
    apart = int((_r16(_tensor_core_dot(h, w))
                 != _r16(rounded_sum(h, w))).sum())
    assert 0 < apart < 1e-3 * h.shape[0] * 64


@pytest.mark.parametrize("site", preact.SITES)
def test_a_dropped_rounding_is_seen(site):
    """The bit-equality above is sharp: the kernel's arithmetic without its
    first bfloat16 rounding (float32 carried one op further) differs."""
    a = _inputs(site, "serve_N3", seed=2)
    want = _call(preact.preact_plain, site, a)
    calls = []

    def skip_first(v):
        calls.append(1)
        return v if len(calls) == 1 else _r16(v)
    assert not torch.equal(_kernel_arithmetic(site, a, skip_first), want)


def test_plain_rejects_an_unknown_site():
    a = _inputs("sinf", "serve_N2")
    with pytest.raises(ValueError, match="unknown site"):
        _call(preact.preact_plain, "stinf2", a)




def _launched():
    return sum(v for k, v in by_entry().items() if k.startswith("preact/"))


@pytest.fixture
def fake_card(monkeypatch):
    """`preact` as on the card: every tensor counts as a CUDA one and the
    kernel is a stand-in that records its site and compute type and
    returns the plain version's values on the parts it was handed (as
    `_checked` passes them: hr strided by pixel, the rest contiguous)."""
    launched = []

    def kernel(site, rep, col_hr, col_t, lr, iy, ix, w, bias, dense, hr, t):
        assert all(v.is_contiguous() for v in (lr, iy, ix, w, bias, dense,
                                                t) if v is not None)
        assert hr.stride(3) == 1
        launched.append((site, lr.dtype))
        return preact.preact_plain(site, lr, iy, ix, w, bias=bias, rep=rep,
                                   dense=dense, hr=hr, col_hr=col_hr, t=t,
                                   col_t=col_t)
    monkeypatch.setattr(preact, "_on_card", lambda t: True)
    monkeypatch.setattr(preact, "_kernel", kernel)
    return launched


@pytest.mark.parametrize("site", preact.SITES)
def test_the_cpu_runs_the_plain_version_uncounted(site):
    a = _inputs(site, "serve_N2")
    before = _launched()
    assert torch.equal(_call(preact.preact, site, a),
                       _call(preact.preact_plain, site, a))
    assert _launched() == before


@pytest.mark.parametrize("site", preact.SITES)
def test_the_card_launches_the_kernel_without_grad(site, fake_card):
    a = _inputs(site, "serve_N3")
    before = _launched()
    with torch.inference_mode():
        got = _call(preact.preact, site, a)
    assert fake_card == [(site, BF)] and _launched() == before + 1
    assert torch.equal(got, _call(preact.preact_plain, site, a))


@pytest.mark.parametrize("site", preact.SITES)
def test_the_card_launches_the_kernel_under_grad_with_the_plain_backward(
        site, fake_card):
    """Under autograd the kernel is the forward and `preact_plain`,
    recomputed and differentiated, the backward: the gradients of every
    floating part are the plain version's bit for bit."""
    a = _inputs(site, "serve_N2")
    floats = [k for k in ("lr", "w", "bias", "dense", "hr", "t")
              if a.get(k) is not None]
    if site == "payload":        # MoTIF detaches the flow
        floats.remove("hr")

    def grads(fn):
        x = dict(a, **{k: a[k].detach().clone().requires_grad_()
                       for k in floats})
        out = _call(fn, site, x)
        g = torch.Generator().manual_seed(5)
        out.backward(torch.randn(out.shape, generator=g).to(out.dtype))
        return out, [x[k].grad for k in floats]
    got, got_grads = grads(preact.preact)
    assert fake_card == [(site, BF)] and got.requires_grad
    want, want_grads = grads(preact.preact_plain)
    assert torch.equal(got, want)
    for k, g, h in zip(floats, got_grads, want_grads):
        assert g is not None and g.dtype == a[k].dtype, k
        assert torch.equal(g, h), k


@pytest.mark.parametrize("site", preact.SITES)
def test_the_card_launches_the_float32_entry(site, fake_card):
    """With every part float32 (float32 compute under fused_decode) the
    kernel's float32 entry runs, and returns float32."""
    n, N, lr_hw, hr_hw = SHAPES["serve_N3"]
    a = preact_inputs(site, n, N, lr_hw, hr_hw, CH, 0, dtype=F32)
    with torch.inference_mode():
        got = _call(preact.preact, site, a)
    assert fake_card == [(site, F32)] and got.dtype == F32
    assert torch.equal(got, _call(preact.preact_plain, site, a))


@pytest.mark.parametrize("change", ["float16_lr", "mixed_types", "four_hr",
                                    "misaligned_lr", "channels_32",
                                    "no_bias"])
def test_the_card_raises_where_the_kernel_cannot(change, fake_card):
    a = _inputs("stinf", "serve_N2")
    if change == "float16_lr":
        a["lr"] = a["lr"].half()
    elif change == "mixed_types":            # a float32 weight in bfloat16
        a["w"] = a["w"].float()
    elif change == "four_hr":
        a["hr"] = torch.cat([a["hr"], a["hr"]], -1)
        a["w"] = torch.cat([a["w"], a["w"][:, :2]], -1)
    elif change == "misaligned_lr":          # 2 bytes past a 16-byte line
        lr = a["lr"]
        flat = torch.empty(lr.numel() + 1, dtype=lr.dtype)
        a["lr"] = flat[1:].view(lr.shape).copy_(lr)
    elif change == "channels_32":
        a["lr"] = a["lr"][..., :32].contiguous()
    else:
        a["bias"] = None
    error = TypeError if change in ("float16_lr", "mixed_types",
                                    "no_bias") else ValueError
    with torch.inference_mode(), pytest.raises(error, match="preact"):
        _call(preact.preact, "stinf", a)
    assert fake_card == []


@pytest.mark.parametrize("change", ["strided_lr", "strided_weight",
                                    "strided_hr"])
def test_the_card_takes_a_strided_layout(change, fake_card):
    """A part in another layout is handed to the kernel contiguous (hr
    strided by pixel, as the payload's flow view is), with the plain
    version's values."""
    site = "synth" if change == "strided_hr" else "stinf"
    a = _inputs(site, "serve_N2")
    if change == "strided_lr":
        a["lr"] = a["lr"].transpose(1, 2).contiguous().transpose(1, 2)
    elif change == "strided_weight":
        a["w"] = a["w"].t().contiguous().t()
    else:
        a["hr"] = a["hr"].transpose(1, 2).contiguous().transpose(1, 2)
    with torch.inference_mode():
        got = _call(preact.preact, site, a)
    assert fake_card == [(site, BF)]
    assert torch.equal(got, _call(preact.preact_plain, site, a))


KNOBS = dict(fused_decode=True, compute_dtype="bfloat16")


@pytest.fixture(scope="module")
def serving_model():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield build_motif(CH, 1, 1, device="cpu", seed=0, **KNOBS)
    torch.set_num_threads(n)


def _forward(model, n_times=3):
    g = torch.Generator().manual_seed(3)
    x = torch.rand((1, 4, 16, 24, 3), generator=g)
    t = torch.rand((1, n_times), generator=g)
    return model(x, t, (64, 96), iters=1)


def test_a_serving_forward_makes_the_four_calls(serving_model, fake_card):
    """Under inference the serving forward launches each site once, and
    its frames are the CPU forward's bit for bit (the stand-in returns the
    plain values)."""
    with torch.inference_mode():
        got = _forward(serving_model)
    assert fake_card == [(s, BF) for s in preact.SITES]
    with torch.inference_mode(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(preact, "_on_card", lambda t: False)
        want = _forward(serving_model)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_a_training_forward_launches_the_four_sites(serving_model,
                                                    fake_card):
    """A training forward and backward under the knobs launches each site
    once, and every parameter's gradient is the CPU path's bit for bit."""
    def grads():
        serving_model.zero_grad(set_to_none=True)
        frames, _, _ = _forward(serving_model, n_times=2)
        frames.square().sum().backward()
        return {k: p.grad for k, p in serving_model.named_parameters()}
    got = grads()
    assert fake_card == [(s, BF) for s in preact.SITES]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(preact, "_on_card", lambda t: False)
        want = grads()
    assert got.keys() == want.keys()
    for k in got:
        assert (got[k] is None) == (want[k] is None), k
        assert got[k] is None or torch.equal(got[k], want[k]), k


def test_float32_fused_decode_launches_the_float32_entries(fake_card):
    model = build_motif(CH, 1, 1, device="cpu", seed=0, fused_decode=True)
    with torch.inference_mode():
        _forward(model, n_times=2)
    assert fake_card == [(s, F32) for s in preact.SITES]
