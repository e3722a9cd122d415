"""What surrounds the port's tensor-core kernel and runs on the CPU: the
packing of the bfloat16 SIREN's weights, its plan, the float64 reference,
the packed buffer kept on the module, dcn_v2's plain version, and the
gates themselves — held against variants of the plain
version that a right kernel may be (another accumulation order) and that a
wrong one would be (a dropped rounding point, a sine that is off).

The kernel (csrc/siren_mlp_bf16.cu) runs on the card only;
test_torch_kernels.py holds it there by these same gates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motif_tpu.models.siren import Siren as JSiren
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch.models.layers import cached
from motif_tpu_torch.models.siren import Siren, hidden_bound
from motif_tpu_torch.ops import dcn as tdcn
from motif_tpu_torch.ops import kernels
from motif_tpu_torch.ops import siren_kernel as tsk

MLPS = {"stinf": [67, 64, 64, 256, 3], "sinf": [66, 64, 64, 256, 64],
        "synth": [198, 64, 64, 64, 256, 3]}
ENTRIES = [(name, skip) for name in MLPS for skip in (False, True)]
IDS = [f"{n}-{'skip_first' if s else 'whole'}" for n, s in ENTRIES]


def _dims(name, skip):
    return MLPS[name][1 if skip else 0:]


def _params(dims, seed=0, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    ws = [((torch.rand((o, i), generator=g) * 2 - 1)
           * hidden_bound(i, 30.0)).to(dtype)
          for i, o in zip(dims[:-1], dims[1:])]
    bs = [(torch.rand((o,), generator=g) * 0.2 - 0.1).to(dtype)
          for o in dims[1:]]
    return ws, bs, g


@pytest.mark.parametrize("name,skip", ENTRIES, ids=IDS)
def test_pack_params_bf16_layout(name, skip):
    """Per layer the weight in torch's own (out, in) order as (N up to 8,
    K up to 16 plus 8) with zeros in every padded row and column, then the
    bias up to 8; rows an odd multiple of 16 bytes apart; the weights and
    biases come back out unchanged."""
    dims = _dims(name, skip)
    ws, bs, _ = _params(dims)
    buf = tsk.pack_params_bf16(ws, bs)
    layers, total = tsk.layout_bf16(dims)
    assert buf.dtype == torch.bfloat16 and buf.numel() == total
    assert total == tsk.pack_size(dims, torch.bfloat16) and total % 8 == 0
    end = 0
    for w, b, (woff, boff, np_, ld) in zip(ws, bs, layers):
        n, k = w.shape
        assert woff == end and woff % 8 == 0 and boff % 8 == 0
        assert np_ % 8 == 0 and 0 <= np_ - n < 8
        assert (ld - 8) % 16 == 0 and 0 <= ld - 8 - k < 16
        assert (2 * ld // 16) % 2 == 1           # no ldmatrix bank conflicts
        mat = buf[woff:boff].view(np_, ld)
        assert torch.equal(mat[:n, :k], w)
        assert not mat[n:].any() and not mat[:, k:].any()
        assert torch.equal(buf[boff:boff + n], b)
        assert not buf[boff + n:boff + np_].any()
        end = boff + np_
    assert end == total
    assert tsk.pack(ws, bs).equal(buf)           # bfloat16 takes this layout
    f32 = tsk.pack([w.float() for w in ws], [b.float() for b in bs])
    assert f32.numel() == tsk.pack_size(dims, torch.float32)


@pytest.mark.parametrize("name,skip,nbuf,smem", [
    ("stinf", True, 2, 124_688), ("sinf", True, 2, 154_368),
    ("synth", True, 2, 134_032), ("stinf", False, 1, 107_408),
    ("sinf", False, 1, 137_088), ("synth", False, 1, 198_672)], ids=IDS[1::2]
    + IDS[0::2])
def test_siren_plan_bf16(name, skip, nbuf, smem):
    """Shared memory of the bfloat16 entries: the weights resident plus a
    slab (two where the rows are 16-byte aligned) of 16 tokens for each of
    a block's 16 warps. All six fit one block per SM."""
    dims = _dims(name, skip)
    assert tsk.plan_bf16(dims) == (nbuf, smem)
    assert smem <= tsk.SMEM_LIMIT
    slab = tsk.BF16_WARPS * tsk.BF16_TILE * (-(-dims[0] // 16) * 16 + 8)
    assert smem == 2 * (tsk.layout_bf16(dims)[1] + nbuf * slab)
    # off a 16-byte boundary the rows come by 2-byte loads into one slab
    assert tsk.plan_bf16(dims, aligned=False)[0] == 1


def test_siren_plan_bf16_refuses_and_overflows():
    """A wide layer that feeds a wide layer is refused; 256 -> 256 in one
    layer exceeds a block's shared memory (the wrapper raises on it); two
    slabs give way to one where only one fits."""
    with pytest.raises(ValueError, match="must be last or feed"):
        tsk.plan_bf16([64, 256, 256, 3])
    assert tsk.plan_bf16([256, 256])[1] > tsk.SMEM_LIMIT
    assert tsk.plan_bf16([64, 256])[1] <= tsk.SMEM_LIMIT       # wide and last
    nbuf, smem = tsk.plan_bf16([256, 64])
    assert nbuf == 1 and smem <= tsk.SMEM_LIMIT
    assert tsk.plan_bf16([64] * 9) == (2, 2 * (8 * 64 * 73 + 2 * 16 * 16 * 72))


@pytest.mark.parametrize("name,skip", ENTRIES, ids=IDS)
def test_siren_reference64_matches_flax(rng, name, skip):
    """siren_mlp_reference64 on bfloat16 inputs and weights against
    motif_tpu's composed Siren in float64 on the same values: 1e-9."""
    dims = MLPS[name]
    hidden, cout = dims[1:-1], dims[-1]
    jm = JSiren(hidden, len(hidden) - 1, cout, skip_first_linear=skip)
    params = JSiren(hidden, len(hidden) - 1, cout).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 2, dims[0])))["params"]
    # bfloat16 values, held in float64
    params = jax.tree.map(lambda a: np.asarray(
        jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32), np.float64),
        params)
    port = Siren(dims[0], hidden, len(hidden) - 1, cout).double()
    tckpt.load_flax_params(port, params)
    lins = port._linears()[1 if skip else 0:]
    ws = [m.weight.detach().bfloat16() for m in lins]
    bs = [m.bias.detach().bfloat16() for m in lins]
    x = torch.from_numpy(rng.uniform(-0.6, 0.6, (2, 40, _dims(name, skip)[0]))
                         ).bfloat16()
    with jax.enable_x64(True):
        want = jm.apply({"params": params}, jnp.asarray(x.double().numpy()))
    got = tsk.siren_mlp_reference64(x, ws, bs, 30.0, False, skip)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-9)


def _variant(x, ws, bs, sine_last=False, skip_first=False, order=None,
             drop=None, sine_eps=0.0):
    """The plain bfloat16 MLP with its float32 sums taken in another order
    (`order`: "permuted" k, or "chunks" of 16 k summed apart, as a tensor
    core does), without one rounding point (`drop`: "product" or "omega"),
    or with every sine off by `sine_eps`."""
    def r(t):
        return t.bfloat16().float()

    def sine(t):
        return r(torch.sin(t) + sine_eps)

    def product(h, w):
        wt = w.float().t()
        if order == "permuted":
            idx = torch.randperm(h.shape[1],
                                 generator=torch.Generator().manual_seed(5))
            return h[:, idx] @ wt[idx]
        if order == "chunks":
            acc = torch.zeros((h.shape[0], wt.shape[1]))
            for k in reversed(range(0, h.shape[1], 16)):
                acc = acc + h[:, k:k + 16] @ wt[k:k + 16]
            return acc
        return h @ wt
    h = x.float()
    if skip_first:
        h = sine(r(30.0 * h))
    for i, (w, b) in enumerate(zip(ws, bs)):
        acc = product(h, w)
        h = r((acc if drop == "product" else r(acc)) + b.float())
        if i < len(ws) - 1 or sine_last:
            h = sine(30.0 * h if drop == "omega" else r(30.0 * h))
    return h.bfloat16()


def _pre_max(x, w, b):
    pre = torch.nn.functional.linear(x.double(), w.double())
    return float(torch.maximum(pre.abs(), (pre + b.double()).abs()).max())


@pytest.mark.parametrize("K,N", [(198, 64), (64, 256), (256, 3)])
@pytest.mark.parametrize("sine", [False, True])
def test_layer_gate_passes_another_order_and_catches_faults(K, N, sine):
    """Gate 1 on one layer: the same sums in a permuted or chunked k order
    pass (a few values on rounding boundaries flip); a missing rounding
    point after the product, or after omega0 *, and a sine off by 1e-3 do
    not."""
    ws, bs, g = _params([K, N])
    x = (torch.rand((20_000, K), generator=g) * 2 - 1).bfloat16()
    want = tsk.siren_mlp_plain(x, ws, bs, 30.0, sine)
    assert torch.equal(_variant(x, ws, bs, sine), want)
    pre_max = _pre_max(x, ws[0], bs[0])
    for order in ("permuted", "chunks"):
        held = tsk.layer_gate(_variant(x, ws, bs, sine, order=order), want,
                              pre_max, 30.0, sine)
        assert held["ok"] and held["exact_share"] < 1.0 or N == 3, held
    bad = tsk.layer_gate(_variant(x, ws, bs, sine, drop="product"), want,
                         pre_max, 30.0, sine)
    assert not bad["ok"] and bad["exact_share"] < 0.99, bad
    if sine:
        for fault in (dict(drop="omega"), dict(sine_eps=1e-3)):
            bad = tsk.layer_gate(_variant(x, ws, bs, sine, **fault), want,
                                 pre_max, 30.0, sine)
            assert not bad["ok"], (fault, bad)
    # a wrong column (a fragment mapped to its neighbour) is far outside
    rolled = torch.roll(want, 1, dims=1)
    assert not tsk.layer_gate(rolled, want, pre_max, 30.0, sine)["ok"]


@pytest.mark.parametrize("name,skip", ENTRIES, ids=IDS)
def test_mlp_gate_passes_another_order_and_catches_faults(name, skip):
    """Gate 2 on the three MLPs, both entries, against the float64
    reference: another accumulation order is as accurate as the plain
    version (RMS within 1.25 x, no bias, max within 2 x) although its
    outputs differ by many ulps in places; sines off by 1e-2 and a dropped
    bias are not. (A sine off by 1e-3, or a missing rounding point, moves a
    whole MLP's error by less than its own rounding noise — a dropped
    rounding even lowers it: those are gate 1's to catch, per layer.)"""
    dims = _dims(name, skip)
    ws, bs, g = _params(dims)
    x = ((torch.rand((6000, dims[0]), generator=g) * 2 - 1)
         * (0.6 if skip else 1.0)).bfloat16()
    want = tsk.siren_mlp_plain(x, ws, bs, 30.0, False, skip)
    ref = tsk.siren_mlp_reference64(x, ws, bs, 30.0, False, skip)
    for order in ("permuted", "chunks"):
        got = _variant(x, ws, bs, False, skip, order=order)
        held = tsk.mlp_gate(got, want, ref)
        assert held["ok"] and 0.5 < held["exact_share"] < 1.0, held
    bad = tsk.mlp_gate(_variant(x, ws, bs, False, skip, sine_eps=1e-2), want,
                       ref)
    assert not bad["ok"], bad
    fine = tsk.mlp_gate(_variant(x, ws, bs, False, skip, drop="product"),
                        want, ref)
    assert fine["ok"] and fine["rms_err"] < fine["plain_rms_err"], fine
    zeroed = [torch.zeros_like(b) for b in bs[:-1]] + [bs[-1]]
    bad = tsk.mlp_gate(tsk.siren_mlp_plain(x, ws, zeroed, 30.0, False, skip),
                       want, ref)
    assert not bad["ok"], bad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("skip", [False, True])
def test_siren_packs_once_and_follows_a_load(dtype, skip):
    """Siren.packed is made once per dtype and per `skip_first_linear`
    (serving the other setting keeps this one's buffer, which a graph
    captured under it reads) and made anew after a load_state_dict (which
    writes the parameters in place) — the buffer the kernel would be given
    always holds the current weights."""
    torch.manual_seed(0)
    net = Siren(19, [64, 64, 256], 2, 3, skip_first_linear=skip)
    other = Siren(19, [64, 64, 256], 2, 3, skip_first_linear=skip)
    first = net.packed(dtype)
    assert first.dtype == dtype and net.packed(dtype) is first
    assert net.packed(torch.float64) is not first
    net.skip_first_linear = not skip
    flipped = net.packed(dtype)
    net.skip_first_linear = skip
    assert flipped is not first and net.packed(dtype) is first
    lins = net._linears()[1 if skip else 0:]
    assert first.numel() == tsk.pack_size(
        [lins[0].weight.shape[1]] + [m.weight.shape[0] for m in lins], dtype)
    net.load_state_dict(other.state_dict())
    second = net.packed(dtype)
    assert second is not first and not torch.equal(second, first)
    assert torch.equal(second, other.packed(dtype))
    assert "_derived_cache" not in net.state_dict()


def test_cached_follows_version_and_device_stamp():
    lin = torch.nn.Linear(3, 2)
    made = []

    def make():
        made.append(1)
        return lin.weight.detach() * 2
    a = cached(lin, "k", [lin.weight], make)
    assert cached(lin, "k", [lin.weight], make) is a and len(made) == 1
    with torch.no_grad():
        lin.weight.add_(1.0)
    b = cached(lin, "k", [lin.weight], make)
    assert b is not a and len(made) == 2
    assert cached(lin, "other", [lin.weight], make) is not b


def _dcn_case(rng, with_bias=True):
    G, cg, K, cout = 4, 8, 3, 16
    x = torch.from_numpy(rng.standard_normal((2, 12, 14, G * cg))).bfloat16()
    off = torch.from_numpy(rng.uniform(-4, 4, (2, 12, 14, G * K * K * 2))
                           ).bfloat16()
    mask = torch.from_numpy(rng.uniform(0, 1, (2, 12, 14, G * K * K))
                            ).bfloat16()
    w = torch.from_numpy(rng.standard_normal((cout, G * cg, K, K)) * 0.1
                         ).bfloat16()
    b = torch.from_numpy(rng.standard_normal((cout,))).bfloat16()
    return (x, off, mask, w, b if with_bias else None, K, 1, 1, 1, G)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("with_bias", [True, False])
def test_dcn_v2_plain_is_the_cpu_route(rng, with_bias, dtype):
    """dcn_v2_plain is the plain im2col and one product in the tensors'
    dtype (bfloat16: float32 sums, the bias, one rounding); on the CPU
    dcn_v2 is that, bit for bit, and its weight columns follow the
    im2col's (g, k, c) order."""
    args = _dcn_case(rng, with_bias)
    args = tuple(a.to(dtype) if isinstance(a, torch.Tensor) else a
                 for a in args)
    x, off, mask, w, b, K, _, _, _, G = args
    want = tdcn.dcn_v2_plain(*args)
    assert want.dtype == dtype and want.shape == (2, 12, 14, 16)
    assert torch.equal(tdcn.dcn_v2(*args), want)
    cols = tdcn.dcn_im2col_plain(x, off, mask, K, 1, 1, 1, G)
    cg = x.shape[-1] // G
    wm = w.reshape(16, G, cg, K * K).permute(0, 1, 3, 2).reshape(16, -1)
    by_hand = cols.double() @ wm.double().t()
    if b is not None:
        by_hand = by_hand + b.double()
    tol = {torch.bfloat16: 2 ** -5, torch.float32: 1e-4,
           torch.float64: 1e-10}[dtype]
    torch.testing.assert_close(want.double().reshape(-1, 16), by_hand,
                               rtol=0, atol=tol)


def test_bfloat16_ulps_counts_neighbours():
    a = torch.tensor([1.0, 1.0, -1.0, 0.0, 0.0078125, 2.0]).bfloat16()
    b = torch.tensor([1.0078125, 1.0, -1.0078125, -0.0, 0.0078125, 1.9921875]
                     ).bfloat16()
    assert kernels.bfloat16_ulps(a, b).tolist() == [1, 0, 1, 0, 0, 1]
    tiny = torch.tensor([1e-40, -1e-40]).bfloat16()
    assert kernels.bfloat16_ulps(tiny, -tiny).max() <= 2
