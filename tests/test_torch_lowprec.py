"""The new entries of the port's three kernels, through their plain versions
on the CPU, against motif_tpu: the skip-first-linear SIREN (float64), and
per module that holds a kernel its low-precision entry — the bfloat16 SIREN
and DCN, the float16-sum splat — in the working type.

Tolerances are in ulps of the element type at the outputs' largest
magnitude (bfloat16 keeps 8 significant bits, float16 11): the two packages
round at the same points but XLA and PyTorch do not always sum in the same
order before a rounding. The CUDA entries are held against these plain
versions on the card in test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _launches import by_entry, by_kernel

from motif_tpu.models.siren import Siren as JSiren
from motif_tpu.ops import dcn as jdcn
from motif_tpu.ops.softsplat import splat_fused as jsplat_fused
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch import obs
from motif_tpu_torch.models.layers import Conv2d, cast_param
from motif_tpu_torch.models.siren import Siren
from motif_tpu_torch.ops import dcn as tdcn
from motif_tpu_torch.ops import kernels
from motif_tpu_torch.ops import siren_kernel as tsk
from motif_tpu_torch.ops import softsplat as tsplat

# (in, hidden widths, out): STINF, SINF and synth at channel 16
SHAPES = {"stinf": (19, [64, 64, 256], 3), "sinf": (18, [64, 64, 256], 64),
          "synth": (102, [64, 64, 64, 256], 3)}


def ulp_at(scale: float, bits: int) -> float:
    """One unit in the last place of a type with `bits` stored mantissa
    bits (bfloat16 7, float16 10) at magnitude `scale`."""
    return 2.0 ** (np.floor(np.log2(scale)) - bits)


def _flax_siren(name, seed=1):
    cin, hidden, cout = SHAPES[name]
    jm = JSiren(hidden, len(hidden) - 1, cout)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 2, cin)))["params"]
    return jax.tree.map(np.asarray, params)


def _port_siren(name, params, dtype, skip):
    cin, hidden, cout = SHAPES[name]
    m = Siren(cin, hidden, len(hidden) - 1, cout, skip_first_linear=skip)
    m = m.to(dtype)
    tckpt.load_flax_params(m, jax.tree.map(
        lambda a: np.asarray(a, np.float64), params))
    return m


@pytest.mark.parametrize("name", SHAPES)
def test_siren_skip_first_linear_matches_flax(rng, name):
    """Siren(skip_first_linear=True) from net_0's pre-activation against
    motif_tpu's, float64, atol 1e-9; and net_0's linear map (read through
    first_linear) followed by the skip-first MLP is the whole MLP."""
    cin, hidden, cout = SHAPES[name]
    params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                          _flax_siren(name))
    pre = rng.uniform(-0.5, 0.5, (2, 50, hidden[0]))
    jm = JSiren(hidden, len(hidden) - 1, cout, skip_first_linear=True)
    with jax.enable_x64(True):
        want = jm.apply({"params": params}, jnp.asarray(pre))
    skip = _port_siren(name, params, torch.float64, True)
    whole = _port_siren(name, params, torch.float64, False)
    assert list(skip.state_dict()) == list(whole.state_dict())
    with torch.no_grad():
        got = skip(torch.from_numpy(pre))
        x = torch.from_numpy(rng.uniform(-1, 1, (2, 50, cin)))
        w0, b0 = skip.first_linear(torch.float64)
        two_step = skip(torch.nn.functional.linear(x, w0, b0))
        one_step = whole(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(two_step.numpy(), one_step.numpy(), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("name", SHAPES)
@pytest.mark.parametrize("skip", [False, True], ids=["whole", "skip_first"])
def test_siren_bfloat16_matches_composed_flax(rng, name, skip):
    """siren_mlp_plain in bfloat16 (float32 parameters cast at use) against
    the composed motif_tpu Siren in bfloat16, both entries: at most 1
    bfloat16 ulp of the largest output (measured: bit-equal on this CPU —
    both round after the product, the bias, omega0 * and the sine)."""
    cin, hidden, cout = SHAPES[name]
    params = _flax_siren(name)
    width = hidden[0] if skip else cin
    x = (rng.uniform(-1, 1, (2, 400, width)) * (0.5 if skip else 1.0)
         ).astype(np.float32)
    jm = JSiren(hidden, len(hidden) - 1, cout, skip_first_linear=skip)
    want = jm.apply({"params": params}, jnp.asarray(x).astype(jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    with torch.no_grad():
        got = _port_siren(name, params, torch.float32, skip)(
            torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    tol = ulp_at(np.abs(want).max(), 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_siren_plain_bfloat16_rounds_four_times():
    """The plain bfloat16 layer is product, bias, omega0 * and sine, each
    rounded: it differs from the sine of the float32 pre-activation."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand((64, 8), generator=g).bfloat16()
    w = (torch.rand((8, 8), generator=g) - 0.5).bfloat16()
    b = (torch.rand((8,), generator=g) - 0.5).bfloat16()
    got = tsk.siren_mlp_plain(x, [w], [b], 30.0, sine_last=True)
    steps = torch.sin(30.0 * ((x.float() @ w.float().t()).bfloat16() + b))
    once = torch.sin(30.0 * (x.float() @ w.float().t() + b.float())).bfloat16()
    assert torch.equal(got, steps)
    assert not torch.equal(got, once)


def _dcn_inputs(rng, B=2, H=12, W=14, G=4, cg=8, K=3, cout=16):
    x = rng.standard_normal((B, H, W, G * cg)).astype(np.float32)
    off = rng.uniform(-4, 4, (B, H, W, G * K * K * 2)).astype(np.float32)
    mask = rng.uniform(0, 1, (B, H, W, G * K * K)).astype(np.float32)
    w = (rng.standard_normal((K, K, G * cg, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    return x, off, mask, w, b


def test_dcn_v2_bfloat16_matches_motif_tpu(rng):
    """dcn_v2 with bfloat16 x, offsets, mask and weights against
    motif_tpu.ops.dcn.dcn_v2 in bfloat16 (its one-hot sampler). The port
    keeps float32 hat weights and rounds a column once; motif_tpu rounds
    the hat weights, the row contraction, the sample and the masked sample.
    Both are then within bfloat16 rounding of the float32 result, and
    within 2 bfloat16 ulps of the largest output of each other (measured:
    1 ulp, 0.0156 at outputs up to 3.9)."""
    G = 4
    x, off, mask, w, b = _dcn_inputs(rng, G=G)

    def jb(a):
        return jnp.asarray(a).astype(jnp.bfloat16)

    def tb(a):
        return torch.from_numpy(a).bfloat16()
    want = jdcn.dcn_v2(jb(x), jb(off), jb(mask), jnp.asarray(w),
                       jnp.asarray(b), 3, 1, 1, 1, G)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    wt = np.transpose(w, (3, 2, 0, 1)).copy()            # HWIO -> OIHW
    got = tdcn.dcn_v2(tb(x), tb(off), tb(mask), tb(wt), tb(b), 3, 1, 1, 1, G)
    assert got.dtype == torch.bfloat16
    tol = 2 * ulp_at(np.abs(want).max(), 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    ref = np.asarray(jdcn.dcn_v2(*(jnp.asarray(a) for a in (x, off, mask, w,
                                                            b)), 3, 1, 1, 1, G))
    assert np.abs(got.float().numpy() - ref).max() < 4 * tol


def test_dcn_im2col_plain_bfloat16_rounds_once(rng):
    """The bfloat16 columns are the float32 columns of the same bfloat16
    inputs, rounded once."""
    x, off, mask, _, _ = _dcn_inputs(rng)
    args = [torch.from_numpy(a).bfloat16() for a in (x, off, mask)]
    got = tdcn.dcn_im2col_plain(*args, 3, 1, 1, 1, 4)
    wide = tdcn.dcn_im2col_plain(*(a.float() for a in args), 3, 1, 1, 1, 4)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, wide.bfloat16())


def _splat_inputs(rng, B=2, H=16, W=20, C=7):
    img = rng.standard_normal((B, H, W, C)).astype(np.float32)
    flow = (rng.standard_normal((B, H, W, 2)) * 3).astype(np.float32)
    flow[0, 0, :, 1] = -30.0                   # thrown off the top
    flow[1, :, -2:, 0] = 2.5                   # pushed past the right edge
    z = (rng.standard_normal((B, H, W, 1)) * 0.5).astype(np.float32)
    return img, flow, z


@pytest.mark.parametrize("z_nonpositive", [True, False])
def test_splat_float16_sums_match_base_backend(rng, z_nonpositive):
    """splat_fused_plain with float16 sums against motif_tpu's
    splat_fused(method="base", scatter_dtype=float16): float32 results,
    out and norm within 2 float16 ulps of the largest value (measured: 1
    ulp, 0.0039 at 8.5; 97% of the entries bit-equal), the count exact,
    the max float32 (atol 1e-6)."""
    img, flow, z = _splat_inputs(rng)
    if z_nonpositive:
        z = -np.abs(z)
    want = jsplat_fused(jnp.asarray(img), jnp.asarray(flow), jnp.asarray(z),
                        z_nonpositive=jnp.asarray(z_nonpositive),
                        method="base", scatter_dtype=jnp.float16)
    got = tsplat.splat_fused(torch.from_numpy(img), torch.from_numpy(flow),
                             torch.from_numpy(z), z_nonpositive,
                             scatter_dtype=torch.float16)
    for g, w_ in zip(got[:2], want[:2]):
        assert g.dtype == torch.float32
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g.numpy(), w_, rtol=0,
                                   atol=2 * ulp_at(np.abs(w_).max(), 10))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    full = tsplat.splat_fused(torch.from_numpy(img), torch.from_numpy(flow),
                              torch.from_numpy(z), z_nonpositive)
    assert not torch.equal(got[0], full[0])      # the sums really are float16
    torch.testing.assert_close(got[0], full[0], rtol=0, atol=2e-2)


def test_splat_scatter_dtype_is_float16_or_the_inputs(rng):
    img, flow, z = (torch.from_numpy(a) for a in _splat_inputs(rng))
    same = tsplat.splat_fused(img, flow, z, False, scatter_dtype=torch.float32)
    none = tsplat.splat_fused(img, flow, z, False)
    assert all(torch.equal(a, b) for a, b in zip(same, none))
    with pytest.raises(ValueError, match="float16"):
        tsplat.splat_fused(img, flow, z, False, scatter_dtype=torch.bfloat16)


@torch.no_grad()      # the serving path; under autograd a cast raises
def test_cast_param_caches_and_follows_writes():
    conv = Conv2d(4, 4, 3, 1, 1)
    assert cast_param(conv, "weight", torch.float32) is conv.weight
    first = cast_param(conv, "weight", torch.bfloat16)
    assert first.dtype == torch.bfloat16
    assert cast_param(conv, "weight", torch.bfloat16) is first
    conv.weight.copy_(torch.ones_like(conv.weight))       # what a load does
    second = cast_param(conv, "weight", torch.bfloat16)
    assert second is not first and (second == 1).all()
    assert "_cast_cache" not in conv.state_dict()
    nobias = Conv2d(4, 4, 1, bias=False)
    assert cast_param(nobias, "bias", torch.bfloat16) is None


@torch.no_grad()      # the serving path; under autograd a cast raises
def test_conv2d_bfloat16_input_gives_bfloat16():
    conv = Conv2d(4, 6, 3, 1, 1)
    x = torch.rand(1, 5, 5, 4)
    y = conv(x.bfloat16())
    assert y.dtype == torch.bfloat16 and conv.weight.dtype == torch.float32
    torch.testing.assert_close(y.float(), conv(x), rtol=0, atol=3e-2)


@pytest.mark.parametrize("C,elem,tile", [(64, 2, (8, 8)), (64, 4, (8, 4)),
                                         (130, 2, (8, 8)), (1000, 2, (8, 8)),
                                         (2000, 2, (4, 8))])
def test_splat_plan_takes_the_element_size(C, elem, tile):
    """The serving payload (C = 64) takes its measured tile per sum type
    (8x8 of halves: 8,704 B with the floats of the max; 8x4 of floats:
    8,576 B), and float16 sums keep 8x8 up to twice the channels float32
    sums do."""
    assert tsplat.plan(C, elem) == tile
    th, tw = tile
    assert (th * tw * ((C + 2) * elem + 4) + tsplat.STAGE_BYTES
            <= tsplat.SMEM_LIMIT)


@pytest.mark.parametrize("dims,elem,smem", [
    ([64, 64, 256, 3], 2, 124_688), ([64, 64, 256, 64], 2, 154_368),
    ([64, 64, 64, 256, 3], 2, 134_032), ([64, 64, 64, 256, 3], 4, 173_600),
    ([198, 64, 64, 64, 256, 3], 2, 198_672),
], ids=["stinf-skip", "sinf-skip", "synth-skip", "synth-skip-f32",
        "synth-whole-bf16"])
def test_siren_plan_takes_the_element_size(dims, elem, smem):
    """Shared memory of the skip-first entries (layer 0 not resident) by
    element type: float32 keeps two activation buffers of 64 x 128 beside
    the weights (`plan`), bfloat16 keeps the weights in the tensor cores'
    layout and a slab or two of 16 tokens per warp (`plan_bf16`). Each fits
    one block per SM."""
    if elem == 2:
        got = tsk.plan_bf16(dims)[1]
    else:
        fused, rows, got = tsk.plan(dims)
        assert rows == 64
    assert got == smem <= tsk.SMEM_LIMIT


def test_require_cuda_names_the_dtypes():
    """The wrappers' check on what reaches a kernel: one CUDA device and
    one of the entry's dtypes, nothing converted."""
    t = torch.zeros(2)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.require_cuda("k", (torch.float32,), t)
    meta = torch.zeros(2, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        kernels.require_cuda("k", (torch.float32,), meta, t)


def test_entry_counters_reset():
    obs.reset(obs.LAUNCHES)
    kernels.count("siren_mlp", "bfloat16/skip_first")
    kernels.count("siren_mlp", "bfloat16/skip_first")
    assert by_kernel()["siren_mlp"] == 2
    assert by_entry() == {"siren_mlp/bfloat16/skip_first": 2}
    obs.reset(obs.LAUNCHES)
    assert by_kernel()["siren_mlp"] == 0 and not by_entry()
