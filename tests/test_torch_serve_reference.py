"""The port's MoTIF under the five serving knobs (bfloat16 compute, float16
splat sums, the fused decode, RAFT at half the HR grid, three decode
chunks) against the benchmark's plain reference of that path
(`benchmark/reference/serve.py` over `lowp.py`, plain PyTorch that imports
nothing of the program), on the CPU, where every kernel op of the port
runs its plain version:

- each op of `lowp.py` against the port's plain entry of the same types;
- the port's frames and flow statistics, through `Evaluator.infer` and
  its bucket (the trunk once a request, the head once a chunk), against
  the reference's whole forward run per chunk;
- several heads over one trunk against the reference's whole forward;
- the control of the benchmark's serving cell (`serve.Lowered`: the
  reference with the parts the configuration keeps above bfloat16
  dropped to bfloat16) failing the same tolerances.

The tolerances, and why: the flow statistics come from RAFT and the
reliability metrics, the same operations in the same order on both sides,
so they agree to float32 rounding (1e-6 relative). The frames: the port's
bfloat16 DCN contracts its columns in one bfloat16 `addmm`, whose
accumulation order is not the reference's float32 product, so a small
share of the DCN outputs round the other way (0.02% in
`test_lowp_ops_are_the_ports_plain_entries`); the encoder carries them
into the features, and a frame value that ends near a bfloat16 rounding
boundary flips by one ulp: at most 2^-8 (one ulp of [0.5, 1)), and at
least 95% of the values bit for bit.

MoTIF at width 16, 1 + 2 blocks, the DCN offsets perturbed, weights from a
seed; LR 32x40 -> HR 128x160 (RAFT at 64x80, above its 64-pixel floor);
one torch thread. Imports no JAX."""

import numpy as np
import pytest
import torch

from benchmark.reference import lowp, serve
from benchmark.reference.motif import MoTIF as RefMoTIF
from motif_tpu_torch.eval import Evaluator
from motif_tpu_torch.models.motif import build_motif
from motif_tpu_torch.models.pcd import DCNSep
from motif_tpu_torch.ops import dcn, siren_kernel, softsplat

SERVING = dict(fused_decode=True, compute_dtype="bfloat16",
               splat_dtype="float16", raft_resolution=0.5, decode_chunks=3)
OUT_HW = (128, 160)
ITERS = 2
FLOW_REL = 1e-6          # the flow statistics: float32 rounding
FRAME_ULP = 2.0 ** -8    # one bfloat16 ulp of a frame value in [0.5, 1)
FRAME_EXACT = 0.95       # the share of frame values bit for bit
BF = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The port's serving MoTIF and the reference's on the same weights."""
    port = build_motif(16, 1, 2, device="cpu", seed=0, **SERVING)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        # the frames inside the clamp to [0, 1], as the benchmark's init
        # rules put them (its configurations' `init`)
        port.synth_net.net[4].bias.fill_(0.5)
        for mod in port.modules():
            if isinstance(mod, DCNSep):
                w, b = mod.conv_offset_mask.weight, mod.conv_offset_mask.bias
                w.copy_(torch.randn(w.shape, generator=g) * 0.01)
                b.copy_(torch.randn(b.shape, generator=g))
    ref = RefMoTIF(16, 1, 2, **SERVING)
    ref.load_state_dict(port.state_dict())
    return port, ref.eval()


LQ = np.random.default_rng(2).random((1, 4, 32, 40, 3)).astype(np.float32)
TIMES = np.float32(np.arange(5) / 5)[None]     # two chunks of 3, padded


def _gaps(got, want, got_stats, want_stats):
    d = (torch.as_tensor(np.asarray(got)) - want).abs()
    rel = max(abs(a - b) / abs(b) for a, b in zip(got_stats, want_stats))
    return float(d.max()), float((d == 0).double().mean()), rel


def _within(gaps) -> bool:
    frame_max, exact, flow_rel = gaps
    return (frame_max <= FRAME_ULP and exact >= FRAME_EXACT
            and flow_rel <= FLOW_REL)


@pytest.fixture(scope="module")
def reference_answer(models):
    _, ref = models
    return serve.infer(ref, LQ, TIMES, OUT_HW, 4, 3, ITERS, "cpu")


def test_the_ports_serving_requests_are_the_references(models,
                                                       reference_answer):
    port, _ = models
    ev = Evaluator(port, iters=ITERS, device="cpu")
    assert ev.model.knobs() == SERVING
    got, stats = ev.infer(LQ, TIMES, OUT_HW)
    want, want_stats = reference_answer
    gaps = _gaps(got, want, stats, want_stats)
    assert _within(gaps), gaps
    assert want_stats[1] > 0


@torch.no_grad()
def test_heads_over_one_trunk_are_the_references_whole_forward(models):
    port, ref = models
    x = torch.as_tensor(LQ)
    state = port.trunk(x, OUT_HW, ITERS)
    with serve.ops():
        for t in (torch.tensor([[0.0, 0.2, 0.4]]),
                  torch.tensor([[0.6, 0.8, 0.8]])):
            got = port.head(state, t, OUT_HW)
            want = ref(x, t, OUT_HW, iters=ITERS)
            frames = (got[0] - want[0]).abs()
            assert float(frames.max()) <= FRAME_ULP
            assert float((frames == 0).double().mean()) >= FRAME_EXACT
            for a, b in zip(got[1:], want[1:]):     # the flows
                assert a.dtype == b.dtype == torch.float32
                assert float((a - b).abs().max()) <= FLOW_REL * float(
                    b.abs().max())


def test_the_control_fails_the_tolerances(models, reference_answer):
    """The reference with the float32 parts dropped to bfloat16 (the
    serving cell's `--control half`) is not within the tolerances the
    port meets."""
    _, ref = models
    lowered = serve.Lowered(RefMoTIF(16, 1, 2, **SERVING).eval())
    lowered.model.load_state_dict(ref.state_dict())
    got, stats = serve.infer(lowered, LQ, TIMES, OUT_HW, 4, 3, ITERS, "cpu")
    want, want_stats = reference_answer
    gaps = _gaps(got.numpy(), want, stats, want_stats)
    assert not _within(gaps), gaps
    assert gaps[2] > 10 * FLOW_REL


def _siren_case(skip_first):
    g = torch.Generator().manual_seed(3)
    dims = [64, 64, 256, 3] if skip_first else [67, 64, 64, 256, 3]
    x = torch.randn(4000, dims[0], generator=g).to(BF)
    ws = [(torch.randn(o, i, generator=g) / i ** 0.5).to(BF)
          for i, o in zip(dims[:-1], dims[1:])]
    bs = [(torch.randn(o, generator=g) * 0.1).to(BF) for o in dims[1:]]
    return x, ws, bs


@pytest.mark.parametrize("skip_first", [False, True],
                         ids=["whole", "skip_first"])
def test_lowp_siren_is_the_ports_plain_entry(skip_first):
    """The bfloat16 SIREN: the same four roundings a layer, bit for bit."""
    x, ws, bs = _siren_case(skip_first)
    got = lowp.siren_mlp(x, ws, bs, skip_first=skip_first)
    want = siren_kernel.siren_mlp_plain(x, ws, bs, skip_first=skip_first)
    assert got.dtype == BF and torch.equal(got, want)


def test_lowp_ops_are_the_ports_plain_entries():
    """The bfloat16 DCN: the columns bit for bit; the outputs one bfloat16
    ulp apart where the port's bfloat16 `addmm` accumulates in another
    order (a small share). The float16-sum splat, with and without its
    max: bit for bit."""
    g = torch.Generator().manual_seed(4)
    B, H, W, C, G, K = 2, 16, 20, 64, 8, 3
    x = torch.randn(B, H, W, C, generator=g).to(BF)
    off = (torch.randn(B, H, W, G * K * K * 2, generator=g) * 2).to(BF)
    mask = torch.rand(B, H, W, G * K * K, generator=g).to(BF)
    w = (torch.randn(64, C, K, K, generator=g) * 0.05).to(BF)
    b = (torch.randn(64, generator=g) * 0.1).to(BF)
    got = lowp.dcn_v2(x, off, mask, w, b, K, 1, 1, 1, G)
    want = dcn.dcn_v2_plain(x, off, mask, w, b, K, 1, 1, 1, G)
    ulp = 2.0 ** (torch.floor(torch.log2(want.float().abs())) - 7)
    assert got.dtype == BF
    assert bool(((got.float() - want.float()).abs() <= ulp).all())
    assert float((got == want).double().mean()) >= 0.999
    img = torch.rand(2, 24, 32, 64, generator=g)
    flow = torch.randn(2, 24, 32, 2, generator=g) * 3
    for z, nonpos in ((-torch.rand(2, 24, 32, 1, generator=g), True),
                      (torch.rand(2, 24, 32, 1, generator=g), False)):
        got = lowp.splat_fused(img, flow, z, nonpos, torch.float16)
        want = softsplat.splat_fused_plain(img, flow, z, nonpos,
                                           torch.float16)
        for a, c in zip(got, want):
            assert a.dtype == c.dtype == torch.float32 and torch.equal(a, c)


def test_lowp_runs_the_plain_ops_in_float32():
    from benchmark.reference import plain

    g = torch.Generator().manual_seed(5)
    x, ws, bs = _siren_case(False)
    x, ws, bs = x.float(), [w.float() for w in ws], [b.float() for b in bs]
    assert torch.equal(lowp.siren_mlp(x, ws, bs), plain.siren_mlp(x, ws, bs))
    img = torch.rand(1, 8, 8, 4, generator=g)
    flow = torch.randn(1, 8, 8, 2, generator=g)
    z = -torch.rand(1, 8, 8, 1, generator=g)
    for a, c in zip(lowp.splat_fused(img, flow, z, True),
                    plain.splat_fused(img, flow, z, True)):
        assert torch.equal(a, c)
