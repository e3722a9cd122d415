"""MoTIF cut into `trunk` (what reads the frames: RAFT, the reliability
metrics, the encoder) and `head` (what reads the times), which
`Evaluator.infer` runs once a request and once a chunk of times.

Several heads over one trunk equal, bit for bit, the whole forward run
anew for each chunk: the benchmark's frozen plain reference
(`benchmark/reference/motif.py`, a copy of the forward from before the
cut that imports nothing of the program) where it has the path (float32:
no knob, fused_decode, raft_resolution, decode_chunks), and the port's own
forward run anew under the low-precision knobs, which the reference does
not run; each head leaves the trunk's state as it was. Families: Ours,
Ours_44 with live RAFT and with precomputed flows, and the linear-motion
Ours_7 with the knobs it takes. The training gradients through `forward`
(teacher forcing along the live teacher, or the precomputed flows) are
the reference's to 1e-12 of the largest in float64. The CPU bucket runs
the trunk once a request and the head once a chunk, bit for bit the
eager per-chunk path (`_infer_eager`).

MoTIF at width 16, 1 + 1 blocks, the DCN offsets perturbed; LQ 16x24 ->
64x96, iters 2, on the CPU.
"""

import numpy as np
import pytest
import torch

from benchmark.reference.motif import MoTIF as RefMoTIF
from motif_tpu_torch import obs
from motif_tpu_torch.eval import Evaluator
from motif_tpu_torch.models.motif import build_motif
from motif_tpu_torch.models.pcd import DCNSep

OUT_HW = (64, 96)
ITERS = 2
FAMILIES = {"Ours": dict(n_anchors=2), "Ours_44": dict(n_anchors=4),
            "Ours_44_flows": dict(n_anchors=4),
            "Ours_7": dict(linear_motion=True, setting=3)}
KNOBS = {"none": {}, "fused_decode": dict(fused_decode=True),
         "raft_resolution": dict(raft_resolution=0.5),
         "decode_chunks": dict(decode_chunks=2),
         "compute_dtype": dict(compute_dtype="bfloat16"),
         "splat_dtype": dict(splat_dtype="float16")}
PLAIN = ("none", "fused_decode", "raft_resolution", "decode_chunks")
OURS7_KNOBS = ("none", "decode_chunks", "splat_dtype")
CASES = [(f, k) for f in FAMILIES for k in KNOBS
         if f != "Ours_7" or k in OURS7_KNOBS]
# two chunks of three times, as the Evaluator cuts six
CHUNKS = (torch.tensor([[0.0, 1 / 6, 1 / 3]]),
          torch.tensor([[0.5, 2 / 3, 5 / 6]]))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(family, knobs=None):
    """The port's MoTIF and the reference's on the same weights."""
    kw = dict(FAMILIES[family], **(knobs or {}))
    port = build_motif(16, 1, 1, device="cpu", seed=0, **kw)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        port.alpha.fill_(0.3)                # z > 0: the max splat runs
        for mod in port.modules():
            if isinstance(mod, DCNSep):
                w, b = mod.conv_offset_mask.weight, mod.conv_offset_mask.bias
                w.copy_(torch.randn(w.shape, generator=g) * 0.01)
                b.copy_(torch.randn(b.shape, generator=g))
    ref = RefMoTIF(16, 1, 1, **kw)
    ref.load_state_dict(port.state_dict())
    return port, ref.eval()


def _inputs(family, dtype=torch.float32):
    """The LQ frames, the GT frames (B, N + 2, 64, 96, 3) and, for the
    precomputed-flow family, the LR flows and one teacher flow per
    chunk."""
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.random((1, 4, 16, 24, 3)), dtype=dtype)
    gt = torch.as_tensor(rng.random((1, 5, 64, 96, 3)), dtype=dtype)
    if family != "Ours_44_flows":
        return x, gt, None, (None, None)
    lr = torch.as_tensor(rng.standard_normal((1, 16, 16, 24, 2)) * 2,
                         dtype=dtype)
    return x, gt, lr, tuple(torch.as_tensor(
        rng.standard_normal((1, 3, 4, 64, 96, 2)) * 2, dtype=dtype)
        for _ in CHUNKS)


def _flows(lr, gt):
    return None if lr is None else (lr, gt)


@pytest.mark.parametrize("family,knob", CASES)
@torch.no_grad()
def test_heads_over_one_trunk_equal_the_whole_forward(family, knob):
    port, ref = _models(family, KNOBS[knob])
    oracle = ref if knob in PLAIN else port
    x, _, lr, gts = _inputs(family)
    state = port.trunk(x, OUT_HW, ITERS, _flows(lr, gts[0]))
    kept = {k: v.clone() for k, v in state.items()
            if isinstance(v, torch.Tensor)}
    for t, gt in zip(CHUNKS, gts):
        got = port.head(state, t, OUT_HW, flows=_flows(lr, gt))
        want = oracle(x, t, OUT_HW, iters=ITERS, flows=_flows(lr, gt))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), float(
                (a - b).abs().max())
    for k, v in kept.items():
        assert torch.equal(state[k], v), k


@pytest.mark.parametrize("family", ["Ours", "Ours_44_flows", "Ours_7"])
def test_training_gradients_through_forward_are_the_references(family):
    """One loss through `forward` in training (teacher forcing: the
    splat along the live teacher's flow, or along the precomputed one),
    its gradients against the reference's."""
    port, ref = _models(family)
    port, ref = port.double().train(), ref.double().train()
    x, gt, lr, gts = _inputs(family, torch.float64)
    t = CHUNKS[0].double()
    for m in (port, ref):
        f, fl, fg = m(x, t, OUT_HW, use_gt=True, iters=ITERS,
                      target_frames=gt, train=True, flows=_flows(lr, gts[0]))
        (f.square().mean() + fl.abs().mean() + fg.abs().mean()).backward()
    grads = [(p.grad, q.grad) for p, q in zip(port.parameters(),
                                              ref.parameters())]
    assert sum(a is not None for a, _ in grads) > 100
    top = max(float(b.abs().max()) for _, b in grads if b is not None)
    for a, b in grads:
        assert (a is None) == (b is None)
        if a is not None:
            assert float((a - b).abs().max()) <= 1e-12 * top


@pytest.mark.parametrize("family", ["Ours", "Ours_44"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_the_cpu_bucket_runs_the_trunk_once_a_request(family, n):
    """N times in chunks (3 a chunk for Ours, 1 for Ours_44), two requests
    on other frames through one bucket: one trunk run a request, one head
    run a chunk, the frames and the flow statistics those of the whole
    forward run per chunk, bit for bit."""
    port, _ = _models(family)
    ev = Evaluator(port, iters=ITERS, family=family, device="cpu")
    rng = np.random.default_rng(3)
    times = np.float32(np.arange(n) / n)[None]
    chunks = -(-n // ev.chunk)
    for _ in range(2):
        lq = rng.random((1, 4, 15, 22, 3))
        before = obs.counters()
        got, stats = ev.infer(lq, times, (60, 88))
        after = obs.counters()
        assert after["eval.trunk_replays"] - before.get(
            "eval.trunk_replays", 0) == 1
        assert after["eval.replays"] - before.get("eval.replays", 0) == chunks
        want, want_stats = ev._infer_eager(lq, times, (60, 88))
        assert got.shape == (n, 1, 60, 88, 3)
        np.testing.assert_array_equal(got, want)
        assert stats == want_stats
    assert len(ev._buckets) == 1
