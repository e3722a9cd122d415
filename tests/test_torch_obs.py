"""`motif_tpu_torch.obs`, the port's spans and counters, and the benchmark's
readers of them (`benchmark/metrics/_program.py` and the Entry and Model
metrics of the clip cells).

A span is off unless a torch profiler records: it then reads no clock and
opens no profiler range. Under the profiler on the CPU a tiny MoTIF's
`Evaluator.infer` records its request as `infer` over its children, in
order, each under one request id, with the same names in the profiler's
events: the trunk's parts under `infer.trunk` once, the head's under
each chunk's `infer.replay`. The counters: kernel launches through a
capture's tape and its replays (the CUDA calls of a capture stood in for
on the CPU), captures, replays and the reset of every bucket after a
weight write; a MoTIF bucket's trunk graph and head graph (`_Graph`),
each with its own tape, marks of the parts it ran and replay counter, and
`parts_ms` times the forwards giving the request's milliseconds of each
part; the marks leave out a part whose end was not recorded; a capture
that fails raises with its bucket's key. A full buffer drops its
oldest record and counts the drop. The readers on a synthetic
traced run whose device clock shifts: each request set on its own device
operations and one whose trace shifted inside it left out, the idle time
inside `infer` split into the graph's own and the host's, the slice line's
reading of it, and the parts per frame.

The card tests (`cuda`): a MoTIF bucket's graphs with their marks' event
nodes serve the eager frames, and one replay of each, their marks, time
the whole forward within 3% of the replays' extent on the profiler's
device timeline; a backward's span holds its kernels' device time. The
file imports no JAX:
`python -m pytest -q -m cuda --noconftest tests/test_torch_obs.py`.
"""

import collections
import contextlib
import copy
import sys
from unittest import mock

import numpy as np
import pytest
import torch
from _launches import by_kernel
from torch.profiler import ProfilerActivity, profile

from motif_tpu_torch import obs
from motif_tpu_torch.eval import Evaluator, _Bucket
from motif_tpu_torch.models.motif import PARTS, build_motif
from motif_tpu_torch.ops import kernels

LQ = np.random.default_rng(0).random((1, 4, 16, 24, 3), np.float32)
TIMES = np.float32([[0.0, 0.25, 0.5, 0.75]])     # two chunks of 3
OUT_HW = (64, 96)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_ev():
    return Evaluator(build_motif(16, 1, 1, device="cpu"), iters=2,
                     device="cpu")


def _profiled(fn):
    obs.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, obs.spans(), {e.name for e in prof.events()}


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def test_a_span_without_a_profiler_reads_no_clock_and_opens_no_range(
        tiny_ev):
    obs.clear()
    with mock.patch.object(obs.time, "perf_counter_ns") as clock, \
            mock.patch.object(obs, "_range") as rf:
        with obs.span("x", a=1) as sp:
            sp.set(b=2)
        frames, _ = tiny_ev.infer(LQ, TIMES, OUT_HW)
    assert obs.span("x") is obs.OFF and not obs.enabled()
    assert clock.call_count == 0 and rf.call_count == 0
    assert obs.spans() == [] and frames.shape == (4, 1, 64, 96, 3)


def test_infer_records_its_request_under_the_profiler(tiny_ev):
    (frames, _), recs, names = _profiled(
        lambda: tiny_ev.infer(LQ, TIMES, OUT_HW))
    root = [r for r in recs if r["name"] == "infer"]
    assert len(root) == 1
    root = root[0]
    assert root["parent"] is None and root["request"] == root["id"]
    assert root["attrs"] == {"n": 4, "chunks": 2, "bucket": root["attrs"][
        "bucket"], "knobs": "fp32", "frames": 4}
    kids = sorted((r for r in recs if r["parent"] == root["id"]),
                  key=lambda r: r["start"])
    assert [k["name"] for k in kids] == [
        "infer.plan", "infer.bucket", "infer.copy_in", "infer.trunk",
        "infer.replay", "infer.gather", "infer.replay", "infer.gather",
        "infer.copy_out", "infer.wait", "infer.unpad"]
    assert [k["attrs"].get("chunk") for k in kids if k["name"] in (
        "infer.replay", "infer.gather")] == [0, 0, 1, 1]
    assert {r["request"] for r in recs} == {root["id"]}
    for k in kids:
        assert root["start"] <= k["start"] <= k["end"] <= root["end"]

    def parts(parent):      # on the CPU a bucket runs the eager trunk, head
        return [r["name"] for r in sorted(
            (r for r in recs if r["parent"] == parent["id"]),
            key=lambda r: r["start"])]
    (trunk,) = [k for k in kids if k["name"] == "infer.trunk"]
    assert parts(trunk) == ["motif.motion", "motif.encoder"]
    for rp in [k for k in kids if k["name"] == "infer.replay"]:
        assert parts(rp) == ["motif.decode", "motif.splat", "motif.synth"]
    assert {r["name"] for r in recs} <= names
    assert frames.shape == (4, 1, 64, 96, 3)


SERVING = dict(fused_decode=True, compute_dtype="bfloat16",
               splat_dtype="float16", raft_resolution=0.5, decode_chunks=3)


@pytest.mark.parametrize("knobs,label", [
    ({}, "fp32"), (SERVING, "bf16/f16/fused/r0.5/dc3"),
    (dict(raft_resolution=0.5), "r0.5")], ids=["float32", "serving", "raft"])
def test_infer_names_its_buckets_knob_set(knobs, label):
    """The `infer` span's `knobs`: the bucket's knob set as one string,
    the parameters' dtype where no knob is on. (LR 16 x 24 -> HR 64 x 96:
    RAFT at half the HR grid keeps its 64-pixel floor.)"""
    ev = Evaluator(build_motif(16, 1, 1, device="cpu", **knobs), iters=2,
                   device="cpu")
    (frames, _), recs, _ = _profiled(lambda: ev.infer(LQ, TIMES, OUT_HW))
    (root,) = [r for r in recs if r["name"] == "infer"]
    assert root["attrs"]["knobs"] == label
    assert frames.shape == (4, 1, 64, 96, 3)


def _grew(before, name):
    return obs.counters().get(name, 0) - before.get(name, 0)


def test_cast_param_counts_each_kept_copy():
    """A bfloat16 forward keeps a cast copy of each float32 weight: the
    first forward counts one copy a weight and its bytes, the next none,
    and one again after `load_state_dict` writes the weights."""
    from motif_tpu_torch.models.layers import Conv2d

    conv = Conv2d(8, 16, 3, 1, 1)
    x = torch.randn(1, 6, 7, 8, dtype=torch.bfloat16)
    nbytes = 2 * (conv.weight.numel() + conv.bias.numel())
    with torch.no_grad():
        for want, want_bytes in ((2, nbytes), (0, 0)):
            before = obs.counters()
            conv(x)
            assert _grew(before, "layers.cast_copies") == want
            assert _grew(before, "layers.cast_bytes") == want_bytes
        conv.load_state_dict(conv.state_dict())
        before = obs.counters()
        conv(x)
    assert _grew(before, "layers.cast_copies") == 2
    assert _grew(before, "layers.cast_bytes") == nbytes


def test_a_serving_request_recasts_no_weight_after_its_first():
    """The serving knobs' requests through `Evaluator.infer`: the first
    keeps the bfloat16 copies, every later one (a window's) counts none;
    float32 makes none."""
    for knobs, first in ((SERVING, True), ({}, False)):
        ev = Evaluator(build_motif(16, 1, 1, device="cpu", **knobs),
                       iters=2, device="cpu")
        before = obs.counters()
        ev.infer(LQ, TIMES, OUT_HW)
        assert (_grew(before, "layers.cast_copies") > 0) == first
        before = obs.counters()
        for _ in range(2):
            ev.infer(LQ[:, ::-1].copy(), TIMES, OUT_HW)
        assert _grew(before, "layers.cast_copies") == 0
        assert _grew(before, "layers.cast_bytes") == 0


def test_the_buffer_drops_its_oldest_record_and_counts_it(monkeypatch):
    monkeypatch.setattr(obs, "CAPACITY", 3)
    monkeypatch.setattr(obs, "_records", collections.deque(maxlen=3))
    before = obs.counters().get("obs.spans_dropped", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with obs.span(f"s{i}", i=i):
                pass
    assert [r["name"] for r in obs.spans()] == ["s2", "s3", "s4"]
    assert [r["attrs"]["i"] for r in obs.spans()] == [2, 3, 4]
    assert obs.counters()["obs.spans_dropped"] - before == 2
    obs.clear()
    assert obs.spans() == []


def test_nested_spans_name_their_parent_and_request():
    _, recs, _ = _profiled(lambda: _nest())
    by = {r["name"]: r for r in recs}
    assert by["a"]["parent"] is None and by["b"]["parent"] == by["a"]["id"]
    assert by["c"]["parent"] == by["b"]["id"]
    assert {r["request"] for r in recs} == {by["a"]["id"]}
    assert by["c"]["attrs"] == {"k": 1, "later": 2}


def _nest():
    with obs.span("a"):
        with obs.span("b"):
            with obs.span("c", k=1) as sp:
                sp.set(later=2)


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

class _FakeEvent:
    t = 0.0

    def __init__(self, enable_timing=False, external=False):
        assert enable_timing and external
        self.at = None

    def record(self):
        _FakeEvent.t += 1.5
        self.at = _FakeEvent.t

    def elapsed_time(self, other):
        return other.at - self.at


class _FakeStream:
    def wait_stream(self, other):
        pass


@contextlib.contextmanager
def _cuda_stand_ins():
    """The CUDA calls of `_Graph.run`'s capture and replay stood in for
    on the CPU: the capture runs the forward once more (recording), a
    replay runs nothing."""
    null = contextlib.nullcontext
    graph = type("Graph", (), {"replay": lambda self: None})
    with mock.patch.object(torch.cuda, "Stream", lambda dev: _FakeStream()), \
            mock.patch.object(torch.cuda, "current_stream",
                              lambda dev=None: _FakeStream()), \
            mock.patch.object(torch.cuda, "stream", lambda s: null()), \
            mock.patch.object(torch.cuda, "CUDAGraph", graph), \
            mock.patch.object(torch.cuda, "graph",
                              lambda g, pool=None: null()), \
            mock.patch.object(torch.cuda, "Event", _FakeEvent):
        yield


def test_launches_captures_and_replays_are_counted():
    """A head graph's capture: the warm run's launches counted, the
    capture's on its tape; each replay counts the tape once, and a replay
    and a capture each their counter. The marks of the capture time the
    parts it ran, by name."""
    calls = []

    def forward(lq, t):
        calls.append(1)
        for p in PARTS:
            with obs.part(p):
                pass
        kernels.count("splat_fused", "float32")
        kernels.count("dcn_im2col", "float32")
        kernels.count("dcn_im2col", "float32")
        return lq + 1, None

    b = _Bucket("k", (1, 2), (1, 3), torch.float32, torch.device("cpu"),
                None)
    b.device = torch.device("cuda")
    before = obs.counters()
    launches = by_kernel()
    with _cuda_stand_ins():
        b._run(forward)
        g = b.head
        assert len(calls) == 2 and g.graph is not None
        assert g.tape == {"splat_fused/float32": 1, "dcn_im2col/float32": 2}
        for _ in range(3):
            b._run(forward)
    after = obs.counters()

    def grew(name):
        return after.get(name, 0) - before.get(name, 0)
    assert len(calls) == 2
    assert grew("eval.captures") == 1 and grew("eval.replays") == 3
    assert grew("kernels.launches.dcn_im2col/float32") == 2 * 4
    assert {k: v - launches[k] for k, v in by_kernel().items()} == {
        "splat_fused": 4, "dcn_im2col": 8, "siren_mlp": 0}
    assert g.marks.elapsed() == {p: 1.5 for p in PARTS}
    # no mark set is active outside a capture: a part is its span alone
    assert obs.part("motion") is obs.OFF


def test_a_trunk_graph_and_a_head_graph_each_count_their_own():
    """A MoTIF bucket's two graphs: the trunk's capture takes the eager
    run's values into its static outputs, records the parts it ran
    (motion, encoder) and its own tape, the head's its parts (decode,
    splat, synth) and its own; each replay counts its graph's tape and
    counter, and only the head's capture counts a bucket captured.
    `parts_ms` holds the trunk's parts over the request's forwards, so
    that each part's ms times the forwards is the request's ms of that
    part."""
    calls = []

    def part(name, ms):        # a part of `ms` ms (and a record 1.5)
        with obs.part(name):
            _FakeEvent.t += ms

    def trunk(lq):
        calls.append("trunk")
        part("motion", 1)
        part("encoder", 2)
        kernels.count("dcn_im2col", "float32")
        kernels.count("dcn_im2col", "float32")
        return {"x": lq, "feat": lq * 2.0 + len(calls)}

    def head(state, t):
        calls.append("head")
        for ms, name in enumerate(("decode", "splat", "synth"), 3):
            part(name, ms)
        kernels.count("splat_fused", "float32")
        return state["feat"] + t.sum(), None

    b = _Bucket("k", (1, 2), (1, 3), torch.float32, torch.device("cpu"),
                None, trunk=True)
    b.device = torch.device("cuda")
    before = obs.counters()
    with _cuda_stand_ins():
        state = b.trunk.run(trunk, b.lq)  # the eager run, then the capture
        assert calls == ["trunk"] * 2 and b.trunk.graph is not None
        assert state is b.trunk.out and state["x"] is b.lq and torch.equal(
            state["feat"], b.lq * 2.0 + 1)      # the eager run's values
        assert b.trunk.tape == {"dcn_im2col/float32": 2}
        assert obs.counters().get("eval.captures", 0) == before.get(
            "eval.captures", 0)
        b.src = state
        b._run(head)
        assert calls[2:] == ["head"] * 2 and b.head.tape == {
            "splat_fused/float32": 1}
        for _ in range(2):               # two more requests of 3 chunks
            assert b.trunk.run(trunk, b.lq) is state
            for _ in range(3):
                b._run(head)
    after = obs.counters()

    def grew(name):
        return after.get(name, 0) - before.get(name, 0)
    assert len(calls) == 4
    assert grew("eval.captures") == 1 and grew("eval.trunk_replays") == 2
    assert grew("eval.replays") == 6
    assert grew("kernels.launches.dcn_im2col/float32") == 2 * 3
    assert grew("kernels.launches.splat_fused/float32") == 1 + 6
    trunk_ms, head_ms = b.trunk.marks.elapsed(), b.head.marks.elapsed()
    assert trunk_ms == {"motion": 2.5, "encoder": 3.5}
    assert head_ms == {"decode": 4.5, "splat": 5.5, "synth": 6.5}
    parts = b.parts_ms(3)
    assert list(parts) == list(PARTS)
    assert {p: parts[p] * 3 for p in trunk_ms} == trunk_ms
    assert {p: parts[p] * 3 for p in head_ms} == {
        p: 3 * ms for p, ms in head_ms.items()}


def test_a_capture_that_fails_names_its_bucket():
    """A forward that raises inside its capture (its second run, after the
    warm one) raises with the bucket's key, and the bucket keeps no
    graph."""
    calls = []

    def forward(lq, t):
        calls.append(1)
        if len(calls) == 2:
            raise ValueError("cannot capture")
        return lq + 1, None

    b = _Bucket(("the", "key"), (1, 2), (1, 3), torch.float32,
                torch.device("cpu"), None)
    b.device = torch.device("cuda")
    with _cuda_stand_ins(), pytest.raises(
            RuntimeError, match=r"bucket \('the', 'key'\) failed: cannot"):
        b._run(forward)
    assert b.head.graph is None and b.head.tape == {}


def test_marks_leave_out_a_part_whose_end_was_not_recorded():
    """`Marks.elapsed` times a part whose start and end were both
    recorded; a part that raised (no end) and a part not run are left
    out."""
    with _cuda_stand_ins(), obs.marking(PARTS) as marks:
        with obs.part("motion"):
            pass
        with pytest.raises(ValueError), obs.part("encoder"):
            raise ValueError("a part that raised")
    assert marks.elapsed() == {"motion": 1.5}


def _last_with(model, name):
    """The last module of `model` holding a parameter `name`."""
    return [m for m in model.modules() if name in m._parameters][-1]


@contextlib.contextmanager
def _future(overwrite=False, swap=False):
    """torch's two modes of `Module._apply` (new tensors put in the dicts;
    tensors swapped in place) for the block, then restored."""
    fut = torch.__future__
    was = (fut.get_overwrite_module_params_on_conversion(),
           fut.get_swap_module_params_on_conversion())
    fut.set_overwrite_module_params_on_conversion(overwrite)
    fut.set_swap_module_params_on_conversion(swap)
    try:
        yield
    finally:
        fut.set_overwrite_module_params_on_conversion(was[0])
        fut.set_swap_module_params_on_conversion(was[1])


def _load(model, assign):
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd["synth_net.net.4.bias"] += 0.01
    model.load_state_dict(sd, assign=assign)


def _replace_param(model):
    mod = _last_with(model, "weight")
    mod.weight = torch.nn.Parameter(mod.weight * 0.5)


def _replace_submodule(model):
    parent, name = model.encoder, list(model.encoder._modules)[-1]
    new = copy.deepcopy(parent._modules[name])
    for p in new.parameters():
        p.mul_(0.9)
    setattr(parent, name, new)


def _to_float64(model):
    model.to(torch.float64)


# each a weight change that must drop every bucket (made under no_grad),
# and the mode of `_apply` it is made in
WEIGHT_CHANGES = {
    "first_param_mul": (lambda m: next(m.parameters()).mul_(1.0), {}),
    "param_write": (lambda m: _last_with(m, "bias").bias.add_(0.01), {}),
    "buffer_write": (lambda m: _last_with(m, "weight").probe.fill_(1.0),
                     {}),
    "load_state_dict": (lambda m: _load(m, assign=False), {}),
    "load_state_dict_assign": (lambda m: _load(m, assign=True), {}),
    "to_float64": (_to_float64, {}),
    "to_float64_overwrite": (_to_float64, dict(overwrite=True)),
    "to_float64_swap": (_to_float64, dict(swap=True)),
    "buffer_added": (lambda m: _last_with(m, "weight").register_buffer(
        "added", torch.ones(2)), {}),
    "param_replaced": (_replace_param, {}),
    "submodule_replaced": (_replace_submodule, {}),
}


@pytest.mark.parametrize("change", list(WEIGHT_CHANGES))
def test_a_weight_write_resets_the_buckets(change):
    """Each weight change drops every bucket once (`eval.bucket_resets`
    +1, a second request before it +0), and the request after it equals
    a fresh Evaluator's over the changed model: an in-place write to a
    parameter (the first, unchanged by `mul_(1.0)`, or a deep one) or to a
    buffer, a load with and without `assign`, a cast through `.to` in
    each of torch's modes, a buffer added, a parameter or a submodule
    replaced."""
    model = build_motif(16, 1, 1, device="cpu")
    if change == "buffer_write":
        _last_with(model, "weight").register_buffer("probe", torch.zeros(3))
    ev = Evaluator(model, iters=2, device="cpu")
    ev.infer(LQ, TIMES[:, :2], OUT_HW)
    before = obs.counters().get("eval.bucket_resets", 0)
    ev.infer(LQ, TIMES[:, :2], OUT_HW)
    assert obs.counters().get("eval.bucket_resets", 0) == before
    fn, mode = WEIGHT_CHANGES[change]
    with torch.no_grad(), _future(**mode):
        fn(model)
    got, stats = ev.infer(LQ, TIMES[:, :2], OUT_HW)
    assert obs.counters()["eval.bucket_resets"] == before + 1
    assert len(ev._buckets) == 1
    want, want_stats = Evaluator(model, iters=2, device="cpu").infer(
        LQ, TIMES[:, :2], OUT_HW)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert stats == want_stats


def test_reset_launches_drops_only_the_launch_counters():
    """`obs.reset(prefix)` drops every counter under `prefix`, here the
    launch counters, and keeps the others."""
    obs.count("test.kept", 2)
    kernels.count("siren_mlp", "float32/whole")
    obs.reset(obs.LAUNCHES)
    assert not [k for k in obs.counters() if k.startswith(obs.LAUNCHES)]
    assert obs.counters()["test.kept"] >= 2


# ---------------------------------------------------------------------------
# the benchmark's readers, on a synthetic traced run
# ---------------------------------------------------------------------------

H0 = 10.0              # the slice on the host's clock: 10 s + 0 .. 3000 us


def _ns(us):
    """A host time (us into the slice) on perf_counter_ns."""
    return int(round(H0 * 1e9 + us * 1e3))


def _rec(name, lo, hi, id_, parent, request, **attrs):
    return {"name": name, "attrs": attrs, "id": id_, "parent": parent,
            "request": request, "start": _ns(lo), "end": _ns(hi)}


# two requests, times on the host's clock (us): (name, lo, hi) of infer's
# children and the device's operations (each chunk: the copy of its times,
# its graph's kernels, the copy that gathers its frames)
KIDS = [("infer.plan", 1110, 1150), ("infer.bucket", 1150, 1300),
        ("infer.copy_in", 1300, 1320), ("infer.replay", 1320, 1330),
        ("infer.gather", 1330, 1335), ("infer.replay", 1335, 1345),
        ("infer.gather", 1345, 1350), ("infer.copy_out", 1350, 1360),
        ("infer.wait", 1360, 1880), ("infer.unpad", 1880, 1890)]
DEVICE = [("Memcpy HtoD", 1300, 1320), ("Memcpy DtoD", 1322, 1325),
          ("k", 1340, 1500), ("k", 1510, 1600),          # chunk 0's graph
          ("Memcpy DtoD", 1600, 1602), ("Memcpy DtoD", 1603, 1605),
          ("k", 1607, 1700),                             # chunk 1's graph
          ("Memcpy DtoD", 1700, 1702), ("Memcpy DtoH", 1750, 1880)]
KIDS2 = [("infer.plan", 2105, 2150), ("infer.bucket", 2150, 2200),
         ("infer.copy_in", 2200, 2220), ("infer.replay", 2220, 2230),
         ("infer.gather", 2230, 2235), ("infer.copy_out", 2235, 2240),
         ("infer.wait", 2240, 2480), ("infer.unpad", 2480, 2490)]
DEVICE2 = [("Memcpy HtoD", 2210, 2220), ("Memcpy DtoD", 2221, 2222),
           ("k", 2240, 2300), ("k", 2320, 2400),
           ("Memcpy DtoD", 2400, 2401), ("Memcpy DtoH", 2410, 2480)]
PARTS_MS = {"motion": 2.0, "encoder": 1.0, "decode": 3.0, "splat": 0.5,
            "synth": 1.5}


def _on_trace(ops, offset):
    """Device operations on the profiler's clock: its own offset, and a
    rate 0.1% slow against the host's (both drift inside a slice)."""
    return [(n, offset + 0.999 * lo, offset + 0.999 * hi)
            for n, lo, hi in ops]


def _synthetic(monkeypatch):
    from benchmark import trace

    recs = [_rec("motif.motion", -500, -400, 1, None, 1)]  # before the slice
    recs += [_rec(n, lo, hi, 10 + i, 2, 2) for i, (n, lo, hi)
             in enumerate(KIDS)]
    recs.append(_rec("infer", 1100, 1900, 2, None, 2, n=4, chunks=2,
                     bucket=0, frames=4, parts_ms=PARTS_MS, forwards=2))
    recs += [_rec(n, lo, hi, 30 + i, 3, 3) for i, (n, lo, hi)
             in enumerate(KIDS2)]
    recs.append(_rec("infer", 2100, 2500, 3, None, 3, n=2, chunks=1,
                     bucket=1, frames=2))
    recs.append(_rec("infer", 2950, 3100, 4, None, 4))    # cut by the end
    monkeypatch.setattr(obs, "_records", collections.deque(recs))
    device = _on_trace(DEVICE, 5000.0) + _on_trace(DEVICE2, 5400.0)
    tr = trace.Trace(device=device, window=(5000.0, 8000.0))
    return {"trace": tr, "trace_host": (H0, H0 + 3e-3), "requests": []}


def _read(name, rec):
    from benchmark import harness

    return harness.load_module("metrics", name).read(rec)


def test_program_spans_map_onto_the_slice(monkeypatch):
    """Each request inside the slice on the host's clock, with its own run
    of device operations put back on the host's clock through its copies,
    whatever the trace's offset, and each chunk's replay between the copy
    of its times and its gather; a request whose run does not fit is left
    out, one whose copies the trace missed reads no other's run, and no
    device operations give nothing."""
    from benchmark.metrics import _program

    rec = _synthetic(monkeypatch)
    reqs = _program.requests(rec)
    assert [q["root"]["id"] for q in reqs] == [2, 3]
    at = H0 * 1e6                          # the slice's start in host us
    for q, kids, ops, lo, hi in ((reqs[0], KIDS, DEVICE, 1100, 1900),
                                 (reqs[1], KIDS2, DEVICE2, 2100, 2500)):
        assert (q["lo"] - at, q["hi"] - at) == pytest.approx((lo, hi))
        assert [k["name"] for k in q["kids"]] == [k[0] for k in kids]
        assert [(k["lo"] - at, k["hi"] - at) for k in q["kids"]] == \
            pytest.approx([k[1:] for k in kids])
        assert [n for n, _, _ in q["ops"]] == [n for n, _, _ in ops]
        assert [(s - at, e - at) for _, s, e in q["ops"]] == pytest.approx(
            [op[1:] for op in ops], abs=1e-6)
    assert [(s - at, e - at) for s, e in reqs[0]["replays"]] == \
        pytest.approx([(1340, 1600), (1607, 1700)])
    assert [(s - at, e - at) for s, e in reqs[1]["replays"]] == \
        pytest.approx([(2240, 2400)])

    rec = _synthetic(monkeypatch)          # a jump inside id 3's run
    rec["trace"].device[-1] = ("Memcpy DtoH", rec["trace"].device[-1][1],
                               rec["trace"].device[-1][2] + 20.0)
    assert [q["root"]["id"] for q in _program.requests(rec)] == [2]

    rec = _synthetic(monkeypatch)          # id 2's copy out missing
    rec["trace"].device = [op for op in rec["trace"].device
                           if op[0] != "Memcpy DtoH" or op[1] > 7000]
    assert [q["root"]["id"] for q in _program.requests(rec)] == [3]
    rec = _synthetic(monkeypatch)          # id 2's operations all missing
    rec["trace"].device = rec["trace"].device[len(DEVICE):]
    assert [q["root"]["id"] for q in _program.requests(rec)] == [3]
    rec["trace"].device = []
    assert _program.requests(rec) is None


def test_idle_inside_infer_splits_into_the_graphs_and_the_hosts(
        monkeypatch):
    from benchmark.metrics import _program

    rec = _synthetic(monkeypatch)
    one, two = (_program.idle_split(q) for q in _program.requests(rec))
    # graph: inside chunk 0's replay 10; before operations already issued
    # 1 + 2 + 48; the launch gap of chunk 0 is the host's (its replay and
    # what the host did next were open)
    want = {"graph": 61.0, "infer": 20.0, "infer.plan": 40.0,
            "infer.bucket": 150.0, "infer.replay": 12.0,
            "infer.gather": 5.0, "infer.unpad": 10.0}
    assert one == pytest.approx(want, abs=1e-6)
    want2 = {"graph": 29.0, "infer": 15.0, "infer.plan": 45.0,
             "infer.bucket": 50.0, "infer.copy_in": 10.0,
             "infer.replay": 9.0, "infer.gather": 5.0,
             "infer.copy_out": 5.0, "infer.unpad": 10.0}
    assert two == pytest.approx(want2, abs=1e-6)
    assert sum(one.values()) == pytest.approx(800 - 502)
    assert sum(two.values()) == pytest.approx(400 - 222)
    # the slice line: request 2's device run, shifted by 400 us on the
    # profiler's clock, falls outside its span, so the reader reads all of
    # that span idle; request 1's operations lie inside its own
    assert _read("infer_idle_ms.clips", rec) == pytest.approx(
        ((800 - 0.999 * 502) / 1e3 + 400 / 1e3) / 2)
    assert _read("infer_bucket_ms.clips", rec) == pytest.approx(0.100)


@pytest.mark.parametrize("shift", ["run_longer", "host_later",
                                   "gather_missing"])
def test_a_request_whose_trace_shifted_is_left_out(monkeypatch, shift):
    """The second request (id 3) is left out for its run 3% longer than the
    host's time between its two points (the trace shifted inside it), the
    host's time 3% longer than its run, or a device-to-device copy that
    the trace missed. The first (id 2) is still read."""
    from benchmark.metrics import _program

    rec = _synthetic(monkeypatch)
    dev = rec["trace"].device
    if shift == "run_longer":
        n, lo, hi = dev[-1]
        dev[-1] = (n, lo, hi + 0.03 * 0.999 * 260)
    elif shift == "host_later":
        wait = next(r for r in obs._records if r["id"] == 30 + 6)
        assert wait["name"] == "infer.wait"
        wait["end"] += int(0.03 * 260e3)
    else:
        del dev[len(DEVICE) + 4]           # its gather
    assert [q["root"]["id"] for q in _program.requests(rec)] == [2]


def test_the_idle_split_tool_sums_the_split(monkeypatch):
    """`benchmark/idle_split.py` over the synthetic run: both requests
    read; the graph's own 61 and 29 us (10 and 20 inside replays); the
    parts of the one request that has them against its busy and graph-own
    time."""
    from benchmark import idle_split

    out = idle_split.split(_synthetic(monkeypatch))
    assert (out["requests"], out["read"]) == (2, 2)
    assert out["idle_ms_per_request"]["graph"] == pytest.approx(0.045)
    assert out["graph_inside_replays_ms"] == pytest.approx(0.015)
    assert out["accounted_pct"] == pytest.approx(
        100 * (1 - 35 / (298 + 178)))
    assert out["idle_ms_median"] == pytest.approx((0.298 + 0.178) / 2)
    assert out["parts_ms_per_frame"] == pytest.approx(8.0 * 2 / 4)
    assert out["busy_graph_ms_per_frame"] == pytest.approx(
        (502 + 61) / 1e3 / 4)


def test_parts_per_frame(monkeypatch):
    rec = _synthetic(monkeypatch)
    for part, ms in PARTS_MS.items():
        # each part's ms x 2 forwards over the 4 frames of the one request
        # that has parts
        assert _read(f"{part}_ms.clips", rec) == pytest.approx(ms / 2)
    total = sum(_read(f"{p}_ms.clips", rec) for p in PARTS)
    assert total == pytest.approx(sum(PARTS_MS.values()) / 2)


@pytest.mark.parametrize("name", [
    "infer_idle_ms.clips", "infer_bucket_ms.clips",
    "motion_ms.clips", "encoder_ms.clips", "decode_ms.clips",
    "splat_ms.clips", "synth_ms.clips"])
def test_readers_find_nothing_without_a_trace_or_the_programs_spans(
        monkeypatch, name):
    """No trace (an untraced run), no device intervals (the CPU), or a
    program that keeps no spans (an older checkout): nothing to read."""
    assert _read(name, {"requests": [], "steps": []}) is None
    rec = _synthetic(monkeypatch)
    assert _read(name, rec) is not None
    rec["trace"].device = []
    assert _read(name, rec) is None
    rec = _synthetic(monkeypatch)
    monkeypatch.setitem(sys.modules, "motif_tpu_torch.obs", None)
    monkeypatch.delattr(sys.modules["motif_tpu_torch"], "obs")
    assert _read(name, rec) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_marks_in_a_captured_graph_time_its_forward():
    """MoTIF at full width, 64 x 112 -> 256 x 448, 3 times (one chunk):
    the captured request and its replay against `_infer_eager` (frames
    within 1e-5 and the flow statistics within 1e-5 relative, as the
    bucket tests hold them: the splat sums in a varying order); a profiled
    request records its parts; and one replay of the trunk's graph and the
    head's, back to back, their parts summed, time the forward within 3%
    of its extent on the profiler's device timeline (its first
    device operation's start to its last one's end)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graph and its events are "
                    "CUDA's")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    ev = Evaluator(build_motif(device=dev), iters=4, device=dev)
    lq = np.random.default_rng(1).random((1, 4, 64, 112, 3), np.float32)
    times = np.float32([[0.25, 0.5, 0.75]])
    want, want_stats = ev._infer_eager(lq, times, (256, 448))
    for _ in range(2):                       # captured, then replayed
        got, stats = ev.infer(lq, times, (256, 448))
        assert float(np.abs(got - want).max()) <= 1e-5
        for a, b in zip(stats, want_stats):
            assert abs(a - b) <= 1e-5 * abs(b)
    (bucket,) = ev._buckets.values()
    obs.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        ev.infer(lq, times, (256, 448))
    (root,) = [r for r in obs.spans() if r["name"] == "infer"]
    assert set(root["attrs"]["parts_ms"]) == set(PARTS)
    assert all(v > 0 for v in root["attrs"]["parts_ms"].values())
    assert root["attrs"]["forwards"] == 1 and root["attrs"]["frames"] == 3

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bucket.trunk.graph.replay()
        bucket.head.graph.replay()
        torch.cuda.synchronize()
    whole = sum(bucket.parts_ms(1).values())
    ops = [e.time_range for e in prof.events()
           if str(e.device_type).endswith("CUDA")
           and not getattr(e, "is_user_annotation", False)]
    extent = (max(r.end for r in ops) - min(r.start for r in ops)) / 1e3
    assert abs(whole - extent) <= 0.03 * extent, (whole, extent)


@pytest.mark.cuda
def test_a_backward_span_holds_its_kernels_device_time():
    """The splat's backward under the profiler: its span
    `splat_fused.backward`, which `chip_smoke.py`'s training profile reads
    from `key_averages()`, holds the device time of the kernels that the
    plain backward launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the splat's forward is a CUDA "
                    "kernel")
    from torch.autograd import DeviceType

    from motif_tpu_torch.ops import softsplat

    g = torch.Generator(device="cuda").manual_seed(6)
    B, H, W, C = 2, 64, 64, 130
    img, flow, z = (torch.randn((B, H, W, c), device="cuda", generator=g)
                    .requires_grad_() for c in (C, 2, 1))
    out, norm = softsplat.splat_fused(img, flow, z, False)[:2]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        (out.sum() + norm.sum()).backward()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.key == "splat_fused.backward"
            and e.device_type == DeviceType.CPU]
    assert len(rows) == 1 and rows[0].count == 1
    assert rows[0].device_time_total > 0
