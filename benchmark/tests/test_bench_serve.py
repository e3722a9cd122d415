"""The serving cell (`ours-serve-clips`, traffic kind `clips_serve`) on the
CPU at a tiny width, the program's plain versions standing in for its
kernels: a run end to end and a traced one reading the cell's own
metrics (launch-counting stand-ins for the kernels' entries), its control
(`--control half`) and the refused `--control tf32`, planted faults
failing its limits, and the dtype-aware bound arithmetic
(`counts/bounds_lowp.py`) against the kernel table's bounds.

The tiny cell: width 16 (the published 5 + 40 blocks: the program's
`define_g` builds them whatever the width), RAFT iterations 2, LR 32x40
-> HR 128x160 (RAFT at 64x80, above its 64-pixel floor), 6 requests, 2
of them checked."""

from __future__ import annotations

import contextlib
import copy
from unittest import mock

import pytest
import torch

from benchmark import harness
from benchmark.counts import bounds, bounds_lowp
from benchmark.tests import tiny

CELL = "ours-serve-clips"


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def tiny_cell():
    c = copy.deepcopy(harness.load_cell(CELL))
    c.config["network_G"].update(tiny.TINY_CONFIG, iters=2)
    c.config["eval_iters"] = 2
    c.traffic.update(tiny.TINY_CLIPS, lq_hw=[32, 40])
    c.limits.update(sample_from=6, sample=2)
    return c


def _kind():
    return harness.load_module("traffic", "clips_serve")


def _run(cell=None, **kw):
    cell = cell or tiny_cell()
    kind = _kind()
    host = tiny.cpu_host()
    rec = kind.run(cell, tiny.args(**kw), host)
    rec["memory"] = host.memory
    return cell, kind, rec


def _failed(checks):
    return [c["name"] for c in checks if not c["ok"]]


def test_serve_end_to_end():
    cell, kind, rec = _run(seconds=600.0)
    assert rec["attempted"] == 6 and rec["failed"] == 0
    assert _failed(rec["checks"]) == [], rec["checks"]
    assert rec["e2e"]["hr_frames_per_s"] > 0
    # the window recast no weight: every kept copy was made in set-up
    assert rec["window_counters"].get("layers.cast_copies", 0) == 0
    assert rec["slice_counters"] is None and rec["ops_lowp"] is None


@contextlib.contextmanager
def _counted_entries():
    """The kernels' launch counters on the CPU: each plain forward counts
    the entry its kernel would run (the CUDA paths count their own)."""
    from motif_tpu_torch.ops import dcn, kernels, siren_kernel, softsplat

    splat, im2col, mlp = (softsplat._splat_forward, dcn._im2col_forward,
                          siren_kernel._mlp_forward)

    def name(dtype):
        return str(dtype).removeprefix("torch.")

    def splat_fwd(img, flow, z, z_nonpositive, scatter_dtype):
        C = img.shape[-1]
        sums = "float16" if scatter_dtype == torch.float16 else "float32"
        kernels.count("splat_fused", f"{sums}/C={C}")
        return splat(img, flow, z, z_nonpositive, scatter_dtype)

    def im2col_fwd(x, *a):
        kernels.count("dcn_im2col", name(x.dtype))
        return im2col(x, *a)

    def mlp_fwd(x, weights, biases, omega0, sine_last, skip_first, packed):
        kernels.count("siren_mlp", name(x.dtype) + (
            "/skip_first" if skip_first else "/whole"))
        return mlp(x, weights, biases, omega0, sine_last, skip_first, packed)

    with mock.patch.object(softsplat, "_splat_forward", splat_fwd), \
            mock.patch.object(dcn, "_im2col_forward", im2col_fwd), \
            mock.patch.object(siren_kernel, "_mlp_forward", mlp_fwd):
        yield


def test_serve_traced_reads_its_metrics():
    from benchmark import run

    with _counted_entries():
        cell, kind, rec = _run(seconds=600.0, trace=1)
    assert _failed(rec["checks"]) == [], rec["checks"]
    metrics, dev, breakdown = run.report(cell, kind, rec, tiny.args(trace=1))
    assert metrics["lowp_launch_pct.serve"]["value"] == 100.0
    assert 0 < metrics["mfu.serve"]["value"] < 100
    # no device here: the device's readers find nothing and say so
    assert "splat_roofline.serve" not in metrics
    assert set(rec["ops_lowp"]) == {"splat", "dcn", "siren"}
    assert all(b > 0 for b, _, _ in rec["ops_lowp"].values())
    assert rec["ops"] is None and "flops_of_n" not in rec
    plan = rec["plan_flops_of_n"]
    assert set(plan) == {2, 4, 8}
    # the trunk once, the head once a chunk: 8 times (3 chunks) cost less
    # than 4 requests of 2 times, and the bfloat16 work dominates
    assert plan[2]["bf16"] < plan[4]["bf16"] < plan[8]["bf16"] \
        < 4 * plan[2]["bf16"]
    assert plan[8]["bf16"] > 10 * plan[8]["fp32"] > 0


def test_launch_share_reads_only_the_three_kernels_entries():
    low_share = _kind().low_share
    counts = {"kernels.launches.siren_mlp/bfloat16/whole": 3,
              "kernels.launches.siren_mlp/float32/skip_first": 1,
              "kernels.launches.splat_fused/float16/C=64": 2,
              "kernels.launches.dcn_im2col/bfloat16": 42,
              "kernels.launches.dcn_im2col": 42,
              "kernels.launches.other/bfloat16": 5, "eval.replays": 9}
    assert low_share(counts) == (47, 48)
    assert low_share({}) == (0, 0)


def test_serve_control_fails_a_limit():
    """`--control half`: the reference with what the configuration keeps
    above bfloat16 dropped to bfloat16, in the program's place, fails a
    limit of the cell."""
    cell = tiny_cell()
    rec = _kind().control(cell, tiny.args(control="half"), tiny.cpu_host())
    assert rec["attempted"] >= 2
    assert _failed(rec["checks"]), rec["checks"]


def test_serve_control_tf32_is_refused():
    with pytest.raises(SystemExit, match="TF32"):
        _kind().control(tiny_cell(), tiny.args(control="tf32"),
                        tiny.cpu_host())


def _altered(change):
    from motif_tpu_torch.eval import Evaluator

    infer = Evaluator.infer

    def altered(self, lq, times, out_hw):
        frames, stats = infer(self, lq, times, out_hw)
        frames = frames.copy()
        change(frames)
        return frames, stats

    return mock.patch.object(Evaluator, "infer", altered)


SHIFT = 0.01


def _shift_frame(frames):
    frames[-1] += SHIFT


def _shift_channel(frames):
    frames[..., 1] += SHIFT


def _shift_tile(frames):
    # an 8 x 12 tile at the frames' corner: 0.47% of each frame's values
    frames[..., -8:, -12:, :] += SHIFT


@pytest.mark.parametrize("change,caught", [
    (_shift_frame, "frame_median_abs_max"),
    (_shift_channel, "frame_p999_abs_max"),
    (_shift_tile, "frame_p999_abs_max")], ids=["frame", "channel", "tile"])
def test_serve_answer_altered(change, caught):
    with _altered(change):
        cell, kind, rec = _run(seconds=600.0)
    assert caught in _failed(rec["checks"])


# ---------------------------------------------------------------------------
# bounds_lowp's arithmetic
# ---------------------------------------------------------------------------

def test_lowp_splat_bound_is_the_kernel_tables():
    # the float16-sum entry at C = 64, 6 x 256 x 448, float32 in and out:
    # 0.1093 ms (bytes); the sums stay in shared memory
    assert bounds_lowp.splat_bound(6, 256, 448, 64, True) == pytest.approx(
        0.1093, abs=5e-5)


def test_lowp_dcn_bound_is_the_kernel_tables():
    # the whole bfloat16 dcn_v2 at L1 (2 x 64 x 112, G 8, K 3): 0.0030 ms,
    # by its bytes (the contraction on the tensor cores 0.0011, the taps
    # at the float32 rate 0.0011)
    got = bounds_lowp.dcn_bound(2, 64, 112, 64, 64, 112, 64, 8, 3, 2)
    assert got == pytest.approx(0.0030, abs=5e-5)
    q = 2 * 64 * 112
    assert got > 2 * q * 9 * 64 * 64 / bounds_lowp.TC_FLOP_PER_S * 1e3
    # float32 data: the float32 bound
    assert bounds_lowp.dcn_bound(2, 64, 112, 64, 64, 112, 64, 8, 3) == \
        bounds.dcn_bound(2, 64, 112, 64, 64, 112, 64, 8, 3)


def test_lowp_siren_bound_departs_from_the_smoke_where_said():
    # STINF in bfloat16 over 688,128 tokens: the smoke's 0.0361 ms adds the
    # sines (2 operations each) to the products at the tensor cores' rate;
    # here the products alone bound it (0.0355), the sines at the float32
    # rate taking 0.0079 beside them
    dims, n = [67, 64, 64, 256, 3], 688128
    got = bounds_lowp.siren_bound(n, dims, False, False, 2)
    assert got == pytest.approx(0.0355, abs=5e-5)
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    smoke = n * (2 * macs + 2 * 384) / bounds_lowp.TC_FLOP_PER_S * 1e3
    assert smoke == pytest.approx(0.0361, abs=5e-5) and got < smoke
    assert bounds_lowp.siren_bound(n, dims, False, False) == \
        bounds.siren_bound(n, dims, False, False)
