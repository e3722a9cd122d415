#!/usr/bin/env python3
"""Drive motif_tpu_torch's serving, eval and training paths on one NVIDIA GPU.

    python3 chip_smoke.py                  # the smoke run
    python3 chip_smoke.py --profile DIR    # also write a torch.profiler
                                           # table of one request and of one
                                           # training step to DIR, count
                                           # their device kernels, and
                                           # dump the bfloat16 SIREN's SASS

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA kernel of the package, nvcc for sm_90a, in parallel;
  3. kernels: each entry of each kernel (float32; bfloat16 DCN and SIREN;
     the SIREN whole and from its first layer's pre-activation; the splat
     at C = 130 and C = 64 with float32 and float16 sums) against its plain
     PyTorch version on the card at the main path's shapes, TF32 off, with
     its time, the plain version's time, one PyTorch library call's time,
     the bound of the card and the fraction of it reached. The bfloat16
     SIREN entries contract on the tensor cores, which sum in another order
     than the plain version: they are held by accuracy against a float64
     evaluation (whole MLPs) and, layer by layer, by the share of bit-equal
     outputs and the reach of one flipped rounding. The float32 SIREN's
     streamed-weight layer (entry float32/layer, csrc/siren_layer.cu: a
     layer that runs alone in an MLP cut into launches) is held bit-equal
     to its definition, one chain of float32 FMAs in ascending k then the
     bias and sinf (`fma_chain`), at each shape its paths give it
     (LAYER_SHAPES), its distance from F.linear + sin and from the plain
     version printed beside it, and timed beside addmm + sin and its
     bound. The DCN im2col also
     with the L2 cold, and the whole dcn_v2 (kernel + addmm) at L1 (and in
     bfloat16 at L1 - L3 with the whole op's bound and library time); the
     splat also by phase (memset, count, scan, fill, accumulate), at other
     tile shapes, on a converging flow and on requests (a) and (e)'s own
     inputs, with its tile lists and its device kernels per call.
     Times are device times (calls replayed from a CUDA graph), with the
     eager per-call time beside them;
  4. the slice: MoTIF(setting=5) at full width (channel 64, 5 + 40 residual
     blocks, RAFT-small) with random weights from a seed, DCN offsets
     perturbed, driven through Evaluator.infer: requests (a)-(d) on the
     float32 reference-order path, request (e) = request (a)'s inputs
     through the serving configuration (fused decode, bfloat16 compute,
     float16 splat sums, RAFT at HR/2), (e) again in three decode chunks,
     and the same inputs with fused decode alone (f) and bfloat16 alone
     (g), so that every entry runs on the main path; the launch counters
     must show every entry ran, and which ran on request (e); requests (a)
     and (e) are held against the same forward with the plain versions,
     (e), (f) and (g) against (a)'s frames; the times of (a) and (e) and
     their HR frames/s, in turns;
  5. the eval harness: the PNG decoder and yml reader it ran with; the
     CLI (motif_tpu_torch.test.main) over test.yml on data/Vid4 (4 clips,
     LR 16x24 -> HR 64x96) at full width from a reference-format .pth with
     the slice's weights, once in the float32 configuration and once with
     the serving knobs in the yml, each with the launch counters set to 0
     before and read after (the configuration's entries, 4 forwards) and
     held against the same run with the plain versions (frames, per-frame
     Y-PSNR and SSIM); Evaluator.run at the bench shape (LQ 64x112 -> GT
     256x448) over 2 seeded clips in both configurations, with per-clip
     seconds in infer and in the metrics; the serving CLI again with each
     of four wrong kernel outputs planted, printing which the serving gate
     refuses: it must refuse the splat's targets half a pixel off;
  6. a {"kernels": [...]} line, the card line, and the result line, printed
     last, after phases 7 to 13; each kernel row also carries its
     launches on every path (requests, eval CLIs, training steps of both
     models, the baselines, the recipes of phase 10) and its plain
     backward's device ms in one two-anchor step; more rows hold the
     entries at the baselines' shapes (the DCN at cg 16, VideoINR's three
     SIRENs) and at phase 10's (the float16-sum splat at C = 130, the
     SIREN of setting 6's synthesis net cut into two launches in either
     type), and at phase 11's (VideoINR's SIRENs at 4 LQ frames; the
     float16-sum splat, the bfloat16 DCN and SIREN at the knobs' training
     shapes, each with its plain backward's time); and the float32
     streamed-weight layer, a row for each path that launches it (a
     VideoINR request, a LIIF step, setting 6's synthesis net);
  7. training the two-anchor Ours (run before phase 6's lines): the CLI
     (motif_tpu_torch.train.main) on configs/train_smoke.yml with the
     shapes of the reference recipe train_Ours_vimeo.yml (nf 64, 5 + 40
     blocks, iters 12, batch 8, GT 128 from LQ 32, 7 target times) but its
     model swapped for Ours, whose teacher is RAFT live, on data/vimeo for
     3 steps, the launch counters set to 0 before and read after (1
     splat, 42 DCN im2cols, 3 SIRENs a step, all float32 entries), teacher
     forcing decaying over 4 steps so that both branches run, then a
     resume to step 4 from the saved state; a Trainer's step split into
     forward, backward and optimiser, its peak memory and HR frames/s; one
     profiled step with each plain backward's device ms; a step held
     against the same step with the plain versions (loss and every
     gradient, TRAIN_GATES) for use_gt True and False, with the parameters
     upstream of each kernel checked for a non-zero gradient, and a splat
     backward that drops the flow gradient planted, which the gate must
     refuse;
  8. the four-anchor Ours_44, the recipe's own model (before phase 6's
     lines): requests (h) (fp32) and (i) (the serving knobs), 4 LQ frames
     64x112 -> 256x448, 3 times one a chunk, the trunk (RAFT on the 12
     cross pairs, the encoder's DCNs) once a request, each counted alone
     (the DCNs once, the SIRENs and the splat once a chunk; the eval CLI's
     clips likewise), held against its plain versions, (i)
     against (h), both timed in turns; the eval CLI over
     configs/test_vimeo44.yml on a Vid4 clip in both configurations
     against their plain versions (EVAL_GATES); data/vimeo copied into a
     temporary directory, its flow files written by `python -m
     motif_tpu_torch.precompute_flows` with the seeded Ours_44's RAFT, the
     training CLI on the recipe's shapes for 3 steps and a resume, RAFT
     counted (never run), a step by part, and the gradient gate for both
     branches; the splat (224 images of 128², and its backward), the STINF
     SIREN (3.67M tokens, and its backward) and the DCN im2col at the
     shapes this path gives them;
  9. the baselines (before phase 6's lines): LIIF (VideoINR), ZSM, TMNet,
     EDVR and Super-SloMo at their configs/test_vid4_*.yml widths and
     depths (EDVR nf 128), random weights, DCN offsets perturbed: a request
     each (2 LQ frames 64x112 -> 256x448, 3 times) counted alone (the
     family's DCNs; VideoINR's SIRENs, cut into 7 launches a time: 4
     single layers on the streamed-weight kernel), held
     against its plain versions (1e-5), timed; the eval CLI
     over the family's yml on one Vid4 clip from a reference-format .pth
     against its plain versions (EVAL_GATES fp32); then the DCN at EDVR's
     16 channels a group (L1 - L3) and the float32 SIREN at VideoINR's
     three widths over a request's 114,688 tokens (a cut MLP also launch
     by launch, beside addmm + sin and its bound, and replayed from a CUDA
     graph);
 10. the Adobe and arbitrary-scale recipes, the MoTIF settings, Ours_7 and
     Ours_flow (before phase 6's lines): an Adobe240-shaped tree (data/Vid4's
     clips ping-ponged to 32 frames, resized to 256x448, LR by MATLAB
     bicubic, the Adobe_flow arrays from --seed) and data/vimeo's clips at
     256x448 under build/; the training CLI on copies of seven
     configs/grid/ ymls (RECIPES: Adobe, Adobe_a, Adobe_flow, vimeo_a with
     Ours_44, setting 2, setting 6, Ours_7) at full width, each counted
     alone for RECIPE_CLI_STEPS steps (the `_a` ones at LQ_size 64), then
     each recipe's steps by part with peak memory, HR frames/s, the host's
     ms per batch and, for `_a`, the first step of a new size bucket
     against a steady one; the gradient gate of three recipes (Adobe_a in
     a bucket of 72 px, setting 6, Ours_7) at GATE_BATCH; requests at
     bench.py's shape for setting 2, setting 6 and Ours_7 (fp32) and
     setting 6 under the serving knobs, each against its plain versions,
     replayed against eager and timed; Ours_flow against itself on the
     CPU in float64; the SIREN of setting 6's synthesis net in both
     types;
 11. the rest of training (before phase 6's lines, on phase 10's trees):
     LIIF (VideoINR at nf 64, 5 + 40 blocks, on the 4 LQ frames every
     training mode gives) through the training CLI on copies of
     train_INR_adobe.yml and train_INR_adobe_a.yml (LQ_size 64), counted
     alone (90 DCNs, 24 float32 SIREN launches a step, 15 of them single
     layers on the streamed-weight kernel; use_gt always
     False), a recipe step by part at batch 24, the gradient gate from the
     deterministic state, the eval CLI on the trained models root, step
     file and init (test_vid4_liif.yml at ref_num 4), VideoINR's SIRENs at
     the step's 393,216 tokens a time and encode_imnet's backward; the
     precision knobs (compute_dtype bfloat16, splat_dtype float16) on a
     copy of train_Ours_adobe.yml: its CLI counted alone (the float16-sum
     splat at C = 130, 42 bfloat16 DCNs, 3 bfloat16 SIRENs a step), its
     step by part beside phase 10's float32 step, the step against the
     float32 step from the deterministic state (BF16_GATES), and each
     entry that trains for the first time held through its kernel's
     forward against autograd through the plain version at the recipe's
     shapes (the splat, the DCN, the SIREN whole, skip-first and cut);
     data-parallel training: a step under an NCCL group of one against the
     same step alone, bit for bit, and two gloo ranks on the one card,
     each on half of the global batch of 24, against the one-process step
     (DP_GATE), both on the plain versions under deterministic
     algorithms;
 12. the last entry points and what no yml reaches (before phase 6's
     lines): `python -m motif_tpu_torch.demo` on 4 frames from --seed at
     Vid4's LR size 180x144, x4 space, x8 time (3 pairs, 24 HR frames of
     576x720) counted alone, its one captured graph (1 capture, the
     pool's bytes), pair 0 replayed against eager at request (a)'s gate
     and against the plain versions, timed, the splat on the demo's own
     inputs and the STINF at its 6,635,520 tokens; the MoTIF fields
     (groups=2, trans, res_liff, local_ensemble, siren=False) each on a
     request at bench.py's shape, counted, against its plain versions,
     replayed and timed, and the groups=2 splat (the generic width) on
     its own inputs; generate, flow and test_tmp over test.yml on one
     data/Vid4 clip, counted (their PNGs, .flo files read back, the
     summary); the native host core built, and the `_a` collate at batch
     24 with it and with numpy (COLLATE_GATE); PWCNet and PWCNetLight on
     a seeded 448x256 pair against the CPU in float32 (PWC_RTOL);
 13. motif_tpu's orbax train states, read without JAX (before phase 6's
     lines): the committed state tests/fixtures/orbax_state, which
     motif_tpu wrote, read by checkpoint.read_orbax_tree, every leaf's
     dtype, shape and sha256 against the list orbax's own restore made,
     the zstd library that decoded it and the read's ms; phase 7's
     full-width Ours trainer after one step, its TrainState laid out as
     motif_tpu saves it and mapped by checkpoint.load_optax_train_state
     (the function restore_train_state uses) onto a fresh trainer, the
     launch counters set to 0 before the step and read after request
     (a)'s inputs served from the restored model; the next step of both
     trainers on the plain versions under the deterministic algorithms
     bit-equal (loss and every parameter), and the request held against
     its plain versions at request (a)'s gate.
Every request goes through Evaluator.infer, which on CUDA replays the
captured CUDA graphs of its shape bucket (MoTIF's trunk once a request,
its head once a chunk; a baseline's one graph): each request of phases 4,
8 and 9 is
also held, replayed, against the same request run eagerly (`_infer_eager`,
at the request's own gate, beside the distance of two eager runs and their
share of bit-equal frames), timed eager and captured in turns, with the
device's busy share of a captured request from its graphs' replays timed
by CUDA events (torch.profiler segfaulted on replays), and requests (a)
and (e) profiled eagerly (device kernels, copies); request (e)
is replayed once more under torch.cuda.set_sync_debug_mode("error"). The
eval CLI's round trip: the models root the training CLI of phase 7 wrote,
its newest step file and the random init, through `--checkpoint`. The
training gates start from a state reached by a warm-up and three steps on
the plain versions under torch's deterministic algorithms, the same bit
for bit in every run (its hash is printed); two plain steps from it must
be bit-equal, and each gate also prints that.
Exits non-zero without CUDA or without the package beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import hashlib
import json
import os
import random
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

# cuBLAS is deterministic under torch's deterministic algorithms only with
# a fixed workspace, set before CUDA starts (the training gates' state)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from motif_tpu_torch import obs  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet): HBM rate, fp32 (non-tensor),
# dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

SERVING = dict(fused_decode=True, compute_dtype="bfloat16",
               splat_dtype="float16", raft_resolution=0.5)
# every entry of the three kernels: each is held against its plain version
# and must run on the main path
ENTRIES = ("splat_fused/float32/C=130", "splat_fused/float32/C=64",
           "splat_fused/float16/C=64", "dcn_im2col/float32",
           "dcn_im2col/bfloat16", "siren_mlp/float32/whole",
           "siren_mlp/float32/skip_first", "siren_mlp/bfloat16/whole",
           "siren_mlp/bfloat16/skip_first")


def launch_counts() -> dict:
    """The launch counters by kernel, each of `kernels.KERNELS` and the
    fused decode's `preact` (0 until launched): `obs.counters()` under
    `obs.LAUNCHES`."""
    from motif_tpu_torch.ops.kernels import KERNELS

    counters = obs.counters()
    return {k: counters.get(obs.LAUNCHES + k, 0)
            for k in (*KERNELS, "preact")}


def entry_counts() -> dict:
    """The launch counters by `<kernel>/<entry>` launched."""
    n = len(obs.LAUNCHES)
    return {k[n:]: v for k, v in obs.counters().items()
            if k.startswith(obs.LAUNCHES) and "/" in k}


def bound(nbytes: float, flops: float, peak: float = FP32_FLOP_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over `peak` (the fp32 rate; the bf16 tensor-core rate where
    the products are bf16)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ulp(scale: float, bits: int) -> float:
    """One unit in the last place at magnitude `scale` of a type with
    `bits` stored mantissa bits (bfloat16 7, float16 10)."""
    return 2.0 ** (np.floor(np.log2(scale)) - bits)


def dname(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds of fn(): `reps` calls captured in one CUDA
    graph and replayed, so that no host launch cost shows (a kernel of a
    few microseconds launched from Python is otherwise timed at the host's
    pace)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    return ms


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def device_work(fn):
    """(device kernels, device copies and memsets) of one call of fn, as
    torch.profiler sees them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    device = [e for e in p.key_averages() if e.device_type == DeviceType.CUDA]
    copies = sum(e.count for e in device if e.key.startswith(("Memcpy",
                                                              "Memset")))
    return sum(e.count for e in device) - copies, copies


SPLAT_PHASES = ("memset", "count", "scan", "fill", "accumulate")


def splat_phases(fn, reps: int = 10) -> dict:
    """Device ms per call of each phase of a splat call (the memset of the
    tile counters, then the count, scan, fill and accumulate kernels), by
    torch.profiler's kernel names over `reps` eager calls; "other" is the
    wrapper's remaining device work (e^z)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys(SPLAT_PHASES + ("other",), 0.0)
    for e in p.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        phase = ("memset" if e.key.startswith("Memset") else
                 next((ph for ph in SPLAT_PHASES[1:] if ph + "_" in e.key),
                      "other"))
        ms[phase] += e.self_device_time_total / 1e3 / reps
    return ms


def splat_bound(B, H, W, C, nonpos):
    """img, flow and e^z read once, acc written once, and z_max when the
    max runs: bytes over the HBM rate (the tile lists are the kernel's own
    overhead and are not counted)."""
    n = B * H * W
    nbytes = 4 * n * (C + 3 + C + 2 + (0 if nonpos else 1))
    flops = n * ((C + 1) * (1 + 4 * 2) + 4) + (0 if nonpos else n * 8)
    return bound(nbytes, flops)


def tile_lists(flow, tile):
    """The splat kernel's tile lists for `flow`, computed with torch: the
    mean and the largest number of entries per tile, the share of the
    listed sources that are listed in more than one tile, and the share of
    sources listed at all (some corner in the image)."""
    from motif_tpu_torch.ops import softsplat

    B, H, W, _ = flow.shape
    th, tw = tile
    nty, ntx = -(-H // th), -(-W // tw)
    b = torch.arange(B, device=flow.device).reshape(B, 1, 1)
    ids = []
    for idx, _, valid in softsplat._corner_data(flow, H, W):
        t = (b * nty + idx // W // th) * ntx + idx % W // tw
        ids.append(torch.where(valid, t, -1).reshape(-1))
    ids = torch.stack(ids).sort(0).values             # (4, sources)
    new = (ids >= 0) & torch.cat([torch.ones_like(ids[:1], dtype=torch.bool),
                                  ids[1:] != ids[:-1]])
    per_source = new.sum(0)
    per_tile = torch.bincount(ids[new], minlength=B * nty * ntx)
    listed = per_source > 0
    return {"tile": list(tile), "entries": int(per_source.sum()),
            "mean_per_tile": float(per_tile.float().mean()),
            "max_per_tile": int(per_tile.max()),
            "multi_tile_share": float((per_source > 1).sum() / listed.sum()),
            "listed_share": float(listed.float().mean())}


def hold_splat(softsplat, kernels, img, flow, z, nonpos, tol=1e-4, sdt=None):
    """The kernel against its plain version on one input: out / norm to
    `tol` (the summation order varies), z_max and the count exact. With
    float16 sums (`sdt`) the tolerance is `tol` float16 ulps of the largest
    value. Returns the errors and the wrapper's launches."""
    n0 = launch_counts()["splat_fused"]
    got = softsplat.splat_fused(img, flow, z, z_nonpositive=nonpos,
                                scatter_dtype=sdt)
    launches = launch_counts()["splat_fused"] - n0
    want = softsplat.splat_fused_plain(img, flow, z, z_nonpositive=nonpos,
                                       scatter_dtype=sdt)
    torch.cuda.synchronize()
    err = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
    err_max = max_err(got[2], want[2])
    err_cnt = max_err(got[3], want[3])
    scale = max(float(want[0].abs().max()), float(want[1].abs().max()))
    if sdt is not None:
        tol = tol * ulp(scale, 10)
    if not (err <= tol and err_max == 0.0 and err_cnt == 0.0):
        raise AssertionError(f"splat_fused: out/norm err {err} (tol {tol}), "
                             f"z_max err {err_max}, count err {err_cnt} "
                             f"(must be 0)")
    return {"launches": launches, "max_abs_err": err, "z_max_err": err_max,
            "count_err": err_cnt, "out_max_abs": scale, "tol": tol}


def check_splat(dev, softsplat, kernels, C=130, sdt=None):
    """Main-path shapes: n*B*N = 6 images of 256x448, payload C = 130 (the
    reference order) or C = 64 (the fused decode), sums in float32 or in
    float16 (`sdt`). Device time from graph replay, the eager per-call
    time beside it, the device time of each phase and the plan's tile;
    that tile against others; a converging flow. Float16 sums depend on
    the order, which varies from run to run: out / norm within 4 float16
    ulps of the largest value (the count and the max exact)."""
    B, H, W = 6, 256, 448
    entry = dname(sdt or torch.float32)
    tol = 1e-4 if sdt is None else 4
    elem = 4 if sdt is None else 2
    tile = list(softsplat.plan(C, elem))

    def run(*a):
        return softsplat.splat_fused(*a, scatter_dtype=sdt)

    def run_plain(*a):
        return softsplat.splat_fused_plain(*a, scatter_dtype=sdt)
    g = torch.Generator(device=dev).manual_seed(1)
    img = torch.randn((B, H, W, C), device=dev, generator=g)
    flow = torch.randn((B, H, W, 2), device=dev, generator=g) * 3.0
    flow[0, :8, :, 1] = -40.0                       # thrown off the image
    z = torch.randn((B, H, W, 1), device=dev, generator=g) * 0.5
    worst, lines = 0.0, {}
    for case, zz, nonpos in (("z<=0", -z.abs(), True), ("z>0", z, False)):
        held = hold_splat(softsplat, kernels, img, flow, zz, nonpos, tol, sdt)
        worst = max(worst, held["max_abs_err"])
        ms = device_ms(lambda: run(img, flow, zz, nonpos))
        eager = cuda_ms(lambda: run(img, flow, zz, nonpos))
        plain = device_ms(lambda: run_plain(img, flow, zz, nonpos), reps=3)
        kern, copies = device_work(lambda: run(img, flow, zz, nonpos))
        b_ms, b_by = splat_bound(B, H, W, C, nonpos)
        lines[case] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                           eager_ms=eager, device_kernels_per_call=kern,
                           device_memsets_per_call=copies)
        emit({"check": "splat_fused", "sums": entry, "case": case,
              "shape": [B, H, W, C], "tile": tile,
              "fraction_of_bound": b_ms / ms, **held, **lines[case],
              "phases_ms": splat_phases(lambda: run(img, flow, zz, nonpos)),
              "lists": tile_lists(flow, tile)})

    # the tile shape: the plan's against others that fit, z <= 0
    zn = -z.abs()
    tiles = {}
    for other in ((8, 8), (8, 4), (4, 8), (4, 16), (8, 16), (16, 8),
                  (16, 16)):
        with mock.patch.object(softsplat, "TILE", {(C, elem): other}):
            tiles["%dx%d" % other] = device_ms(
                lambda: run(img, flow, zn, True), reps=10)
    emit({"check": "splat_tiles", "sums": entry, "C": C, "plan": tile,
          "device_ms": tiles})

    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    pos = torch.stack([xs, ys], -1).float()
    if C == 130:
        # a converging flow: every pixel of each image into one tile, which
        # one block then takes alone (correct for any flow; slow here)
        spread = torch.rand((B, H, W, 2), device=dev, generator=g) * 7.0
        conv = (torch.tensor([200.0, 120.0], device=dev) + spread
                - pos).contiguous()
        ctol = 5e-2
        note = ("float32 sums of ~7,200 terms per pixel in a varying order: "
                "tol 5e-2 on values up to out_max_abs")
    else:
        # each image contracted by 2 towards a point, with a jitter: tile
        # lists ~4x the random flow's, ~16 terms per target pixel
        jitter = torch.rand((B, H, W, 2), device=dev, generator=g)
        conv = (torch.tensor([200.0, 120.0], device=dev) + 0.5 * pos + jitter
                - pos).contiguous()
        ctol = tol if sdt is None else 16
        note = ("float16 sums of ~16 terms in a varying order: 16 float16 "
                "ulps of the largest value, as the card tests' converging "
                "case" if sdt is not None else "tol 1e-4")
    held = hold_splat(softsplat, kernels, img, conv, zn, True, ctol, sdt)
    emit({"check": "splat_fused", "sums": entry, "case": "converging",
          "shape": [B, H, W, C], "tile": tile, **held,
          "ms": cuda_ms(lambda: run(img, conv, zn, True), reps=2, warmup=1),
          "phases_ms": splat_phases(lambda: run(img, conv, zn, True),
                                    reps=2),
          "lists": tile_lists(conv, tile), "note": note})

    return dict(max_abs_err=worst, library_ms=index_add_ms(
        softsplat, img, flow, zn, sdt), **lines["z<=0"])


def index_add_ms(softsplat, img, flow, z, sdt=None, reps=10):
    """The splat's yardstick: the same 4-corner scatter of [img e^z, e^z, 1]
    as ONE index_add_ call in the sums' type (a float16 index_add_ for the
    float16 entry), its payload and indices prepared outside the timed
    call; device ms."""
    B, H, W, C = img.shape
    corners = softsplat._corner_data(flow, H, W)
    ez = torch.exp(z).reshape(B, H * W, 1)
    flat = torch.cat([img.reshape(B, H * W, C) * ez, ez], -1)
    boff = (torch.arange(B, device=img.device) * H * W)[:, None, None]
    idx = torch.cat([(c[0] + boff).reshape(-1) for c in corners])
    src = torch.cat([torch.cat([flat * torch.where(c[2], c[1], 0).reshape(
        B, H * W, 1), c[2].float().reshape(B, H * W, 1)], -1).reshape(-1, C + 2)
        for c in corners]).to(sdt or torch.float32)
    del flat, corners
    acc = torch.zeros((B * H * W, C + 2), device=img.device, dtype=src.dtype)
    ms = device_ms(lambda: acc.index_add_(0, idx, src), reps=reps)
    del src, idx, acc
    torch.cuda.empty_cache()
    return ms


def check_splat_request(softsplat, kernels, inputs, request):
    """The kernel on a request's own splat inputs (the forward's feat_hr,
    flow_hr and z, and its sums' type): held against the plain version and
    timed, by phase too, with its tile lists. Returns its numbers."""
    img, flow, z, nonpos, sdt = inputs
    held = hold_splat(softsplat, kernels, img, flow, z, nonpos,
                      1e-4 if sdt is None else 4, sdt)
    B, H, W, C = img.shape
    b_ms, b_by = splat_bound(B, H, W, C, nonpos)
    tile = list(softsplat.plan(C, 4 if sdt is None else 2))

    def run():
        return softsplat.splat_fused(img, flow, z, nonpos, scatter_dtype=sdt)
    ms = device_ms(run)
    line = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": index_add_ms(softsplat, img, flow, z, sdt),
            "eager_ms": cuda_ms(run), "max_abs_err": held["max_abs_err"]}
    emit({"check": "splat_fused", "case": "request_" + request,
          "sums": dname(sdt or torch.float32), "shape": [B, H, W, C],
          "z_nonpositive": nonpos, "tile": tile, **held, **line,
          "fraction_of_bound": b_ms / ms,
          "library": f"{dname(sdt or torch.float32)} index_add_",
          "phases_ms": splat_phases(run),
          "flow_abs_max": float(flow.abs().max()),
          "lists": tile_lists(flow, tile)})
    return line


def cold_ms(fn, flush: torch.Tensor, reps: int = 20) -> float:
    """Mean milliseconds of fn() on the card with the L2 cold: a write of
    `flush` (larger than the 50 MB L2) before each rep, timed apart."""
    times = []
    for _ in range(reps + 2):
        flush.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.mean(times[2:]))


def dcn_inputs(dev, B, H, W, G, cg, K, dtype=torch.float32):
    """x, offsets up to ±10 px and the sigmoided mask, the last two sliced
    from one conv-like output as DCNSep does (strided views)."""
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((B, H, W, G * cg), device=dev, generator=g).to(dtype)
    n_off = G * K * K * 2
    com = torch.rand((B, H, W, G * K * K * 3), device=dev, generator=g)
    off = com[..., :n_off] * 20.0 - 10.0
    com[..., :n_off] = off
    com = com.to(dtype)
    mask = torch.sigmoid(com[..., n_off:] * 4.0 - 2.0)
    return x, com[..., :n_off], mask


LEVELS = {"L1": (2, 64, 112), "L2": (2, 32, 56), "L3": (2, 16, 28)}


def time_dcn_v2(dev, dcn, dtype=torch.float32, level="L1"):
    """The whole dcn_v2 at a PCD level (L1: 2 x 64 x 112; 64 -> 64 channels,
    G = 8, K = 3) through its public signature, which older checkouts of
    the package share: device ms (graph replay) and eager ms per call."""
    G, cg, K = 8, 8, 3
    x, off, mask = dcn_inputs(dev, *LEVELS[level], G, cg, K, dtype)
    g = torch.Generator(device=dev).manual_seed(5)
    w = (torch.randn((64, G * cg, K, K), device=dev, generator=g) * 0.05
         ).to(dtype)
    bias = torch.randn((64,), device=dev, generator=g).to(dtype)
    full = (x, off, mask, w, bias, K, 1, 1, 1, G)
    return {"dcn_v2_ms": device_ms(lambda: dcn.dcn_v2(*full), reps=10),
            "dcn_v2_eager_ms": cuda_ms(lambda: dcn.dcn_v2(*full))}


DCN_SHAPES = {"L1": (2, 64, 112), "L2": (2, 32, 56), "L3": (2, 16, 28),
              "H%8!=0": (2, 62, 110)}


def check_dcn(dev, dcn, kernels, dtype=torch.float32, shapes=DCN_SHAPES,
              cg=8):
    """L1 / L2 / L3 of the BiLSTM's PCD (B = 2, G = 8, cg = 8, K = 3),
    offsets up to ±10 px, and one H % 8 != 0 height (or the (B, H, W) of
    `shapes`, and `cg` channels a group: EDVR's 16); the offsets a strided
    view as on the main path. At L1 also the kernel with the L2 cold and
    the whole dcn_v2 (kernel + addmm). float32: atol 1e-5. bfloat16: the
    kernel and the plain version do the same float32 arithmetic and round
    once, so 1 bfloat16 ulp of the largest column (a fused multiply-add
    may move a float32 sum across a rounding boundary)."""
    import torch.nn.functional as F

    G, K = 8, 3
    esize = torch.empty((), dtype=dtype).element_size()
    worst, first = 0.0, None
    for level, (B, H, W) in shapes.items():
        x, off, mask = dcn_inputs(dev, B, H, W, G, cg, K, dtype)
        args = (x, off, mask, K, 1, 1, 1, G)
        n0 = launch_counts()["dcn_im2col"]
        got = dcn.dcn_im2col(*args)
        launches = launch_counts()["dcn_im2col"] - n0
        want = dcn.dcn_im2col_plain(*args)
        torch.cuda.synchronize()
        err = max_err(got, want)
        tol = (1e-5 if dtype == torch.float32
               else ulp(float(want.abs().max()), 7))
        if not err <= tol:
            raise AssertionError(f"dcn_im2col {level}: err {err} (tol {tol})")
        worst = max(worst, err)
        ms = device_ms(lambda: dcn.dcn_im2col(*args))
        eager = cuda_ms(lambda: dcn.dcn_im2col(*args))
        plain = device_ms(lambda: dcn.dcn_im2col_plain(*args), reps=5)
        # yardstick: F.grid_sample computes the same per-group bilinear
        # sampling (zeros, align_corners=True) on an NCHW copy, without the
        # mask and the column order
        py, px = dcn.sample_positions(off, K, 1, 1, 1, G)
        Q = py.shape[2]
        xg = x.reshape(B, H, W, G, cg).permute(0, 3, 4, 1, 2).reshape(
            B * G, cg, H, W).contiguous()
        grid = torch.stack([2.0 * px / (W - 1) - 1.0, 2.0 * py / (H - 1) - 1.0],
                           -1).reshape(B * G, 1, Q, 2).to(dtype)
        library = device_ms(lambda: F.grid_sample(
            xg, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True))
        # x, offsets and mask read once, the columns written once
        nbytes = esize * (x.numel() + off.numel() + mask.numel()
                          + got.numel())
        flops = B * G * Q * (cg * 9 + 20)
        b_ms, b_by = bound(nbytes, flops)
        line = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                    library_ms=library, eager_ms=eager)
        extra = {}
        if level == "L1":
            flush = torch.empty(2 ** 26, device=dev)       # 256 MB > L2
            extra["ms_l2_cold"] = cold_ms(lambda: dcn.dcn_im2col(*args),
                                          flush)
            del flush
            extra.update(time_dcn_v2(dev, dcn, dtype))
            with mock.patch.object(dcn, "dcn_im2col", dcn.dcn_im2col_plain):
                extra["dcn_v2_plain_ms"] = time_dcn_v2(dev, dcn,
                                                       dtype)["dcn_v2_ms"]
        emit({"check": "dcn_im2col", "dtype": dname(dtype), "level": level,
              "exact_share": float((got == want).float().mean()),
              "launches": launches,
              "shape": [B, H, W, G, cg], "Q": Q, "max_abs_err": err,
              "tol": tol, "fraction_of_bound": b_ms / ms, **line, **extra})
        first = first or line
    return dict(max_abs_err=worst, **first)


def check_dcn_v2(dev, dcn):
    """The whole bfloat16 dcn_v2 (the dcn_im2col kernel + one bfloat16 addmm)
    at L1 / L2 / L3 of the PCD against dcn_v2_plain (the plain im2col + the
    same addmm): 2 bfloat16 ulps of the largest output (a column off by an
    ulp moves a float32 sum). Times: the whole op, its plain version, the
    library composition (F.grid_sample + addmm), and the whole op's bound:
    x, offsets, mask and weight read once, the output written once (the
    columns are the op's own traffic); products at the bf16 tensor-core
    peak."""
    import torch.nn.functional as F

    G, cg, K, dtype = 8, 8, 3, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(5)
    w = (torch.randn((64, G * cg, K, K), device=dev, generator=g) * 0.05
         ).to(dtype)
    bias = torch.randn((64,), device=dev, generator=g).to(dtype)
    for level, (B, H, W) in LEVELS.items():
        x, off, mask = dcn_inputs(dev, B, H, W, G, cg, K, dtype)
        args = (x, off, mask, w, bias, K, 1, 1, 1, G)
        got, want = dcn.dcn_v2(*args), dcn.dcn_v2_plain(*args)
        torch.cuda.synchronize()
        err = max_err(got, want)
        tol = 2 * ulp(float(want.abs().max()), 7)
        if not err <= tol:
            raise AssertionError(f"dcn_v2 bfloat16 {level}: err {err} "
                                 f"(tol {tol})")
        py, px = dcn.sample_positions(off, K, 1, 1, 1, G)
        Q = py.shape[2]
        xg = x.reshape(B, H, W, G, cg).permute(0, 3, 4, 1, 2).reshape(
            B * G, cg, H, W).contiguous()
        grid = torch.stack([2.0 * px / (W - 1) - 1.0, 2.0 * py / (H - 1) - 1.0],
                           -1).reshape(B * G, 1, Q, 2).to(dtype)
        cols = torch.empty((B * H * W, G * K * K * cg), device=dev,
                           dtype=dtype)
        wm = w.reshape(64, -1)

        def library():
            # the same sampling by F.grid_sample (without the mask and the
            # column order), then the product
            F.grid_sample(xg, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=True)
            return torch.addmm(bias, cols, wm.t())
        nbytes = 2 * (x.numel() + off.numel() + mask.numel() + w.numel()
                      + bias.numel() + got.numel())
        flops = 2 * B * H * W * 64 * G * K * K * cg
        b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
        ms = device_ms(lambda: dcn.dcn_v2(*args))
        emit({"check": "dcn_v2", "dtype": "bfloat16", "level": level,
              "shape": [B, H, W, G, cg], "max_abs_err": err, "tol": tol,
              "ms": ms, "plain_ms": device_ms(lambda: dcn.dcn_v2_plain(*args),
                                              reps=5),
              "library_ms": device_ms(library), "bound_ms": b_ms,
              "bound_by": b_by, "fraction_of_bound": b_ms / ms,
              "eager_ms": cuda_ms(lambda: dcn.dcn_v2(*args)),
              "library": "F.grid_sample + addmm"})


SIRENS = {  # name: (fan-in, hidden widths, out, tokens on the main path)
    "stinf": (67, [64, 64, 256], 3, 688128),
    "sinf": (66, [64, 64, 256], 64, 229376),
    "synth": (198, [64, 64, 64, 256], 3, 344064),
}


def check_siren(dev, siren_kernel, Siren, kernels, dtype=torch.float32,
                skip_first=False, mlps=SIRENS):
    """One entry of siren_mlp (element type; whole MLP or from the first
    layer's pre-activation) on the three MLPs at the main path's token
    counts (or those of `mlps`). float32: FMA and sinf, as the plain version with TF32 off:
    1e-5 (the outputs are about 0.05; TF32 products or a fast __sinf would
    miss it). bfloat16: the tensor cores sum in another order than the
    plain version, so the entry is held by accuracy (siren_kernel.mlp_gate:
    against the float64 evaluation of the same bfloat16 inputs its RMS
    error is at most 1.25 x the plain version's, its mean signed error
    below 10% of its RMS error, its max error at most 2 x the plain
    version's); the bit-equal share and the max abs difference from the
    plain version are printed and not gated. The bound counts the bfloat16
    products at the tensor cores' bf16 peak."""
    bf = dtype == torch.bfloat16
    worst, first = 0.0, None
    for name, (cin, hidden, cout, n_tok) in mlps.items():
        torch.manual_seed(3)
        m = Siren(cin, hidden, len(hidden) - 1, cout).to(dev)
        lins = m._linears()[1 if skip_first else 0:]
        ws = [lin.weight.detach().to(dtype) for lin in lins]
        bs = [lin.bias.detach().to(dtype) for lin in lins]
        g = torch.Generator(device=dev).manual_seed(4)
        width = hidden[0] if skip_first else cin
        # a pre-activation is about ±0.6 (what layer 0 gives on this x)
        x = ((torch.rand((n_tok, width), device=dev, generator=g) * 2.0 - 1.0)
             * (0.6 if skip_first else 1.0)).to(dtype)

        def run():
            return siren_kernel.siren_mlp(x, ws, bs, 30.0, False, skip_first)

        def run_plain():
            return siren_kernel.siren_mlp_plain(x, ws, bs, 30.0, False,
                                                skip_first)
        n0 = launch_counts()["siren_mlp"]
        got = run()
        launches = launch_counts()["siren_mlp"] - n0
        want = run_plain()
        torch.cuda.synchronize()
        err = max_err(got, want)
        exact = float((got == want).float().mean())
        tol, held = 1e-5, {}
        if bf:
            ref = siren_kernel.siren_mlp_reference64(x, ws, bs, 30.0, False,
                                                     skip_first)
            held = siren_kernel.mlp_gate(got, want, ref)
            tol = None
            del ref
        del want
        if not (held["ok"] if bf else err <= tol):
            raise AssertionError(f"siren_mlp {name} {dname(dtype)} "
                                 f"skip_first={skip_first}: err {err} "
                                 f"(tol {tol}), bit-equal share {exact}, "
                                 f"accuracy {held}")
        worst = max(worst, err)
        replay = None
        if launches > 1 and not bf:
            replay = replay_holds(run, run_plain, x)
            if not replay["ok"]:
                raise AssertionError(f"siren_mlp {name}: the cut MLP "
                                     f"replayed from a graph: {replay}")
        ms = device_ms(run, reps=10)
        eager = cuda_ms(run, reps=10)
        plain = device_ms(run_plain, reps=10)

        def addmm_sin_chain():
            # the fastest one-call-per-layer form: cuBLAS addmm (what
            # F.linear runs), then the sine, in the entry's element type
            h = torch.sin(30.0 * x) if skip_first else x
            for i, (w, b) in enumerate(zip(ws, bs)):
                h = torch.addmm(b, h, w.t())
                if i < len(ws) - 1:
                    h = torch.sin(30.0 * h)
            return h
        library = device_ms(addmm_sin_chain, reps=10)
        dims = [width] + hidden[1 if skip_first else 0:] + [cout]
        macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        sines = sum(dims[1:-1]) + (dims[0] if skip_first else 0)
        flops = n_tok * (2 * macs + 2 * sines)
        nbytes = x.element_size() * (
            x.numel() + got.numel()
            + sum(w.numel() + b.numel() for w, b in zip(ws, bs)))
        b_ms, b_by = bound(nbytes, flops,
                           BF16_FLOP_PER_S if bf else FP32_FLOP_PER_S)
        line = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                    library_ms=library, eager_ms=eager)
        emit({"check": "siren_mlp", "dtype": dname(dtype),
              "skip_first": skip_first, "mlp": name, "launches": launches,
              "tokens": n_tok, "dims": dims, "max_abs_err": err, "tol": tol,
              "exact_share": exact, "fraction_of_bound": b_ms / ms,
              "peak": "bf16 tensor cores" if bf else "fp32",
              "library": "addmm + sin per layer (cuBLAS)", **line,
              **({"accuracy_vs_float64": held} if bf else {}),
              **({"replay": replay} if replay else {}),
              **({"by_launch": siren_launch_ms(siren_kernel, x, ws, bs,
                                               skip_first)}
                 if launches > 1 and not bf else {})})
        first = first or line
    return dict(max_abs_err=worst, **first)


def replay_holds(run, run_plain, x):
    """run() (reading x) captured in a CUDA graph, replayed on -x written
    into x in place: bit-equal to run() eagerly on -x and within 1e-5 of
    the plain version; x restored after."""
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        out = run()
    x.neg_()
    graph.replay()
    eager = run()
    err = max_err(out, run_plain())
    equal = bool(torch.equal(out, eager))
    x.neg_()
    del graph, out, eager
    return {"bit_equal_to_eager": equal, "max_abs_err": err, "tol": 1e-5,
            "ok": equal and err <= 1e-5}


def siren_launch_ms(siren_kernel, x, ws, bs, skip_first):
    """A float32 MLP cut into launches (`siren_kernel.segments`), each
    launch's layers timed as an MLP of their own on the input the launch
    reads (the plain version's activation before it), beside `addmm` +
    `sin` of the same layers and the launch's bound: device ms, the bound's
    share of each."""
    dims = [x.shape[-1]] + [w.shape[0] for w in ws]
    h, rows = x, []
    for s in siren_kernel.segments(dims):
        lw, lb = ws[s.first:s.last], bs[s.first:s.last]
        sine = s.last < len(ws)
        skip = skip_first and s.first == 0

        def kernel(h=h, lw=lw, lb=lb, sine=sine, skip=skip):
            return siren_kernel.siren_mlp(h, lw, lb, 30.0, sine, skip)

        def library(h=h, lw=lw, lb=lb, sine=sine, skip=skip):
            y = torch.sin(30.0 * h) if skip else h
            for i, (w, b) in enumerate(zip(lw, lb)):
                y = torch.addmm(b, y, w.t())
                if i < len(lw) - 1 or sine:
                    y = torch.sin(30.0 * y)
            return y
        b_ms, b_by = siren_bound(h.shape[0], s.dims, sine, skip)
        ms = device_ms(kernel, reps=10)
        lib_ms = device_ms(library, reps=10)
        rows.append({"layers": [s.first, s.last], "dims": s.dims,
                     "kernel": "siren_layer" if s.layer else "resident",
                     "smem": s.smem, "ms": ms, "library_ms": lib_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "share": b_ms / ms, "library_share": b_ms / lib_ms})
        h = siren_kernel.siren_mlp_plain(h, lw, lb, 30.0, sine, skip)
    return rows


def siren_bound(n_tok, dims, sine_last, skip_first):
    """The float32 bound of an MLP of widths `dims` over `n_tok` tokens:
    x read once, the result written once, the weights and biases read
    once; 2 flops a multiply-add and a sine."""
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    sines = (sum(dims[1:-1]) + (dims[-1] if sine_last else 0)
             + (dims[0] if skip_first else 0))
    nbytes = 4 * (n_tok * (dims[0] + dims[-1]) + sum(
        (a + 1) * b for a, b in zip(dims[:-1], dims[1:])))
    return bound(nbytes, n_tok * (2 * macs + 2 * sines))


# siren_layer at its launches' shapes (K, N, tokens, sine): VideoINR's
# request (114,688 tokens a time at 256x448), LIIF training (393,216 a
# time at batch 24 x 128²), setting 6's synthesis net (344,064), and a
# layer no block held 8 columns of before (6000 -> 8)
LAYER_SHAPES = {
    "liif_train_1049x64": (1049, 64, 393216, True),
    "liif_train_525x64": (525, 64, 393216, True),
    "liif_train_463x64": (463, 64, 393216, True),
    "liif_train_256x256": (256, 256, 393216, True),
    "liif_train_256x3": (256, 3, 393216, False),
    "request_201x64": (201, 64, 114688, True),
    "request_525x64": (525, 64, 114688, True),
    "request_256x256": (256, 256, 114688, True),
    "request_256x3": (256, 3, 114688, False),
    "synth_s6_331x64": (331, 64, 344064, True),
    "wide_6000x8": (6000, 8, 114688, False),
}


def fma_chain(x, w, b, sine, omega0=30.0):
    """The streamed-weight layer's definition, as the card tests hold it
    (tests/test_torch_kernels.py::_fma_chain): [sin(omega0 *)](x W^T + b)
    with each output one chain of float32 FMAs in ascending k from 0
    (torch.addcmul with value 1: acc + x * w rounded once), then the bias
    added, then torch.sin (sinf's arithmetic)."""
    acc = torch.zeros((x.shape[0], w.shape[0]), device=x.device)
    for k in range(x.shape[1]):
        acc.addcmul_(x[:, k:k + 1], w[:, k])
    acc += b
    return torch.sin(omega0 * acc) if sine else acc


def check_siren_layers_f32(dev, siren_kernel, kernels, shapes=LAYER_SHAPES):
    """The streamed-weight kernel (siren_mlp's "float32/layer" entry, one
    layer alone) at each shape of `shapes`: one launch, bit-equal to the
    ascending-k FMA chain (`fma_chain`: max abs err 0), which does not
    depend on the order cuBLAS picks; its distance from F.linear + sin and
    from the plain version (siren_mlp_plain) printed beside it; timed
    beside the plain version, `addmm` + `sin` and its bound. Returns
    {name: row}."""
    out = {}
    for name, (K, N, n_tok, sine) in shapes.items():
        x, ws, bs = siren_case(dev, [K, N], n_tok, torch.float32, False)

        def run():
            return siren_kernel.siren_mlp(x, ws, bs, 30.0, sine)

        def run_plain():
            return siren_kernel.siren_mlp_plain(x, ws, bs, 30.0, sine)

        def library():
            y = torch.addmm(bs[0], x, ws[0].t())
            return torch.sin(30.0 * y) if sine else y
        n0 = entry_counts().get("siren_mlp/float32/layer", 0)
        got = run()
        launches = entry_counts().get("siren_mlp/float32/layer",
                                              0) - n0
        chain = fma_chain(x, ws[0], bs[0], sine)
        torch.cuda.synchronize()
        err = max_err(got, chain)
        equal = bool(torch.equal(got, chain))
        del chain
        linear = torch.nn.functional.linear(x, ws[0], bs[0])
        linear = torch.sin(30.0 * linear) if sine else linear
        err_linear = max_err(got, linear)
        del linear
        err_plain = max_err(got, run_plain())
        del got
        if launches != 1 or not equal:
            raise AssertionError(f"siren_layer {K} -> {N} sine={sine}: "
                                 f"{launches} launches, {err} from the "
                                 "ascending-k FMA chain")
        b_ms, b_by = siren_bound(n_tok, [K, N], sine, False)
        ms = device_ms(run, reps=10)
        lib_ms = device_ms(library, reps=10)
        row = dict(ms=ms, plain_ms=device_ms(run_plain, reps=10),
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   eager_ms=cuda_ms(run, reps=10), max_abs_err=err,
                   max_abs_err_vs_plain=err_plain,
                   max_abs_err_vs_linear=err_linear)
        emit({"check": "siren_layer", "case": name, "K": K, "N": N,
              "tokens": n_tok, "sine": sine, "launches": launches,
              "bit_equal": equal, "reference": "ascending-k FMA chain",
              "share": b_ms / ms,
              "library_share": b_ms / lib_ms, "vs_library": ms / lib_ms,
              "library": "addmm + sin (cuBLAS)", **row})
        out[name] = row
        del x, ws, bs
        torch.cuda.empty_cache()
    return out


def siren_case(dev, dims, n_tok, dtype, skip_first, scale=1.0):
    """Weights with SIREN's hidden init, biases and tokens from a seed."""
    from motif_tpu_torch.models.siren import hidden_bound

    g = torch.Generator(device=dev).manual_seed(6)
    ws = [((torch.rand((o, i), device=dev, generator=g) * 2 - 1)
           * hidden_bound(i, 30.0)).to(dtype)
          for i, o in zip(dims[:-1], dims[1:])]
    bs = [(torch.rand((o,), device=dev, generator=g) * 0.2 - 0.1).to(dtype)
          for o in dims[1:]]
    x = ((torch.rand((n_tok, dims[0]), device=dev, generator=g) * 2 - 1)
         * scale).to(dtype)
    return x, ws, bs


def check_siren_layers(dev, siren_kernel):
    """Gate 1 of the bfloat16 entries: ONE layer K -> N at the widths of
    the MoTIF MLPs, with and without the sine, on the same bfloat16 input
    as the plain version (siren_kernel.layer_gate: at least 99% of the
    outputs bit-equal, none further off than one flipped rounding of the
    product puts it). 256 -> 256 does not fit a block's shared memory."""
    for K in (64, 67, 198, 256):
        for N in (64, 256, 3):
            if (K, N) == (256, 256):
                continue
            x, ws, bs = siren_case(dev, [K, N], 100_000, torch.bfloat16,
                                   False)
            pre = torch.nn.functional.linear(x.double(), ws[0].double())
            pre_max = float(torch.maximum(
                pre.abs(), (pre + bs[0].double()).abs()).max())
            for sine in (False, True):
                got = siren_kernel.siren_mlp(x, ws, bs, 30.0, sine)
                want = siren_kernel.siren_mlp_plain(x, ws, bs, 30.0, sine)
                held = siren_kernel.layer_gate(got, want, pre_max, 30.0, sine)
                emit({"check": "siren_mlp_layer", "dtype": "bfloat16",
                      "K": K, "N": N, "sine": sine, "tokens": 100_000,
                      "pre_max": pre_max, **held})
                if not held["ok"]:
                    raise AssertionError(f"siren_mlp bfloat16 layer {K} -> "
                                         f"{N}, sine={sine}: {held}")


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_versions(softsplat, dcn, siren_kernel):
    """Route the model's kernel calls to the plain versions (the reference
    forward for the comparison; the package itself has no such switch)."""
    from motif_tpu_torch.ops import preact

    def siren_plain(*a, packed=None, **kw):   # the kernel's buffer: unused
        return siren_kernel.siren_mlp_plain(*a, **kw)
    with mock.patch.object(softsplat, "splat_fused",
                           softsplat.splat_fused_plain), \
            mock.patch.object(dcn, "dcn_im2col", dcn.dcn_im2col_plain), \
            mock.patch.object(siren_kernel, "siren_mlp", siren_plain), \
            mock.patch.object(preact, "preact", preact.preact_plain):
        yield


def perturb_offsets(model, seed: int) -> int:
    """conv_offset_mask is zero at init, which makes every DCN offset 0;
    give it random weights so the offsets are real (about ±2 px)."""
    from motif_tpu_torch.models.pcd import DCNSep

    g = torch.Generator().manual_seed(seed)
    n = 0
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, DCNSep):
                w, b = mod.conv_offset_mask.weight, mod.conv_offset_mask.bias
                w.copy_(torch.randn(w.shape, generator=g) * 0.01)
                b.copy_(torch.randn(b.shape, generator=g))
                n += 1
    return n


def check_frames(name, frames, shape, clipped=True):
    """The frames' shape, finite values, and (where the model clips them,
    as MoTIF does; the baselines do not) values in [0, 1]."""
    if frames.shape != shape:
        raise AssertionError(f"request {name}: shape {frames.shape} != {shape}")
    if not np.isfinite(frames).all():
        raise AssertionError(f"request {name}: non-finite frames")
    if clipped and (frames.min() < 0.0 or frames.max() > 1.0):
        raise AssertionError(f"request {name}: frames outside [0, 1]")


def build_request(dev, **knobs):
    """MoTIF(setting=5) at full width with random weights from seed 0 and
    perturbed DCN offsets (the same weights whatever the knobs), its
    Evaluator, and request (a)'s inputs."""
    from motif_tpu_torch.eval import Evaluator
    from motif_tpu_torch.models.motif import build_motif

    model = build_motif(channel=64, front_rbs=5, back_rbs=40, device=dev,
                        seed=0, **knobs)
    n_dcn = perturb_offsets(model, seed=1)
    ev = Evaluator(model, scale=4, iters=4, chunk=3, device=dev)
    rng = np.random.default_rng(0)
    lq_a = rng.random((1, 4, 64, 112, 3), dtype=np.float32)
    t3 = np.linspace(0, 1, 3, dtype=np.float32)[None]
    return model, n_dcn, ev, rng, lq_a, t3


def time_request(infer, lq, times, n, out_hw=(256, 448)):
    """Wall milliseconds of n runs of one request through `infer` (an
    Evaluator's `infer`, or `eager(ev)`), each ending in the frames' copy
    to the host."""
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        infer(lq, times, out_hw)
        ts.append((time.perf_counter() - t) * 1e3)
    return ts


def eager(ev):
    """The Evaluator's eager request (`_infer_eager`: every chunk's forward
    run eagerly, no bucket), the reference of the captured one, which the
    plain versions, hooks and spies need (a replay runs none of them); an
    older checkout's `infer`, which is eager."""
    return getattr(ev, "_infer_eager", ev.infer)


def pool_bytes(ev):
    """The bytes the Evaluator's buckets hold in their shared CUDA-graph
    memory pool (its segments' size), or None without a pool."""
    pool = getattr(ev, "_pool", None)
    if pool is None:
        return None
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def graph_ms(ev, lq, times, out_hw, reps=5):
    """Device ms of one request's replays through its bucket's graphs (a
    MoTIF bucket's trunk graph once and the head's graph once per chunk),
    by CUDA events over `reps` requests' replays back to back (a replay's
    kernels run with no host gap between them), and the request's chunks. torch.profiler is not used on
    replays: CUPTI segfaulted the process in them (PERF.md §7)."""
    lq_shape, chunks, _, hw = ev._plan(lq, times)
    bucket = ev._buckets[ev._key(lq_shape, chunks[0].shape, hw)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        if bucket.trunk is not None:
            bucket.trunk.graph.replay()
        for _ in chunks:
            bucket.head.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, len(chunks)


def hold_replay(ev, lq, times, name, tol, stats_rtol, card,
                out_hw=(256, 448), n=5):
    """Request `name` replayed from its bucket's graph against the same
    request run eagerly: the frames within `tol` and the flow statistics
    within `stats_rtol` (the request's own gates), beside the distance of
    two eager runs and the share of frames bit-equal to the first eager
    run's; then eager and captured timed in turns (n each, twice), and the
    device's busy share of a captured request: its graph replays
    (`graph_ms`) over its median wall time. Returns the line it prints."""
    first, _ = ev.infer(lq, times, out_hw)       # captures a new bucket
    got, stats = ev.infer(lq, times, out_hw)
    ref, stats_ref = eager(ev)(lq, times, out_hw)
    ref2, _ = eager(ev)(lq, times, out_hw)

    def dist(a):
        return float(np.abs(a - ref).max())

    def bit_equal(a):
        return float(np.mean([np.array_equal(x, y) for x, y in zip(
            a.reshape(-1, *a.shape[2:]), ref.reshape(-1, *ref.shape[2:]))]))
    stats_err = None if stats is None else max(
        abs(a - b) / abs(b) for a, b in zip(stats, stats_ref))
    e1 = time_request(eager(ev), lq, times, n, out_hw)
    c1 = time_request(ev.infer, lq, times, n, out_hw)
    c2 = time_request(ev.infer, lq, times, n, out_hw)
    e2 = time_request(eager(ev), lq, times, n, out_hw)
    g_ms, chunks = graph_ms(ev, lq, times, out_hw)
    captured = float(np.median(c1 + c2))
    line = {"phase": "replay", "request": name, "card": card,
            "max_abs_err": dist(got), "tol": tol,
            "first_request_max_abs_err": dist(first),
            "eager_twice_max_abs_err": dist(ref2),
            "bit_equal_frames": bit_equal(got),
            "eager_twice_bit_equal_frames": bit_equal(ref2),
            "flow_stats_max_rel_err": stats_err,
            "flow_stats_rtol": stats_rtol,
            "eager_ms_median": float(np.median(e1 + e2)),
            "eager_ms_range": [min(e1 + e2), max(e1 + e2)],
            "captured_ms_median": captured,
            "captured_ms_range": [min(c1 + c2), max(c1 + c2)],
            "eager_ms": e1 + e2, "captured_ms": c1 + c2,
            "graph_device_ms": g_ms, "chunks": chunks,
            "device_busy_ms": g_ms,
            "device_busy_share": g_ms / captured,
            "buckets": len(getattr(ev, "_buckets", {})),
            "pool_bytes": pool_bytes(ev),
            "note": "Evaluator.infer wall ms incl. the frames' copy to the "
                    "host, eager and captured in turns: e, c, c, e; busy = "
                    "graph_device_ms (a request's replays, CUDA events) / "
                    "captured median"}
    emit(line)
    if not (dist(got) <= tol and dist(first) <= tol
            and (stats is None or stats_err <= stats_rtol)):
        raise AssertionError(f"request ({name}) replayed against eager: "
                             f"{dist(got)}, first {dist(first)} (tol {tol}); "
                             f"flow stats rel {stats_err} (rtol {stats_rtol})")
    return line


def psnr(a, b) -> float:
    return float(10.0 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)),
                                           1e-20)))


def hold_against(name, frames, ref, tol, min_psnr=None):
    """Frames of a knob path against the float32 reference-order frames on
    the same weights: max abs below `tol`, and at least `min_psnr` dB."""
    err = float(np.abs(frames - ref).max())
    db = psnr(frames, ref)
    emit({"phase": "knobs_vs_float32", "request": name, "max_abs_err": err,
          "tol": tol, "psnr_db": db, "min_psnr_db": min_psnr,
          "mean_abs_err": float(np.abs(frames - ref).mean())})
    if not err < tol or (min_psnr is not None and not db >= min_psnr):
        raise AssertionError(f"request ({name}) against request (a): max abs "
                             f"{err} (tol {tol}), {db} dB (min {min_psnr})")


def slice_vs_plain(ev, model, lq, times, name, tol, stats_rtol, mods,
                   out_hw=(256, 448)):
    """One request against the same forward with the plain versions, both
    run eagerly: the frames, the synthesis output before the clip (most
    frames clip with random weights; every forward of the request) and the
    flow statistics."""
    softsplat, dcn, siren_kernel, kernels = mods
    pre_clip = []
    hook = model.synth_net.register_forward_hook(
        lambda mod, inp, out: pre_clip.append(out.double().cpu()))
    f_k, stats_k = eager(ev)(lq, times, out_hw)   # kernels, hooked
    with plain_versions(softsplat, dcn, siren_kernel):
        obs.reset(obs.LAUNCHES)
        f_plain, stats_plain = eager(ev)(lq, times, out_hw)
        if any(launch_counts().values()):
            raise AssertionError("the plain forward launched a kernel")
    hook.remove()
    half = len(pre_clip) // 2
    pre_k, pre_plain = torch.cat(pre_clip[:half]), torch.cat(pre_clip[half:])
    err = float(np.abs(f_k - f_plain).max())
    err_pre = float((pre_k - pre_plain).abs().max())
    err_stats = max(abs(a - b) / abs(b) for a, b in zip(stats_k, stats_plain))
    emit({"phase": "slice_vs_plain", "request": name, "max_abs_err": err,
          "mean_abs_err": float(np.abs(f_k - f_plain).mean()), "tol": tol,
          "psnr_db": psnr(f_k, f_plain),
          "clipped_share": float(((f_plain <= 0) | (f_plain >= 1)).mean()),
          "pre_clip_max_abs_err": err_pre,
          "pre_clip_mean_abs_err": float((pre_k - pre_plain).abs().mean()),
          "pre_clip_max_abs": float(pre_plain.abs().max()),
          "flow_stats": stats_k, "flow_stats_plain": stats_plain,
          "flow_stats_max_rel_err": err_stats, "flow_stats_rtol": stats_rtol})
    if not (err <= tol and err_pre <= tol and err_stats <= stats_rtol):
        raise AssertionError(
            f"request ({name}) kernels vs plain: frames {err}, before the "
            f"clip {err_pre} (tol {tol}); flow stats rel {err_stats} (rtol "
            f"{stats_rtol})")


def capture_splat(ev, softsplat, lq, times, out_hw=(256, 448)):
    """The splat's inputs on one request."""
    captured = []
    splat = softsplat.splat_fused

    def spy(img, flow, z, z_nonpositive, scatter_dtype=None):
        captured.append((img.clone(), flow.clone(), z.clone(), z_nonpositive,
                         scatter_dtype))
        return splat(img, flow, z, z_nonpositive, scatter_dtype)
    with mock.patch.object(softsplat, "splat_fused", spy):
        eager(ev)(lq, times, out_hw)
    return captured[0]


def capture_preacts(ev, lq, times, out_hw=(256, 448)):
    """The fused decode's parts on one eager request's first forward: per
    site, the positional and keyword arguments of its `preact` call,
    cloned."""
    from motif_tpu_torch.ops import preact

    captured = {}
    real = preact.preact

    def clone(v):
        return v.clone() if torch.is_tensor(v) else v

    def spy(site, *a, **kw):
        captured.setdefault(site, ([clone(v) for v in a],
                                   {k: clone(v) for k, v in kw.items()}))
        return real(site, *a, **kw)
    with mock.patch.object(preact, "preact", spy):
        eager(ev)(lq, times, out_hw)
    return captured


def check_preacts(captured, request):
    """Each site's kernel on a request's own parts (`capture_preacts`)
    against `preact_plain`, bit for bit, timed from a CUDA graph beside the
    plain version, with its bound: the output written and each part read
    once, at the HBM rate. Returns a line per site."""
    from motif_tpu_torch.ops import preact

    lines = {}
    for site in preact.SITES:
        a, kw = captured[site]

        def run(fn=preact.preact, a=a, kw=kw, site=site):
            return fn(site, *a, **kw)

        def plain(run=run):
            return run(preact.preact_plain)
        with torch.no_grad():
            out, want = run(), plain()
            held = {"bit_equal": out.dtype == want.dtype and
                    torch.equal(out, want),
                    "apart": int((out != want).sum()),
                    "max_abs_err": max_err(out, want)}
            nbytes = out.numel() * out.element_size() + sum(
                v.numel() * v.element_size() for v in (*a, *kw.values())
                if torch.is_tensor(v))
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            line = {"ms": device_ms(run), "plain_ms": device_ms(plain),
                    "bound_ms": b_ms, "bound_by": "bytes",
                    "eager_ms": cuda_ms(run), "max_abs_err":
                    held["max_abs_err"], "shape": list(out.shape)}
        emit({"check": "preact", "site": site, "case": "request_" + request,
              "dtype": dname(out.dtype), "bytes": nbytes, **held, **line,
              "fraction_of_bound": b_ms / line["ms"]})
        if not held["bit_equal"]:
            raise AssertionError(f"preact ({site}) on request ({request})'s "
                                 f"parts against the plain version: {held}")
        lines[site] = line
    return lines


# the fused decode's four pre-activations, one launch each a forward
PREACTS = {"preact/stinf": 1, "preact/sinf": 1, "preact/payload": 1,
           "preact/synth": 1}


# What request (e) must launch and nothing else of these kernels: 42 DCNs,
# three SIRENs per decode chunk, one splat and the four pre-activations per
# forward.
def serving_entries(chunks: int) -> dict:
    return {"dcn_im2col/bfloat16": 42,
            "siren_mlp/bfloat16/skip_first": 3 * chunks,
            "splat_fused/float16/C=64": 1, **PREACTS}


def run_slice(dev, args, card):
    from motif_tpu_torch.ops import dcn, kernels, siren_kernel, softsplat

    mods = (softsplat, dcn, siren_kernel, kernels)
    t0 = time.perf_counter()
    model, n_dcn, ev, rng, lq_a, t3 = build_request(dev)
    model_s, _, ev_s, _, _, _ = build_request(dev, **SERVING)
    t7 = np.linspace(0, 1, 7, dtype=np.float32)[None]
    lq_c = rng.random((1, 4, 62, 110, 3), dtype=np.float32)
    same = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 model_s.state_dict().values()))
    if not same:
        raise AssertionError("the serving model's weights differ")
    emit({"phase": "slice_setup", "params": sum(p.numel() for p in
                                                model.parameters()),
          "dcn_modules_perturbed": n_dcn, "serving_knobs": SERVING,
          "seconds": time.perf_counter() - t0})

    # ---- the main path: counters to 0, the requests, counters read ----
    obs.reset(obs.LAUNCHES)
    per_request, entries = {}, {}

    def counted(name, fn):
        before, ebefore = launch_counts(), entry_counts()
        out = fn()
        per_request[name] = {k: v - before[k]
                             for k, v in launch_counts().items()}
        entries[name] = {k: v - ebefore.get(k, 0)
                         for k, v in entry_counts().items()
                         if v - ebefore.get(k, 0)}
        return out

    t0 = time.perf_counter()
    fa, stats_a = counted("a", lambda: ev.infer(lq_a, t3, (256, 448)))
    fb, _ = counted("b", lambda: ev.infer(lq_a, t7, (256, 448)))
    fc, _ = counted("c", lambda: ev.infer(lq_c, t3, (248, 440)))
    with torch.no_grad():
        model.alpha.fill_(0.05)          # z > 0: the max splat runs
    fd, _ = counted("d", lambda: ev.infer(lq_a, t3, (256, 448)))
    with torch.no_grad():
        model.alpha.fill_(-20.0)
    fe, stats_e = counted("e", lambda: ev_s.infer(lq_a, t3, (256, 448)))
    fe2, _ = counted("e2", lambda: ev_s.infer(lq_a, t3, (256, 448)))
    model_s.configure(**SERVING, decode_chunks=3)
    fe3, _ = counted("e3", lambda: ev_s.infer(lq_a, t3, (256, 448)))
    model_s.configure(fused_decode=True)
    ff, _ = counted("f", lambda: ev_s.infer(lq_a, t3, (256, 448)))
    model_s.configure(compute_dtype="bfloat16")
    fg, _ = counted("g", lambda: ev_s.infer(lq_a, t3, (256, 448)))
    model_s.configure(**SERVING)
    launches = launch_counts()
    entry_launches = entry_counts()
    seconds = time.perf_counter() - t0
    for name, f, shape in (("a", fa, (3, 1, 256, 448, 3)),
                           ("b", fb, (7, 1, 256, 448, 3)),
                           ("c", fc, (3, 1, 248, 440, 3)),
                           ("d", fd, (3, 1, 256, 448, 3)),
                           ("e", fe, (3, 1, 256, 448, 3)),
                           ("e2", fe2, (3, 1, 256, 448, 3)),
                           ("e3", fe3, (3, 1, 256, 448, 3)),
                           ("f", ff, (3, 1, 256, 448, 3)),
                           ("g", fg, (3, 1, 256, 448, 3))):
        check_frames(name, f, shape)
    missing = [k for k, v in launches.items() if v == 0]
    missing += [k for k in ENTRIES if not entry_launches.get(k)]
    if missing:
        raise AssertionError(f"never launched on the main path: {missing} "
                             f"(counts {launches}, {entry_launches})")
    if entries["e"] != serving_entries(1) or entries["e3"] != serving_entries(3):
        raise AssertionError(
            f"request (e) launched {entries['e']} (wanted "
            f"{serving_entries(1)}), in three chunks {entries['e3']} "
            f"(wanted {serving_entries(3)})")
    emit({"phase": "main_path", "requests": len(per_request),
          "seconds": seconds, "launches": launches,
          "entry_launches": entry_launches,
          "launches_per_request": per_request,
          "entry_launches_per_request": entries,
          "flow_stats_a": stats_a, "flow_stats_e": stats_e})
    emit({"phase": "request_e_entries",
          "ran_in": {k.split("/")[0]: k.split("/", 1)[1]
                     for k in entries["e"]},
          "launches": entries["e"],
          "no_float32_entry": not any("float32" in k for k in entries["e"])})
    # the fused decode's pre-activations on request (e)'s own parts
    preacts = check_preacts(capture_preacts(ev_s, lq_a, t3), "e")

    # ---- the knob paths against request (a)'s float32 frames: fused
    # decode is a reordering (5e-3); the low precisions by the 6e-2 / 35 dB
    # gate. Decode chunks are exact for the SIRENs (the card tests hold
    # that bit for bit), but the float16 splat sums in an order that varies
    # from run to run, so request (e) in three chunks is held to request
    # (e) as a second run of request (e) itself is: 2e-2 ----
    again = float(np.abs(fe - fe2).max())
    chunked = float(np.abs(fe - fe3).max())
    emit({"phase": "decode_chunks", "request": "e", "chunks": 3,
          "max_abs_err_vs_one_chunk": chunked,
          "max_abs_err_run_to_run": again, "tol": 2e-2})
    if not (chunked <= 2e-2 and again <= 2e-2):
        raise AssertionError(
            f"request (e): in three decode chunks off by {chunked}, a second "
            f"run by {again} (tol 2e-2)")
    hold_against("f", ff, fa, 5e-3)
    hold_against("g", fg, fa, 6e-2, 35.0)
    hold_against("e", fe, fa, 6e-2, 35.0)

    # ---- requests (a) and (e) against the same forward with the plain
    # versions. (a): 1e-5. (e): every kernel entry is within one ulp of its
    # plain version, but one bfloat16 ulp in a motion SIREN's output moves
    # a splatted pixel across a floor(), so the request is held by the
    # gate of the knobs themselves, frames and pre-clip output ----
    slice_vs_plain(ev, model, lq_a, t3, "a", 1e-5, 1e-5, mods)
    slice_vs_plain(ev_s, model_s, lq_a, t3, "e", 6e-2, 1e-2, mods)

    # ---- the splat kernel on the requests' own inputs ----
    check_splat_request(softsplat, kernels,
                        capture_splat(ev, softsplat, lq_a, t3), "a")
    check_splat_request(softsplat, kernels,
                        capture_splat(ev_s, softsplat, lq_a, t3), "e")

    # ---- every request replayed against eager, timed in turns, and one
    # captured request of each profiled; the fp32 ones at (a)'s gate, the
    # bfloat16 ones at (e)'s ----
    fp32, low = (1e-5, 1e-5), (6e-2, 1e-2)
    # (b)-(d) and the knob requests (e3), (f), (g): timed 2 + 2 a way (the
    # smoke's time)
    replay = {"a": hold_replay(ev, lq_a, t3, "a", *fp32, card)}
    hold_replay(ev, lq_a, t7, "b", *fp32, card, n=2)
    hold_replay(ev, lq_c, t3, "c", *fp32, card, (248, 440), n=2)
    with torch.no_grad():
        model.alpha.fill_(0.05)
    hold_replay(ev, lq_a, t3, "d", *fp32, card, n=2)
    with torch.no_grad():
        model.alpha.fill_(-20.0)
    replay["e"] = hold_replay(ev_s, lq_a, t3, "e", *low, card)
    # request (e) replayed with every synchronising call an error: only
    # the final event's wait may block
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ev_s.infer(lq_a, t3, (256, 448))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    emit({"phase": "sync_debug", "request": "e", "mode": "error",
          "raised": False})
    for name, knobs, gate in (("e3", dict(SERVING, decode_chunks=3), low),
                              ("f", dict(fused_decode=True), fp32),
                              ("g", dict(compute_dtype="bfloat16"), low)):
        model_s.configure(**knobs)
        hold_replay(ev_s, lq_a, t3, name, *gate, card, n=2)
    model_s.configure(**SERVING)

    # ---- (a)'s plain forward, timed eagerly; the requests' eager
    # profiles beside the captured ones ----
    with plain_versions(softsplat, dcn, siren_kernel):
        p1 = time_request(eager(ev), lq_a, t3, 3)
        p2 = time_request(eager(ev), lq_a, t3, 3)
    for name, r in replay.items():
        ms = r["captured_ms_median"]
        emit({"phase": f"request_{name}_time", "card": card,
              "forward_ms_median": ms, "hr_frames_per_s": 3e3 / ms,
              "forward_ms": r["captured_ms"],
              "eager_ms_median": r["eager_ms_median"],
              "eager_hr_frames_per_s": 3e3 / r["eager_ms_median"],
              "plain_forward_ms_median": (float(np.median(p1 + p2))
                                          if name == "a" else None),
              "plain_forward_ms": p1 + p2 if name == "a" else None,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "knobs": SERVING if name == "e" else {},
              "device_busy_share": r["device_busy_share"],
              "profile_eager": profile_request(
                  eager(ev if name == "a" else ev_s), lq_a, t3, args.profile,
                  f"{name}_eager"),
              "note": "Evaluator.infer wall time incl. host copy-out, TF32 "
                      "off, iters=4, LQ 64x112 -> HR 256x448, 3 times; "
                      "captured and eager (`replay` line), plain eagerly"})

    if args.profile:
        sass_counts(kernels, args.profile)
    return launches, entry_launches, per_request, entries, preacts


# ---------------------------------------------------------------------------
# phase 5: the eval harness
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
VID4 = os.path.join(ROOT, "data", "Vid4")
BENCH_LQ = (64, 112)          # bench.py's LQ; the GT is 4x that
# what one forward of each configuration launches of the three kernels
EVAL_ENTRIES = {"fp32": {"dcn_im2col/float32": 42,
                         "siren_mlp/float32/whole": 3,
                         "splat_fused/float32/C=130": 1},
                "serving": serving_entries(1)}
# The CLI against the same run with the plain versions. Frames: request
# (a)'s 1e-5 (fp32) and request (e)'s 6e-2 / 35 dB (serving). Per-frame
# Y-PSNR and SSIM: the largest distance of three H100 runs times 4 to 70
# (fp32 1.5e-9 dB and 2.1e-10; serving 8.2e-6 dB and 2.7e-6). The serving
# pair must refuse the planted faults of PLANTED_FAULTS marked so.
EVAL_GATES = {"fp32": dict(frames=1e-5, min_psnr=None, psnr_db=1e-7,
                           ssim=1e-8),
              "serving": dict(frames=6e-2, min_psnr=35.0, psnr_db=4e-5,
                              ssim=1e-5)}


def _float32_sums(splat, img, flow, z, scatter_dtype=None, **kw):
    return splat(img, flow, z, **kw)


def _four_half_ulps_high(splat, img, flow, z, **kw):
    out, *rest = splat(img, flow, z, **kw)
    return (out * (1 + 4 * 2.0 ** -10), *rest)


def _splat_half_pixel(splat, img, flow, z, **kw):
    return splat(img, flow + 0.5, z, **kw)


def _dcn_half_pixel(im2col, x, offset, *args):
    return im2col(x, offset + 0.5, *args)


# Wrong kernel outputs planted into the serving CLI: (module, wrapper,
# fault, whether the serving gate must refuse it). Faults of the float16
# splat's precision (its sums left in float32, the knob not passed on; its
# output four float16 ulps high) and the bfloat16 DCN's samples half a
# pixel off move the random-weight metrics no more than the kernels' own
# order does (PERF.md §6, PR 7): the per-entry checks of phase 3 hold
# those. The splat's targets half a pixel off must be refused.
PLANTED_FAULTS = {
    "splat_float32_sums": ("softsplat", "splat_fused", _float32_sums, False),
    "splat_four_half_ulps_high": ("softsplat", "splat_fused",
                                  _four_half_ulps_high, False),
    "splat_half_pixel": ("softsplat", "splat_fused", _splat_half_pixel, True),
    "dcn_half_pixel": ("dcn", "dcn_im2col", _dcn_half_pixel, False)}


class ClipClock:
    """Wraps an Evaluator's `infer` to keep each call's frames and its host
    clock: per clip, the seconds in `infer` (the forward, ending in the
    frames' copy to the host) and the seconds from its return to the next
    call or to `stop()` (the metrics, and whatever the loader adds)."""

    def __init__(self, infer):
        self.infer, self.frames, self.spans, self.end = infer, [], [], None

    def __call__(self, ev, lq, times, out_hw):
        t = time.perf_counter()
        out = self.infer(ev, lq, times, out_hw)
        self.spans.append((t, time.perf_counter()))
        self.frames.append(out[0])
        return out

    def stop(self):
        self.end = time.perf_counter()

    def seconds(self):
        starts = [a for a, _ in self.spans[1:]] + [self.end]
        return ([b - a for a, b in self.spans],
                [n - b for (_, b), n in zip(self.spans, starts)])


def clocked(ev_cls, fn):
    """fn() with `ev_cls.infer` clocked; returns (fn's result, clock)."""
    clock = ClipClock(ev_cls.infer)

    def infer(self, lq, times, out_hw):
        return clock(self, lq, times, out_hw)
    with mock.patch.object(ev_cls, "infer", infer):
        out = fn()
    clock.stop()
    return out, clock


def eval_ymls(tmp, src="test.yml", name="tmp"):
    """An eval yml of the repository (`src`, whose `name:` is `name`) as it
    is (the fp32 configuration) and with the serving knobs in its
    network_G, written into `tmp`; and the two runs' names."""
    with open(os.path.join(ROOT, src)) as f:
        text = f.read()
    knobs = "".join(f"  {k}: {str(v).lower() if isinstance(v, bool) else v}\n"
                    for k, v in {**SERVING, "decode_chunks": 1}.items())
    served = f"{name}_serving"
    serving = text.replace(f"name: {name}\n", f"name: {served}\n").replace(
        "network_G:\n", "network_G:\n" + knobs)
    if serving.count(served) != 1 or knobs not in serving:
        raise AssertionError(f"{src} has no `name: {name}` or `network_G:` "
                             "line to put the serving knobs under")
    stem = os.path.splitext(os.path.basename(src))[0]
    paths = {"fp32": os.path.join(tmp, f"{stem}.yml"),
             "serving": os.path.join(tmp, f"{stem}_serving.yml")}
    for config, body in (("fp32", text), ("serving", serving)):
        with open(paths[config], "w") as f:
            f.write(body)
    return paths, {"fp32": name, "serving": served}


def reference_pth(dev, path, n_anchors=2):
    """MoTIF (`n_anchors`) at full width with build_request's weights (seed
    0, DCN offsets perturbed from seed 1), saved as the reference saves a
    checkpoint: DataParallel's `module.` prefix, the fixed blur's
    `g_filter` and a {"state_dict": ...} wrapper."""
    from motif_tpu_torch.models.motif import build_motif

    model = build_motif(channel=64, front_rbs=5, back_rbs=40, device=dev,
                        seed=0, n_anchors=n_anchors)
    perturb_offsets(model, seed=1)
    sd = {f"module.{k}": v.detach().cpu()
          for k, v in model.state_dict().items()}
    sd["module.g_filter.weight"] = torch.ones(3, 1, 5, 5)
    torch.save({"state_dict": sd}, path)


def cli_run(tmp, yml, pth, clips=4):
    """`python -m motif_tpu_torch.test -opt yml --checkpoint pth
    --max_clips clips` run in `tmp` with the Vid4 dataroots as overrides:
    its summary and the clock of its `infer` calls (with their frames)."""
    from motif_tpu_torch import test as cli
    from motif_tpu_torch.eval import Evaluator

    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        summary, clock = clocked(Evaluator, lambda: cli.main(
            ["-opt", yml, "--checkpoint", pth, "--max_clips", str(clips)],
            overrides={"dataroot_GT": os.path.join(VID4, "HR"),
                       "dataroot_LQ": os.path.join(VID4, "LR")}))
    finally:
        os.chdir(cwd)
    return summary, clock


def read_npys(tmp, stem):
    """The per-frame PSNRs and SSIMs (clips x frames) a CLI run wrote."""
    return tuple(np.load(os.path.join(tmp, "psnrs", f"{stem}{suffix}.npy"),
                         allow_pickle=True).astype(np.float64)
                 for suffix in ("", "_ssim"))


def eval_cli(tmp, config, yml, stem, pth, mods, per_clip=None,
             frames_shape=(3, 1, 64, 96, 3), clips=4, clipped=True):
    """The CLI over an eval yml in one configuration on its first `clips`
    clips, with the kernels (the launch counters set to 0 just before and
    read just after) and with the plain versions, held against each other.
    `per_clip`: what a clip must launch (one forward of
    EVAL_ENTRIES[config] by default); the frames of each clip's `infer`
    have `frames_shape` (in [0, 1] where `clipped`)."""
    softsplat, dcn, siren_kernel, kernels = mods
    gate = EVAL_GATES[config]
    obs.reset(obs.LAUNCHES)
    summary, clock = cli_run(tmp, yml, pth, clips)
    launches, entries = launch_counts(), entry_counts()
    psnrs, ssims = read_npys(tmp, stem)
    with plain_versions(softsplat, dcn, siren_kernel):
        obs.reset(obs.LAUNCHES)
        summary_p, clock_p = cli_run(tmp, yml, pth, clips)
        if any(launch_counts().values()):
            raise AssertionError("the plain CLI run launched a kernel")
    psnrs_p, ssims_p = read_npys(tmp, stem)
    n = summary["n_clips"]
    want = {k: v * n for k, v in (EVAL_ENTRIES[config] if per_clip is None
                                  else per_clip).items()}
    frames_err = max(float(np.abs(a - b).max())
                     for a, b in zip(clock.frames, clock_p.frames))
    frames_db = min(psnr(a, b) for a, b in zip(clock.frames, clock_p.frames))
    psnr_err = float(np.abs(psnrs - psnrs_p).max())
    ssim_err = float(np.abs(ssims - ssims_p).max())
    infer_s, metrics_s = clock.seconds()
    emit({"phase": "eval_cli", "config": config, "yml": os.path.basename(yml),
          "summary": summary, "summary_plain": summary_p,
          "clip_psnr": psnrs.mean(1).tolist(), "clip_ssim": ssims.mean(1).tolist(),
          "frames_max_abs_err": frames_err, "frames_min_psnr_db": frames_db,
          "frame_psnr_max_abs_err_db": psnr_err,
          "frame_ssim_max_abs_err": ssim_err, "gates": gate,
          "entry_launches": entries, "launches": launches,
          "clip_infer_s": infer_s, "clip_metrics_s": metrics_s,
          "clip_infer_s_plain": clock_p.seconds()[0]})
    finite = all(np.isfinite(v) for s in (summary, summary_p)
                 for v in s.values())
    if not (n == summary_p["n_clips"] == clips and len(clock.frames) == clips
            and finite and np.isfinite(psnrs).all()
            and np.isfinite(ssims).all()):
        raise AssertionError(f"eval CLI ({config}): {n} clips, summaries "
                             f"{summary} / {summary_p}")
    if entries != want or not all(launches[k.split("/")[0]] for k in want):
        raise AssertionError(f"eval CLI ({config}) launched {entries} "
                             f"(wanted {want})")
    for frames in clock.frames:
        check_frames(f"eval {config}", frames, frames_shape, clipped)
    hold_eval(f"eval CLI ({config}) kernels vs plain", gate, frames_err,
              frames_db, psnr_err, ssim_err)
    return entries, (clock_p.frames, psnrs_p, ssims_p)


def within(gate, frames_err, frames_db, psnr_err, ssim_err) -> bool:
    return (frames_err <= gate["frames"] and psnr_err <= gate["psnr_db"]
            and ssim_err <= gate["ssim"]
            and (gate["min_psnr"] is None or frames_db >= gate["min_psnr"]))


def hold_eval(what, gate, frames_err, frames_db, psnr_err, ssim_err):
    if not within(gate, frames_err, frames_db, psnr_err, ssim_err):
        raise AssertionError(
            f"{what}: frames {frames_err} ({frames_db} dB), frame PSNR "
            f"{psnr_err} dB, SSIM {ssim_err} (gates {gate})")


def eval_planted_faults(tmp, yml, stem, pth, plain, mods):
    """The serving CLI with each of PLANTED_FAULTS in place of its kernel
    wrapper, held against the plain run (`plain`: its frames, per-frame
    PSNRs and SSIMs): the serving gate must refuse every fault marked so."""
    import functools

    frames, psnrs0, ssims0 = plain
    gate = EVAL_GATES["serving"]
    modules = {"softsplat": mods[0], "dcn": mods[1]}
    passed = []
    for name, (module, wrapper, fault, must_refuse) in PLANTED_FAULTS.items():
        mod = modules[module]
        wrong = functools.partial(fault, getattr(mod, wrapper))
        with mock.patch.object(mod, wrapper, wrong):
            _, clock = cli_run(tmp, yml, pth)
        psnrs, ssims = read_npys(tmp, stem)
        d = (max(float(np.abs(a - b).max())
                 for a, b in zip(clock.frames, frames)),
             min(psnr(a, b) for a, b in zip(clock.frames, frames)),
             float(np.abs(psnrs - psnrs0).max()),
             float(np.abs(ssims - ssims0).max()))
        emit({"phase": "eval_planted_fault", "fault": name,
              "must_refuse": must_refuse, "frames_max_abs_err": d[0],
              "frames_min_psnr_db": d[1], "frame_psnr_max_abs_err_db": d[2],
              "frame_ssim_max_abs_err": d[3],
              "refused_by": {"psnr_db": d[2] > gate["psnr_db"],
                             "ssim": d[3] > gate["ssim"]},
              "gates": gate})
        if must_refuse and within(gate, *d):
            passed.append(name)
    if passed:
        raise AssertionError(f"the serving gate passed the planted faults "
                             f"{passed}")


def eval_bench_shape(dev, card, pth, mods):
    """Evaluator.run at the bench shape (LQ 64x112 → GT 256x448, 3 times)
    over a seeded in-memory loader of 2 clips, in both configurations, with
    per-clip seconds in `infer` and in the metrics."""
    from motif_tpu_torch.checkpoint import load_reference_checkpoint
    from motif_tpu_torch.eval import Evaluator
    from motif_tpu_torch.models.motif import build_motif

    kernels = mods[3]
    h, w = BENCH_LQ
    rng = np.random.default_rng(2)
    clips = [{"lq": rng.random((1, 4, h, w, 3), dtype=np.float32),
              "gt": rng.random((1, 5, 4 * h, 4 * w, 3), dtype=np.float32),
              "times": np.asarray([[0.0, 0.5, 1.0]], np.float32)}
             for _ in range(2)]
    model = build_motif(channel=64, front_rbs=5, back_rbs=40, device=dev,
                        seed=5)
    load_reference_checkpoint(model, pth)
    for config, knobs in (("fp32", {}), ("serving", SERVING)):
        ev = Evaluator(model, scale=4, iters=4, chunk=3, family="Ours",
                       device=dev, **knobs)
        ev.infer(clips[0]["lq"], clips[0]["times"], (4 * h, 4 * w))  # warm-up
        obs.reset(obs.LAUNCHES)
        res, clock = clocked(Evaluator, lambda: ev.run(iter(clips)))
        launches = launch_counts()
        infer_s, metrics_s = clock.seconds()
        s = res.summary()
        emit({"phase": "eval_bench_shape", "config": config, "card": card,
              "clips": len(clips), "summary": s,
              "clip_infer_s": infer_s, "clip_metrics_s": metrics_s,
              "launches": launches, "buckets": len(ev._buckets),
              "pool_bytes": pool_bytes(ev),
              "note": f"Evaluator.run, LQ 1x4x{h}x{w} -> GT 1x5x{4 * h}x"
                      f"{4 * w}, 3 times, iters 4; host clock; metrics = from "
                      "infer's return to the next clip (L1, Y-PSNR, 3 SSIMs)"})
        ran = {k.split("/")[0] for k in EVAL_ENTRIES[config]}
        if s["n_clips"] != 2 or not all(np.isfinite(v) for v in s.values()) \
                or not all(launches[k] for k in ran):
            raise AssertionError(f"eval at the bench shape ({config}): {s}, "
                                 f"launches {launches}")


def run_eval(dev, card, mods):
    """The eval harness on the card: the CLI over test.yml in both
    configurations against its plain versions, Evaluator.run at the bench
    shape, then the serving gate against planted faults."""
    import tempfile

    import cv2
    import yaml

    emit({"phase": "eval_readers", "png_decoder": f"cv2 {cv2.__version__}",
          "yml_reader": f"yaml.safe_load {yaml.__version__}"})
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        pth = os.path.join(tmp, "best.pth")
        reference_pth(dev, pth)
        ymls, stems = eval_ymls(tmp)
        entries, runs = {}, {}
        for name in ("fp32", "serving"):
            entries[name], runs[name] = eval_cli(tmp, name, ymls[name],
                                                 stems[name], pth, mods)
        eval_bench_shape(dev, card, pth, mods)
        eval_planted_faults(tmp, ymls["serving"], stems["serving"], pth,
                            runs["serving"], mods)
    emit({"phase": "eval", "seconds": time.perf_counter() - t0})
    return entries


# ---------------------------------------------------------------------------
# phase 7: training
# ---------------------------------------------------------------------------

# the float32 entries a training step runs: 1 splat, 42 DCNs, 3 SIRENs
TRAIN_ENTRIES = {"splat_fused/float32/C=130": 1, "dcn_im2col/float32": 42,
                 "siren_mlp/float32/whole": 3}
TRAIN_STEPS, RESUME_STEPS = 3, 1
# a step of the kernels against the same step with the plain versions, TF32
# off: the loss relative, each parameter's gradient relative to its
# tensor's largest |g|. Readings on an H100 (one run): loss equal, gradients
# 3.8e-5 (use_gt True) and 1.2e-4 (False), at encoder convs; a splat
# backward that drops the flow gradient 4.8e-3 (flow_imnet's first layer)
TRAIN_GATES = dict(loss_rel=1e-5, grad_rel=1e-3)
BACKWARDS = {"splat_fused": "splat_fused.backward",
             "dcn_im2col": "dcn_im2col.backward",
             "siren_mlp": "siren_mlp.backward"}


def train_yml(tmp: str, which: str = "Ours", vimeo: str | None = None,
              steps: int = TRAIN_STEPS) -> str:
    """configs/train_smoke.yml with the shapes of the reference recipe
    train_Ours_vimeo.yml (nf 64, setting 5, iters 12, batch 8, GT 128, 7
    frames, 200 passes an epoch) for the model `which`: the recipe's own
    Ours_44 (four anchors, on the precomputed flows under `vimeo`, which
    the CLI loads by default for it) in phase 8, the two-anchor Ours (the
    live RAFT teacher, on the repository's data/vimeo) in phase 7; teacher
    forcing decaying over 4 steps so that both branches run, `steps`
    steps, a log line a step and a save every 3 steps, under `tmp`."""
    import yaml

    with open(os.path.join(ROOT, "configs", "train_smoke.yml")) as f:
        opt = yaml.safe_load(f)
    vimeo = vimeo or os.path.join(ROOT, "data", "vimeo")
    opt["dataset_ratio"] = 200
    opt["datasets"]["train"].update(
        dataroot_GT=os.path.join(vimeo, "GT"),
        dataroot_LQ=os.path.join(vimeo, "LR"),
        cache_keys=os.path.join(vimeo, "keys.txt"), N_frames=7,
        batch_size=8, GT_size=128)
    opt["network_G"].update(which_model_G=which, nf=64, setting=5, iters=12)
    opt["path"] = {"root": tmp}
    opt["train"].update(niter=steps, teacher_forcing_steps=4)
    opt["logger"] = {"print_freq": 1, "save_checkpoint_freq": 3}
    path = os.path.join(tmp, "train.yml")
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return path


def grad_gate(model, kernel_grads, plain_grads, loss, plain_loss):
    """The largest distances of a step from its plain twin: the loss
    relative, and each parameter's gradient relative to the plain one's
    largest |g| (a gradient zero in the plain step must be zero)."""
    worst, where = 0.0, None
    for (name, _), a, b in zip(model.named_parameters(), kernel_grads,
                               plain_grads):
        scale = float(b.abs().max())
        err = float((a.double() - b.double()).abs().max())
        rel = err / scale if scale > 0 else (0.0 if err == 0 else np.inf)
        if rel > worst:
            worst, where = rel, name
    loss_rel = abs(loss - plain_loss) / abs(plain_loss)
    return {"loss_rel": loss_rel, "grad_rel": worst, "grad_rel_at": where,
            "ok": (loss_rel <= TRAIN_GATES["loss_rel"]
                   and worst <= TRAIN_GATES["grad_rel"])}


def upstream_nonzero(model) -> dict:
    """Whether the parameters upstream of each kernel took a gradient: the
    splat's payload (imnet) and flow (flow_imnet), every DCN's offset and
    mask conv, every SIREN's layers and the flow-context convs before the
    first. A gradient cut at a kernel leaves its group at zero. Ours_7
    (`linear_motion`) runs neither the STINF nor the flow-context convs,
    and its motion takes no gradient. A LIIF (VideoINR) has no splat: its
    DCNs and its three SIRENs."""
    from motif_tpu_torch.models.pcd import DCNSep

    def nz(params):
        return all(float(p.grad.abs().max()) > 0 for p in params)
    dcns = [m for m in model.modules() if isinstance(m, DCNSep)]
    if not hasattr(model, "imnet"):
        return {"dcn_im2col": len(dcns) > 0 and all(
                    nz(m.conv_offset_mask.parameters()) for m in dcns),
                "siren_mlp": all(nz(net.parameters()) for net in (
                    model.feat_imnet, model.flow_imnet,
                    model.encode_imnet))}
    linear = getattr(model, "linear_motion", False)
    sirens = (model.imnet, model.synth_net) + (
        () if linear else (model.flow_imnet,))
    return {
        "splat_fused": nz(model.imnet.parameters())
        and (linear or nz(model.flow_imnet.parameters())),
        "dcn_im2col": len(dcns) > 0 and all(
            nz(m.conv_offset_mask.parameters()) for m in dcns),
        "siren_mlp": all(nz(net.parameters()) for net in sirens)
        and (linear or nz(model.flow_process.parameters())),
    }


def _drop_flow_grad(softsplat):
    real = softsplat.splat_fused_backward_plain

    def faulty(*a, **kw):
        d_img, d_flow, d_z = real(*a, **kw)
        return d_img, torch.zeros_like(d_flow), d_z
    return mock.patch.object(softsplat, "splat_fused_backward_plain", faulty)


def profile_train_step(trainer, batch, out_dir, mods):
    """One training step under torch.profiler: the device ms of each plain
    backward (its record_function range: every kernel it launched), the
    step's device kernels and busy time against its wall time; the table
    goes to `out_dir` when given. Each plain backward's calls in that step
    are also kept and replayed, timed by CUDA events (`event_ms`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    softsplat, dcn, siren_kernel, _ = mods
    fns = {"splat_fused": (softsplat, "splat_fused_backward_plain"),
           "dcn_im2col": (dcn, "dcn_im2col_backward_plain"),
           "siren_mlp": (siren_kernel, "siren_mlp_backward_plain")}
    calls = {k: [] for k in fns}

    def keep(k, real):
        def f(*a):
            calls[k].append(a)
            return real(*a)
        return f
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        for k, (mod, name) in fns.items():
            stack.enter_context(mock.patch.object(
                mod, name, keep(k, getattr(mod, name))))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            trainer.step(batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    avg = prof.key_averages()
    # a range's host-side event sums the device time of the kernels its ops
    # launched; its device-side twin (a user annotation) spans the gaps too
    back = {k: {"device_ms": 0.0, "calls": 0} for k in BACKWARDS}
    for e in avg:
        for k, rng in BACKWARDS.items():
            if e.key == rng and e.device_type == DeviceType.CPU:
                back[k] = {"device_ms": e.device_time_total / 1e3,
                           "calls": e.count}
    for k, (mod, name) in fns.items():
        fn = getattr(mod, name)
        back[k]["event_ms"] = cuda_ms(lambda: [fn(*a) for a in calls[k]],
                                      reps=3, warmup=1)
        back[k]["kept_calls"] = len(calls[k])
    del calls
    device = [e for e in avg if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    prof_stats = {"device_kernels": sum(e.count for e in device),
                  "device_busy_ms": busy_ms, "wall_ms_profiled": wall_ms,
                  "top_device": [[e.key[:70], e.self_device_time_total / 1e3,
                                  e.count] for e in sorted(
                                      device, key=lambda e:
                                      -e.self_device_time_total)[:12]]}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "train_step.txt"), "w") as f:
            f.write(avg.table(sort_by="device_time_total", row_limit=60))
    return back, prof_stats


def train_cli(yml, opt, kernels, entries, card, tag, steps=None,
              resume_steps=None, branches=(True, False)):
    """The training CLI on `yml` (its `niter` steps), the launch counters
    set to 0 just before and read just after: `entries` a step and no
    other entry, the steps' use_gt taking the values `branches` (LIIF: only
    False); then a resume for `resume_steps` more (0: none). Returns the
    launches per step of every entry."""
    from motif_tpu_torch import checkpoint, train

    steps = steps or TRAIN_STEPS
    resume_steps = RESUME_STEPS if resume_steps is None else resume_steps
    models = opt["path"]["models"]
    log_path = os.path.join(opt["path"]["experiments_root"], "train_log.jsonl")
    obs.reset(obs.LAUNCHES)
    t1 = time.perf_counter()
    train.main(["-opt", yml])
    cli_s = time.perf_counter() - t1
    launches = entry_counts()
    if checkpoint.latest_step(models) != steps:
        raise AssertionError(f"{tag}: no final train state")
    log = [json.loads(ln) for ln in open(log_path)]
    if [ln["step"] for ln in log] != list(range(1, steps + 1)) or \
            {ln["use_gt"] for ln in log} != set(branches) or \
            not all(np.isfinite(ln["loss"]) for ln in log):
        raise AssertionError(f"{tag}: log {log}")
    per_step = {k: launches.get(k, 0) / steps
                for k in {*ENTRIES, *launches, *entries}}
    for entry, n in entries.items():
        if per_step[entry] != n:
            raise AssertionError(f"{tag}: {entry} launched {per_step[entry]} "
                                 f"times a step, not {n}")
    if sum(launches.values()) != steps * sum(entries.values()):
        raise AssertionError(f"{tag}: other entries ran {launches}")
    t1 = time.perf_counter()
    if resume_steps:
        train.main(["-opt", yml, "--max_steps", str(steps + resume_steps)])
    resume_s = time.perf_counter() - t1
    log2 = [json.loads(ln) for ln in open(log_path)]
    if [ln["step"] for ln in log2[steps:]] != list(
            range(steps + 1, steps + resume_steps + 1)) or \
            checkpoint.latest_step(models) != steps + resume_steps:
        raise AssertionError(f"{tag}: resume log {log2}")
    emit({"phase": f"{tag}_cli", "card": card, "steps": steps,
          "seconds": cli_s, "resume_steps": resume_steps,
          "resume_seconds": resume_s,
          "losses": [ln["loss"] for ln in log2],
          "s_per_it": [ln["s_per_it"] for ln in log2],
          "use_gt": [ln["use_gt"] for ln in log2],
          "lr": [ln["lr"] for ln in log2],
          "launches": launches, "launches_per_step": per_step})
    return per_step


def train_steps_by_part(dev, opt, card, tag):
    """A Trainer on the yml's model and data (`train.setup`): a warm-up
    step, then three steps split into forward, backward and optimiser,
    their peak memory and HR frames/s. Returns (trainer, model, the batch
    iterator)."""
    from motif_tpu_torch import train
    from motif_tpu_torch.data import device_prefetch

    net = opt["network_G"]
    model, loader, tr = train.setup(opt, dev)
    ds_opt = opt["datasets"]["train"]
    B, N, gt = ds_opt["batch_size"], ds_opt["N_frames"], ds_opt["GT_size"]
    batches = device_prefetch(loader.epoch(0), dev)
    tr.step(next(batches))                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    parts = [tr.step(next(batches), sync_times=True)["ms"]
             for _ in range(3)]
    peak = torch.cuda.max_memory_allocated(dev)
    ms = {k: float(np.median([p[k] for p in parts])) for k in parts[0]}
    step_ms = sum(ms.values())
    emit({"phase": f"{tag}_step", "card": card, "model":
          net["which_model_G"], "batch": B, "times": N, "gt": gt,
          "lq": gt // 4, "ms_median_of_3": ms, "step_ms": step_ms,
          "ms_runs": parts, "peak_memory_gb": peak / 1e9,
          "hr_frames_per_s": B * N / (step_ms / 1e3)})
    return tr, model, batches


def checkpoint_round_trip(tmp, models, card, yml=None,
                          tag="checkpoint_round_trip"):
    """The eval CLI (`yml`, default test.yml fp32, one Vid4 clip) through
    `--checkpoint` on the models root the training CLI wrote (read at its
    newest step), on that step's file and on a path that does not exist
    (the random init from seed 0, the weights the training started from):
    the root and the file give the same frames (EVAL_GATES fp32), the init
    other frames."""
    from motif_tpu_torch import checkpoint

    yml = yml or eval_ymls(tmp)[0]["fp32"]
    step = checkpoint.latest_step(models)
    frames, summaries = {}, {}
    for what, path in (("root", models),
                       ("step", os.path.join(models, f"step_{step}")),
                       ("init", os.path.join(tmp, "absent.pth"))):
        summaries[what], clock = cli_run(tmp, yml, path, clips=1)
        frames[what] = clock.frames[0]
    same = float(np.abs(frames["root"] - frames["step"]).max())
    moved = float(np.abs(frames["root"] - frames["init"]).max())
    emit({"phase": tag, "card": card, "step": step,
          "yml": os.path.basename(yml),
          "root_vs_step_max_abs_err": same,
          "tol": EVAL_GATES["fp32"]["frames"],
          "trained_vs_init_max_abs": moved, "min_trained_vs_init": 1e-3,
          "frames_shape": list(frames["root"].shape),
          "psnr": {k: v["psnr"] for k, v in summaries.items()}})
    if not (same <= EVAL_GATES["fp32"]["frames"] and moved > 1e-3
            and np.isfinite(frames["root"]).all()):
        raise AssertionError(f"{tag}: the models root against its step "
                             f"file {same}, the trained frames against the "
                             f"init's {moved}")


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms and cuDNN's, as the training gates'
    state needs them: an op without a deterministic CUDA path raises."""
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy())
    return h.hexdigest()[:16]


def gate_state(dev, opt, mods, rng=None):
    """The state the training gates start from, the same bit for bit in
    every run: the yml's model from seed 0, a Trainer from the yml's seed
    (0), the loader's order and the dataset's draws from seed 0 (an
    arbitrary-scale collate's from `rng`), a warm-up step and three steps
    on the plain versions under `deterministic()` (`train.setup`).
    Returns (trainer, model, the next batch, the hashes of the parameters
    and of that batch)."""
    from motif_tpu_torch import train
    from motif_tpu_torch.data import device_prefetch

    softsplat, dcn, siren_kernel, _ = mods
    model, loader, tr = train.setup(opt, dev, rng=rng, dataset_seed=0)
    batches = device_prefetch(loader.epoch(0), dev)
    with plain_versions(softsplat, dcn, siren_kernel), deterministic():
        for _ in range(4):
            tr.step(next(batches))
    batch = next(batches)
    batches.close()
    arrays = [torch.as_tensor(v) for _, v in sorted(batch.items())
              if isinstance(v, (torch.Tensor, np.ndarray))]
    return tr, model, batch, {"params": digest(tr.params),
                              "batch": digest(arrays)}


def train_gates(dev, opt, mods, card, tag, rng=None, upstream_all=True,
                branches=(True, False)):
    """At `gate_state`'s state (its hashes printed), a step of the kernels
    against the same step with the plain versions, same weights and batch,
    for use_gt True and False (the loss and every gradient, TRAIN_GATES),
    every kernel's upstream parameters with a non-zero gradient wherever
    the plain step gives them one, and everywhere with `upstream_all`;
    all under `deterministic()`, where two plain steps must be bit-equal
    (for each of `branches`: LIIF has only use_gt False). Returns the
    trainer, model and batch, the plain use_gt=False gradients and aux."""
    softsplat, dcn, siren_kernel, _ = mods
    t0 = time.perf_counter()
    tr, model, batch, hashes = gate_state(dev, opt, mods, rng)
    state_s = time.perf_counter() - t0
    for use_gt in branches:
        with deterministic():
            aux = tr.compute_grads(batch, use_gt)
            got = [p.grad.clone() for p in tr.params]
            nonzero = upstream_nonzero(model)
            with plain_versions(softsplat, dcn, siren_kernel):
                again = tr.compute_grads(batch, use_gt)
                twice = [p.grad.clone() for p in tr.params]
                plain = tr.compute_grads(batch, use_gt)
            want = [p.grad.clone() for p in tr.params]
            plain_nonzero = upstream_nonzero(model)
        gate = grad_gate(model, got, want, float(aux["loss"]),
                         float(plain["loss"]))
        bit_equal = float(again["loss"]) == float(plain["loss"]) and all(
            torch.equal(a, b) for a, b in zip(twice, want))
        emit({"phase": f"{tag}_gate", "use_gt": use_gt, "card": card,
              "state_sha256": hashes, "state_seconds": state_s,
              "loss": float(aux["loss"]),
              "plain_loss": float(plain["loss"]), "gates": TRAIN_GATES,
              "upstream_nonzero": nonzero,
              "upstream_nonzero_plain": plain_nonzero, **gate,
              "plain_twice_bit_equal": bit_equal})
        if not bit_equal:
            raise AssertionError(f"{tag}: two plain steps with use_gt="
                                 f"{use_gt} from the gate's state differ")
        if not gate["ok"]:
            raise AssertionError(f"{tag}: the step with use_gt={use_gt} "
                                 f"fails its gate {gate}")
        if any(plain_nonzero[k] and not nonzero[k] for k in nonzero) or (
                upstream_all and not all(nonzero.values())):
            raise AssertionError(f"{tag}: a kernel cut the gradient "
                                 f"{nonzero} (plain {plain_nonzero})")
    return tr, model, batch, want, plain


def run_train(dev, card, args, mods):
    """Training of the two-anchor Ours at full width: the CLI for
    TRAIN_STEPS steps and a resume, with the launch counters read around
    them; a Trainer's step split by part, peak memory and HR frames/s; one
    profiled step; the gradient gate against the plain versions for both
    teacher-forcing branches, refusing a splat backward that drops the
    flow gradient; the eval CLI on the models the training CLI wrote
    (`checkpoint_round_trip`)."""
    import tempfile

    from motif_tpu_torch.utils import config as cfg

    softsplat, dcn, siren_kernel, kernels = mods
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        yml = train_yml(tmp)
        opt = cfg.parse(yml, is_train=True)
        # ---- the main path: the CLI, counters from 0, then a resume ----
        per_step = train_cli(yml, opt, kernels, TRAIN_ENTRIES, card, "train")

        # ---- a Trainer's step by part, and one profiled step ----
        tr, model, batches = train_steps_by_part(dev, opt, card, "train")
        back, prof_stats = profile_train_step(tr, next(batches),
                                              args.profile, mods)
        emit({"phase": "train_profile", "card": card,
              "plain_backward": back, "profiled_step": prof_stats})

        batches.close()
        del tr, model

        # ---- the gradient gate, and a planted fault: a splat backward
        # that drops the flow gradient ----
        tr, model, batch, want, plain = train_gates(dev, opt, mods, card,
                                                    "train")
        with _drop_flow_grad(softsplat), deterministic():
            aux = tr.compute_grads(batch, False)
        fault = grad_gate(model, [p.grad.clone() for p in tr.params], want,
                          float(aux["loss"]), float(plain["loss"]))
        emit({"phase": "train_planted_fault", "fault": "splat drops d flow",
              "refused": not fault["ok"], **fault})
        if fault["ok"]:
            raise AssertionError("train: the gate passed a splat backward "
                                 "that drops the flow gradient")
        del tr, model
        checkpoint_round_trip(tmp, opt["path"]["models"], card)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    emit({"phase": "train", "seconds": seconds})
    return per_step, back


# ---------------------------------------------------------------------------
# phase 8: the four-anchor MoTIF (Ours_44)
# ---------------------------------------------------------------------------

FOUR = "Ours_44"
TRAIN44_STEPS, RESUME44_STEPS = 3, 1
# the eval CLI over configs/test_vimeo44.yml on its first Vid4 clip (7
# one-time forwards)
EVAL44_CLIPS = 1
# training shapes of the recipe (batch 8, N 7, GT 128) for four anchors:
# the splat over 4 * 8 * 7 = 224 images of 128², the STINF over as many
# tokens; the DCNs of the PCD's L1 over the 3 frame pairs of 8 clips at
# 32² and of a request's 3 pairs at 64x112
SPLAT44 = (224, 128, 128, 130)
STINF44 = {"stinf_train44": (67, [64, 64, 256], 3, 224 * 128 * 128)}
DCN44 = {"train44_L1": (24, 32, 32), "request_h_L1": (3, 64, 112)}


def per_forward(dcns: int, config: str) -> dict:
    """What one four-anchor forward launches in a configuration: `dcns`
    DCNs (read from request (h)'s counters), three SIRENs, one splat."""
    if config == "fp32":
        return {"dcn_im2col/float32": dcns, "siren_mlp/float32/whole": 3,
                "splat_fused/float32/C=130": 1}
    return {"dcn_im2col/bfloat16": dcns, "siren_mlp/bfloat16/skip_first": 3,
            "splat_fused/float16/C=64": 1, **PREACTS}


def per_request(dcns: int, config: str, chunks: int) -> dict:
    """What a four-anchor request of `chunks` chunks launches through
    Evaluator.infer: the trunk's DCNs once, a forward's SIRENs and splat
    once a chunk."""
    return {k: v if k.startswith("dcn_im2col") else v * chunks
            for k, v in per_forward(dcns, config).items()}


def build_request44(dev, **knobs):
    """MoTIF(n_anchors=4) at full width with build_request's weights (seed
    0, DCN offsets perturbed from seed 1) and its Evaluator (family
    Ours_44: one time a forward)."""
    from motif_tpu_torch.eval import Evaluator
    from motif_tpu_torch.models.motif import build_motif

    model = build_motif(channel=64, front_rbs=5, back_rbs=40, device=dev,
                        seed=0, n_anchors=4, **knobs)
    perturb_offsets(model, seed=1)
    return model, Evaluator(model, scale=4, iters=4, family=FOUR, device=dev)


def raft_counter(model):
    """(the batch sizes of RAFT's forwards on `model`, its hook)."""
    calls = []
    hook = model.flow_predictor.register_forward_hook(
        lambda mod, inp, out: calls.append(int(inp[0].shape[0])))
    return calls, hook


def run_requests44(dev, card, mods):
    """Requests (h) (fp32) and (i) (the serving knobs): four LQ frames of
    64x112 -> 256x448, 3 times, iters 4, each time its own forward with
    RAFT on the 12 cross pairs. Each counted alone; (i) against (h), each
    against its plain versions; each replayed against eager and timed
    eager and captured in turns. Returns the entries each launched and the
    DCNs of one forward."""
    softsplat, dcn, siren_kernel, kernels = mods
    t0 = time.perf_counter()
    model_h, ev_h = build_request44(dev)
    model_i, ev_i = build_request44(dev, **SERVING)
    lq = np.random.default_rng(0).random((1, 4, 64, 112, 3), dtype=np.float32)
    t3 = np.linspace(0, 1, 3, dtype=np.float32)[None]
    entries, rafts, frames = {}, {}, {}
    for name, model, ev in (("h", model_h, ev_h), ("i", model_i, ev_i)):
        obs.reset(obs.LAUNCHES)
        frames[name], _ = ev.infer(lq, t3, (256, 448))
        entries[name] = entry_counts()
        check_frames(name, frames[name], (3, 1, 256, 448, 3))
        # RAFT's batches, on an eager request (a replay runs no hook)
        calls, hook = raft_counter(model)
        eager(ev)(lq, t3, (256, 448))
        hook.remove()
        rafts[name] = calls
    dcns = entries["h"].get("dcn_im2col/float32", 0)
    want = {"h": per_request(dcns, "fp32", 3),
            "i": per_request(dcns, "serving", 3)}
    emit({"phase": "requests44", "model": FOUR, "entries": entries,
          "dcn_per_forward": dcns, "raft_batches": rafts,
          "seconds": time.perf_counter() - t0})
    if entries != want or rafts != {"h": [12] * 3, "i": [12] * 3}:
        raise AssertionError(f"requests (h), (i) launched {entries} (wanted "
                             f"{want}), RAFT batches {rafts}")
    hold_against("i", frames["i"], frames["h"], 6e-2, 35.0)
    slice_vs_plain(ev_h, model_h, lq, t3, "h", 1e-5, 1e-5, mods)
    slice_vs_plain(ev_i, model_i, lq, t3, "i", 6e-2, 1e-2, mods)
    # the splat on the requests' own inputs: 4 images a forward
    check_splat_request(softsplat, kernels,
                        capture_splat(ev_h, softsplat, lq, t3), "h")
    check_splat_request(softsplat, kernels,
                        capture_splat(ev_i, softsplat, lq, t3), "i")
    preacts = check_preacts(capture_preacts(ev_i, lq, t3), "i")

    replay = {"h": hold_replay(ev_h, lq, t3, "h", 1e-5, 1e-5, card),
              "i": hold_replay(ev_i, lq, t3, "i", 6e-2, 1e-2, card)}
    for name, knobs in (("h", {}), ("i", SERVING)):
        r = replay[name]
        ms = r["captured_ms_median"]
        emit({"phase": f"request_{name}_time", "card": card, "model": FOUR,
              "forward_ms_median": ms, "hr_frames_per_s": 3e3 / ms,
              "forward_ms": r["captured_ms"],
              "eager_ms_median": r["eager_ms_median"],
              "eager_hr_frames_per_s": 3e3 / r["eager_ms_median"],
              "knobs": knobs, "launches_per_request": entries[name],
              "device_busy_share": r["device_busy_share"],
              "note": "Evaluator.infer wall time incl. host copy-out, TF32 "
                      "off, iters 4, LQ 4x64x112 -> HR 256x448, 3 times one "
                      "a forward; captured and eager in turns (`replay`)"})
    del model_h, model_i, ev_h, ev_i
    torch.cuda.empty_cache()
    return entries, dcns, preacts


def run_eval44(dev, card, mods, dcns):
    """The eval CLI over configs/test_vimeo44.yml (Vimeo_test_44 on the
    first EVAL44_CLIPS data/Vid4 clips: the septuplet LQ 16x24 -> 7 times
    at 64x96, one a forward) from a reference-format Ours_44 .pth, fp32
    and with the serving knobs, each against its plain versions
    (EVAL_GATES)."""
    import tempfile

    t0 = time.perf_counter()
    entries = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        pth = os.path.join(tmp, "best44.pth")
        reference_pth(dev, pth, n_anchors=4)
        ymls, stems = eval_ymls(tmp, os.path.join("configs",
                                                  "test_vimeo44.yml"),
                                "vimeo44")
        for config in ("fp32", "serving"):
            entries[config], _ = eval_cli(
                tmp, config, ymls[config], stems[config], pth, mods,
                per_clip=per_request(dcns, config, 7),
                frames_shape=(7, 1, 64, 96, 3), clips=EVAL44_CLIPS)
    emit({"phase": "eval44", "seconds": time.perf_counter() - t0})
    return entries


def run_train44(dev, card, mods, dcns, profile=None):
    """Training of Ours_44 as the reference recipe does: data/vimeo copied
    into a temporary directory, its flow files written there by `python -m
    motif_tpu_torch.precompute_flows` with the RAFT of the smoke's seeded
    Ours_44 (a reference-format .pth), then the CLI on
    train_Ours_vimeo.yml's shapes for TRAIN44_STEPS steps and a resume,
    RAFT counted (it must not run); a Trainer's step by part and one
    profiled step (its table into the directory `profile` when given); the
    gradient gate against the plain versions for both teacher-forcing
    branches. Returns the launches per step and the plain backwards."""
    import shutil
    import tempfile

    from motif_tpu_torch.models.raft import RAFT
    from motif_tpu_torch.utils import config as cfg

    kernels = mods[3]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        vimeo = shutil.copytree(os.path.join(ROOT, "data", "vimeo"),
                                os.path.join(tmp, "vimeo"))
        pth = os.path.join(tmp, "best44.pth")
        reference_pth(dev, pth, n_anchors=4)
        t1 = time.perf_counter()
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
        tool = subprocess.run(
            [sys.executable, "-m", "motif_tpu_torch.precompute_flows",
             "--gt_root", os.path.join(vimeo, "GT"),
             "--lq_root", os.path.join(vimeo, "LR"),
             "--keys", os.path.join(vimeo, "keys.txt"),
             "--checkpoint", pth, "--iters", "12"],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        if tool.returncode != 0:
            raise AssertionError(f"precompute_flows failed: {tool.stderr}")
        flows = {}
        with open(os.path.join(vimeo, "keys.txt")) as f:
            for key in (ln.strip() for ln in f if ln.strip()):
                lr = np.load(os.path.join(vimeo, "LR", key, "lr_flow_12.npy"))
                hr = np.load(os.path.join(vimeo, "GT", key, "hr_gt_flow.npy"))
                if lr.shape != (16, 2, 32, 32) or hr.shape != (28, 2, 128, 128) \
                        or not (np.isfinite(lr).all() and np.isfinite(hr).all()):
                    raise AssertionError(f"flow files of {key}: {lr.shape}, "
                                         f"{hr.shape}")
                flows[key] = {"lr_abs_mean": float(np.abs(lr).mean()),
                              "hr_abs_mean": float(np.abs(hr).mean())}
        emit({"phase": "flow_tool", "card": card, "seconds":
              time.perf_counter() - t1, "clips": flows,
              "stdout": tool.stdout.strip().splitlines()})

        raft_calls = []
        forward = RAFT.forward

        def counted(self, *a, **kw):
            raft_calls.append(1)
            return forward(self, *a, **kw)
        yml = train_yml(tmp, FOUR, vimeo, TRAIN44_STEPS)
        opt = cfg.parse(yml, is_train=True)
        with mock.patch.object(RAFT, "forward", counted):
            per_step = train_cli(yml, opt, kernels, per_forward(dcns, "fp32"),
                                 card, "train44", TRAIN44_STEPS,
                                 RESUME44_STEPS)
            tr, model, batches = train_steps_by_part(dev, opt, card,
                                                     "train44")
            back, prof_stats = profile_train_step(
                tr, next(batches), profile and os.path.join(profile,
                                                            "ours44"), mods)
            emit({"phase": "train44_profile", "card": card,
                  "plain_backward": back, "profiled_step": prof_stats})
            batches.close()
            del tr, model
            tr, model, batch, _, _ = train_gates(dev, opt, mods, card,
                                                 "train44")
            shapes = {k: list(batch[k].shape) for k in ("flow", "flow_gt")}
        ds = opt["datasets"]["train"]
        B, N, gt = ds["batch_size"], ds["N_frames"], ds["GT_size"]
        want = {"flow": [B, 16, gt // 4, gt // 4, 2],
                "flow_gt": [B, N, 4, gt, gt, 2]}
        emit({"phase": "train44_raft", "raft_forwards": len(raft_calls),
              "batch_flows": shapes})
        if raft_calls or shapes != want:
            raise AssertionError(f"train44: RAFT ran {len(raft_calls)} "
                                 f"times, batch flows {shapes}")
        del tr, model
    torch.cuda.empty_cache()
    emit({"phase": "train44", "seconds": time.perf_counter() - t0})
    return per_step, back


def grads_of(fn, inputs, cotangents):
    """d(sum of outputs x cotangents) / d inputs, through fn."""
    ts = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * c).sum() for o, c in zip(outs, cotangents))
    return torch.autograd.grad(loss, ts)


def hold_backward(name, fn, fn_plain, inputs, cotangents, card, bits=None,
                  tag=None):
    """An entry's autograd Function (the kernel forward, its plain
    backward) against autograd through the plain version at a training
    shape: each gradient within 1e-5 of its largest value (the card tests'
    gate), or for a low-precision entry (`bits` stored mantissa bits of its
    working type) within 2 of its ulps there; the Function's forward +
    backward ms, the plain version's, and peak memory. Returns the line."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = grads_of(fn, inputs, cotangents)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    want = grads_of(fn_plain, inputs, cotangents)
    errs = [float((a.double() - b.double()).abs().max())
            / float(b.double().abs().max()) for a, b in zip(got, want)]
    # 2 ulps at the largest |g|, relative to it: 2 * 2^-bits at most
    tols = [1e-5 if bits is None else
            2 * ulp(float(b.double().abs().max()), bits)
            / float(b.double().abs().max()) for b in want]
    dtypes = [dname(a.dtype) for a in got]
    del got, want
    ms = cuda_ms(lambda: grads_of(fn, inputs, cotangents), reps=2, warmup=1)
    plain_ms = cuda_ms(lambda: grads_of(fn_plain, inputs, cotangents),
                       reps=2, warmup=1)
    line = {"check": f"{name}_backward", "card": card,
            "shapes": [list(t.shape) for t in inputs], "grad_dtypes": dtypes,
            "grad_rel_errs": errs, "tols": tols, "forward_backward_ms": ms,
            "plain_forward_backward_ms": plain_ms,
            "peak_memory_gb": peak / 1e9}
    if tag:
        line["case"] = tag
    emit(line)
    if not all(e <= t for e, t in zip(errs, tols)):
        raise AssertionError(f"{name} backward at {inputs[0].shape}: {errs} "
                             f"(tols {tols})")
    return line


def check_shapes44(dev, card, mods, Siren):
    """Each entry the four-anchor path runs, at its shapes there: the
    float32 splat over 224 images of 128² (C = 130) and its backward, the
    float32 SIREN at the training step's STINF tokens and its backward,
    the DCN im2col (float32, and bfloat16 for request (i)) over the PCD's
    frame pairs."""
    softsplat, dcn, siren_kernel, kernels = mods
    B, H, W, C = SPLAT44
    g = torch.Generator(device=dev).manual_seed(7)
    img = torch.randn((B, H, W, C), device=dev, generator=g)
    flow = torch.randn((B, H, W, 2), device=dev, generator=g) * 3.0
    z = -(torch.randn((B, H, W, 1), device=dev, generator=g) * 0.5).abs()
    held = hold_splat(softsplat, kernels, img, flow, z, True)
    b_ms, b_by = splat_bound(B, H, W, C, True)

    def run():
        return softsplat.splat_fused(img, flow, z, True)
    ms = device_ms(run, reps=5)
    emit({"check": "splat_fused", "sums": "float32", "case": "train44",
          "shape": [B, H, W, C], "tile": list(softsplat.plan(C, 4)), **held,
          "ms": ms, "eager_ms": cuda_ms(run, reps=5),
          "plain_ms": device_ms(lambda: softsplat.splat_fused_plain(
              img, flow, z, True), reps=2),
          "bound_ms": b_ms, "bound_by": b_by, "fraction_of_bound": b_ms / ms,
          "library_ms": index_add_ms(softsplat, img, flow, z, reps=3),
          "library": "float32 index_add_", "elements": B * H * W * C})
    cot = (torch.randn((B, H, W, C), device=dev, generator=g),
           torch.randn((B, H, W, 1), device=dev, generator=g))
    hold_backward("splat_fused",
                  lambda *a: softsplat.splat_fused(*a, True)[:2],
                  lambda *a: softsplat.splat_fused_plain(*a, True)[:2],
                  (img, flow, z), cot, card)
    del img, flow, z, cot
    torch.cuda.empty_cache()

    check_siren(dev, siren_kernel, Siren, kernels, mlps=STINF44)
    (cin, hidden, cout, n_tok), = STINF44.values()
    torch.manual_seed(3)
    net = Siren(cin, hidden, len(hidden) - 1, cout).to(dev)
    lins = net._linears()
    ws = [m.weight.detach() for m in lins]
    bs = [m.bias.detach() for m in lins]
    x = torch.rand((n_tok, cin), device=dev, generator=g) * 2.0 - 1.0
    n = len(ws)
    hold_backward("siren_mlp",
                  lambda xx, *p: siren_kernel.siren_mlp(xx, p[:n], p[n:]),
                  lambda xx, *p: siren_kernel.siren_mlp_plain(xx, p[:n],
                                                              p[n:]),
                  (x, *ws, *bs),
                  (torch.randn((n_tok, cout), device=dev, generator=g),),
                  card)
    del x, net
    torch.cuda.empty_cache()
    check_dcn(dev, dcn, kernels, shapes=DCN44)
    check_dcn(dev, dcn, kernels, torch.bfloat16,
              {"request_i_L1": DCN44["request_h_L1"]})


def run_four_anchor(dev, card, args, mods, Siren):
    """Phase 8: requests (h) and (i), the test_vimeo44.yml CLI, training
    on precomputed flows, and the entries at the new shapes. Returns the
    launches of each entry on each of its paths and the plain backwards'
    device ms in one Ours_44 step."""
    t0 = time.perf_counter()
    entries, dcns, preacts = run_requests44(dev, card, mods)
    eval_entries = run_eval44(dev, card, mods, dcns)
    train_per_step, back = run_train44(dev, card, mods, dcns, args.profile)
    check_shapes44(dev, card, mods, Siren)
    emit({"phase": "four_anchor", "seconds": time.perf_counter() - t0})
    return {"launches_request_h": entries["h"],
            "launches_request_i": entries["i"],
            "launches_eval_vimeo44": eval_entries,
            "launches_train_step_ours44": train_per_step,
            "plain_backward_ms_train_step_ours44": back,
            "preact_request_i": preacts}


# ---------------------------------------------------------------------------
# phase 9: the baselines
# ---------------------------------------------------------------------------

# each family: its eval yml, and what one request launches of the kernels
# (2 LQ frames 64x112 -> 256x448, 3 times): the ZSM trunk's 42 DCNs (6 in
# the PCD, 36 in the ConvLSTM's), TMNet's 2 more in its comparison stage,
# EDVR's 4 (its PCD and cascade, the frames batched), VideoINR's SIRENs
# per time in 2 + 1 + 4 launches (siren_kernel.segments): 4 single layers
# on the streamed-weight kernel, 3 resident runs
BASELINES = {
    "LIIF": ("test_vid4_liif.yml", {"dcn_im2col/float32": 42,
                                    "siren_mlp/float32/whole": 9,
                                    "siren_mlp/float32/layer": 12}),
    "ZSM": ("test_vid4_zsm.yml", {"dcn_im2col/float32": 42}),
    "TMNet": ("test_vid4_tmnet.yml", {"dcn_im2col/float32": 44}),
    "EDVR": ("test_vid4_edvr.yml", {"dcn_im2col/float32": 4}),
    "Super_SloMo": ("test_vid4_superslomo.yml", {}),
}
# the entries at their new shapes: VideoINR's SIRENs over a request's
# 256x448 tokens, one time; EDVR's DCNs (nf 128: 8 groups of 16) at its
# PCD's three levels of the request's 2 frames
VIDEOINR_SIRENS = {"feat_imnet": (201, [64, 64, 256], 64, 256 * 448),
                   "flow_imnet": (263, [64, 64, 256], 4, 256 * 448),
                   "encode_imnet": (525, [64, 64, 256, 256], 3, 256 * 448)}
EDVR_DCN = {"edvr_L1": (2, 64, 112), "edvr_L2": (2, 32, 56),
            "edvr_L3": (2, 16, 28)}
BASE_LQ = (64, 112)           # a request's LQ; the frames are 4x that


def build_baseline_request(dev, family):
    """The family at its yml's full width and depth (configs/test_vid4_*;
    EDVR nf 128) with random weights from seed 0, DCN offsets perturbed
    from seed 1, and its Evaluator."""
    from motif_tpu_torch.eval import Evaluator
    from motif_tpu_torch.models.factory import define_g
    from motif_tpu_torch.utils import config

    yml = os.path.join(ROOT, "configs", BASELINES[family][0])
    opt = config.parse(yml, is_train=False)
    model = define_g(opt["network_G"], device=dev)
    perturb_offsets(model, seed=1)
    return (model, Evaluator(model, scale=4, family=family, device=dev), yml,
            opt["name"])


def baseline_pth(model, path):
    """`model`'s state dict as the reference saves a checkpoint."""
    torch.save({"state_dict": {f"module.{k}": v.detach().cpu()
                               for k, v in model.state_dict().items()}},
               path)


def run_baselines(dev, card, mods, tmp):
    """Phase 9, per family: a request (2 LQ frames 64x112 -> 256x448, 3
    times) counted alone, held against its plain versions (1e-5), replayed
    against eager (1e-5) and timed; then the CLI over its yml on one
    Vid4 clip against its plain versions (EVAL_GATES fp32). Returns each
    family's entry launches (request, CLI)."""
    softsplat, dcn, siren_kernel, kernels = mods
    h, w = BASE_LQ
    hw = (4 * h, 4 * w)
    lq = np.random.default_rng(0).random((1, 2, h, w, 3), dtype=np.float32)
    t3 = np.linspace(0, 1, 3, dtype=np.float32)[None]
    out = {}
    for family, (_, want) in BASELINES.items():
        t0 = time.perf_counter()
        model, ev, yml, stem = build_baseline_request(dev, family)
        obs.reset(obs.LAUNCHES)
        frames, stats = ev.infer(lq, t3, hw)
        entries = entry_counts()
        check_frames(family, frames, (3, 1, *hw, 3), clipped=False)
        if entries != want or stats is not None:
            raise AssertionError(f"request ({family}) launched {entries} "
                                 f"(wanted {want}), flow stats {stats}")
        with plain_versions(softsplat, dcn, siren_kernel):
            obs.reset(obs.LAUNCHES)
            plain, _ = eager(ev)(lq, t3, hw)
            if any(launch_counts().values()):
                raise AssertionError("the plain forward launched a kernel")
        err = float(np.abs(frames - plain).max())
        emit({"phase": "baseline_vs_plain", "model": family,
              "max_abs_err": err, "tol": 1e-5,
              "mean_abs_err": float(np.abs(frames - plain).mean()),
              "max_abs": float(np.abs(plain).max()),
              "params": sum(p.numel() for p in model.parameters()),
              "entry_launches": entries})
        if not err <= 1e-5:
            raise AssertionError(f"request ({family}) kernels vs plain: "
                                 f"{err} (tol 1e-5)")
        torch.cuda.reset_peak_memory_stats()
        r = hold_replay(ev, lq, t3, family, 1e-5, None, card, hw)
        ms = r["captured_ms_median"]
        emit({"phase": "baseline_request_time", "model": family, "card": card,
              "forward_ms_median": ms, "hr_frames_per_s": 3e3 / ms,
              "forward_ms": r["captured_ms"],
              "eager_ms_median": r["eager_ms_median"],
              "eager_hr_frames_per_s": 3e3 / r["eager_ms_median"],
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "device_busy_share": r["device_busy_share"],
              "note": "Evaluator.infer wall time incl. host copy-out, fp32, "
                      "TF32 off, LQ 2x64x112 -> HR 256x448, 3 times, median "
                      "of 10 captured, in turns with 10 eager (`replay`); "
                      "peak memory over them"})
        pth = os.path.join(tmp, f"{family}.pth")
        baseline_pth(model, pth)
        cli, _ = eval_cli(tmp, "fp32", yml, stem, pth, mods, per_clip=want,
                          clips=1, clipped=False)
        out[family] = {"request": entries, "cli": cli}
        emit({"phase": "baseline", "model": family,
              "seconds": time.perf_counter() - t0})
        del model, ev
        torch.cuda.empty_cache()
    return out


def run_baseline_phase(dev, card, args, mods, Siren):
    """Phase 9: the five baselines' requests and CLIs, then the entries at
    the shapes they give them (K2 at cg 16, K4 float32 at VideoINR's
    widths). Returns the launches per family and the checks' rows."""
    import tempfile

    _, dcn, siren_kernel, kernels = mods
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        launches = run_baselines(dev, card, mods, tmp)
    dcn16 = check_dcn(dev, dcn, kernels, shapes=EDVR_DCN, cg=16)
    sirens = {name: check_siren(dev, siren_kernel, Siren, kernels,
                                mlps={name: shape})
              for name, shape in VIDEOINR_SIRENS.items()}
    emit({"phase": "baselines", "seconds": time.perf_counter() - t0})
    return launches, dcn16, sirens


# ---------------------------------------------------------------------------
# phase 10: the Adobe and arbitrary-scale recipes, the MoTIF settings,
# Ours_7 and Ours_flow
# ---------------------------------------------------------------------------

# the recipes' data: Adobe240-shaped clips of TREE_FRAMES frames ping-ponged
# from data/Vid4 (8 frames a clip) and data/vimeo's two clips, their frames
# resized to TREE_HW (Adobe240's 720x1280 frames cut to what the recipes
# crop: up to 256 px at LQ_size 64), the Adobe LR frames by MATLAB bicubic
# at 1/4
TREE_HW = (256, 448)
TREE_FRAMES = 32
# configs/grid/ ymls the smoke trains, and the batch each trains at (the
# recipes' 24 unless listed with a reason)
RECIPES = ("train_Ours_adobe.yml", "train_Ours_adobe_a.yml",
           "train_Ours_adobe_flow.yml", "train_Ours_vimeo_a.yml",
           "train_Ours_adobe_s2.yml", "train_OursZSM_adobe_a.yml",
           "train_Ours7_adobe.yml")
RECIPE_BATCH: dict = {}
RECIPE_LQ_SIZE = 64         # the `_a` recipes' LQ_size (the grid's 32
                            # refuses at RAFT's size check, ROADMAP §C)
RECIPE_CLI_STEPS = 2        # teacher forcing over 1 step: both branches
# the `_a` timing's buckets, in order (GT crops; outputs half of them):
# after a warm-up, the first steps of two new buckets and a second (steady)
# step of the first
A_BUCKETS = (128, 144, 240, 144)
# the gates' batch (cut from 24: the gate's state is a warm-up and three
# plain steps under deterministic algorithms, ~1 s each per 4 clips), and
# the `_a` gate's bucket: a crop of 144, outputs of 72 (no multiple of 16)
GATE_BATCH = 4
GATE_BUCKET = 144
# requests at bench.py's shape, the same weights per setting
SETTING_REQUESTS = {"s2": dict(setting=2), "s6": dict(setting=6),
                    "ours7": dict(setting=3, linear_motion=True),
                    "s6_serving": dict(setting=6, **SERVING)}
# the synthesis net of setting 6 (331 inputs at width 64) at a request's
# tokens: cut into two launches in either type
SYNTH_S6 = {"synth_s6": (331, [64, 64, 64, 256], 3, 3 * 256 * 448)}
FLOW_PRECOMPUTE_GATES = dict(flow=1e-2, psies=1e-2)


class PinnedScale(random.Random):
    """The collate's generator with its d_scale draws pinned: the i-th
    returns crops[i] / lq_size (cycling); every other draw its own."""

    def __init__(self, seed, crops, lq_size):
        super().__init__(seed)
        self.crops, self.lq_size, self.i = list(crops), lq_size, 0

    def uniform(self, a, b):
        super().uniform(a, b)
        d = self.crops[self.i % len(self.crops)] / self.lq_size
        self.i += 1
        return d


def recipe_entries(which: str, setting: int) -> dict:
    """What one training step of a recipe launches: one splat at C = 130,
    the DCNs of 2 or 4 frames, the SIRENs it runs (setting 6's synthesis
    net in two launches: its 331 -> 64 layer alone, then the resident rest;
    Ours_7 has no STINF and its synthesis net fits one block)."""
    four = which in ("Ours_44", "Ours_4")
    if which == "Ours_7":
        return {"splat_fused/float32/C=130": 1, "dcn_im2col/float32": 42,
                "siren_mlp/float32/whole": 2}
    return {"splat_fused/float32/C=130": 1,
            "dcn_im2col/float32": 90 if four else 42,
            "siren_mlp/float32/whole": 3,
            **({"siren_mlp/float32/layer": 1} if setting >= 6 else {})}


def make_trees(tmp: str, seed: int) -> dict:
    """The recipes' data under `tmp`, as tools/make_synth_eval_data.py lays
    out its trees: per data/Vid4 clip TREE_FRAMES ping-ponged frame names
    linked to 8 frames resized to TREE_HW (cv2 bicubic), the LR frames by
    imresize_matlab_np at 1/4; the Adobe_flow arrays of each window from
    `seed` in the reference layout (flow (4, 2, h, w), psies (4, 3, h, w),
    flow_GT (18, 2, H, W)); data/vimeo's clips resized likewise."""
    import cv2

    from motif_tpu_torch.ops.resize import imresize_matlab_np

    H, W = TREE_HW
    rng = np.random.default_rng(seed)
    adobe, vimeo = os.path.join(tmp, "adobe240"), os.path.join(tmp, "vimeo")
    vid4 = os.path.join(ROOT, "data", "Vid4", "HR")
    clips = sorted(os.listdir(vid4))
    for clip in clips:
        names = sorted(f for f in os.listdir(os.path.join(vid4, clip))
                       if f.endswith(".png"))
        cycle = list(range(len(names))) + list(range(len(names) - 2, 0, -1))
        for res in ("HR", "LR"):
            os.makedirs(os.path.join(adobe, res, clip))
            os.makedirs(os.path.join(adobe, "src", res, clip))
        for k, name in enumerate(names):
            hr = cv2.resize(cv2.imread(os.path.join(vid4, clip, name)),
                            (W, H), interpolation=cv2.INTER_CUBIC)
            lr = imresize_matlab_np(hr.astype(np.float32), 0.25)
            for res, img in (("HR", hr), ("LR", np.clip(np.round(lr), 0, 255)
                                          .astype(np.uint8))):
                cv2.imwrite(os.path.join(adobe, "src", res, clip,
                                         f"{k}.png"), img)
        for i in range(TREE_FRAMES):
            for res in ("HR", "LR"):
                os.symlink(os.path.join(adobe, "src", res, clip,
                                        f"{cycle[i % len(cycle)]}.png"),
                           os.path.join(adobe, res, clip, f"{i:03d}.png"))
        for start in range(0, TREE_FRAMES - 9, 8):     # the windows
            base = os.path.join(adobe, "LR", clip,
                                f"{start:03d}_{start + 2:03d}")
            f32 = np.float32
            np.save(base + "_flow.npy", (rng.standard_normal(
                (4, 2, H // 4, W // 4), f32) * 2))
            np.save(base + "_psies.npy", np.abs(rng.standard_normal(
                (4, 3, H // 4, W // 4), f32)) * 0.1)
            np.save(base + "_flow_GT.npy", rng.standard_normal(
                (18, 2, H, W), f32) * 2)
    src = os.path.join(ROOT, "data", "vimeo")
    with open(os.path.join(src, "keys.txt")) as f:
        keys = [ln.strip() for ln in f if ln.strip()]
    for key in keys:
        os.makedirs(os.path.join(vimeo, "GT", key))
        for v in range(1, 8):
            img = cv2.imread(os.path.join(src, "GT", key, f"im{v}.png"))
            cv2.imwrite(os.path.join(vimeo, "GT", key, f"im{v}.png"),
                        cv2.resize(img, (W, H), interpolation=cv2.INTER_CUBIC))
    with open(os.path.join(vimeo, "keys.txt"), "w") as f:
        f.write("\n".join(keys) + "\n")
    return {"adobe": adobe, "vimeo": vimeo, "clips": clips, "keys": keys}


def recipe_yml(tmp: str, name: str, trees: dict, steps: int,
               batch: int | None = None, network: dict | None = None) -> str:
    """A copy of configs/grid/`name` at its full width (nf 64, 5 + 40
    blocks, iters 12) pointed at the trees: the batch RECIPE_BATCH gives
    (the recipe's 24 unless listed), an `_a` recipe at LQ_size
    RECIPE_LQ_SIZE, `steps` steps with teacher forcing decaying over 1
    step (the first step use_gt True, the next False), a log line a step,
    under `tmp`/<name>; `network` added to its network_G."""
    import yaml

    with open(os.path.join(ROOT, "configs", "grid", name)) as f:
        opt = yaml.safe_load(f)
    ds = opt["datasets"]["train"]
    if ds["mode"].startswith("vimeo"):
        ds.update(dataroot_GT=os.path.join(trees["vimeo"], "GT"),
                  dataroot_LQ=os.path.join(trees["vimeo"], "GT"),
                  cache_keys=os.path.join(trees["vimeo"], "keys.txt"))
    else:
        ds.update(dataroot_GT=os.path.join(trees["adobe"], "HR"),
                  dataroot_LQ=os.path.join(trees["adobe"], "LR"))
    ds["batch_size"] = batch or RECIPE_BATCH.get(name, ds["batch_size"])
    if ds["mode"].endswith("_a"):
        ds["LQ_size"] = RECIPE_LQ_SIZE
    opt["network_G"].update(network or {})
    opt["path"] = {"root": os.path.join(tmp, name[:-4])}
    opt["train"].update(niter=steps, teacher_forcing_steps=1)
    opt["logger"] = {"print_freq": 1, "save_checkpoint_freq": 10 ** 6}
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return path


class TimedLoads:
    """A dataset whose items, and a collate whose calls, are timed (ms, on
    the loader's thread)."""

    def __init__(self, dataset, collate):
        self.dataset, self.collate = dataset, collate
        self.items_ms, self.collate_ms = [], []

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        t = time.perf_counter()
        item = self.dataset[i]
        self.items_ms.append((time.perf_counter() - t) * 1e3)
        return item

    def collated(self, items):
        t = time.perf_counter()
        out = self.collate(items)
        self.collate_ms.append((time.perf_counter() - t) * 1e3)
        return out


def recipe_steps(dev, opt, card, tag):
    """A Trainer on the recipe (`train.setup`): a warm-up step, then steps
    split into forward, backward and optimiser, their peak memory, HR
    frames trained/s, and the host's ms per batch on the loader's thread
    (reading the items, the collate) beside what each step waited for it;
    an `_a` recipe steps through A_BUCKETS (d_scale pinned): the first
    step of each new output size, and a steady (repeated) one, whose
    parts are the line's."""
    from motif_tpu_torch import train
    from motif_tpu_torch.data import device_prefetch

    ds = opt["datasets"]["train"]
    arbitrary = ds["mode"].endswith("_a")
    rng = PinnedScale(0, A_BUCKETS, ds["LQ_size"]) if arbitrary else None
    model, loader, tr = train.setup(opt, dev, rng=rng, dataset_seed=0)
    timed = TimedLoads(loader.dataset, loader.collate)
    loader.dataset, loader.collate = timed, timed.collated
    batches = device_prefetch(loader.epoch(0), dev)
    tr.step(next(batches))                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    for _ in range(len(A_BUCKETS) - 1 if arbitrary else 2):
        t = time.perf_counter()
        batch = next(batches)
        wait = (time.perf_counter() - t) * 1e3
        ms = tr.step(batch, sync_times=True)["ms"]
        runs.append({"out_hw": list(batch["gt"].shape[2:4]), "ms": ms,
                     "step_ms": sum(ms.values()), "loader_wait_ms": wait})
    peak = torch.cuda.max_memory_allocated(dev)
    batches.close()
    B, N = ds["batch_size"], ds["sample_num"]
    buckets, steady = {}, []
    for r in runs:
        b = buckets.setdefault(str(r["out_hw"][0]), {})
        if "first_ms" in b:
            b["steady_ms"] = r["step_ms"]
            steady.append(r)
        else:
            b["first_ms"] = r["step_ms"]
    items = np.asarray(timed.items_ms)
    host = {"items_ms_per_batch": float(items.sum() / (len(items) / B)),
            "collate_ms_per_batch": float(np.median(timed.collate_ms)),
            "loader_wait_ms_median": float(np.median(
                [r["loader_wait_ms"] for r in runs]))}
    steady = steady if arbitrary else runs
    ms = {k: float(np.median([r["ms"][k] for r in steady])) for k in
          runs[0]["ms"]}
    step_ms = sum(ms.values())
    line = {"phase": f"{tag}_step", "card": card, "model":
            opt["network_G"]["which_model_G"],
            "setting": getattr(model, "setting", None), "mode": ds["mode"],
            "batch": B,
            "times": N, "ms_median": ms, "step_ms": step_ms, "runs": runs,
            "peak_memory_gb": peak / 1e9,
            "hr_frames_per_s": B * N / (step_ms / 1e3), **host,
            "note": "device-synchronised ms by part after the batch is on "
                    "the card; the loader (one thread: the items' PNG "
                    "decodes, the collate) works ahead of the step, and "
                    "loader_wait_ms is what the step waited for it"}
    if arbitrary:
        line["buckets"] = buckets
    emit(line)
    del model, tr
    torch.cuda.empty_cache()
    return line


def run_recipes(dev, card, mods, tmp, trees):
    """The main path of phase 10: the training CLI on each recipe (its
    counters from 0, RECIPE_CLI_STEPS steps, its launches a step against
    `recipe_entries`; for Adobe_flow RAFT must not run), then each
    recipe's steps by part. Returns the entry launches a step per recipe
    and each recipe's `recipe_steps` line."""
    from motif_tpu_torch.models.raft import RAFT
    from motif_tpu_torch.utils import config as cfg

    kernels = mods[3]
    per_step, rafts, lines = {}, {}, {}
    forward = RAFT.forward
    for name in RECIPES:
        t0 = time.perf_counter()
        yml = recipe_yml(tmp, name, trees, RECIPE_CLI_STEPS)
        opt = cfg.parse(yml, is_train=True)
        net = opt["network_G"]
        calls = []

        def counted(self, *a, **kw):
            calls.append(int(a[0].shape[0]))
            return forward(self, *a, **kw)
        with mock.patch.object(RAFT, "forward", counted):
            per_step[name] = train_cli(
                yml, opt, kernels,
                recipe_entries(net["which_model_G"], int(net.get("setting")
                                                         or 5)),
                card, f"recipe_{name[6:-4]}", RECIPE_CLI_STEPS, 0)
        rafts[name] = calls
        if name == "train_Ours_adobe_flow.yml" and calls:
            raise AssertionError(f"{name}: RAFT ran on precomputed flows "
                                 f"{calls}")
        lines[name] = recipe_steps(dev, opt, card, f"recipe_{name[6:-4]}")
        emit({"phase": "recipe", "yml": name, "raft_batches": calls,
              "seconds": time.perf_counter() - t0})
    return per_step, lines


def recipe_gates(dev, card, mods, tmp, trees):
    """The gradient gate (`train_gates`, both teacher-forcing branches from
    a deterministic state) on three recipes at GATE_BATCH: the Adobe_a
    Ours step in the GATE_BUCKET bucket, setting 6 (Ours_ZSM on Adobe_a,
    the same bucket) and Ours_7 (Adobe)."""
    from motif_tpu_torch.utils import config as cfg

    for name, bucket in (("train_Ours_adobe_a.yml", GATE_BUCKET),
                         ("train_OursZSM_adobe_a.yml", GATE_BUCKET),
                         ("train_Ours7_adobe.yml", None)):
        yml = recipe_yml(os.path.join(tmp, "gates"), name, trees, 1,
                         GATE_BATCH)
        opt = cfg.parse(yml, is_train=True)
        rng = PinnedScale(0, [bucket], RECIPE_LQ_SIZE) if bucket else None
        # Ours_ZSM has no flow loss: under teacher forcing its STINF takes
        # a gradient through z alone, which a ReLU may zero everywhere
        tr, model, batch, _, _ = train_gates(
            dev, opt, mods, card, f"recipe_{name[6:-4]}", rng,
            upstream_all=name != "train_OursZSM_adobe_a.yml")
        emit({"phase": "recipe_gate_batch", "yml": name,
              "gt": list(batch["gt"].shape), "lq": list(batch["lq"].shape)})
        del tr, model, batch
        torch.cuda.empty_cache()


def setting_entries(name: str) -> dict:
    """What a request of SETTING_REQUESTS launches (3 times in one
    forward)."""
    if name == "s6_serving":      # no fused decode under warp_to_many
        return {"dcn_im2col/bfloat16": 42, "siren_mlp/bfloat16/whole": 4,
                "splat_fused/float16/C=130": 1}
    return recipe_entries("Ours_7" if name == "ours7" else "Ours",
                          6 if name == "s6" else 2)


def run_setting_requests(dev, card, mods):
    """Requests at bench.py's shape (LQ 64x112 -> 256x448, 3 times, iters
    4) for setting 2, setting 6, Ours_7 (fp32) and setting 6 under the
    serving knobs: each counted alone, against its plain versions (fp32
    1e-5; serving 6e-2 and 35 dB against the fp32 setting 6), replayed
    against eager and timed; the splat on the serving request's own
    inputs (float16 sums at C = 130). Returns the entries per request and
    that splat's row."""
    from motif_tpu_torch.eval import Evaluator
    from motif_tpu_torch.models.motif import build_motif

    softsplat, dcn, siren_kernel, kernels = mods
    lq = np.random.default_rng(0).random((1, 4, 64, 112, 3), dtype=np.float32)
    t3 = np.linspace(0, 1, 3, dtype=np.float32)[None]
    entries, frames, row = {}, {}, None
    for name, kw in SETTING_REQUESTS.items():
        t0 = time.perf_counter()
        model = build_motif(channel=64, front_rbs=5, back_rbs=40, device=dev,
                            seed=0, **kw)
        perturb_offsets(model, seed=1)
        ev = Evaluator(model, scale=4, iters=4, chunk=3, device=dev,
                       family="Ours_7" if name == "ours7" else "Ours")
        obs.reset(obs.LAUNCHES)
        frames[name], _ = ev.infer(lq, t3, (256, 448))
        entries[name] = entry_counts()
        check_frames(name, frames[name], (3, 1, 256, 448, 3))
        if entries[name] != setting_entries(name):
            raise AssertionError(f"request ({name}) launched {entries[name]}"
                                 f" (wanted {setting_entries(name)})")
        serving = name == "s6_serving"
        gate = (6e-2, 1e-2) if serving else (1e-5, 1e-5)
        if serving:
            hold_against(name, frames[name], frames["s6"], 6e-2, 35.0)
        slice_vs_plain(ev, model, lq, t3, name, *gate, mods)
        if serving:
            inputs = capture_splat(ev, softsplat, lq, t3)
            row = check_splat_request(softsplat, kernels, inputs, name)
            img, flow, z, nonpos, sdt = inputs
            row["plain_ms"] = device_ms(lambda: softsplat.splat_fused_plain(
                img, flow, z, nonpos, scatter_dtype=sdt), reps=3)
            del inputs, img, flow, z
        r = hold_replay(ev, lq, t3, name, *gate, card, n=2)
        ms = r["captured_ms_median"]
        emit({"phase": f"request_{name}_time", "card": card,
              "forward_ms_median": ms, "hr_frames_per_s": 3e3 / ms,
              "forward_ms": r["captured_ms"],
              "eager_ms_median": r["eager_ms_median"],
              "eager_hr_frames_per_s": 3e3 / r["eager_ms_median"],
              "model": kw, "launches_per_request": entries[name],
              "device_busy_share": r["device_busy_share"],
              "seconds": time.perf_counter() - t0,
              "note": "Evaluator.infer wall time incl. host copy-out, TF32 "
                      "off, iters 4, LQ 4x64x112 -> HR 256x448, 3 times; "
                      "captured and eager in turns (`replay`)"})
        del model, ev
        torch.cuda.empty_cache()
    return entries, row


def run_flow_precompute(dev, card):
    """Ours_flow (`define_g`, RAFT from seed 0) on 4 LQ frames of 64x112
    with 12 iterations on the card, timed; its flows and psies against
    the same module on the CPU in float64 (FLOW_PRECOMPUTE_GATES, TF32
    off)."""
    import copy

    from motif_tpu_torch.models.factory import define_g

    m = define_g({"which_model_G": "Ours_flow"}, device=dev)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (1, 4, 64, 112, 3), dtype=np.float32))
    xd = x.to(dev)
    flow, _, psies = m(xd, iters=12)
    ms = cuda_ms(lambda: m(xd, iters=12), reps=3, warmup=1)
    cpu = copy.deepcopy(m).to("cpu").double()
    t = time.perf_counter()
    flow64, _, psies64 = cpu(x.double(), iters=12)
    cpu_s = time.perf_counter() - t
    errs = {"flow": max_err(flow.cpu(), flow64),
            "psies": max_err(psies.cpu(), psies64)}
    emit({"phase": "flow_precompute", "card": card, "ms": ms,
          "shape": {"flow": list(flow.shape), "psies": list(psies.shape)},
          "max_abs_err_vs_cpu_float64": errs,
          "tol": FLOW_PRECOMPUTE_GATES, "cpu_float64_seconds": cpu_s,
          "flow_abs_max": float(flow64.abs().max()),
          "psies_abs_max": float(psies64.abs().max())})
    h, w = x.shape[2:4]
    if not (flow.shape == (8, h, w, 2) and psies.shape == (8, h, w, 3)
            and all(errs[k] <= FLOW_PRECOMPUTE_GATES[k] for k in errs)):
        raise AssertionError(f"Ours_flow: shapes {flow.shape}, "
                             f"{psies.shape}; against the CPU {errs}")
    del m, cpu
    torch.cuda.empty_cache()


def run_recipe_phase(dev, card, args, mods, Siren, tmp):
    """Phase 10: the trees (under `tmp`, kept for phase 11), the recipes'
    CLIs and steps, their gates, the settings' requests, Ours_flow, and
    the SIREN cut at setting 6's synthesis net in both types. Returns the
    launches per recipe step and per request, the rows of the new shapes,
    the trees and the recipes' step lines."""
    softsplat, dcn, siren_kernel, kernels = mods
    t0 = time.perf_counter()
    trees = make_trees(tmp, args.seed)
    emit({"phase": "recipe_trees", "clips": trees["clips"],
          "vimeo_keys": trees["keys"], "hw": TREE_HW,
          "frames": TREE_FRAMES, "seed": args.seed,
          "seconds": time.perf_counter() - t0})
    per_step, lines = run_recipes(dev, card, mods, tmp, trees)
    recipe_gates(dev, card, mods, tmp, trees)
    requests, splat_row = run_setting_requests(dev, card, mods)
    run_flow_precompute(dev, card)
    sirens = {dname(dt): check_siren(dev, siren_kernel, Siren, kernels, dt,
                                     mlps=SYNTH_S6)
              for dt in (torch.float32, torch.bfloat16)}
    emit({"phase": "recipes", "seconds": time.perf_counter() - t0})
    return per_step, requests, splat_row, sirens, trees, lines


# ---------------------------------------------------------------------------
# phase 11: LIIF training, training under the precision knobs, and
# data-parallel training
# ---------------------------------------------------------------------------

LIIF_RECIPES = ("train_INR_adobe.yml", "train_INR_adobe_a.yml")
# a LIIF step: VideoINR on the 4 LQ frames every training mode gives (3
# frame pairs, 7 fused frames): 90 DCNs, and its three float32 SIRENs, cut
# into 2 + 2 + 4 launches (5 single layers, 3 resident runs), at each of 3
# times; no splat
LIIF_ENTRIES = {"dcn_im2col/float32": 90, "siren_mlp/float32/whole": 9,
                "siren_mlp/float32/layer": 15}
# VideoINR's SIRENs at 4 LQ frames and nf 64 over one time of a recipe
# step (batch 24 at 128²)
LIIF_TOKENS = 24 * 128 * 128
LIIF_SIRENS = {"feat_imnet": (463, [64, 64, 256], 64, LIIF_TOKENS),
               "flow_imnet": (525, [64, 64, 256], 4, LIIF_TOKENS),
               "encode_imnet": (1049, [64, 64, 256, 256], 3, LIIF_TOKENS)}
# the precision knobs on a copy of the Adobe recipe, and what its step
# launches: the float16-sum splat, the bfloat16 DCNs and whole SIRENs
BF16_RECIPE = "train_Ours_adobe.yml"
BF16_KNOBS = dict(compute_dtype="bfloat16", splat_dtype="float16")
BF16_ENTRIES = {"splat_fused/float16/C=130": 1, "dcn_im2col/bfloat16": 42,
                "siren_mlp/bfloat16/whole": 3}
# the recipe's shapes at batch 24, 3 times: the splat over n·B·N = 144
# images of 128² (payload 130), the STINF over their tokens, the SINF over
# n·B = 48 images', setting 6's synthesis net (cut) over B·N = 72's, the
# PCD's L1 over the 24 frame pairs of 32²
BF16_SPLAT = (144, 128, 128, 130)
BF16_SIRENS = {"stinf": ((67, 64, 64, 256, 3), False, 144 * 128 * 128),
               "sinf": ((64, 64, 256, 64), True, 48 * 128 * 128),
               "synth_s6": ((331, 64, 64, 64, 256, 3), False,
                            72 * 128 * 128)}
BF16_DCN = {"train_bf16_L1": (24, 32, 32)}
# a step under the knobs against the float32 step from the same state and
# batch (GATE_BATCH): each module's gradient within this L2 distance of the
# float32 one's, relative to its norm, and the loss (the CPU lane reads
# 1.3-3.6e-2 a module at channel 16, tests/test_torch_train_bf16.py)
BF16_GATES = dict(module_l2=0.2, loss_rel=1e-2)
DP_RECIPE = "train_Ours_adobe.yml"
DP_WORLD = 2
DP_GATE = 1e-3        # TRAIN_GATES' grad_rel: of each tensor's largest |g|


def liif_round_trip(tmp, models, card):
    """`checkpoint_round_trip` on the LIIF models root, with
    configs/test_vid4_liif.yml at ref_num 4 (the LQ frames a trained LIIF
    takes)."""
    with open(os.path.join(ROOT, "configs", "test_vid4_liif.yml")) as f:
        text = f.read()
    if "    ref_num: 2\n" not in text:
        raise AssertionError("test_vid4_liif.yml has no `ref_num: 2` line")
    yml = os.path.join(tmp, "test_vid4_liif_4.yml")
    with open(yml, "w") as f:
        f.write(text.replace("    ref_num: 2\n", "    ref_num: 4\n"))
    checkpoint_round_trip(tmp, models, card, yml,
                          "liif_checkpoint_round_trip")


def run_liif(dev, card, mods, Siren, tmp, trees):
    """LIIF at full width (VideoINR nf 64, 5 + 40 blocks, 4 LQ frames): the
    training CLI on both LIIF recipes (counted alone, use_gt always False;
    `_a` at LQ_size 64), a recipe step by part at batch 24, the gradient
    gate against the plain versions from the deterministic state, the eval
    CLI's round trip on the trained state, and the float32 SIRENs at the
    step's shapes (cut into launches; encode_imnet's backward held).
    Returns the launches a step per recipe and the SIRENs' row."""
    from motif_tpu_torch.utils import config as cfg

    softsplat, dcn, siren_kernel, kernels = mods
    per_step, opts = {}, {}
    for name in LIIF_RECIPES:
        yml = recipe_yml(os.path.join(tmp, "liif"), name, trees,
                         RECIPE_CLI_STEPS)
        opts[name] = opt = cfg.parse(yml, is_train=True)
        per_step[name] = train_cli(yml, opt, kernels, LIIF_ENTRIES, card,
                                   f"liif_{name[10:-4] or 'adobe'}",
                                   RECIPE_CLI_STEPS, 0, branches=(False,))
    liif_round_trip(os.path.join(tmp, "liif"),
                    opts[LIIF_RECIPES[0]]["path"]["models"], card)
    step = recipe_steps(dev, opts[LIIF_RECIPES[0]], card, "liif_adobe")
    gate_yml = recipe_yml(os.path.join(tmp, "liif_gate"), LIIF_RECIPES[0],
                          trees, 1, GATE_BATCH)
    tr, model, batch, _, _ = train_gates(
        dev, cfg.parse(gate_yml, is_train=True), mods, card, "liif_adobe",
        branches=(False,))
    del tr, model, batch
    torch.cuda.empty_cache()
    sirens = {n: check_siren(dev, siren_kernel, Siren, kernels,
                             mlps={n: shape})
              for n, shape in LIIF_SIRENS.items()}
    cin, hidden, cout, n_tok = LIIF_SIRENS["encode_imnet"]
    dims = [cin] + hidden + [cout]
    x, ws, bs = siren_case(dev, dims, n_tok, torch.float32, False)
    n = len(ws)
    g = torch.Generator(device=dev).manual_seed(8)
    back = hold_backward(
        "siren_mlp", lambda xx, *p: siren_kernel.siren_mlp(xx, p[:n], p[n:]),
        lambda xx, *p: siren_kernel.siren_mlp_plain(xx, p[:n], p[n:]),
        (x, *ws, *bs), (torch.randn((n_tok, cout), device=dev, generator=g),),
        card, tag="liif_encode_imnet")
    del x, ws, bs
    torch.cuda.empty_cache()
    row = {"max_abs_err": max(r["max_abs_err"] for r in sirens.values()),
           **{k: sum(r[k] for r in sirens.values())
              for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                        "eager_ms")},
           "bound_by": max(sirens.values(),
                           key=lambda r: r["bound_ms"])["bound_by"],
           "backward_ms_encode_imnet": back["forward_backward_ms"]}
    emit({"phase": "liif", "steps": {k: v for k, v in per_step.items()},
          "step_ms": step["step_ms"], "peak_memory_gb":
          step["peak_memory_gb"]})
    return per_step, row


def bf16_backwards(dev, card, mods, Siren):
    """The new backward entries at the knobs' recipe shapes, each through
    its kernel's forward against autograd through the plain version in the
    working type (2 ulps of it): the float16-sum splat (C = 130), the
    bfloat16 DCN (the PCD's L1) and the bfloat16 SIREN whole, skip-first
    and cut; and each forward's row at that shape (time, bound, library).
    Returns the rows by entry."""
    softsplat, dcn, siren_kernel, kernels = mods
    rows = {}
    f16, bf = torch.float16, torch.bfloat16
    B, H, W, C = BF16_SPLAT
    g = torch.Generator(device=dev).manual_seed(9)
    img = torch.randn((B, H, W, C), device=dev, generator=g)
    flow = torch.randn((B, H, W, 2), device=dev, generator=g) * 3.0
    z = (torch.randn((B, H, W, 1), device=dev, generator=g) * 0.5).abs()
    held = hold_splat(softsplat, kernels, img, flow, z, False, tol=4,
                      sdt=f16)
    b_ms, b_by = splat_bound(B, H, W, C, False)

    def run():
        return softsplat.splat_fused(img, flow, z, False, scatter_dtype=f16)
    ms = device_ms(run, reps=5)
    line = {"ms": ms, "eager_ms": cuda_ms(run, reps=5),
            "plain_ms": device_ms(lambda: softsplat.splat_fused_plain(
                img, flow, z, False, scatter_dtype=f16), reps=2),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": index_add_ms(softsplat, img, flow, z, f16, reps=3)}
    emit({"check": "splat_fused", "sums": "float16", "case": "train_bf16",
          "shape": [B, H, W, C], **held, **line,
          "fraction_of_bound": b_ms / ms, "library": "float16 index_add_"})
    cot = (torch.randn((B, H, W, C), device=dev, generator=g),
           torch.randn((B, H, W, 1), device=dev, generator=g))
    back = hold_backward(
        "splat_fused",
        lambda *a: softsplat.splat_fused(*a, False, scatter_dtype=f16)[:2],
        lambda *a: softsplat.splat_fused_plain(*a, False,
                                               scatter_dtype=f16)[:2],
        (img, flow, z), cot, card, bits=10, tag="train_bf16")
    rows["splat_fused/float16/C=130"] = dict(
        line, max_abs_err=held["max_abs_err"],
        backward_ms=back["forward_backward_ms"],
        grad_rel_err=max(back["grad_rel_errs"]))
    del img, flow, z, cot
    torch.cuda.empty_cache()

    row = check_dcn(dev, dcn, kernels, bf, BF16_DCN)
    (Bd, Hd, Wd), = BF16_DCN.values()
    G, cg, K = 8, 8, 3
    x, off, mask = dcn_inputs(dev, Bd, Hd, Wd, G, cg, K, bf)
    w = (torch.randn((64, G * cg, K, K), device=dev, generator=g)
         * 0.05).to(bf)
    bias = torch.randn((64,), device=dev, generator=g).to(bf)
    back = hold_backward(
        "dcn_v2", lambda *a: dcn.dcn_v2(*a, K, 1, 1, 1, G),
        lambda *a: dcn.dcn_v2_plain(*a, K, 1, 1, 1, G),
        (x, off, mask, w, bias),
        (torch.randn((Bd, Hd, Wd, 64), device=dev, generator=g).to(bf),),
        card, bits=7, tag="train_bf16")
    rows["dcn_im2col/bfloat16"] = dict(
        row, backward_ms=back["forward_backward_ms"],
        grad_rel_err=max(back["grad_rel_errs"]))
    del x, off, mask
    torch.cuda.empty_cache()

    for name, (dims, skip, n_tok) in BF16_SIRENS.items():
        if name == "stinf":
            cin, *hidden, cout = dims
            row = check_siren(dev, siren_kernel, Siren, kernels, bf,
                              mlps={"stinf_train_bf16": (cin, hidden, cout,
                                                         n_tok)})
        x, ws, bs = siren_case(dev, list(dims), n_tok, bf, skip,
                               0.6 if skip else 1.0)
        n = len(ws)
        back = hold_backward(
            "siren_mlp",
            lambda xx, *p, s=skip: siren_kernel.siren_mlp(
                xx, p[:n], p[n:], 30.0, False, s),
            lambda xx, *p, s=skip: siren_kernel.siren_mlp_plain(
                xx, p[:n], p[n:], 30.0, False, s),
            (x, *ws, *bs),
            (torch.randn((n_tok, dims[-1]), device=dev,
                         generator=g).to(bf),), card, bits=7,
            tag=f"train_bf16_{name}")
        if name == "stinf":
            rows["siren_mlp/bfloat16/whole"] = dict(
                row, backward_ms=back["forward_backward_ms"],
                grad_rel_err=max(back["grad_rel_errs"]))
        del x, ws, bs
        torch.cuda.empty_cache()
    return rows


def module_l2(model, got, want) -> dict:
    """Per top-level module, the L2 distance of the gradients `got` from
    `want` relative to the norm of `want` (modules without a gradient in
    `want` left out)."""
    out, names = {}, [k for k, _ in model.named_parameters()]
    for key in dict.fromkeys(k.split(".")[0] for k in names):
        idx = [i for i, k in enumerate(names) if k.split(".")[0] == key]
        a = torch.cat([got[i].double().reshape(-1) for i in idx])
        b = torch.cat([want[i].double().reshape(-1) for i in idx])
        if float(b.norm()) > 0:
            out[key] = float((a - b).norm() / b.norm())
    return out


def bf16_step_gate(dev, card, mods, opt):
    """From the float32 recipe's deterministic gate state (`gate_state`),
    the step under the knobs against the float32 step on the same weights
    and batch, both with the kernels, for use_gt True and False: every
    module's gradient within BF16_GATES of the float32 one's and the loss
    likewise; per parameter the worst distance is printed."""
    tr, model, batch, hashes = gate_state(dev, opt, mods)
    for use_gt in (True, False):
        aux = tr.compute_grads(batch, use_gt)
        want = [p.grad.clone() for p in tr.params]
        model.configure(**BF16_KNOBS)
        aux16 = tr.compute_grads(batch, use_gt)
        got = [p.grad.clone() for p in tr.params]
        model.configure()
        mods_l2 = module_l2(model, got, want)
        per = {k: float((a.double() - b.double()).norm()
                        / b.double().norm())
               for (k, _), a, b in zip(model.named_parameters(), got, want)
               if float(b.norm()) > 0}
        worst = max(per, key=per.get)
        loss_rel = abs(float(aux16["loss"]) / float(aux["loss"]) - 1)
        reached = all((float(a.abs().max()) > 0) == (float(b.abs().max()) > 0)
                      for a, b in zip(got, want))
        ok = (max(mods_l2.values()) <= BF16_GATES["module_l2"]
              and loss_rel <= BF16_GATES["loss_rel"] and reached)
        emit({"phase": "train_bf16_gate", "card": card, "use_gt": use_gt,
              "state_sha256": hashes, "loss_float32": float(aux["loss"]),
              "loss_knobs": float(aux16["loss"]), "loss_rel": loss_rel,
              "module_l2_rel": mods_l2, "worst_parameter": [worst,
                                                           per[worst]],
              "same_parameters_reached": reached, "gates": BF16_GATES,
              "ok": ok})
        if not ok:
            raise AssertionError(f"train_bf16: the step under the knobs "
                                 f"(use_gt={use_gt}) against float32: "
                                 f"modules {mods_l2}, loss {loss_rel}")
    del tr, model, batch
    torch.cuda.empty_cache()


def run_bf16(dev, card, mods, Siren, tmp, trees, f32_line):
    """Training under the precision knobs at full width: the CLI on a copy
    of the Adobe recipe with `compute_dtype: bfloat16`, `splat_dtype:
    float16` (counted alone), its step by part beside the float32
    recipe's (phase 10), the step against the float32 step, and the new
    backward entries at its shapes. Returns the launches a step and the
    rows of the entries."""
    from motif_tpu_torch.utils import config as cfg

    kernels = mods[3]
    yml = recipe_yml(os.path.join(tmp, "bf16"), BF16_RECIPE, trees,
                     RECIPE_CLI_STEPS, network=BF16_KNOBS)
    opt = cfg.parse(yml, is_train=True)
    per_step = train_cli(yml, opt, kernels, BF16_ENTRIES, card, "train_bf16",
                         RECIPE_CLI_STEPS, 0)
    line = recipe_steps(dev, opt, card, "train_bf16")
    emit({"phase": "train_bf16_vs_float32", "card": card,
          "step_ms": {"knobs": line["step_ms"],
                      "float32": f32_line["step_ms"]},
          "ms_median": {"knobs": line["ms_median"],
                        "float32": f32_line["ms_median"]},
          "peak_memory_gb": {"knobs": line["peak_memory_gb"],
                             "float32": f32_line["peak_memory_gb"]},
          "hr_frames_per_s": {"knobs": line["hr_frames_per_s"],
                              "float32": f32_line["hr_frames_per_s"]}})
    gate_yml = recipe_yml(os.path.join(tmp, "bf16_gate"), BF16_RECIPE,
                          trees, 1, GATE_BATCH)
    bf16_step_gate(dev, card, mods, cfg.parse(gate_yml, is_train=True))
    rows = bf16_backwards(dev, card, mods, Siren)
    return per_step, rows


def dp_worker(rank, world, spec_path, out_dir):
    """One rank of the data-parallel check (spawned): a gloo group through
    a file in `out_dir`, CUDA tensors on the one card, the recipe's model
    (`build_motif` at the spec's sizes) with the spec's weights, its half
    of the global batch, one backward on the plain versions under
    deterministic algorithms; rank 0 writes the summed loss and
    gradients."""
    import torch.distributed as tdist

    from motif_tpu_torch.models.motif import build_motif
    from motif_tpu_torch.ops import dcn, siren_kernel, softsplat
    from motif_tpu_torch.trainer import Trainer

    tdist.init_process_group("gloo", init_method=f"file://{out_dir}/gloo",
                             rank=rank, world_size=world)
    try:
        spec = torch.load(spec_path, weights_only=False)
        dev = torch.device(spec["device"])
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        model = build_motif(device=dev, **spec["sizes"])
        model.load_state_dict(spec["state"])
        tr = Trainer(model, spec["cfg"], spec["out_hw"], iters=spec["iters"],
                     seed=0)
        share = spec["batch"]["lq"].shape[0] // world
        half = {k: v[rank * share:(rank + 1) * share]
                for k, v in spec["batch"].items()}
        with plain_versions(softsplat, dcn, siren_kernel), deterministic():
            aux = tr.compute_grads(half, False)
        torch.cuda.synchronize()
        if rank == 0:
            torch.save({"loss": float(aux["loss"]), "sync": tr.sync,
                        "grads": [p.grad.cpu() for p in tr.params]},
                       os.path.join(out_dir, "dp_grads.pt"))
    finally:
        tdist.destroy_process_group()


def run_data_parallel(dev, card, mods, tmp, trees):
    """The data-parallel step of the Adobe recipe at full width, on the
    plain versions under deterministic algorithms: the step of one process
    under an NCCL group of one (its gradients through the all-reduce)
    against the same step without a group, bit for bit, at GATE_BATCH; and
    two gloo ranks on the one card (NCCL refuses two ranks on one device),
    each on half of the global batch of 24, their summed gradients against
    the one-process step over the global batch (DP_GATE of each tensor's
    largest |g|, the loss 1e-5)."""
    import torch.distributed as tdist
    import torch.multiprocessing as tmp_mp

    from motif_tpu_torch import train
    from motif_tpu_torch.data import device_prefetch
    from motif_tpu_torch.trainer import Trainer
    from motif_tpu_torch.utils import config as cfg

    softsplat, dcn, siren_kernel, _ = mods
    out = os.path.join(tmp, "dp")
    os.makedirs(out)
    # ---- world 1 over NCCL, from the deterministic gate state ----
    gate_yml = recipe_yml(os.path.join(tmp, "dp_gate"), DP_RECIPE, trees, 1,
                          GATE_BATCH)
    tr, model, batch, hashes = gate_state(
        dev, cfg.parse(gate_yml, is_train=True), mods)
    with plain_versions(softsplat, dcn, siren_kernel), deterministic():
        alone = tr.compute_grads(batch, False)
        want = [p.grad.clone() for p in tr.params]
        tdist.init_process_group("nccl", init_method=f"file://{out}/nccl",
                                 rank=0, world_size=1)
        try:
            grouped = Trainer(model, tr.cfg, tr.out_hw, iters=tr.iters,
                              seed=0)
            aux = grouped.compute_grads(batch, False)
            got = [p.grad.clone() for p in grouped.params]
            synced = grouped.sync
        finally:
            tdist.destroy_process_group()
    bit_equal = synced and float(aux["loss"]) == float(alone["loss"]) and all(
        torch.equal(a, b) for a, b in zip(got, want))
    emit({"phase": "data_parallel_nccl_world1", "card": card,
          "state_sha256": hashes, "synced": synced,
          "bit_equal": bit_equal, "loss": float(aux["loss"])})
    if not bit_equal:
        raise AssertionError("data-parallel: a step under an NCCL group of "
                             "one differs from the step alone")
    del tr, model, batch, grouped, got, want
    torch.cuda.empty_cache()

    # ---- world 2 over gloo on the one card, global batch 24 ----
    t0 = time.perf_counter()
    opt = cfg.parse(recipe_yml(os.path.join(tmp, "dp_recipe"), DP_RECIPE,
                               trees, 1), is_train=True)
    model, loader, tr = train.setup(opt, dev, dataset_seed=0)
    perturb_offsets(model, seed=1)
    batches = device_prefetch(loader.epoch(0), dev)
    batch = {k: v for k, v in next(batches).items()
             if k in ("lq", "gt", "times")}
    batches.close()
    with plain_versions(softsplat, dcn, siren_kernel), deterministic():
        single = tr.compute_grads(batch, False)
    want = [p.grad.detach().cpu() for p in tr.params]
    spec = os.path.join(out, "spec.pt")
    enc = model.encoder
    torch.save({"device": str(dev), "cfg": tr.cfg, "out_hw": tr.out_hw,
                "iters": tr.iters,
                "sizes": dict(channel=model.channel,
                              front_rbs=len(enc.feature_extraction),
                              back_rbs=len(enc.recon_trunk),
                              setting=model.setting),
                "state": {k: v.cpu() for k, v in model.state_dict().items()},
                "batch": {k: torch.as_tensor(v).cpu()
                          for k, v in batch.items()}}, spec)
    single_loss = float(single["loss"])
    names = [k for k, _ in model.named_parameters()]
    del model, tr, loader, batch, single
    torch.cuda.empty_cache()
    single_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tmp_mp.start_processes(dp_worker, args=(DP_WORLD, spec, out),
                           nprocs=DP_WORLD, join=True, start_method="spawn")
    ranks_s = time.perf_counter() - t0
    res = torch.load(os.path.join(out, "dp_grads.pt"))
    rels = {}
    for name, a, b in zip(names, res["grads"], want):
        scale = float(b.abs().max())
        err = float((a.double() - b.double()).abs().max())
        rels[name] = err / scale if scale > 0 else (0.0 if err == 0
                                                     else np.inf)
    worst = max(rels, key=rels.get)
    loss_rel = abs(res["loss"] / single_loss - 1)
    ok = res["sync"] and rels[worst] <= DP_GATE and loss_rel <= 1e-5
    emit({"phase": "data_parallel_gloo_world2", "card": card,
          "world": DP_WORLD, "global_batch": RECIPE_BATCH.get(DP_RECIPE, 24),
          "loss_ranks_summed": res["loss"], "loss_one_process": single_loss,
          "loss_rel": loss_rel, "grad_rel": rels[worst],
          "grad_rel_at": worst, "gate": DP_GATE,
          "one_process_seconds": single_s, "ranks_seconds": ranks_s,
          "ok": ok, "note": "plain versions, deterministic algorithms; a "
                            "run on two cards waits for a machine with "
                            "them"})
    if not ok:
        raise AssertionError(f"data-parallel: two ranks' summed gradient "
                             f"{rels[worst]} at {worst}, loss {loss_rel}")


def run_phase11(dev, card, mods, Siren, tmp, trees, recipe_lines):
    """Phase 11: LIIF training, training under the precision knobs and the
    data-parallel step. Returns the launches a step of each path and the
    rows of the entries at the new shapes."""
    t0 = time.perf_counter()
    liif_steps, liif_row = run_liif(dev, card, mods, Siren, tmp, trees)
    t1 = time.perf_counter()
    bf16_steps, bf16_rows = run_bf16(dev, card, mods, Siren, tmp, trees,
                                     recipe_lines[BF16_RECIPE])
    t2 = time.perf_counter()
    run_data_parallel(dev, card, mods, tmp, trees)
    emit({"phase": "phase11", "seconds": time.perf_counter() - t0,
          "liif_seconds": t1 - t0, "bf16_seconds": t2 - t1,
          "data_parallel_seconds": time.perf_counter() - t2})
    return liif_steps, liif_row, bf16_steps, bf16_rows


def profile_request(infer, lq, times, out_dir, name, out_hw=(256, 448)):
    """One request through `infer` under torch.profiler: the table goes to
    `out_dir` when given; the device busy time (kernels and copies only,
    not the host-side ops that enclose them) against the request's wall
    time, the device kernels and the copies by direction. Returns (and
    prints) the line."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t = time.perf_counter()
        infer(lq, times, out_hw)
        wall_ms = (time.perf_counter() - t) * 1e3
    events = p.key_averages()
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"profile_request_{name}.txt"),
                  "w") as f:
            f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)
    copies = sum(e.count for e in device if e.key.startswith(("Memcpy",
                                                              "Memset")))
    by_kind = {kind: sum(e.count for e in device if e.key.startswith(
        f"Memcpy {kind}")) for kind in ("HtoD", "DtoH", "DtoD")}
    by_kind["keys"] = {e.key: e.count for e in device
                       if e.key.startswith(("Memcpy", "Memset"))}
    line = {"phase": "profile", "request": name,
            "request_wall_ms_profiled": wall_ms,
            "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
            "device_kernel_launches": sum(e.count for e in device) - copies,
            "device_copies": copies, "copies": by_kind,
            "top_device": [[e.key[:70], e.self_device_time_total / 1e3,
                            e.count] for e in top[:25]]}
    emit(line)
    return {k: line[k] for k in ("device_busy_share", "device_busy_ms",
                                 "request_wall_ms_profiled",
                                 "device_kernel_launches", "copies")}


def sass_counts(kernels, out_dir, source="siren_mlp_bf16"):
    """The SASS of one built source into `out_dir` (cuobjdump), and per
    kernel in it the static instruction counts by opcode, and the same for
    each straight-line run of code that holds 32 branch-free sines (one
    F2I each: sin_rr over an accumulator tile, with the roundings that
    follow it). The fp32-pipe floor of the bfloat16 SIREN's sines and
    roundings is reckoned from these: instructions per value x values per
    token x tokens, over SMs x 128 lanes x the clock."""
    import collections
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(kernels._library_path(source))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{source}.sass"), "w") as f:
        f.write(sass)
    ops = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            ops[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_]+)",
                     line)
        if m and name:
            ops[name].append(m.group(1))
    ends = {"BRA", "BSSY", "BSYNC", "HMMA", "EXIT", "CALL", "RET"}
    for fn, seq in ops.items():
        runs, cur = [], []
        for op in seq + ["EXIT"]:
            if op in ends:
                runs.append(cur)
                cur = []
            else:
                cur.append(op)
        sines = [collections.Counter(r) for r in runs
                 if r.count("F2I") == 32 and "MUFU" not in r]
        emit({"phase": "sass", "source": source, "function": fn,
              "instructions": len(seq),
              "by_opcode": dict(collections.Counter(seq).most_common(16)),
              "runs_of_32_sines": [{"instructions": sum(c.values()),
                                    "by_opcode": dict(c.most_common(10))}
                                   for c in sines]})


def compare_only(dev, card, out_dir):
    """The numbers that compare two checkouts of the package, through the
    entry points they share: dcn_v2 at L1, splat_fused at the smoke's
    shapes (z <= 0), request (a)'s median and single runs, and one profiled
    request's device kernels; and, where the checkout has the serving
    knobs, dcn_v2 in bfloat16 at L1 - L3, siren_mlp in bfloat16 (both
    entries, the three MLPs) and request (e) likewise."""
    from motif_tpu_torch.models.motif import MoTIF
    from motif_tpu_torch.ops import dcn, siren_kernel, softsplat

    emit({"phase": "compare_dcn_v2_L1", "card": card,
          **time_dcn_v2(dev, dcn)})
    if hasattr(MoTIF, "configure"):          # the checkout has bfloat16
        for level in LEVELS:
            emit({"phase": "compare_dcn_v2_bfloat16", "level": level,
                  "card": card,
                  **time_dcn_v2(dev, dcn, torch.bfloat16, level)})
        for skip_first in (True, False):
            for name, (cin, hidden, cout, n_tok) in SIRENS.items():
                dims = ([] if skip_first else [cin]) + hidden + [cout]
                x, ws, bs = siren_case(dev, dims, n_tok, torch.bfloat16,
                                       skip_first, 0.6 if skip_first else 1.0)
                emit({"phase": "compare_siren_mlp_bfloat16", "mlp": name,
                      "skip_first": skip_first, "tokens": n_tok, "card": card,
                      "device_ms": device_ms(lambda: siren_kernel.siren_mlp(
                          x, ws, bs, 30.0, False, skip_first), reps=10)})
    B, H, W = 6, 256, 448
    entries = [(130, None)]
    if hasattr(MoTIF, "configure"):          # the checkout has C = 64, f16
        entries += [(64, None), (64, torch.float16)]
    for C, sdt in entries:
        g = torch.Generator(device=dev).manual_seed(1)
        img = torch.randn((B, H, W, C), device=dev, generator=g)
        flow = torch.randn((B, H, W, 2), device=dev, generator=g) * 3.0
        z = -(torch.randn((B, H, W, 1), device=dev, generator=g) * 0.5).abs()

        def run():
            return softsplat.splat_fused(img, flow, z, True,
                                         **({"scatter_dtype": sdt} if sdt
                                            else {}))
        emit({"phase": "compare_splat", "card": card, "shape": [B, H, W, C],
              "sums": dname(sdt or torch.float32),
              "device_ms": device_ms(run), "eager_ms": cuda_ms(run),
              "phases_ms": splat_phases(run)})
        del img, flow, z
    runs = [("a", {})]
    if hasattr(MoTIF, "configure"):
        runs.append(("e", SERVING))
    for name, knobs in runs:
        _, _, ev, _, lq_a, t3 = build_request(dev, **knobs)
        time_request(ev.infer, lq_a, t3, 2)                  # warm-up
        ts = time_request(ev.infer, lq_a, t3, 10)
        emit({"phase": f"compare_request_{name}", "card": card,
              "forward_ms_median": float(np.median(ts)), "forward_ms": ts})
        profile_request(eager(ev), lq_a, t3, out_dir, name)
        if name == "e":
            img, flow, z, nonpos, sdt = capture_splat(ev, softsplat, lq_a, t3)

            def run():
                return softsplat.splat_fused(img, flow, z, nonpos,
                                             scatter_dtype=sdt)
            # the float16 sums' distance from the plain version over 100
            # runs, in float16 ulps of the largest value: the order, and so
            # the distance, varies from run to run (the smoke's gate is 4)
            want = softsplat.splat_fused_plain(img, flow, z, nonpos,
                                               scatter_dtype=sdt)
            unit = ulp(max(float(want[0].abs().max()),
                           float(want[1].abs().max())), 10)
            ulps = {}
            for _ in range(100):
                got = run()
                k = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
                ulps[k / unit] = ulps.get(k / unit, 0) + 1
            emit({"phase": "compare_splat_request_e", "card": card,
                  "shape": list(img.shape), "device_ms": device_ms(run),
                  "phases_ms": splat_phases(run),
                  "ulps_of_100_runs": {str(k): ulps[k] for k in sorted(ulps)}})


# ---------------------------------------------------------------------------
# phase 12: the last entry points (demo, generate, flow, test_tmp), the
# MoTIF fields, the native host core and PWC-Net
# ---------------------------------------------------------------------------

DEMO_LR = (144, 180)          # Vid4 calendar's LR (its HR is 720x576)
DEMO_FRAMES, DEMO_SPACE, DEMO_TIME = 4, 4, 8
# one request each at bench.py's shape, the same weights per field
FIELD_REQUESTS = {"groups2": dict(groups=2), "trans": dict(trans=True),
                  "res_liff": dict(res_liff=True),
                  "local_ensemble": dict(local_ensemble=True),
                  "conv_synth": dict(siren=False)}
# the demo's STINF: 67 -> 64 -> 64 -> 256 -> 3 over 2 directions x 8 times
# x 576 x 720 tokens of one pair
STINF_DEMO = {"stinf_demo": (67, [64, 64, 256], 3, 2 * 8 * 576 * 720)}
COLLATE_GATE = 2e-5           # the native resize against the numpy one
COLLATE_CROPS = (128, 144, 240)
PWC_RTOL = 1e-4               # the card's float32 flow against the CPU's,
                              # relative to the largest |flow|


def field_entries(name: str, model, siren_kernel) -> dict:
    """What a field's request launches (3 times in one forward): one splat
    (at the generic width for groups=2), 42 DCNs, and the float32 SIREN
    launches of the MLPs it runs (`segments` of each: STINF and SINF, four
    times each under the local ensemble; res_liff's residual SIREN; the
    synthesis net unless it is the conv stack; at width 64 res_liff's 262
    inputs cut the synthesis net into two launches, its first layer alone
    on the streamed-weight kernel)."""
    from motif_tpu_torch.models.siren import Siren

    counts = {"siren_mlp/float32/whole": 0, "siren_mlp/float32/layer": 0}

    def add(net, times=1):
        ws = [m.weight for m in net._linears()]
        for s in siren_kernel.segments([ws[0].shape[1]]
                                       + [w.shape[0] for w in ws]):
            counts["siren_mlp/float32/" + ("layer" if s.layer
                                           else "whole")] += times
    for net in (model.flow_imnet, model.imnet):
        add(net, 4 if model.local_ensemble else 1)
    if model.res_liff:
        add(model.res_imnet)
    if isinstance(model.synth_net, Siren):
        add(model.synth_net)
    splat = ("splat_fused/float32/generic" if name == "groups2"
             else "splat_fused/float32/C=130")
    return {splat: 1, "dcn_im2col/float32": 42,
            **{k: v for k, v in counts.items() if v}}


def demo_frames(folder: str, seed: int) -> None:
    """DEMO_FRAMES frames of DEMO_LR from `seed`: a smooth texture (a
    random image 4x upsampled by MATLAB bicubic) moving 2 px down and 3
    px right a frame, written as PNGs."""
    from motif_tpu_torch.ops.resize import imresize_matlab_np
    from motif_tpu_torch.utils.video import save_img

    h, w = DEMO_LR
    small = np.random.default_rng(seed).random(
        ((h + 2 * DEMO_FRAMES) // 4 + 2, (w + 3 * DEMO_FRAMES) // 4 + 2, 3))
    big = np.clip(imresize_matlab_np(small * 255, 4) / 255, 0, 1)
    os.makedirs(folder, exist_ok=True)
    for k in range(DEMO_FRAMES):
        save_img(big[2 * k:2 * k + h, 3 * k:3 * k + w],
                 os.path.join(folder, f"{k:05d}.png"))


def run_demo(dev, card, args, mods, tmp):
    """`python -m motif_tpu_torch.demo` at Vid4's LR size, x4 space, x8
    time (3 pairs, 24 HR frames of 576x720) with the launches counted
    around it; then its one bucket: the captures (must be 1), the pool's
    bytes, pair 0 replayed against eager at request (a)'s gate and timed
    in turns (`replay`), eager against the plain versions, and the splat
    on the demo's own inputs. Returns (entries, splat row)."""
    from motif_tpu_torch import demo
    from motif_tpu_torch import eval as eval_mod
    from motif_tpu_torch.utils.video import read_seq_imgs

    softsplat, dcn, siren_kernel, kernels = mods
    frames_dir = os.path.join(tmp, "demo_in")
    out_dir = os.path.join(tmp, "demo_out")
    demo_frames(frames_dir, args.seed)
    made = []

    class Recorded(eval_mod.Evaluator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    t0 = time.perf_counter()
    obs.reset(obs.LAUNCHES)
    with mock.patch.object(eval_mod, "Evaluator", Recorded):
        res = demo.main(["--frames_dir", frames_dir, "--out_dir", out_dir,
                         "--space_scale", str(DEMO_SPACE), "--time_scale",
                         str(DEMO_TIME)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    entries = entry_counts()
    ev = made[0]
    pairs = DEMO_FRAMES - 1
    want = {"dcn_im2col/float32": 42 * pairs,
            "siren_mlp/float32/whole": 3 * pairs,
            "splat_fused/float32/C=130": pairs}
    hh, ww = DEMO_LR[0] * DEMO_SPACE, DEMO_LR[1] * DEMO_SPACE
    pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    line = {"phase": "demo", "card": card, "pairs": res["pairs"],
            "hr_frames": res["frames"], "out_hw": list(res["out_hw"]),
            "pngs": len(pngs), "captures": res["captures"],
            "launches": entries, "launches_per_pair": {
                k: v / pairs for k, v in entries.items()},
            "pool_bytes": pool_bytes(ev), "buckets": len(ev._buckets),
            "pair_seconds": res["pair_seconds"], "seconds": seconds,
            "note": "first pair: eager warm-up + capture; the others replay"}
    emit(line)
    if not (res["captures"] == 1 and len(ev._buckets) == 1
            and entries == want and res["frames"] == pairs * DEMO_TIME
            and len(pngs) == res["frames"]
            and tuple(res["out_hw"]) == (hh, ww)):
        raise AssertionError(f"demo: {line} (launches wanted {want})")

    f = read_seq_imgs(frames_dir)
    x0 = np.stack([f[0], f[0], f[1], f[1]], 0)[None]
    times = np.asarray([[i / DEMO_TIME for i in range(DEMO_TIME)]],
                       np.float32)
    got, _ = ev.infer(x0, times, (hh, ww))
    check_frames("demo", got, (DEMO_TIME, 1, hh, ww, 3))
    if ev.captures != 1:
        raise AssertionError(f"demo: {ev.captures} captures")
    r = hold_replay(ev, x0, times, "demo", 1e-5, 1e-5, card, (hh, ww), n=2)
    ms = r["captured_ms_median"]
    emit({"phase": "demo_time", "card": card, "pair_ms_captured": ms,
          "pair_ms_eager": r["eager_ms_median"],
          "hr_frames_per_s": DEMO_TIME * 1e3 / ms,
          "eager_hr_frames_per_s": DEMO_TIME * 1e3 / r["eager_ms_median"],
          "device_busy_share": r["device_busy_share"],
          "pool_bytes": r["pool_bytes"], "captures": ev.captures,
          "note": "one pair [f0, f0, f1, f1] -> 8 times at 576x720, iters "
                  "4, TF32 off; Evaluator.infer wall ms incl. the copy-out"})
    slice_vs_plain(ev, ev.model, x0, times, "demo", 1e-5, 1e-5, mods,
                   (hh, ww))
    inputs = capture_splat(ev, softsplat, x0, times, (hh, ww))
    del ev, made
    torch.cuda.empty_cache()
    row = check_splat_request(softsplat, kernels, inputs, "demo")
    img, flow, z, nonpos, sdt = inputs
    row["plain_ms"] = device_ms(lambda: softsplat.splat_fused_plain(
        img, flow, z, nonpos, scatter_dtype=sdt), reps=2)
    row["shape"] = list(img.shape)
    del inputs, img, flow, z
    torch.cuda.empty_cache()
    return entries, row


def run_field_requests(dev, card, mods):
    """The MoTIF fields (FIELD_REQUESTS) at full width on a request at
    bench.py's shape (LQ 64x112 -> 256x448, 3 times, iters 4): each
    counted alone (`field_entries`), against its plain versions (1e-5),
    replayed against eager and timed; the groups=2 splat (B·N·G = 12
    rows, C = 66: the generic width) on its own inputs. Returns the
    entries per field and that splat's row."""
    from motif_tpu_torch.eval import Evaluator
    from motif_tpu_torch.models.motif import build_motif

    softsplat, dcn, siren_kernel, kernels = mods
    lq = np.random.default_rng(0).random((1, 4, 64, 112, 3), dtype=np.float32)
    t3 = np.linspace(0, 1, 3, dtype=np.float32)[None]
    entries, row = {}, None
    for name, fields in FIELD_REQUESTS.items():
        t0 = time.perf_counter()
        model = build_motif(channel=64, front_rbs=5, back_rbs=40, device=dev,
                            seed=0, fields=fields)
        perturb_offsets(model, seed=1)
        ev = Evaluator(model, scale=4, iters=4, chunk=3, device=dev)
        obs.reset(obs.LAUNCHES)
        frames, _ = ev.infer(lq, t3, (256, 448))
        entries[name] = entry_counts()
        check_frames(name, frames, (3, 1, 256, 448, 3))
        want = field_entries(name, model, siren_kernel)
        if entries[name] != want:
            raise AssertionError(f"request ({name}) launched {entries[name]}"
                                 f" (wanted {want})")
        slice_vs_plain(ev, model, lq, t3, name, 1e-5, 1e-5, mods)
        if name == "groups2":
            inputs = capture_splat(ev, softsplat, lq, t3)
            row = check_splat_request(softsplat, kernels, inputs, name)
            img, flow, z, nonpos, sdt = inputs
            row["plain_ms"] = device_ms(lambda: softsplat.splat_fused_plain(
                img, flow, z, nonpos, scatter_dtype=sdt), reps=3)
            row["shape"] = list(img.shape)
            del inputs, img, flow, z
        r = hold_replay(ev, lq, t3, name, 1e-5, 1e-5, card, n=2)
        ms = r["captured_ms_median"]
        emit({"phase": f"request_{name}_time", "card": card,
              "forward_ms_median": ms, "hr_frames_per_s": 3e3 / ms,
              "eager_ms_median": r["eager_ms_median"],
              "fields": fields, "launches_per_request": entries[name],
              "device_busy_share": r["device_busy_share"],
              "pool_bytes": r["pool_bytes"],
              "seconds": time.perf_counter() - t0,
              "note": "Evaluator.infer wall time incl. host copy-out, TF32 "
                      "off, iters 4, LQ 4x64x112 -> HR 256x448, 3 times; "
                      "captured and eager in turns (`replay`)"})
        del model, ev
        torch.cuda.empty_cache()
    return entries, row


def run_entry_clis(card, mods, tmp):
    """generate, flow and test_tmp (`--max_clips 1`) over test.yml on
    data/Vid4 (its dataroots made absolute, run in `tmp`), each with the
    launches counted around it: generate's PNGs (out, GT, diff per time),
    flow's .flo files read back (finite, the HR size) beside their
    pictures, test_tmp's summary (finite). Returns the entries per CLI."""
    from motif_tpu_torch import flow, generate, test_tmp
    from motif_tpu_torch.utils.flow_io import read_flow

    kernels = mods[3]
    with open(os.path.join(ROOT, "test.yml")) as f:
        text = f.read()
    yml = os.path.join(tmp, "test_abs.yml")
    with open(yml, "w") as f:
        f.write(text.replace("./data/Vid4/", VID4 + "/"))
    entries, cwd = {}, os.getcwd()
    os.chdir(tmp)
    try:
        t0 = time.perf_counter()
        obs.reset(obs.LAUNCHES)
        clips = generate.main(["-opt", yml, "--out_dir", "gen"])
        entries["generate"] = entry_counts()
        pngs = os.listdir("gen")
        n_t = len(pngs) // 3
        emit({"phase": "generate_cli", "card": card, "clips": clips,
              "pngs": len(pngs), "launches": entries["generate"],
              "seconds": time.perf_counter() - t0})
        if clips != 1 or n_t < 1 or len(pngs) != 3 * n_t:
            raise AssertionError(f"generate: {clips} clips, {pngs}")

        t0 = time.perf_counter()
        obs.reset(obs.LAUNCHES)
        means = flow.main(["-opt", yml, "--out_dir", "fl", "--max_clips",
                           "1"])
        entries["flow"] = entry_counts()
        flos = sorted(f for f in os.listdir("fl") if f.endswith(".flo"))
        fields = [read_flow(os.path.join("fl", f)) for f in flos]
        n_png = sum(f.endswith(".png") for f in os.listdir("fl"))
        emit({"phase": "flow_cli", "card": card, "flo_files": len(flos),
              "pngs": n_png, "shape": list(fields[0].shape),
              "flow_abs_mean": means, "launches": entries["flow"],
              "seconds": time.perf_counter() - t0})
        if not (flos and n_png == len(flos)
                and all(np.isfinite(x).all() and x.shape[2] == 2
                        and x.shape[0] % 4 == 0 for x in fields)):
            raise AssertionError(f"flow: {len(flos)} .flo, {n_png} PNGs")

        t0 = time.perf_counter()
        obs.reset(obs.LAUNCHES)
        res = test_tmp.main(["-opt", yml, "--max_clips", "1",
                             "--t_scales", "6"])
        entries["test_tmp"] = entry_counts()
        (key, summary), = res.items()
        emit({"phase": "test_tmp_cli", "card": card, "sweep": list(key),
              "summary": summary, "launches": entries["test_tmp"],
              "seconds": time.perf_counter() - t0})
        if not np.isfinite(summary["psnr"]):
            raise AssertionError(f"test_tmp: {summary}")
    finally:
        os.chdir(cwd)
    for cli, e in entries.items():
        if not all(e.get(k, 0) > 0 for k in ("dcn_im2col/float32",
                                             "siren_mlp/float32/whole")) \
                or not any(k.startswith("splat_fused") for k in e) \
                or e["dcn_im2col/float32"] % 42:
            raise AssertionError(f"{cli}: launched {e}")
    return entries


def run_native(card, mods):
    """The native host core: built (g++ -fopenmp) or the phase fails; the
    arbitrary-scale collate at the `_a` recipes' batch (24 items of 4 LQ
    and 5 GT frames at the smoke trees' size, LQ_size 64) per crop in
    COLLATE_CROPS, timed with the core and with the numpy resize on the
    same draws, and their outputs compared (COLLATE_GATE)."""
    from motif_tpu_torch import native
    from motif_tpu_torch.data import pipeline

    t0 = time.perf_counter()
    built = native.available()
    emit({"phase": "native_core", "card": card, "built": built,
          "threads": native.num_threads(),
          "seconds": time.perf_counter() - t0,
          "log_tail": native.BUILD_LOG[-400:]})
    if not built:
        raise AssertionError(f"the native core was not built: "
                             f"{native.BUILD_LOG[-2000:]}")
    rng = np.random.default_rng(5)
    h, w = TREE_HW
    items = [{"lq_raw": [rng.random((h, w, 3), dtype=np.float32)
                         for _ in range(4)],
              "gt_raw": [rng.random((h, w, 3), dtype=np.float32)
                         for _ in range(5)],
              "times": rng.random(3).astype(np.float32)} for _ in range(24)]
    for crop in COLLATE_CROPS:
        def collate():
            return pipeline.collate_adobe_arbitrary(
                items, RECIPE_LQ_SIZE,
                PinnedScale(crop, [crop], RECIPE_LQ_SIZE))
        core = collate()
        ts_core = []
        for _ in range(3):
            t = time.perf_counter()
            collate()
            ts_core.append((time.perf_counter() - t) * 1e3)
        with mock.patch.object(native, "_load", lambda: None):
            plain = collate()
            ts_np = []
            for _ in range(2):
                t = time.perf_counter()
                collate()
                ts_np.append((time.perf_counter() - t) * 1e3)
        err = max(float(np.abs(core[k] - plain[k]).max())
                  for k in ("lq", "gt"))
        same = core["out_hw"] == plain["out_hw"] and np.array_equal(
            core["times"], plain["times"])
        emit({"phase": "native_collate", "card": card, "crop": crop,
              "batch": len(items), "out_hw": list(core["out_hw"]),
              "collate_ms_native": float(np.median(ts_core)),
              "collate_ms_numpy": float(np.median(ts_np)),
              "native_ms": ts_core, "numpy_ms": ts_np,
              "max_abs_err_vs_numpy": err, "tol": COLLATE_GATE,
              "threads": native.num_threads(),
              "note": "host ms on the loader's thread, one call a batch"})
        if not (same and err <= COLLATE_GATE):
            raise AssertionError(f"native collate at crop {crop}: {err} "
                                 f"(tol {COLLATE_GATE}), draws equal {same}")


def run_pwcnet(dev, card):
    """PWCNet and PWCNetLight (seed 0) on a seeded 448x256 pair on the card
    in float32, against the same call on the CPU in float32 (PWC_RTOL of
    the largest |flow|), timed."""
    import copy

    from motif_tpu_torch.models import pwcnet

    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.random((1, 256, 448, 3), dtype=np.float32))
    b = torch.from_numpy(np.roll(a.numpy(), (2, 3), (1, 2)) * 0.9 + 0.05)
    for name in ("PWCNet", "PWCNetLight"):
        torch.manual_seed(0)
        cpu = getattr(pwcnet, name)().eval()
        with torch.no_grad():
            t = time.perf_counter()
            want = cpu(a, b)
            cpu_s = time.perf_counter() - t
            m = copy.deepcopy(cpu).to(dev)
            ad, bd = a.to(dev), b.to(dev)
            got = m(ad, bd)
            ms = cuda_ms(lambda: m(ad, bd), reps=5, warmup=1)
        err = max_err(got.cpu(), want)
        scale = float(want.abs().max())
        emit({"phase": "pwcnet", "card": card, "model": name,
              "shape": list(got.shape), "ms": ms, "cpu_seconds": cpu_s,
              "max_abs_err_vs_cpu": err, "flow_abs_max": scale,
              "rtol": PWC_RTOL})
        if not (tuple(got.shape) == (1, 64, 112, 2)
                and torch.isfinite(got).all() and err <= PWC_RTOL * scale):
            raise AssertionError(f"{name}: {tuple(got.shape)}, err {err} "
                                 f"(max |flow| {scale})")
        del m, got


def run_phase12(dev, card, args, mods, Siren):
    """Phase 12. Returns what the kernels line needs: the launches per
    entry of the demo, of each field's request and of each CLI, and rows
    for the entries at the new shapes (the demo's splat and STINF, the
    groups=2 splat)."""
    t0 = time.perf_counter()
    softsplat, dcn, siren_kernel, kernels = mods
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        demo_entries, demo_splat = run_demo(dev, card, args, mods, tmp)
        stinf = check_siren(dev, siren_kernel, Siren, kernels,
                            mlps=STINF_DEMO)
        torch.cuda.empty_cache()
        field_e, groups_splat = run_field_requests(dev, card, mods)
        cli_e = run_entry_clis(card, mods, tmp)
    run_native(card, mods)
    run_pwcnet(dev, card)
    emit({"phase": "phase12", "seconds": time.perf_counter() - t0})
    return {"demo": demo_entries, "fields": field_e, "clis": cli_e,
            "demo_splat": demo_splat, "demo_stinf": stinf,
            "groups_splat": groups_splat}


# ---------------------------------------------------------------------------
# phase 13: motif_tpu's orbax train states, read without JAX
# ---------------------------------------------------------------------------

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "orbax_state")


def leaf_digests(tree, at=()) -> dict:
    """{key path: (dtype, shape, sha256 of the C-order bytes)} of a tree
    `read_orbax_tree` gives (a list index as its decimal string, a
    bfloat16 tensor as its uint16 bits), None for an empty leaf: the form
    of tests/fixtures/orbax_state/leaves.json."""
    if isinstance(tree, dict) and tree:
        return {p: d for k, v in tree.items()
                for p, d in leaf_digests(v, at + (k,)).items()}
    if isinstance(tree, list) and tree:
        return {p: d for i, v in enumerate(tree)
                for p, d in leaf_digests(v, at + (str(i),)).items()}
    if tree is None or isinstance(tree, (dict, list)):
        return {at: None}
    if isinstance(tree, torch.Tensor):
        raw, dtype = tree.view(torch.int16).numpy().view(np.uint16), \
            "bfloat16"
    else:
        raw = np.asarray(tree)
        dtype = raw.dtype.name
    return {at: (dtype, list(raw.shape), hashlib.sha256(
        np.ascontiguousarray(raw).tobytes()).hexdigest())}


def read_fixture(card) -> float:
    """The committed state motif_tpu wrote (tools/make_orbax_fixture.py)
    read by `read_orbax_tree` on this machine: every leaf's dtype, shape
    and sha256 as orbax's own restore listed them, the same keys stored out
    of line. Returns the read's milliseconds."""
    from motif_tpu_torch import checkpoint, ocdbt
    from motif_tpu_torch.utils import zstd

    with open(os.path.join(FIXTURE, "leaves.json")) as f:
        spec = json.load(f)
    t0 = time.perf_counter()
    tree = checkpoint.read_orbax_tree(FIXTURE)
    read_ms = (time.perf_counter() - t0) * 1e3
    got = leaf_digests(tree)
    want = {tuple(r["path"]): None if r["dtype"] is None else
            (r["dtype"], r["shape"], r["sha256"]) for r in spec["leaves"]}
    bad = sorted("/".join(p) for p in set(got) | set(want)
                 if got.get(p, "absent") != want.get(p, "absent"))
    store = ocdbt.OcdbtStore(os.path.join(FIXTURE, spec["step_dir"]))
    out_of_line = sorted(k.decode() for k, v in store.entries.items()
                         if not isinstance(v, bytes))
    emit({"phase": "orbax_fixture", "card": card,
          "zstd": f"ctypes {zstd.LIBRARY} {zstd.version()}",
          "read_ms": read_ms, "leaves": len(want),
          "leaves_equal": len(want) - len(bad), "mismatched": bad[:10],
          "out_of_line": out_of_line, "nodes": store.nodes,
          "written_by": f"orbax {spec['orbax']}"})
    if bad or out_of_line != spec["out_of_line"]:
        raise AssertionError(f"orbax fixture: leaves {bad[:10]} differ from "
                             f"leaves.json; out of line {out_of_line}")
    return read_ms


def flax_tree(tensors: dict) -> dict:
    """motif_tpu's flax tree of a {port key: tensor} map, numpy on the
    host: the inverse of checkpoint.state_dict_from_flax (the flax path of
    each key, kernels HWIO / IO, the scanned families' blocks stacked on a
    leading axis under <family>/block, as
    motif_tpu/checkpoint.py::_stack_scanned_blocks lays them)."""
    from motif_tpu_torch import checkpoint

    tree: dict = {}
    for key, t in tensors.items():
        path = checkpoint.torch_key_to_flax_path(key)
        a = t.detach().cpu().numpy()
        if path[-1] == "kernel" and a.ndim == 4:
            a = a.transpose((2, 3, 0, 1) if any(
                n in path for n in checkpoint.TRANSPOSED_CONV_NAMES)
                else (2, 3, 1, 0))
        elif path[-1] == "kernel" and a.ndim == 2:
            a = a.T
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return _stack_blocks(tree, checkpoint.SCANNED_BLOCK_FAMILIES)


def _stack_blocks(tree, families):
    if not isinstance(tree, dict):
        return tree
    for fam in families:
        idx = sorted(int(m.group(1)) for k in tree
                     if (m := re.fullmatch(re.escape(fam) + r"_(\d+)", k)))
        if idx and idx == list(range(len(idx))):
            tree[fam] = {"block": _stack_leaves(
                [tree.pop(f"{fam}_{i}") for i in idx])}
    return {k: _stack_blocks(v, families) for k, v in tree.items()}


def _stack_leaves(blocks):
    if isinstance(blocks[0], dict):
        return {k: _stack_leaves([b[k] for b in blocks]) for k in blocks[0]}
    return np.stack(blocks)


def optax_tree(trainer) -> dict:
    """The tree motif_tpu would have saved for `trainer` (Adam): its
    TrainState as orbax's raw restore gives it back, {params, opt_state:
    [scale_by_adam's {count, mu, nu}, the schedule's {count}], step},
    int32 counts and step."""
    names = [n for n, _ in trainer.model.named_parameters()]
    state = trainer.optimizer.state_dict()["state"]
    counts = {int(float(s["step"])) for s in state.values()}
    if len(counts) != 1 or len(state) != len(names):
        raise AssertionError(f"optimiser state: counts {counts}, "
                             f"{len(state)} of {len(names)} parameters")
    count = np.asarray(counts.pop(), np.int32)
    moments = {m: flax_tree({n: state[i][key] for i, n in enumerate(names)})
               for m, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}
    return {"params": flax_tree(trainer.model.state_dict()),
            "opt_state": [{"count": count, **moments},
                          {"count": count.copy()}],
            "step": np.asarray(trainer.step_count, np.int32)}


def run_orbax(dev, card, mods):
    """Phase 13. (a) The committed fixture read on this machine
    (`read_fixture`). (b) The full-width two-anchor Ours of phase 7's yml
    after one step on its first batch, with the launch counters set to 0
    before the step: its TrainState in motif_tpu's layout (`optax_tree`)
    mapped onto a fresh trainer whose weights were zeroed by the function
    `restore_train_state` uses (`checkpoint.load_optax_train_state`);
    the next step of both trainers on the plain versions under the
    deterministic algorithms (the kernels' float sums are not run to run
    bit-equal) equal bit for bit, loss and every parameter, the restored
    trainer's generator aligned with the first's (a resumed run draws
    from a fresh one, as motif_tpu's does); request (a)'s inputs served
    from the restored model through Evaluator.infer, the counters read
    after it, then held against its plain versions at request (a)'s gate.
    Returns the launches by entry of the step and the request."""
    from motif_tpu_torch import checkpoint, train
    from motif_tpu_torch.data import device_prefetch
    from motif_tpu_torch.eval import Evaluator
    from motif_tpu_torch.utils import config as cfg

    softsplat, dcn, siren_kernel, kernels = mods
    t0 = time.perf_counter()
    read_ms = read_fixture(card)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        opt = cfg.parse(train_yml(tmp), is_train=True)
        model, loader, tr = train.setup(opt, dev, dataset_seed=0)
        batches = device_prefetch(loader.epoch(0), dev)
        b1, b2 = next(batches), next(batches)
        batches.close()
        _, _, tr2 = train.setup(opt, dev, dataset_seed=0)
    with torch.no_grad():
        for p in tr2.params:
            p.zero_()

    # ---- the main path: counters to 0, a step, the mapping, a request --
    obs.reset(obs.LAUNCHES)
    tr.step(b1)
    tree = optax_tree(tr)
    torch.cuda.synchronize()
    t_map = time.perf_counter()
    checkpoint.load_optax_train_state(tr2, tree, "the phase-13 TrainState")
    torch.cuda.synchronize()
    map_ms = (time.perf_counter() - t_map) * 1e3
    rng = np.random.default_rng(0)
    lq_a = rng.random((1, 4, 64, 112, 3), dtype=np.float32)
    t3 = np.linspace(0, 1, 3, dtype=np.float32)[None]
    restored = tr2.model
    ev = Evaluator(restored, scale=4, iters=4, chunk=3, device=dev)
    frames, _ = ev.infer(lq_a, t3, (256, 448))
    entries = {k: v for k, v in entry_counts().items() if v}
    want_entries = {k: TRAIN_ENTRIES[k] + EVAL_ENTRIES["fp32"][k]
                    for k in TRAIN_ENTRIES}
    check_frames("orbax_a", frames, (3, 1, 256, 448, 3))
    slice_vs_plain(ev, restored, lq_a, t3, "orbax_a", 1e-5, 1e-5, mods)

    # ---- the next step of both trainers, bit for bit ----
    tr2._rng.setstate(tr._rng.getstate())
    same_state = (tr2.step_count == tr.step_count and all(
        torch.equal(a, b) for a, b in zip(tr.params, tr2.params)))
    with plain_versions(softsplat, dcn, siren_kernel), deterministic():
        aux = tr.step(b2)
        aux2 = tr2.step(b2)
    torch.cuda.synchronize()
    equal = [torch.equal(a, b) for a, b in zip(tr.params, tr2.params)]
    emit({"phase": "orbax_resume", "card": card,
          "params": sum(p.numel() for p in tr.params),
          "tensors": len(tr.params), "step_count": tr2.step_count,
          "adam_count": int(tree["opt_state"][0]["count"]),
          "fixture_read_ms": read_ms, "map_ms": map_ms,
          "restored_bit_equal": same_state,
          "next_step_loss": float(aux["loss"]),
          "next_step_loss_restored": float(aux2["loss"]),
          "next_step_use_gt": [aux["use_gt"], aux2["use_gt"]],
          "next_step_params_bit_equal": sum(equal),
          "entries": entries, "entries_wanted": want_entries,
          "seconds": time.perf_counter() - t0})
    if not same_state or not all(equal) or \
            float(aux["loss"]) != float(aux2["loss"]):
        raise AssertionError(
            f"orbax resume: restored state equal {same_state}, "
            f"{len(equal) - sum(equal)} parameters differ after the next "
            f"step, loss {float(aux['loss'])} vs {float(aux2['loss'])}")
    if entries != want_entries:
        raise AssertionError(f"orbax resume launched {entries}, wanted "
                             f"{want_entries}")
    del tr, tr2, model, restored, ev
    torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------

LAYER_SRC = "motif_tpu_torch/csrc/siren_layer.cu"


def f32_entries(entries: dict) -> dict:
    """The float32 SIREN launches of `entries` by entry."""
    return {k: entries.get(k, 0) for k in ("siren_mlp/float32/whole",
                                           "siren_mlp/float32/layer")}


def f32_sirens(entries: dict) -> int:
    """Every float32 SIREN launch of `entries`: resident runs and single
    layers."""
    return sum(f32_entries(entries).values())


def card_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="write torch.profiler tables of requests (a) and "
                         "(e) and of one training step to DIR")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the data the smoke makes (the Adobe_flow "
                         "arrays of phase 10)")
    ap.add_argument("--compare-only", metavar="DIR",
                    help="only time dcn_v2 (float32 at L1, bfloat16 at L1 - "
                         "L3), the bfloat16 siren_mlp entries, the splat and "
                         "requests (a) and (e) and profile the requests into "
                         "DIR, through entry points that "
                         "older checkouts share (run one with `python3 -P` "
                         "and its tree first on PYTHONPATH)")
    args = ap.parse_args()
    faulthandler.enable()            # a crash prints where it happened

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    # the package must sit beside this script
    from motif_tpu_torch.models.siren import Siren
    from motif_tpu_torch.ops import dcn, kernels, siren_kernel, softsplat

    dev = torch.device("cuda", 0)
    card = card_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": card, "clocks_sm_max_and_now": card_line(
              "clocks.max.sm,clocks.sm"), "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})

    build_s = kernels.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "bytes stack" in ln]
             for name, log in kernels.BUILD_LOGS.items()}
    emit({"phase": "build", "seconds": build_s, "sources": getattr(kernels, "SOURCES", kernels.KERNELS),
          "ptxas": ptxas})

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "tf32", "matmul.allow_tf32": False,
          "cudnn.allow_tf32": False})
    if args.compare_only:
        compare_only(dev, card, args.compare_only)
        return 0

    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    results = {
        "splat_fused/float32/C=130": check_splat(dev, softsplat, kernels),
        "splat_fused/float32/C=64": check_splat(dev, softsplat, kernels, 64),
        "splat_fused/float16/C=64": check_splat(dev, softsplat, kernels, 64,
                                                f16),
        "dcn_im2col/float32": check_dcn(dev, dcn, kernels),
        "dcn_im2col/bfloat16": check_dcn(dev, dcn, kernels, bf16),
        "siren_mlp/float32/whole": check_siren(dev, siren_kernel, Siren,
                                               kernels),
        "siren_mlp/float32/skip_first": check_siren(
            dev, siren_kernel, Siren, kernels, f32, True),
        "siren_mlp/bfloat16/whole": check_siren(dev, siren_kernel, Siren,
                                                kernels, bf16),
        "siren_mlp/bfloat16/skip_first": check_siren(
            dev, siren_kernel, Siren, kernels, bf16, True),
    }
    check_siren_layers(dev, siren_kernel)
    layer_rows = check_siren_layers_f32(dev, siren_kernel, kernels)
    check_dcn_v2(dev, dcn)
    if set(results) != set(ENTRIES):
        raise AssertionError("an entry was not held against its plain version")
    launches, entry_launches, per_request, entries, preacts = run_slice(
        dev, args, card)
    eval_entries = run_eval(dev, card, (softsplat, dcn, siren_kernel, kernels))
    train_per_step, train_back = run_train(
        dev, card, args, (softsplat, dcn, siren_kernel, kernels))
    four = run_four_anchor(dev, card, args,
                           (softsplat, dcn, siren_kernel, kernels), Siren)
    base, dcn16, sirens = run_baseline_phase(
        dev, card, args, (softsplat, dcn, siren_kernel, kernels), Siren)
    mods = (softsplat, dcn, siren_kernel, kernels)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        (recipes, setting_requests, splat_c130, synth_s6, trees,
         recipe_lines) = run_recipe_phase(dev, card, args, mods, Siren, tmp)
        liif_steps, liif_row, bf16_steps, bf16_rows = run_phase11(
            dev, card, mods, Siren, tmp, trees, recipe_lines)
    p12 = run_phase12(dev, card, args, mods, Siren)
    orbax_entries = run_orbax(dev, card, mods)

    meta = {
        "splat_fused": ("motif_tpu_torch/csrc/splat_fused.cu",
                        "motif_tpu/ops/softsplat_pallas.py:82"),
        "dcn_im2col": ("motif_tpu_torch/csrc/dcn_im2col.cu",
                       "motif_tpu/ops/dcn_pallas.py:37"),
        "siren_mlp": ("motif_tpu_torch/csrc/siren_mlp.cu",
                      "motif_tpu/ops/siren_kernel.py:41"),
    }
    also = {"dcn_im2col": ["motif_tpu/ops/dcn_pallas.py:152"]}
    rows = []
    for entry in ENTRIES:
        name, variant = entry.split("/", 1)
        src, replaces = meta[name]
        if entry.startswith("siren_mlp/bfloat16"):
            src = "motif_tpu_torch/csrc/siren_mlp_bf16.cu"
        r = results[entry]
        row = {"name": f"{name}[{variant}]", "kernel": name, "route": "cuda",
               "source": src, "replaces": replaces,
               "launches": entry_launches[entry],
               "max_abs_err": r["max_abs_err"],
               "ms": r["ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": r["library_ms"], "eager_ms": r["eager_ms"],
               "launches_request_a": entries["a"].get(entry, 0),
               "launches_request_e": entries["e"].get(entry, 0),
               "launches_eval": {c: e.get(entry, 0)
                                 for c, e in eval_entries.items()}}
        row["launches_train_step"] = train_per_step[entry]
        row["launches_request_h"] = four["launches_request_h"].get(entry, 0)
        row["launches_request_i"] = four["launches_request_i"].get(entry, 0)
        row["launches_eval_vimeo44"] = {
            c: e.get(entry, 0)
            for c, e in four["launches_eval_vimeo44"].items()}
        row["launches_train_step_ours44"] = \
            four["launches_train_step_ours44"][entry]
        row["plain_backward_ms_train_step_ours44"] = (
            four["plain_backward_ms_train_step_ours44"][name]["device_ms"]
            if entry in TRAIN_ENTRIES else None)
        row["plain_backward_ms_train_step"] = (
            train_back[name]["device_ms"] if entry in TRAIN_ENTRIES else None)
        row["plain_backward_event_ms_train_step"] = (
            train_back[name]["event_ms"] if entry in TRAIN_ENTRIES else None)
        row["launches_baselines"] = {
            f: {path: e.get(entry, 0) for path, e in runs.items()}
            for f, runs in base.items()}
        row["launches_recipes_per_step"] = {
            y: e.get(entry, 0) for y, e in recipes.items()}
        row["launches_setting_requests"] = {
            k: e.get(entry, 0) for k, e in setting_requests.items()}
        row["launches_demo"] = p12["demo"].get(entry, 0)
        row["launches_fields"] = {f: e.get(entry, 0)
                                  for f, e in p12["fields"].items()}
        row["launches_entry_clis"] = {c: e.get(entry, 0)
                                      for c, e in p12["clis"].items()}
        row["launches_orbax_resume"] = orbax_entries.get(entry, 0)
        if "device_kernels_per_call" in r:
            row["device_kernels_per_call"] = r["device_kernels_per_call"]
        if name in also:
            row["also_replaces"] = also[name]
        rows.append(row)
    # the entries at the baselines' new shapes: the DCN at EDVR's L1 (its
    # launches: an EDVR request's), the three VideoINR SIRENs of one time
    # summed (their launches: a LIIF request's, 3 times)
    src, replaces = meta["dcn_im2col"]
    rows.append({
        "name": "dcn_im2col[float32/cg=16]", "kernel": "dcn_im2col",
        "route": "cuda", "source": src, "replaces": replaces,
        "launches": base["EDVR"]["request"]["dcn_im2col/float32"],
        **{k: dcn16[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms", "eager_ms")},
        "shape": "EDVR PCD L1: 2x64x112, G 8, cg 16, K 3",
        "also_replaces": also["dcn_im2col"]})
    src, replaces = meta["siren_mlp"]
    worst = max(sirens.values(), key=lambda r: r["bound_ms"])
    rows.append({
        "name": "siren_mlp[float32/whole/VideoINR]", "kernel": "siren_mlp",
        "route": "cuda", "source": f"{src} + {LAYER_SRC}",
        "replaces": replaces,
        "launches": f32_sirens(base["LIIF"]["request"]),
        "launches_by_entry": f32_entries(base["LIIF"]["request"]),
        "max_abs_err": max(r["max_abs_err"] for r in sirens.values()),
        **{k: sum(r[k] for r in sirens.values())
           for k in ("ms", "plain_ms", "bound_ms", "library_ms", "eager_ms")},
        "bound_by": worst["bound_by"],
        "shape": "feat_imnet + flow_imnet + encode_imnet, 114,688 tokens "
                 "each (one time of a 256x448 request)"})
    # the entries at phase 10's new shapes: the float16-sum splat at C =
    # 130 on the setting-6 serving request's own inputs (its launches:
    # that request's), the synthesis net of setting 6 (331 inputs), cut
    # into two launches in either type (its launches: the setting-6
    # recipe's CLI run, a step's STINF, SINF and the synthesis net's two;
    # the serving request's)
    src, replaces = meta["splat_fused"]
    rows.append({
        "name": "splat_fused[float16/C=130]", "kernel": "splat_fused",
        "route": "cuda", "source": src, "replaces": replaces,
        "launches": setting_requests["s6_serving"][
            "splat_fused/float16/C=130"],
        **{k: splat_c130[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "eager_ms")},
        "shape": "setting 6 serving request's splat: 6x256x448x130"})
    for dt, r in synth_s6.items():
        rows.append({
            "name": f"siren_mlp[{dt}/whole/cut]", "kernel": "siren_mlp",
            "route": "cuda",
            "source": ("motif_tpu_torch/csrc/siren_mlp_bf16.cu"
                       if dt == "bfloat16" else meta["siren_mlp"][0]),
            "replaces": meta["siren_mlp"][1],
            "launches": (setting_requests["s6_serving"][
                "siren_mlp/bfloat16/whole"] if dt == "bfloat16" else
                int(RECIPE_CLI_STEPS * f32_sirens(
                    recipes["train_OursZSM_adobe_a.yml"]))),
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms", "eager_ms")},
            "shape": "setting 6 synthesis net 331->64->64->64->256->3, "
                     "344,064 tokens, two launches"})
    # phase 11's entries at new shapes: VideoINR's three float32 SIRENs at
    # 4 LQ frames over one time of a LIIF recipe step, summed (their
    # launches: the LIIF CLI's); the three entries that train for the
    # first time under the knobs, at the knobs' recipe shapes, each with
    # its plain backward's time (their launches: the knobs' CLI run)
    src, replaces = meta["siren_mlp"]
    liif = LIIF_RECIPES[0]
    rows.append({
        "name": "siren_mlp[float32/whole/LIIF train]", "kernel": "siren_mlp",
        "route": "cuda", "source": f"{src} + {LAYER_SRC}",
        "replaces": replaces,
        "launches": int(RECIPE_CLI_STEPS * f32_sirens(liif_steps[liif])),
        "launches_by_entry": f32_entries(liif_steps[liif]),
        **{k: liif_row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "eager_ms", "backward_ms_encode_imnet")},
        "shape": "feat_imnet 463 + flow_imnet 525 + encode_imnet 1049 "
                 "inputs, 393,216 tokens each (one time of a LIIF step at "
                 "batch 24, 128²)"})
    shapes = {"splat_fused/float16/C=130": "144x128x128x130 (2 x 24 x 3 "
              "images of the knobs' Adobe step)",
              "dcn_im2col/bfloat16": "PCD L1 24x32x32, G 8, cg 8, K 3",
              "siren_mlp/bfloat16/whole": "STINF 67->64->64->256->3, "
              "2,359,296 tokens"}
    for entry, r in bf16_rows.items():
        name, variant = entry.split("/", 1)
        src, replaces = meta[name]
        if name == "siren_mlp":
            src = "motif_tpu_torch/csrc/siren_mlp_bf16.cu"
        rows.append({
            "name": f"{name}[{variant}/train]", "kernel": name,
            "route": "cuda", "source": src, "replaces": replaces,
            "launches": int(RECIPE_CLI_STEPS * bf16_steps[entry]),
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms",
                                 "eager_ms", "backward_ms", "grad_rel_err")},
            "shape": shapes[entry],
            "backward": "plain PyTorch in the working type (new: trains)"})
    # phase 12's entries at new shapes: the float32 splat on the demo's
    # pair (16 images of 576x720, C = 130) and on the groups=2 request (12
    # images of 256x448 at the generic width C = 66), each on its request's
    # own inputs; the demo's STINF at a pair's tokens (the launches: every
    # float32 SIREN of the demo's 3 pairs)
    src, replaces = meta["splat_fused"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "eager_ms")
    for name, r, launches in (
            ("float32/C=130/demo", p12["demo_splat"],
             p12["demo"]["splat_fused/float32/C=130"]),
            ("float32/generic/groups2", p12["groups_splat"],
             p12["fields"]["groups2"]["splat_fused/float32/generic"])):
        rows.append({"name": f"splat_fused[{name}]", "kernel": "splat_fused",
                     "route": "cuda", "source": src, "replaces": replaces,
                     "launches": launches, **{k: r[k] for k in keys},
                     "shape": "x".join(map(str, r["shape"]))})
    src, replaces = meta["siren_mlp"]
    rows.append({
        "name": "siren_mlp[float32/whole/demo STINF]", "kernel": "siren_mlp",
        "route": "cuda", "source": src, "replaces": replaces,
        "launches": p12["demo"]["siren_mlp/float32/whole"],
        **{k: p12["demo_stinf"][k] for k in keys},
        "shape": "STINF 67->64->64->256->3, 6,635,520 tokens (one demo "
                 "pair: 2 directions x 8 times x 576x720)"})
    # the streamed-weight layer at its paths' shapes, one row a path: a
    # time's single layers summed (their launches: the path's, counted
    # alone in its phase)
    layer_paths = (
        ("VideoINR request", ("request_201x64", "request_525x64",
                              "request_256x256", "request_256x3"),
         base["LIIF"]["request"]["siren_mlp/float32/layer"],
         "201->64 + 525->64 + 256->256 + 256->3, 114,688 tokens each (one "
         "time of a 256x448 request)"),
        ("LIIF train", ("liif_train_463x64", "liif_train_525x64",
                        "liif_train_1049x64", "liif_train_256x256",
                        "liif_train_256x3"),
         int(RECIPE_CLI_STEPS * liif_steps[liif]["siren_mlp/float32/layer"]),
         "463->64 + 525->64 + 1049->64 + 256->256 + 256->3, 393,216 tokens "
         "each (one time of a LIIF step at batch 24, 128²)"),
        ("setting 6 synth", ("synth_s6_331x64",),
         int(RECIPE_CLI_STEPS * recipes["train_OursZSM_adobe_a.yml"][
             "siren_mlp/float32/layer"]),
         "331->64, 344,064 tokens (the first layer of setting 6's synthesis "
         "net)"))
    for path, cases, launches, shape in layer_paths:
        rs = [layer_rows[c] for c in cases]
        rows.append({
            "name": f"siren_mlp[float32/layer/{path}]", "kernel": "siren_mlp",
            "route": "cuda", "source": LAYER_SRC, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "max_abs_err_reference": "ascending-k FMA chain",
            "max_abs_err_vs_plain": max(r["max_abs_err_vs_plain"]
                                        for r in rs),
            **{k: sum(r[k] for r in rs)
               for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                         "eager_ms")},
            "bound_by": max(rs, key=lambda r: r["bound_ms"])["bound_by"],
            "by_launch_ms": [r["ms"] for r in rs],
            "by_launch_library_ms": [r["library_ms"] for r in rs],
            "shape": shape})
    # the fused decode's pre-activations on request (e)'s parts (their
    # launches: the main path's), request (i)'s beside them
    for site, r in preacts.items():
        entry = f"preact/{site}"
        rows.append({
            "name": f"preact[{site}]", "kernel": "preact", "route": "cuda",
            "source": "motif_tpu_torch/csrc/preact_bf16.cu",
            "replaces": "motif_tpu/models/motif.py:411 (the fused decode's "
                        "sums, fused by XLA)",
            "launches": entry_launches[entry],
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "eager_ms")},
            "shape": "x".join(map(str, r["shape"])),
            "launches_request_e": entries["e"].get(entry, 0),
            "launches_request_i": four["launches_request_i"].get(entry, 0),
            "request_i": four["preact_request_i"][site]})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
