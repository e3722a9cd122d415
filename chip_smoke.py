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
     outputs and the reach of one flipped rounding. The DCN im2col also
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
     last, after phases 7, 8 and 9; each kernel row also carries its
     launches on every path (requests, eval CLIs, training steps of both
     models, the baselines) and its plain backward's device ms in one
     two-anchor step; two more rows hold the entries at the baselines'
     shapes (the DCN at cg 16, VideoINR's three SIRENs);
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
     64x112 -> 256x448, 3 times one a forward with RAFT on the 12 cross
     pairs, each counted alone, held against its plain versions, (i)
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
     family's DCNs; VideoINR's SIRENs, cut into 8 launches a time), held
     against its plain versions (1e-5), timed; the eval CLI
     over the family's yml on one Vid4 clip from a reference-format .pth
     against its plain versions (EVAL_GATES fp32); then the DCN at EDVR's
     16 channels a group (L1 - L3) and the float32 SIREN at VideoINR's
     three widths over a request's 114,688 tokens (a cut MLP also launch
     by launch).
Every request goes through Evaluator.infer, which on CUDA replays one
captured CUDA graph per shape bucket: each request of phases 4, 8 and 9 is
also held, replayed, against the same request run eagerly (`_infer_eager`,
at the request's own gate, beside the distance of two eager runs and their
share of bit-equal frames), timed eager and captured in turns, with the
device's busy share of a captured request from its graph's replays timed
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
import dataclasses
import faulthandler
import hashlib
import json
import os
import subprocess
import sys
import time
from unittest import mock

# cuBLAS is deterministic under torch's deterministic algorithms only with
# a fixed workspace, set before CUDA starts (the training gates' state)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

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
    n0 = kernels.LAUNCHES["splat_fused"]
    got = softsplat.splat_fused(img, flow, z, z_nonpositive=nonpos,
                                scatter_dtype=sdt)
    launches = kernels.LAUNCHES["splat_fused"] - n0
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
    timed, by phase too, with its tile lists."""
    img, flow, z, nonpos, sdt = inputs
    held = hold_splat(softsplat, kernels, img, flow, z, nonpos,
                      1e-4 if sdt is None else 4, sdt)
    B, H, W, C = img.shape
    b_ms, _ = splat_bound(B, H, W, C, nonpos)
    tile = list(softsplat.plan(C, 4 if sdt is None else 2))

    def run():
        return softsplat.splat_fused(img, flow, z, nonpos, scatter_dtype=sdt)
    ms = device_ms(run)
    emit({"check": "splat_fused", "case": "request_" + request,
          "sums": dname(sdt or torch.float32), "shape": [B, H, W, C],
          "z_nonpositive": nonpos, "tile": tile, **held, "ms": ms,
          "bound_ms": b_ms, "fraction_of_bound": b_ms / ms,
          "library_ms": index_add_ms(softsplat, img, flow, z, sdt),
          "library": f"{dname(sdt or torch.float32)} index_add_",
          "eager_ms": cuda_ms(run), "phases_ms": splat_phases(run),
          "flow_abs_max": float(flow.abs().max()),
          "lists": tile_lists(flow, tile)})


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
        n0 = kernels.LAUNCHES["dcn_im2col"]
        got = dcn.dcn_im2col(*args)
        launches = kernels.LAUNCHES["dcn_im2col"] - n0
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
        n0 = kernels.LAUNCHES["siren_mlp"]
        got = run()
        launches = kernels.LAUNCHES["siren_mlp"] - n0
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
              **({"by_launch": siren_launch_ms(siren_kernel, x, ws, bs,
                                               skip_first)}
                 if launches > 1 else {})})
        first = first or line
    return dict(max_abs_err=worst, **first)


def siren_launch_ms(siren_kernel, x, ws, bs, skip_first):
    """A float32 MLP cut into launches (`siren_kernel.segments`), each
    launch's layers timed as an MLP of their own on the input the launch
    reads (the plain version's activation before it), beside `addmm` +
    `sin` of the same layers: device ms."""
    dims = [x.shape[-1]] + [w.shape[0] for w in ws]
    h, rows = x, []
    for s in siren_kernel.segments(dims):
        lw, lb = list(ws[s.first:s.last]), list(bs[s.first:s.last])
        lw[-1] = lw[-1][s.cols[0]:s.cols[1]].contiguous()
        lb[-1] = lb[-1][s.cols[0]:s.cols[1]].contiguous()
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
        rows.append({"layers": [s.first, s.last], "cols": list(s.cols),
                     "dims": s.dims, "smem": s.smem,
                     "ms": device_ms(kernel, reps=10),
                     "library_ms": device_ms(library, reps=10)})
        if s.cols[1] == dims[s.last]:
            h = siren_kernel.siren_mlp_plain(
                h, ws[s.first:s.last], bs[s.first:s.last], 30.0, sine,
                skip)
    return rows


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
    def siren_plain(*a, packed=None, **kw):   # the kernel's buffer: unused
        return siren_kernel.siren_mlp_plain(*a, **kw)
    with mock.patch.object(softsplat, "splat_fused",
                           softsplat.splat_fused_plain), \
            mock.patch.object(dcn, "dcn_im2col", dcn.dcn_im2col_plain), \
            mock.patch.object(siren_kernel, "siren_mlp", siren_plain):
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
    """Device ms of one replay of the graph of the request's bucket, by
    CUDA events over `reps` replays back to back (a replay's kernels run
    with no host gap between them), and the request's chunks. torch.profiler
    is not used on replays: CUPTI segfaulted the process in them (PERF.md
    §7)."""
    lq_p, chunks, _, hw = ev._plan(lq, times)
    graph = ev._buckets[ev._key(lq_p.shape, chunks[0].shape, hw)].graph
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
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
    device's busy share of a captured request: its chunks' graph replays
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
            "device_busy_ms": chunks * g_ms,
            "device_busy_share": chunks * g_ms / captured,
            "buckets": len(getattr(ev, "_buckets", {})),
            "pool_bytes": pool_bytes(ev),
            "note": "Evaluator.infer wall ms incl. the frames' copy to the "
                    "host, eager and captured in turns: e, c, c, e; busy = "
                    "chunks x graph_device_ms (CUDA events) / captured "
                    "median"}
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


def slice_vs_plain(ev, model, lq, times, name, tol, stats_rtol, mods):
    """One request against the same forward with the plain versions, both
    run eagerly: the frames, the synthesis output before the clip (most
    frames clip with random weights; every forward of the request) and the
    flow statistics."""
    softsplat, dcn, siren_kernel, kernels = mods
    pre_clip = []
    hook = model.synth_net.register_forward_hook(
        lambda mod, inp, out: pre_clip.append(out.double().cpu()))
    f_k, stats_k = eager(ev)(lq, times, (256, 448))   # kernels, hooked
    with plain_versions(softsplat, dcn, siren_kernel):
        kernels.reset_launches()
        f_plain, stats_plain = eager(ev)(lq, times, (256, 448))
        if any(kernels.LAUNCHES.values()):
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


def capture_splat(ev, softsplat, lq, times):
    """The splat's inputs on one request."""
    captured = []
    splat = softsplat.splat_fused

    def spy(img, flow, z, z_nonpositive, scatter_dtype=None):
        captured.append((img.clone(), flow.clone(), z.clone(), z_nonpositive,
                         scatter_dtype))
        return splat(img, flow, z, z_nonpositive, scatter_dtype)
    with mock.patch.object(softsplat, "splat_fused", spy):
        eager(ev)(lq, times, (256, 448))
    return captured[0]


# What request (e) must launch and nothing else of these kernels: 42 DCNs,
# three SIRENs per decode chunk and one splat per forward.
def serving_entries(chunks: int) -> dict:
    return {"dcn_im2col/bfloat16": 42,
            "siren_mlp/bfloat16/skip_first": 3 * chunks,
            "splat_fused/float16/C=64": 1}


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
    kernels.reset_launches()
    per_request, entries = {}, {}

    def counted(name, fn):
        before, ebefore = dict(kernels.LAUNCHES), dict(kernels.ENTRY_LAUNCHES)
        out = fn()
        per_request[name] = {k: v - before[k]
                             for k, v in kernels.LAUNCHES.items()}
        entries[name] = {k: v - ebefore.get(k, 0)
                         for k, v in kernels.ENTRY_LAUNCHES.items()
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
    launches = dict(kernels.LAUNCHES)
    entry_launches = dict(kernels.ENTRY_LAUNCHES)
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
    return launches, entry_launches, per_request, entries


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
    kernels.reset_launches()
    summary, clock = cli_run(tmp, yml, pth, clips)
    launches, entries = dict(kernels.LAUNCHES), dict(kernels.ENTRY_LAUNCHES)
    psnrs, ssims = read_npys(tmp, stem)
    with plain_versions(softsplat, dcn, siren_kernel):
        kernels.reset_launches()
        summary_p, clock_p = cli_run(tmp, yml, pth, clips)
        if any(kernels.LAUNCHES.values()):
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
        kernels.reset_launches()
        res, clock = clocked(Evaluator, lambda: ev.run(iter(clips)))
        launches = dict(kernels.LAUNCHES)
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
        if s["n_clips"] != 2 or not all(np.isfinite(v) for v in s.values()) \
                or not all(launches.values()):
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
    first. A gradient cut at a kernel leaves its group at zero."""
    from motif_tpu_torch.models.pcd import DCNSep

    def nz(params):
        return all(float(p.grad.abs().max()) > 0 for p in params)
    dcns = [m for m in model.modules() if isinstance(m, DCNSep)]
    return {
        "splat_fused": nz(model.imnet.parameters())
        and nz(model.flow_imnet.parameters()),
        "dcn_im2col": len(dcns) > 0 and all(
            nz(m.conv_offset_mask.parameters()) for m in dcns),
        "siren_mlp": all(nz(net.parameters()) for net in (
            model.flow_imnet, model.imnet, model.synth_net))
        and nz(model.flow_process.parameters()),
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
              resume_steps=None):
    """The training CLI on `yml` (its `niter` steps), the launch counters
    set to 0 just before and read just after: `entries` a step and no
    other entry; then a resume for `resume_steps` more. Returns the
    launches per step of every entry."""
    from motif_tpu_torch import checkpoint, train

    steps = steps or TRAIN_STEPS
    resume_steps = resume_steps or RESUME_STEPS
    models = opt["path"]["models"]
    log_path = os.path.join(opt["path"]["experiments_root"], "train_log.jsonl")
    kernels.reset_launches()
    t1 = time.perf_counter()
    train.main(["-opt", yml])
    cli_s = time.perf_counter() - t1
    launches = dict(kernels.ENTRY_LAUNCHES)
    if checkpoint.latest_step(models) != steps:
        raise AssertionError(f"{tag}: no final train state")
    log = [json.loads(ln) for ln in open(log_path)]
    if [ln["step"] for ln in log] != list(range(1, steps + 1)) or \
            {ln["use_gt"] for ln in log} != {True, False} or \
            not all(np.isfinite(ln["loss"]) for ln in log):
        raise AssertionError(f"{tag}: log {log}")
    per_step = {k: launches.get(k, 0) / steps for k in ENTRIES}
    for entry, n in entries.items():
        if per_step[entry] != n:
            raise AssertionError(f"{tag}: {entry} launched {per_step[entry]} "
                                 f"times a step, not {n}")
    if sum(launches.values()) != steps * sum(entries.values()):
        raise AssertionError(f"{tag}: other entries ran {launches}")
    t1 = time.perf_counter()
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
          "use_gt": [ln["use_gt"] for ln in log2],
          "lr": [ln["lr"] for ln in log2],
          "launches": launches, "launches_per_step": per_step})
    return per_step


def train_steps_by_part(dev, opt, card, tag, ds_extra=None):
    """A Trainer on the yml's model and data: a warm-up step, then three
    steps split into forward, backward and optimiser, their peak memory
    and HR frames/s. Returns (trainer, model, the batch iterator)."""
    from motif_tpu_torch.data import BatchLoader, create_dataset, \
        device_prefetch
    from motif_tpu_torch.models.factory import define_g
    from motif_tpu_torch.trainer import Trainer
    from motif_tpu_torch.utils import config as cfg

    net = opt["network_G"]
    model = define_g(net, device=dev)
    ds_opt = {**opt["datasets"]["train"], **(ds_extra or {})}
    B, N, gt = ds_opt["batch_size"], ds_opt["N_frames"], ds_opt["GT_size"]
    loader = BatchLoader(create_dataset(ds_opt), batch_size=B,
                         shuffle=True, seed=0,
                         epoch_ratio=opt["dataset_ratio"])
    batches = device_prefetch(loader.epoch(0), dev)
    tr = Trainer(model, cfg.trainer_config_from_opt(opt), (gt, gt),
                 iters=net["iters"], seed=0,
                 family=net["which_model_G"])
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


def checkpoint_round_trip(tmp, models, card):
    """The eval CLI (test.yml, fp32, one Vid4 clip) through `--checkpoint`
    on the models root the training CLI wrote (read at its newest step), on
    that step's file and on a path that does not exist (the random init
    from seed 0, the weights the training started from): the root and the
    file give the same frames (EVAL_GATES fp32), the init other frames."""
    from motif_tpu_torch import checkpoint

    ymls, _ = eval_ymls(tmp)
    step = checkpoint.latest_step(models)
    frames, summaries = {}, {}
    for what, path in (("root", models),
                       ("step", os.path.join(models, f"step_{step}")),
                       ("init", os.path.join(tmp, "absent.pth"))):
        summaries[what], clock = cli_run(tmp, ymls["fp32"], path, clips=1)
        frames[what] = clock.frames[0]
    same = float(np.abs(frames["root"] - frames["step"]).max())
    moved = float(np.abs(frames["root"] - frames["init"]).max())
    emit({"phase": "checkpoint_round_trip", "card": card, "step": step,
          "root_vs_step_max_abs_err": same,
          "tol": EVAL_GATES["fp32"]["frames"],
          "trained_vs_init_max_abs": moved, "min_trained_vs_init": 1e-3,
          "psnr": {k: v["psnr"] for k, v in summaries.items()}})
    if not (same <= EVAL_GATES["fp32"]["frames"] and moved > 1e-3):
        raise AssertionError(f"eval CLI --checkpoint: the models root against "
                             f"its step file {same}, the trained frames "
                             f"against the init's {moved}")


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


def gate_state(dev, opt, mods, ds_extra=None):
    """The state the training gates start from, the same bit for bit in
    every run: the yml's model from seed 0, a Trainer from seed 0, the
    loader's order and the dataset's augmentation draws from seed 0, a
    warm-up step and three steps on the plain versions under
    `deterministic()`. Returns (trainer, model, the next batch, the hashes
    of the parameters and of that batch)."""
    from motif_tpu_torch.data import BatchLoader, create_dataset, \
        device_prefetch
    from motif_tpu_torch.models.factory import define_g
    from motif_tpu_torch.trainer import Trainer
    from motif_tpu_torch.utils import config as cfg

    softsplat, dcn, siren_kernel, _ = mods
    net = opt["network_G"]
    model = define_g(net, device=dev)
    ds_opt = {**opt["datasets"]["train"], **(ds_extra or {})}
    gt = ds_opt["GT_size"]
    ds = dataclasses.replace(create_dataset(ds_opt), seed=0)
    loader = BatchLoader(ds, batch_size=ds_opt["batch_size"], shuffle=True,
                         seed=0, epoch_ratio=opt["dataset_ratio"])
    batches = device_prefetch(loader.epoch(0), dev)
    tr = Trainer(model, cfg.trainer_config_from_opt(opt), (gt, gt),
                 iters=net["iters"], seed=0, family=net["which_model_G"])
    with plain_versions(softsplat, dcn, siren_kernel), deterministic():
        for _ in range(4):
            tr.step(next(batches))
    batch = next(batches)
    batches.close()
    arrays = [torch.as_tensor(v) for _, v in sorted(batch.items())
              if isinstance(v, (torch.Tensor, np.ndarray))]
    return tr, model, batch, {"params": digest(tr.params),
                              "batch": digest(arrays)}


def train_gates(dev, opt, mods, card, tag, ds_extra=None):
    """At `gate_state`'s state (its hashes printed), a step of the kernels
    against the same step with the plain versions, same weights and batch,
    for use_gt True and False (the loss and every gradient, TRAIN_GATES),
    every kernel's upstream parameters with a non-zero gradient; all under
    `deterministic()`, where two plain steps must be bit-equal. Returns
    the trainer, model and batch, the plain use_gt=False gradients and
    aux."""
    softsplat, dcn, siren_kernel, _ = mods
    t0 = time.perf_counter()
    tr, model, batch, hashes = gate_state(dev, opt, mods, ds_extra)
    state_s = time.perf_counter() - t0
    for use_gt in (True, False):
        with deterministic():
            aux = tr.compute_grads(batch, use_gt)
            got = [p.grad.clone() for p in tr.params]
            nonzero = upstream_nonzero(model)
            with plain_versions(softsplat, dcn, siren_kernel):
                again = tr.compute_grads(batch, use_gt)
                twice = [p.grad.clone() for p in tr.params]
                plain = tr.compute_grads(batch, use_gt)
            want = [p.grad.clone() for p in tr.params]
        gate = grad_gate(model, got, want, float(aux["loss"]),
                         float(plain["loss"]))
        bit_equal = float(again["loss"]) == float(plain["loss"]) and all(
            torch.equal(a, b) for a, b in zip(twice, want))
        emit({"phase": f"{tag}_gate", "use_gt": use_gt, "card": card,
              "state_sha256": hashes, "state_seconds": state_s,
              "loss": float(aux["loss"]),
              "plain_loss": float(plain["loss"]), "gates": TRAIN_GATES,
              "upstream_nonzero": nonzero, **gate,
              "plain_twice_bit_equal": bit_equal})
        if not bit_equal:
            raise AssertionError(f"{tag}: two plain steps with use_gt="
                                 f"{use_gt} from the gate's state differ")
        if not gate["ok"]:
            raise AssertionError(f"{tag}: the step with use_gt={use_gt} "
                                 f"fails its gate {gate}")
        if not all(nonzero.values()):
            raise AssertionError(f"{tag}: a kernel cut the gradient "
                                 f"{nonzero}")
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
            "splat_fused/float16/C=64": 1}


def times_n(entries: dict, n: int) -> dict:
    return {k: v * n for k, v in entries.items()}


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
        kernels.reset_launches()
        frames[name], _ = ev.infer(lq, t3, (256, 448))
        entries[name] = dict(kernels.ENTRY_LAUNCHES)
        check_frames(name, frames[name], (3, 1, 256, 448, 3))
        # RAFT's batches, on an eager request (a replay runs no hook)
        calls, hook = raft_counter(model)
        eager(ev)(lq, t3, (256, 448))
        hook.remove()
        rafts[name] = calls
    dcns = entries["h"].get("dcn_im2col/float32", 0) // 3
    want = {"h": times_n(per_forward(dcns, "fp32"), 3),
            "i": times_n(per_forward(dcns, "serving"), 3)}
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
    return entries, dcns


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
                per_clip=times_n(per_forward(dcns, config), 7),
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
            tr, model, batches = train_steps_by_part(
                dev, opt, card, "train44", {"load_flows": True})
            back, prof_stats = profile_train_step(
                tr, next(batches), profile and os.path.join(profile,
                                                            "ours44"), mods)
            emit({"phase": "train44_profile", "card": card,
                  "plain_backward": back, "profiled_step": prof_stats})
            batches.close()
            del tr, model
            tr, model, batch, _, _ = train_gates(
                dev, opt, mods, card, "train44", {"load_flows": True})
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


def hold_backward(name, fn, fn_plain, inputs, cotangents, card):
    """An entry's autograd Function (the kernel forward, its plain
    backward) against autograd through the plain version at a training
    shape: each gradient within 1e-5 of its largest value (the card tests'
    gate); the Function's forward + backward ms and peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = grads_of(fn, inputs, cotangents)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    want = grads_of(fn_plain, inputs, cotangents)
    errs = [float((a.double() - b.double()).abs().max())
            / float(b.double().abs().max()) for a, b in zip(got, want)]
    del got, want
    ms = cuda_ms(lambda: grads_of(fn, inputs, cotangents), reps=2, warmup=1)
    emit({"check": f"{name}_backward", "card": card,
          "shapes": [list(t.shape) for t in inputs], "grad_rel_errs": errs,
          "tol": 1e-5, "forward_backward_ms": ms,
          "peak_memory_gb": peak / 1e9})
    if not max(errs) <= 1e-5:
        raise AssertionError(f"{name} backward at {inputs[0].shape}: {errs}")


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
    entries, dcns = run_requests44(dev, card, mods)
    eval_entries = run_eval44(dev, card, mods, dcns)
    train_per_step, back = run_train44(dev, card, mods, dcns, args.profile)
    check_shapes44(dev, card, mods, Siren)
    emit({"phase": "four_anchor", "seconds": time.perf_counter() - t0})
    return {"launches_request_h": entries["h"],
            "launches_request_i": entries["i"],
            "launches_eval_vimeo44": eval_entries,
            "launches_train_step_ours44": train_per_step,
            "plain_backward_ms_train_step_ours44": back}


# ---------------------------------------------------------------------------
# phase 9: the baselines
# ---------------------------------------------------------------------------

# each family: its eval yml, and what one request launches of the kernels
# (2 LQ frames 64x112 -> 256x448, 3 times): the ZSM trunk's 42 DCNs (6 in
# the PCD, 36 in the ConvLSTM's), TMNet's 2 more in its comparison stage,
# EDVR's 4 (its PCD and cascade, the frames batched), VideoINR's SIRENs
# per time in 2 + 1 + 5 launches (siren_kernel.segments)
BASELINES = {
    "LIIF": ("test_vid4_liif.yml", {"dcn_im2col/float32": 42,
                                    "siren_mlp/float32/whole": 24}),
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
        kernels.reset_launches()
        frames, stats = ev.infer(lq, t3, hw)
        entries = dict(kernels.ENTRY_LAUNCHES)
        check_frames(family, frames, (3, 1, *hw, 3), clipped=False)
        if entries != want or stats is not None:
            raise AssertionError(f"request ({family}) launched {entries} "
                                 f"(wanted {want}), flow stats {stats}")
        with plain_versions(softsplat, dcn, siren_kernel):
            kernels.reset_launches()
            plain, _ = eager(ev)(lq, t3, hw)
            if any(kernels.LAUNCHES.values()):
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
    check_dcn_v2(dev, dcn)
    if set(results) != set(ENTRIES):
        raise AssertionError("an entry was not held against its plain version")
    launches, entry_launches, per_request, entries = run_slice(dev, args, card)
    eval_entries = run_eval(dev, card, (softsplat, dcn, siren_kernel, kernels))
    train_per_step, train_back = run_train(
        dev, card, args, (softsplat, dcn, siren_kernel, kernels))
    four = run_four_anchor(dev, card, args,
                           (softsplat, dcn, siren_kernel, kernels), Siren)
    base, dcn16, sirens = run_baseline_phase(
        dev, card, args, (softsplat, dcn, siren_kernel, kernels), Siren)

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
        "route": "cuda", "source": src, "replaces": replaces,
        "launches": base["LIIF"]["request"]["siren_mlp/float32/whole"],
        "max_abs_err": max(r["max_abs_err"] for r in sirens.values()),
        **{k: sum(r[k] for r in sirens.values())
           for k in ("ms", "plain_ms", "bound_ms", "library_ms", "eager_ms")},
        "bound_by": worst["bound_by"],
        "shape": "feat_imnet + flow_imnet + encode_imnet, 114,688 tokens "
                 "each (one time of a 256x448 request)"})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
