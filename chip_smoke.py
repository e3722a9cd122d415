#!/usr/bin/env python3
"""Drive motif_tpu_torch's serving forward and its training on one NVIDIA GPU.

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
     last, after phase 7; each kernel row also carries its launches per
     training step and its plain backward's device ms in one step;
  7. training (run before phase 6's lines): the CLI (motif_tpu_torch.train
     .main) on configs/train_smoke.yml with train_Ours_vimeo.yml's shapes
     (Ours, nf 64, 5 + 40 blocks, iters 12, batch 8, GT 128 from LQ 32, 7
     target times) on data/vimeo for 6 steps, the launch counters set to 0
     before and read after (1 splat, 42 DCN im2cols, 3 SIRENs a step, all
     float32 entries), teacher forcing decaying over 4 steps so that both
     branches run, then a resume to step 8 from the saved state; a
     Trainer's step split into forward, backward and optimiser, its peak
     memory and HR frames/s; one profiled step with each plain backward's
     device ms; a step held against the same step with the plain versions
     (loss and every gradient, TRAIN_GATES) for use_gt True and False,
     with the parameters upstream of each kernel checked for a non-zero
     gradient, and a splat backward that drops the flow gradient planted,
     which the gate must refuse.
Exits non-zero without CUDA or without the package beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

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

    # yardstick: the same 4-corner scatter as ONE index_add_ call, its
    # payload and indices prepared outside the timed call
    # (in the sums' type: a float16 index_add_ for the float16 entry)
    corners = softsplat._corner_data(flow, H, W)
    ez = torch.exp(zn).reshape(B, H * W, 1)
    flat = torch.cat([img.reshape(B, H * W, C) * ez, ez], -1)
    boff = (torch.arange(B, device=dev) * H * W)[:, None, None]
    idx = torch.cat([(c[0] + boff).reshape(-1) for c in corners])
    src = torch.cat([torch.cat([flat * torch.where(c[2], c[1], 0).reshape(
        B, H * W, 1), c[2].float().reshape(B, H * W, 1)], -1).reshape(-1, C + 2)
        for c in corners]).to(sdt or torch.float32)
    acc = torch.zeros((B * H * W, C + 2), device=dev, dtype=src.dtype)
    library = device_ms(lambda: acc.index_add_(0, idx, src), reps=10)
    del src, idx, acc
    return dict(max_abs_err=worst, library_ms=library, **lines["z<=0"])


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


def check_dcn(dev, dcn, kernels, dtype=torch.float32):
    """L1 / L2 / L3 of the BiLSTM's PCD (B = 2, G = 8, cg = 8, K = 3),
    offsets up to ±10 px, and one H % 8 != 0 height; the offsets a strided
    view as on the main path. At L1 also the kernel with the L2 cold and
    the whole dcn_v2 (kernel + addmm). float32: atol 1e-5. bfloat16: the
    kernel and the plain version do the same float32 arithmetic and round
    once, so 1 bfloat16 ulp of the largest column (a fused multiply-add
    may move a float32 sum across a rounding boundary)."""
    import torch.nn.functional as F

    G, cg, K = 8, 8, 3
    esize = torch.empty((), dtype=dtype).element_size()
    worst, first = 0.0, None
    for level, (B, H, W) in (("L1", (2, 64, 112)), ("L2", (2, 32, 56)),
                             ("L3", (2, 16, 28)), ("H%8!=0", (2, 62, 110))):
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
                skip_first=False):
    """One entry of siren_mlp (element type; whole MLP or from the first
    layer's pre-activation) on the three MLPs at the main path's token
    counts. float32: FMA and sinf, as the plain version with TF32 off:
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
    for name, (cin, hidden, cout, n_tok) in SIRENS.items():
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
              **({"accuracy_vs_float64": held} if bf else {})})
        first = first or line
    return dict(max_abs_err=worst, **first)


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


def check_frames(name, frames, shape):
    if frames.shape != shape:
        raise AssertionError(f"request {name}: shape {frames.shape} != {shape}")
    if not np.isfinite(frames).all():
        raise AssertionError(f"request {name}: non-finite frames")
    if frames.min() < 0.0 or frames.max() > 1.0:
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


def time_request(ev, lq, times, n):
    """Wall milliseconds of n runs of one request, each ending in the
    frames' copy to the host."""
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        ev.infer(lq, times, (256, 448))
        ts.append((time.perf_counter() - t) * 1e3)
    return ts


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
    """One request against the same forward with the plain versions: the
    frames, the synthesis output before the clip (most frames clip with
    random weights) and the flow statistics."""
    softsplat, dcn, siren_kernel, kernels = mods
    pre_clip = []
    hook = model.synth_net.register_forward_hook(
        lambda mod, inp, out: pre_clip.append(out.double().cpu()))
    f_k, stats_k = ev.infer(lq, times, (256, 448))   # kernels, hooked
    with plain_versions(softsplat, dcn, siren_kernel):
        kernels.reset_launches()
        f_plain, stats_plain = ev.infer(lq, times, (256, 448))
        if any(kernels.LAUNCHES.values()):
            raise AssertionError("the plain forward launched a kernel")
    hook.remove()
    pre_k, pre_plain = pre_clip
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
        ev.infer(lq, times, (256, 448))
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

    # ---- time requests (a) and (e), in turns, and (a)'s plain forward ----
    a1 = time_request(ev, lq_a, t3, 5)
    e1 = time_request(ev_s, lq_a, t3, 5)
    with plain_versions(softsplat, dcn, siren_kernel):
        p1 = time_request(ev, lq_a, t3, 3)
    e2 = time_request(ev_s, lq_a, t3, 5)
    a2 = time_request(ev, lq_a, t3, 5)
    with plain_versions(softsplat, dcn, siren_kernel):
        p2 = time_request(ev, lq_a, t3, 3)
    fwd_ms = float(np.median(a1 + a2))
    plain_ms = float(np.median(p1 + p2))
    emit({"phase": "request_a_time", "card": card,
          "forward_ms_median": fwd_ms, "hr_frames_per_s": 3e3 / fwd_ms,
          "forward_ms": a1 + a2, "plain_forward_ms_median": plain_ms,
          "plain_forward_ms": p1 + p2,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "note": "Evaluator.infer wall time incl. host copy-out, fp32, "
                  "TF32 off, iters=4, LQ 64x112 -> HR 256x448, 3 times"})
    e_ms = float(np.median(e1 + e2))
    emit({"phase": "request_e_time", "card": card,
          "forward_ms_median": e_ms, "hr_frames_per_s": 3e3 / e_ms,
          "forward_ms": e1 + e2, "request_a_forward_ms_median": fwd_ms,
          "knobs": SERVING,
          "note": "request (a)'s inputs through the serving configuration, "
                  "timed in turns with request (a): a, e, e, a"})

    if args.profile:
        profile_request(ev, lq_a, t3, args.profile, "a")
        profile_request(ev_s, lq_a, t3, args.profile, "e")
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


def eval_ymls(tmp):
    """test.yml as it is (the fp32 configuration) and test.yml with the
    serving knobs in its network_G, written into `tmp`."""
    with open(os.path.join(ROOT, "test.yml")) as f:
        text = f.read()
    knobs = "".join(f"  {k}: {str(v).lower() if isinstance(v, bool) else v}\n"
                    for k, v in {**SERVING, "decode_chunks": 1}.items())
    serving = text.replace("name: tmp\n", "name: serving\n").replace(
        "network_G:\n", "network_G:\n" + knobs)
    if serving.count("serving") != 1 or knobs not in serving:
        raise AssertionError("test.yml has no `name: tmp` or `network_G:` "
                             "line to put the serving knobs under")
    paths = {"fp32": os.path.join(tmp, "test.yml"),
             "serving": os.path.join(tmp, "serving.yml")}
    for name, body in (("fp32", text), ("serving", serving)):
        with open(paths[name], "w") as f:
            f.write(body)
    return paths, {"fp32": "tmp", "serving": "serving"}


def reference_pth(dev, path):
    """MoTIF at full width with build_request's weights (seed 0, DCN
    offsets perturbed from seed 1), saved as the reference saves a
    checkpoint: DataParallel's `module.` prefix, the fixed blur's
    `g_filter` and a {"state_dict": ...} wrapper."""
    from motif_tpu_torch.models.motif import build_motif

    model = build_motif(channel=64, front_rbs=5, back_rbs=40, device=dev,
                        seed=0)
    perturb_offsets(model, seed=1)
    sd = {f"module.{k}": v.detach().cpu()
          for k, v in model.state_dict().items()}
    sd["module.g_filter.weight"] = torch.ones(3, 1, 5, 5)
    torch.save({"state_dict": sd}, path)


def cli_run(tmp, yml, pth):
    """`python -m motif_tpu_torch.test -opt yml --checkpoint pth` run in
    `tmp` with the Vid4 dataroots as overrides: its summary and the clock
    of its `infer` calls (with their frames)."""
    from motif_tpu_torch import test as cli
    from motif_tpu_torch.eval import Evaluator

    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        summary, clock = clocked(Evaluator, lambda: cli.main(
            ["-opt", yml, "--checkpoint", pth],
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


def eval_cli(tmp, config, yml, stem, pth, mods):
    """The CLI over test.yml in one configuration, with the kernels (the
    launch counters set to 0 just before and read just after) and with the
    plain versions, held against each other."""
    softsplat, dcn, siren_kernel, kernels = mods
    gate = EVAL_GATES[config]
    kernels.reset_launches()
    summary, clock = cli_run(tmp, yml, pth)
    launches, entries = dict(kernels.LAUNCHES), dict(kernels.ENTRY_LAUNCHES)
    psnrs, ssims = read_npys(tmp, stem)
    with plain_versions(softsplat, dcn, siren_kernel):
        kernels.reset_launches()
        summary_p, clock_p = cli_run(tmp, yml, pth)
        if any(kernels.LAUNCHES.values()):
            raise AssertionError("the plain CLI run launched a kernel")
    psnrs_p, ssims_p = read_npys(tmp, stem)
    n = summary["n_clips"]
    want = {k: v * n for k, v in EVAL_ENTRIES[config].items()}
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
    if not (n == summary_p["n_clips"] == 4 and len(clock.frames) == 4
            and finite and np.isfinite(psnrs).all()
            and np.isfinite(ssims).all()):
        raise AssertionError(f"eval CLI ({config}): {n} clips, summaries "
                             f"{summary} / {summary_p}")
    if entries != want or not all(launches.values()):
        raise AssertionError(f"eval CLI ({config}) launched {entries} "
                             f"(wanted {want})")
    for frames in clock.frames:
        check_frames(f"eval {config}", frames, (3, 1, 64, 96, 3))
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
              "launches": launches,
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
TRAIN_STEPS, RESUME_STEPS = 6, 2
# a step of the kernels against the same step with the plain versions, TF32
# off: the loss relative, each parameter's gradient relative to its
# tensor's largest |g|. Readings on an H100 (one run): loss equal, gradients
# 3.8e-5 (use_gt True) and 1.2e-4 (False), at encoder convs; a splat
# backward that drops the flow gradient 4.8e-3 (flow_imnet's first layer)
TRAIN_GATES = dict(loss_rel=1e-5, grad_rel=1e-3)
BACKWARDS = {"splat_fused": "splat_fused.backward",
             "dcn_im2col": "dcn_im2col.backward",
             "siren_mlp": "siren_mlp.backward"}


def train_yml(tmp: str) -> str:
    """configs/train_smoke.yml with train_Ours_vimeo.yml's shapes (Ours,
    nf 64, setting 5, iters 12, batch 8, GT 128, 7 frames, 200 passes an
    epoch) on the repository's data/vimeo, teacher forcing decaying over 4
    steps so that both branches run, a log line a step and a save every 3
    steps, under `tmp`."""
    import yaml

    with open(os.path.join(ROOT, "configs", "train_smoke.yml")) as f:
        opt = yaml.safe_load(f)
    vimeo = os.path.join(ROOT, "data", "vimeo")
    opt["dataset_ratio"] = 200
    opt["datasets"]["train"].update(
        dataroot_GT=os.path.join(vimeo, "GT"),
        dataroot_LQ=os.path.join(vimeo, "LR"),
        cache_keys=os.path.join(vimeo, "keys.txt"), N_frames=7,
        batch_size=8, GT_size=128)
    opt["network_G"].update(which_model_G="Ours", nf=64, setting=5, iters=12)
    opt["path"] = {"root": tmp}
    opt["train"].update(niter=TRAIN_STEPS, teacher_forcing_steps=4)
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


def run_train(dev, card, args, mods):
    """Training at full width: the CLI for TRAIN_STEPS steps and a resume,
    with the launch counters read around them; a Trainer's step split by
    part, peak memory and HR frames/s; one profiled step; the gradient gate
    against the plain versions for both teacher-forcing branches, refusing
    a splat backward that drops the flow gradient."""
    import tempfile

    from motif_tpu_torch import checkpoint, train
    from motif_tpu_torch.data import BatchLoader, create_dataset, \
        device_prefetch
    from motif_tpu_torch.models.factory import define_g
    from motif_tpu_torch.trainer import Trainer
    from motif_tpu_torch.utils import config as cfg

    softsplat, dcn, siren_kernel, kernels = mods
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        yml = train_yml(tmp)
        opt = cfg.parse(yml, is_train=True)
        models = opt["path"]["models"]
        # ---- the main path: the CLI, counters from 0, then a resume ----
        kernels.reset_launches()
        t1 = time.perf_counter()
        train.main(["-opt", yml])
        cli_s = time.perf_counter() - t1
        launches = dict(kernels.ENTRY_LAUNCHES)
        if checkpoint.latest_step(models) != TRAIN_STEPS:
            raise AssertionError("train: no final train state")
        log = [json.loads(ln) for ln in open(os.path.join(
            opt["path"]["experiments_root"], "train_log.jsonl"))]
        if [ln["step"] for ln in log] != list(range(1, TRAIN_STEPS + 1)) or \
                {ln["use_gt"] for ln in log} != {True, False} or \
                not all(np.isfinite(ln["loss"]) for ln in log):
            raise AssertionError(f"train: log {log}")
        per_step = {k: launches.get(k, 0) / TRAIN_STEPS for k in ENTRIES}
        for entry, n in TRAIN_ENTRIES.items():
            if per_step[entry] != n:
                raise AssertionError(f"train: {entry} launched "
                                     f"{per_step[entry]} times a step, not {n}")
        if sum(launches.values()) != TRAIN_STEPS * sum(TRAIN_ENTRIES.values()):
            raise AssertionError(f"train: other entries ran {launches}")
        t1 = time.perf_counter()
        train.main(["-opt", yml, "--max_steps",
                    str(TRAIN_STEPS + RESUME_STEPS)])
        resume_s = time.perf_counter() - t1
        log2 = [json.loads(ln) for ln in open(os.path.join(
            opt["path"]["experiments_root"], "train_log.jsonl"))]
        if [ln["step"] for ln in log2[TRAIN_STEPS:]] != list(
                range(TRAIN_STEPS + 1, TRAIN_STEPS + RESUME_STEPS + 1)) or \
                checkpoint.latest_step(models) != TRAIN_STEPS + RESUME_STEPS:
            raise AssertionError(f"train: resume log {log2}")
        emit({"phase": "train_cli", "card": card, "steps": TRAIN_STEPS,
              "seconds": cli_s, "resume_steps": RESUME_STEPS,
              "resume_seconds": resume_s,
              "losses": [ln["loss"] for ln in log2],
              "use_gt": [ln["use_gt"] for ln in log2],
              "lr": [ln["lr"] for ln in log2],
              "launches": launches, "launches_per_step": per_step})

        # ---- a Trainer's step by part ----
        model = define_g(opt["network_G"], device=dev)
        ds_opt = dict(opt["datasets"]["train"])
        B, N, gt = ds_opt["batch_size"], ds_opt["N_frames"], ds_opt["GT_size"]
        loader = BatchLoader(create_dataset(ds_opt), batch_size=B,
                             shuffle=True, seed=0,
                             epoch_ratio=opt["dataset_ratio"])
        batches = device_prefetch(loader.epoch(0), dev)
        tr = Trainer(model, cfg.trainer_config_from_opt(opt), (gt, gt),
                     iters=opt["network_G"]["iters"], seed=0)
        tr.step(next(batches))                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        parts = [tr.step(next(batches), sync_times=True)["ms"]
                 for _ in range(3)]
        peak = torch.cuda.max_memory_allocated(dev)
        ms = {k: float(np.median([p[k] for p in parts])) for k in parts[0]}
        step_ms = sum(ms.values())
        back, prof_stats = profile_train_step(tr, next(batches),
                                              args.profile, mods)
        emit({"phase": "train_step", "card": card, "batch": B, "times": N,
              "gt": gt, "lq": gt // 4, "ms_median_of_3": ms, "step_ms": step_ms,
              "ms_runs": parts, "peak_memory_gb": peak / 1e9,
              "hr_frames_per_s": B * N / (step_ms / 1e3),
              "plain_backward": back, "profiled_step": prof_stats})

        # ---- the gradient gate: a step of the kernels against the same
        # step with the plain versions, same weights and batch ----
        batch = next(batches)
        gates = {}
        for use_gt in (True, False):
            aux = tr.compute_grads(batch, use_gt)
            got = [p.grad.clone() for p in tr.params]
            nonzero = upstream_nonzero(model)
            with plain_versions(softsplat, dcn, siren_kernel):
                plain = tr.compute_grads(batch, use_gt)
            want = [p.grad.clone() for p in tr.params]
            gates[use_gt] = grad_gate(model, got, want, float(aux["loss"]),
                                      float(plain["loss"]))
            emit({"phase": "train_gate", "use_gt": use_gt, "card": card,
                  "loss": float(aux["loss"]), "plain_loss":
                  float(plain["loss"]), "gates": TRAIN_GATES,
                  "upstream_nonzero": nonzero, **gates[use_gt]})
            if not gates[use_gt]["ok"]:
                raise AssertionError(f"train: the step with use_gt={use_gt} "
                                     f"fails its gate {gates[use_gt]}")
            if not all(nonzero.values()):
                raise AssertionError(f"train: a kernel cut the gradient "
                                     f"{nonzero}")
        # planted: a splat backward that drops the flow gradient
        with _drop_flow_grad(softsplat):
            aux = tr.compute_grads(batch, False)
        fault = grad_gate(model, [p.grad.clone() for p in tr.params], want,
                          float(aux["loss"]), float(plain["loss"]))
        emit({"phase": "train_planted_fault", "fault": "splat drops d flow",
              "refused": not fault["ok"], **fault})
        if fault["ok"]:
            raise AssertionError("train: the gate passed a splat backward "
                                 "that drops the flow gradient")
        batches.close()
        del tr, model
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    emit({"phase": "train", "seconds": seconds})
    return per_step, back


def profile_request(ev, lq, times, out_dir, name):
    """One request under torch.profiler: the table goes to `out_dir`; the
    device busy time (kernels and copies only, not the host-side ops that
    enclose them) against the request's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t = time.perf_counter()
        ev.infer(lq, times, (256, 448))
        wall_ms = (time.perf_counter() - t) * 1e3
    events = p.key_averages()
    with open(os.path.join(out_dir, f"profile_request_{name}.txt"), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)
    copies = sum(e.count for e in device if e.key.startswith(("Memcpy",
                                                              "Memset")))
    emit({"phase": "profile", "request": name,
          "request_wall_ms_profiled": wall_ms,
          "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
          "device_kernel_launches": sum(e.count for e in device) - copies,
          "device_copies": copies,
          "top_device": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                         for e in top[:25]]})


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
        time_request(ev, lq_a, t3, 2)                        # warm-up
        ts = time_request(ev, lq_a, t3, 10)
        emit({"phase": f"compare_request_{name}", "card": card,
              "forward_ms_median": float(np.median(ts)), "forward_ms": ts})
        profile_request(ev, lq_a, t3, out_dir, name)
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
        row["plain_backward_ms_train_step"] = (
            train_back[name]["device_ms"] if entry in TRAIN_ENTRIES else None)
        row["plain_backward_event_ms_train_step"] = (
            train_back[name]["event_ms"] if entry in TRAIN_ENTRIES else None)
        if "device_kernels_per_call" in r:
            row["device_kernels_per_call"] = r["device_kernels_per_call"]
        if name in also:
            row["also_replaces"] = also[name]
        rows.append(row)
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
