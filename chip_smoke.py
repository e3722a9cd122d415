#!/usr/bin/env python3
"""Drive motif_tpu_torch's serving forward on one NVIDIA GPU.

    python3 chip_smoke.py                  # the smoke run
    python3 chip_smoke.py --profile DIR    # also write a torch.profiler
                                           # table of one request to DIR and
                                           # count its device kernels

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA kernel of the package, nvcc for sm_90a, in parallel;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes, TF32 off, with its time, the plain version's
     time, one PyTorch library call's time, the bound of the card and the
     fraction of it reached; the DCN im2col also with the L2 cold, and the
     whole dcn_v2 (kernel + addmm) at L1; the splat also at other tile
     shapes, on a converging flow and on request (a)'s own inputs, with
     its tile lists and its device kernels per call. Times are device
     times (calls replayed from a CUDA graph), with the eager per-call time
     beside them;
  4. the slice: MoTIF(setting=5) at full width (channel 64, 5 + 40 residual
     blocks, RAFT-small) with random weights from a seed, DCN offsets
     perturbed, driven through Evaluator.infer on four requests; the launch
     counters must show every kernel ran; request (a) is held against the
     same forward with the plain versions; its time and HR frames/s;
  5. a {"kernels": [...]} line, the card line, and the result line.
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

# published H100 SXM peaks (NVIDIA data sheet): HBM rate, fp32 (non-tensor)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the fp32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def hold_splat(softsplat, kernels, img, flow, z, nonpos, tol=1e-4):
    """The kernel against its plain version on one input: out / norm to
    `tol` (the summation order varies), z_max and the count exact. Returns
    the errors and the wrapper's launches."""
    n0 = kernels.LAUNCHES["splat_fused"]
    got = softsplat.splat_fused(img, flow, z, z_nonpositive=nonpos)
    launches = kernels.LAUNCHES["splat_fused"] - n0
    want = softsplat.splat_fused_plain(img, flow, z, z_nonpositive=nonpos)
    torch.cuda.synchronize()
    err = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
    err_max = max_err(got[2], want[2])
    err_cnt = max_err(got[3], want[3])
    scale = max(float(want[0].abs().max()), float(want[1].abs().max()))
    if not (err <= tol and err_max == 0.0 and err_cnt == 0.0):
        raise AssertionError(f"splat_fused: out/norm err {err} (tol {tol}), "
                             f"z_max err {err_max}, count err {err_cnt} "
                             f"(must be 0)")
    return {"launches": launches, "max_abs_err": err, "z_max_err": err_max,
            "count_err": err_cnt, "out_max_abs": scale, "tol": tol}


def check_splat(dev, softsplat, kernels):
    """Main-path shapes: n*B*N = 6 images of 256x448, payload C = 130.
    Device time from graph replay, the eager per-call time beside it; the
    kernel's tile shape against others; a converging flow."""
    B, H, W, C = 6, 256, 448, 130
    g = torch.Generator(device=dev).manual_seed(1)
    img = torch.randn((B, H, W, C), device=dev, generator=g)
    flow = torch.randn((B, H, W, 2), device=dev, generator=g) * 3.0
    flow[0, :8, :, 1] = -40.0                       # thrown off the image
    z = torch.randn((B, H, W, 1), device=dev, generator=g) * 0.5
    worst, lines = 0.0, {}
    for case, zz, nonpos in (("z<=0", -z.abs(), True), ("z>0", z, False)):
        held = hold_splat(softsplat, kernels, img, flow, zz, nonpos)
        worst = max(worst, held["max_abs_err"])
        ms = device_ms(lambda: softsplat.splat_fused(img, flow, zz, nonpos))
        eager = cuda_ms(lambda: softsplat.splat_fused(img, flow, zz, nonpos))
        plain = device_ms(lambda: softsplat.splat_fused_plain(
            img, flow, zz, nonpos), reps=3)
        kern, copies = device_work(
            lambda: softsplat.splat_fused(img, flow, zz, nonpos))
        b_ms, b_by = splat_bound(B, H, W, C, nonpos)
        lines[case] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                           eager_ms=eager, device_kernels_per_call=kern,
                           device_memsets_per_call=copies)
        emit({"check": "splat_fused", "case": case, "shape": [B, H, W, C],
              "fraction_of_bound": b_ms / ms, **held, **lines[case],
              "lists": tile_lists(flow, softsplat.plan(C))})

    # the tile shape: the plan's against others that fit, z <= 0
    zn = -z.abs()
    tiles = {}
    for tile in ((8, 8), (4, 16), (8, 16), (16, 8), (4, 8)):
        with mock.patch.object(softsplat, "TILE", tile):
            tiles["%dx%d" % tile] = device_ms(
                lambda: softsplat.splat_fused(img, flow, zn, True), reps=10)
    emit({"check": "splat_tiles", "plan": list(softsplat.plan(C)),
          "device_ms": tiles})

    # a converging flow: every pixel of each image into one tile, which
    # one block then takes alone (correct for any flow; slow here)
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    spread = torch.rand((B, H, W, 2), device=dev, generator=g) * 7.0
    conv = (torch.tensor([200.0, 120.0], device=dev) + spread
            - torch.stack([xs, ys], -1).float()).contiguous()
    held = hold_splat(softsplat, kernels, img, conv, zn, True, tol=5e-2)
    emit({"check": "splat_fused", "case": "converging", **held,
          "ms": cuda_ms(lambda: softsplat.splat_fused(img, conv, zn, True),
                        reps=2, warmup=1),
          "lists": tile_lists(conv, softsplat.plan(C)),
          "note": "float32 sums of ~7,200 terms per pixel in a varying "
                  "order: tol 5e-2 on values up to out_max_abs"})

    # yardstick: the same 4-corner scatter as ONE index_add_ call, its
    # payload and indices prepared outside the timed call
    corners = softsplat._corner_data(flow, H, W)
    ez = torch.exp(zn).reshape(B, H * W, 1)
    flat = torch.cat([img.reshape(B, H * W, C) * ez, ez], -1)
    boff = (torch.arange(B, device=dev) * H * W)[:, None, None]
    idx = torch.cat([(c[0] + boff).reshape(-1) for c in corners])
    src = torch.cat([torch.cat([flat * torch.where(c[2], c[1], 0).reshape(
        B, H * W, 1), c[2].float().reshape(B, H * W, 1)], -1).reshape(-1, C + 2)
        for c in corners])
    acc = torch.zeros((B * H * W, C + 2), device=dev)
    library = device_ms(lambda: acc.index_add_(0, idx, src), reps=10)
    del src, idx, acc
    return dict(max_abs_err=worst, library_ms=library, **lines["z<=0"])


def check_splat_request(softsplat, kernels, inputs):
    """The kernel on request (a)'s own splat inputs (the forward's
    feat_hr, flow_hr and z): held against the plain version and timed,
    with its tile lists."""
    img, flow, z, nonpos = inputs
    held = hold_splat(softsplat, kernels, img, flow, z, nonpos)
    B, H, W, C = img.shape
    b_ms, _ = splat_bound(B, H, W, C, nonpos)
    ms = device_ms(lambda: softsplat.splat_fused(img, flow, z, nonpos))
    emit({"check": "splat_fused", "case": "request_a", "shape": [B, H, W, C],
          "z_nonpositive": nonpos, **held, "ms": ms, "bound_ms": b_ms,
          "fraction_of_bound": b_ms / ms,
          "eager_ms": cuda_ms(lambda: softsplat.splat_fused(img, flow, z,
                                                            nonpos)),
          "flow_abs_max": float(flow.abs().max()),
          "lists": tile_lists(flow, softsplat.plan(C))})


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


def dcn_inputs(dev, B, H, W, G, cg, K):
    """x, offsets up to ±10 px and the sigmoided mask, the last two sliced
    from one conv-like output as DCNSep does (strided views)."""
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((B, H, W, G * cg), device=dev, generator=g)
    n_off = G * K * K * 2
    com = torch.rand((B, H, W, G * K * K * 3), device=dev, generator=g)
    off = com[..., :n_off] * 20.0 - 10.0
    mask = torch.sigmoid(com[..., n_off:] * 4.0 - 2.0)
    com[..., :n_off] = off
    return x, com[..., :n_off], mask


def time_dcn_v2(dev, dcn):
    """The whole dcn_v2 at L1 (2 x 64 x 112, 64 -> 64 channels, G = 8,
    K = 3) through its public signature, which older checkouts of the
    package share: device ms (graph replay) and eager ms per call."""
    G, cg, K = 8, 8, 3
    x, off, mask = dcn_inputs(dev, 2, 64, 112, G, cg, K)
    g = torch.Generator(device=dev).manual_seed(5)
    w = torch.randn((64, G * cg, K, K), device=dev, generator=g) * 0.05
    bias = torch.randn((64,), device=dev, generator=g)
    full = (x, off, mask, w, bias, K, 1, 1, 1, G)
    return {"dcn_v2_ms": device_ms(lambda: dcn.dcn_v2(*full), reps=10),
            "dcn_v2_eager_ms": cuda_ms(lambda: dcn.dcn_v2(*full))}


def check_dcn(dev, dcn, kernels):
    """L1 / L2 / L3 of the BiLSTM's PCD (B = 2, G = 8, cg = 8, K = 3),
    offsets up to ±10 px, and one H % 8 != 0 height; the offsets a strided
    view as on the main path. At L1 also the kernel with the L2 cold and
    the whole dcn_v2 (kernel + addmm)."""
    import torch.nn.functional as F

    G, cg, K = 8, 8, 3
    tol = 1e-5
    worst, first = 0.0, None
    for level, (B, H, W) in (("L1", (2, 64, 112)), ("L2", (2, 32, 56)),
                             ("L3", (2, 16, 28)), ("H%8!=0", (2, 62, 110))):
        x, off, mask = dcn_inputs(dev, B, H, W, G, cg, K)
        args = (x, off, mask, K, 1, 1, 1, G)
        n0 = kernels.LAUNCHES["dcn_im2col"]
        got = dcn.dcn_im2col(*args)
        launches = kernels.LAUNCHES["dcn_im2col"] - n0
        want = dcn.dcn_im2col_plain(*args)
        torch.cuda.synchronize()
        err = max_err(got, want)
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
                           -1).reshape(B * G, 1, Q, 2)
        library = device_ms(lambda: F.grid_sample(
            xg, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True))
        # x, offsets and mask read once, the columns written once
        nbytes = 4 * (x.numel() + off.numel() + mask.numel() + got.numel())
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
            extra.update(time_dcn_v2(dev, dcn))
            with mock.patch.object(dcn, "dcn_im2col", dcn.dcn_im2col_plain):
                extra["dcn_v2_plain_ms"] = time_dcn_v2(dev, dcn)["dcn_v2_ms"]
        emit({"check": "dcn_im2col", "level": level, "launches": launches,
              "shape": [B, H, W, G, cg], "Q": Q, "max_abs_err": err,
              "tol": tol, "fraction_of_bound": b_ms / ms, **line, **extra})
        first = first or line
    return dict(max_abs_err=worst, **first)


SIRENS = {  # name: (fan-in, hidden widths, out, tokens on the main path)
    "stinf": (67, [64, 64, 256], 3, 688128),
    "sinf": (66, [64, 64, 256], 64, 229376),
    "synth": (198, [64, 64, 64, 256], 3, 344064),
}


def check_siren(dev, siren_kernel, Siren, kernels):
    """fp32 FMA and sinf, as the plain version with TF32 off: 1e-5 (the
    outputs are about 0.05; TF32 products or a fast __sinf would miss it)."""
    tol = 1e-5
    worst, first = 0.0, None
    for name, (cin, hidden, cout, n_tok) in SIRENS.items():
        torch.manual_seed(3)
        m = Siren(cin, hidden, len(hidden) - 1, cout).to(dev)
        lins = m._linears()
        ws = [lin.weight.detach() for lin in lins]
        bs = [lin.bias.detach() for lin in lins]
        g = torch.Generator(device=dev).manual_seed(4)
        x = torch.rand((n_tok, cin), device=dev, generator=g) * 2.0 - 1.0
        n0 = kernels.LAUNCHES["siren_mlp"]
        got = siren_kernel.siren_mlp(x, ws, bs)
        launches = kernels.LAUNCHES["siren_mlp"] - n0
        want = siren_kernel.siren_mlp_plain(x, ws, bs)
        torch.cuda.synchronize()
        err = max_err(got, want)
        if not err <= tol:
            raise AssertionError(f"siren_mlp {name}: err {err} (tol {tol})")
        worst = max(worst, err)
        ms = device_ms(lambda: siren_kernel.siren_mlp(x, ws, bs), reps=10)
        eager = cuda_ms(lambda: siren_kernel.siren_mlp(x, ws, bs), reps=10)
        plain = device_ms(lambda: siren_kernel.siren_mlp_plain(x, ws, bs),
                          reps=10)

        def addmm_sin_chain():
            # the fastest one-call-per-layer form: cuBLAS addmm (what
            # F.linear runs), then the sine
            h = x
            for i, (w, b) in enumerate(zip(ws, bs)):
                h = torch.addmm(b, h, w.t())
                if i < len(ws) - 1:
                    h = torch.sin(30.0 * h)
            return h
        library = device_ms(addmm_sin_chain, reps=10)
        dims = [cin] + hidden + [cout]
        macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        flops = n_tok * (2 * macs + 2 * sum(dims[1:-1]))
        nbytes = 4 * (x.numel() + got.numel()
                      + sum(w.numel() + b.numel() for w, b in zip(ws, bs)))
        b_ms, b_by = bound(nbytes, flops)
        line = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                    library_ms=library, eager_ms=eager)
        emit({"check": "siren_mlp", "mlp": name, "launches": launches,
              "tokens": n_tok, "dims": dims, "max_abs_err": err, "tol": tol,
              "fraction_of_bound": b_ms / ms,
              "library": "addmm + sin per layer (cuBLAS)", **line})
        first = first or line
    return dict(max_abs_err=worst, **first)


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_versions(softsplat, dcn, siren_kernel):
    """Route the model's kernel calls to the plain versions (the reference
    forward for the comparison; the package itself has no such switch)."""
    with mock.patch.object(softsplat, "splat_fused",
                           softsplat.splat_fused_plain), \
            mock.patch.object(dcn, "dcn_im2col", dcn.dcn_im2col_plain), \
            mock.patch.object(siren_kernel, "siren_mlp",
                              siren_kernel.siren_mlp_plain):
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


def build_request(dev):
    """MoTIF(setting=5) at full width with random weights from seed 0 and
    perturbed DCN offsets, its Evaluator, and request (a)'s inputs."""
    from motif_tpu_torch.eval import Evaluator
    from motif_tpu_torch.models.motif import build_motif

    model = build_motif(channel=64, front_rbs=5, back_rbs=40, device=dev,
                        seed=0)
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


def run_slice(dev, args, card):
    from motif_tpu_torch.ops import dcn, kernels, siren_kernel, softsplat

    t0 = time.perf_counter()
    model, n_dcn, ev, rng, lq_a, t3 = build_request(dev)
    t7 = np.linspace(0, 1, 7, dtype=np.float32)[None]
    lq_c = rng.random((1, 4, 62, 110, 3), dtype=np.float32)
    emit({"phase": "slice_setup", "params": sum(p.numel() for p in
                                                model.parameters()),
          "dcn_modules_perturbed": n_dcn,
          "seconds": time.perf_counter() - t0})

    # ---- the main path: counters to 0, four requests, counters read ----
    kernels.reset_launches()
    per_request = {}
    t0 = time.perf_counter()
    fa, stats_a = ev.infer(lq_a, t3, (256, 448))
    per_request["a"] = dict(kernels.LAUNCHES)
    fb, _ = ev.infer(lq_a, t7, (256, 448))
    fc, _ = ev.infer(lq_c, t3, (248, 440))
    with torch.no_grad():
        model.alpha.fill_(0.05)          # z > 0: the max splat runs
    before_d = dict(kernels.LAUNCHES)
    fd, _ = ev.infer(lq_a, t3, (256, 448))
    per_request["d"] = {k: v - before_d[k] for k, v in kernels.LAUNCHES.items()}
    with torch.no_grad():
        model.alpha.fill_(-20.0)
    launches = dict(kernels.LAUNCHES)
    seconds = time.perf_counter() - t0
    for name, f, shape in (("a", fa, (3, 1, 256, 448, 3)),
                           ("b", fb, (7, 1, 256, 448, 3)),
                           ("c", fc, (3, 1, 248, 440, 3)),
                           ("d", fd, (3, 1, 256, 448, 3))):
        check_frames(name, f, shape)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing} (counts {launches})")
    emit({"phase": "main_path", "requests": 4, "seconds": seconds,
          "launches": launches, "launches_per_request": per_request,
          "flow_stats_a": stats_a})

    # ---- request (a) against the same forward with the plain versions:
    # the frames, the synthesis output before the clip (most frames clip
    # with random weights) and the flow statistics ----
    tol, stats_rtol = 1e-5, 1e-5
    pre_clip = []
    hook = model.synth_net.register_forward_hook(
        lambda mod, inp, out: pre_clip.append(out.double().cpu()))
    fa_k, stats_k = ev.infer(lq_a, t3, (256, 448))   # kernels, hooked
    with plain_versions(softsplat, dcn, siren_kernel):
        kernels.reset_launches()
        fa_plain, stats_plain = ev.infer(lq_a, t3, (256, 448))
        if any(kernels.LAUNCHES.values()):
            raise AssertionError("the plain forward launched a kernel")
    hook.remove()
    pre_k, pre_plain = pre_clip
    err = float(np.abs(fa_k - fa_plain).max())
    err_pre = float((pre_k - pre_plain).abs().max())
    err_stats = max(abs(a - b) / abs(b) for a, b in zip(stats_k, stats_plain))
    emit({"phase": "slice_vs_plain", "request": "a", "max_abs_err": err,
          "mean_abs_err": float(np.abs(fa_k - fa_plain).mean()), "tol": tol,
          "clipped_share": float(((fa_plain <= 0) | (fa_plain >= 1)).mean()),
          "pre_clip_max_abs_err": err_pre,
          "pre_clip_max_abs": float(pre_plain.abs().max()),
          "flow_stats": stats_k, "flow_stats_plain": stats_plain,
          "flow_stats_max_rel_err": err_stats, "flow_stats_rtol": stats_rtol})
    if not (err <= tol and err_pre <= tol and err_stats <= stats_rtol):
        raise AssertionError(
            f"request (a) kernels vs plain: frames {err}, before the clip "
            f"{err_pre} (tol {tol}); flow stats rel {err_stats} (rtol "
            f"{stats_rtol})")

    # ---- the splat kernel on request (a)'s own inputs ----
    captured = []
    splat = softsplat.splat_fused

    def spy(img, flow, z, z_nonpositive):
        captured.append((img.clone(), flow.clone(), z.clone(), z_nonpositive))
        return splat(img, flow, z, z_nonpositive)
    with mock.patch.object(softsplat, "splat_fused", spy):
        ev.infer(lq_a, t3, (256, 448))
    check_splat_request(softsplat, kernels, captured[0])
    del captured

    # ---- time request (a): kernels, plain, kernels, plain ----
    k1 = time_request(ev, lq_a, t3, 5)
    with plain_versions(softsplat, dcn, siren_kernel):
        p1 = time_request(ev, lq_a, t3, 3)
    k2 = time_request(ev, lq_a, t3, 5)
    with plain_versions(softsplat, dcn, siren_kernel):
        p2 = time_request(ev, lq_a, t3, 3)
    fwd_ms = float(np.median(k1 + k2))
    plain_ms = float(np.median(p1 + p2))
    emit({"phase": "request_a_time", "card": card,
          "forward_ms_median": fwd_ms, "hr_frames_per_s": 3e3 / fwd_ms,
          "forward_ms": k1 + k2, "plain_forward_ms_median": plain_ms,
          "plain_forward_ms": p1 + p2,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "note": "Evaluator.infer wall time incl. host copy-out, fp32, "
                  "TF32 off, iters=4, LQ 64x112 -> HR 256x448, 3 times"})

    if args.profile:
        profile_request(ev, lq_a, t3, args.profile)
    return launches, per_request


def profile_request(ev, lq, times, out_dir):
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
    with open(os.path.join(out_dir, "profile_request_a.txt"), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)
    copies = sum(e.count for e in device if e.key.startswith(("Memcpy",
                                                              "Memset")))
    emit({"phase": "profile", "request_wall_ms_profiled": wall_ms,
          "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
          "device_kernel_launches": sum(e.count for e in device) - copies,
          "device_copies": copies,
          "top_device": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                         for e in top[:20]]})


def compare_only(dev, card, out_dir):
    """The numbers that compare two checkouts of the package, through the
    entry points they share: dcn_v2 at L1, splat_fused at the smoke's
    shapes (z <= 0), request (a)'s median and single runs, and one profiled
    request's device kernels."""
    from motif_tpu_torch.ops import dcn, softsplat

    emit({"phase": "compare_dcn_v2_L1", "card": card,
          **time_dcn_v2(dev, dcn)})
    B, H, W, C = 6, 256, 448, 130
    g = torch.Generator(device=dev).manual_seed(1)
    img = torch.randn((B, H, W, C), device=dev, generator=g)
    flow = torch.randn((B, H, W, 2), device=dev, generator=g) * 3.0
    z = -(torch.randn((B, H, W, 1), device=dev, generator=g) * 0.5).abs()
    emit({"phase": "compare_splat", "card": card, "shape": [B, H, W, C],
          "device_ms": device_ms(lambda: softsplat.splat_fused(
              img, flow, z, True)),
          "eager_ms": cuda_ms(lambda: softsplat.splat_fused(img, flow, z,
                                                            True))})
    del img, flow, z
    _, _, ev, _, lq_a, t3 = build_request(dev)
    time_request(ev, lq_a, t3, 2)                        # warm-up
    ts = time_request(ev, lq_a, t3, 10)
    emit({"phase": "compare_request_a", "card": card,
          "forward_ms_median": float(np.median(ts)), "forward_ms": ts})
    profile_request(ev, lq_a, t3, out_dir)


# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler table of request (a) to DIR")
    ap.add_argument("--compare-only", metavar="DIR",
                    help="only time dcn_v2 at L1, the splat and request (a) "
                         "and profile it into DIR, through entry points that "
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
          "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})

    build_s = kernels.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "bytes stack" in ln]
             for name, log in kernels.BUILD_LOGS.items()}
    emit({"phase": "build", "seconds": build_s, "kernels": kernels.KERNELS,
          "ptxas": ptxas})

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "tf32", "matmul.allow_tf32": False,
          "cudnn.allow_tf32": False})
    if args.compare_only:
        compare_only(dev, card, args.compare_only)
        return 0

    results = {"splat_fused": check_splat(dev, softsplat, kernels),
               "dcn_im2col": check_dcn(dev, dcn, kernels),
               "siren_mlp": check_siren(dev, siren_kernel, Siren, kernels)}
    launches, per_request = run_slice(dev, args, card)

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
    for name, (src, rep) in meta.items():
        r = results[name]
        row = {"name": name, "route": "cuda", "source": src, "replaces": rep,
               "launches": launches[name], "max_abs_err": r["max_abs_err"],
               "ms": r["ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": r["library_ms"], "eager_ms": r["eager_ms"],
               "launches_request_a": per_request["a"][name]}
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
