"""Clip requests, closed loop, one client: back-to-back `Evaluator.infer`
calls (the serving and eval entry of the program), each a batch of LQ
frames and N target times with N drawn from the mix's `n_times`, in
blocks that hold each N once in an order drawn from the seed, so every
seed sends the same work. The times are k / N, k = 0 .. N - 1, on the
model's own time axis (the two-anchor model's anchor interval, the
four-anchor model's whole window, as its eval places them).

Mix keys: `lq_hw`, `batch`, `n_times`, `pool` (distinct clips),
`trace_skip` / `trace_requests` (the traced slice of the window). The
cell's own file sets how many answers are checked."""

from __future__ import annotations

import time

import numpy as np

from benchmark import reference, trace, weights
from benchmark.data import frames as frame_src
from benchmark.ops_pass import op_times, wrapped

SPANS = ("request", "plan", "replay")


def lq_pool(seed: int, mix: dict, scale: int) -> np.ndarray:
    """(pool, batch, 4, h, w, 3) float32 LQ inputs: frames 1, 3, 5, 7 of
    septuplets at the HR size, each downscaled by `scale`, reversed in
    time where the seed says."""
    rng = np.random.default_rng([int(seed), 1])
    h, w = mix["lq_hw"]
    P, B = int(mix["pool"]), int(mix["batch"])
    clips = frame_src.septuplets(rng, P * B, (h * scale, w * scale))
    out = np.empty((P * B, 4, h, w, 3), np.float32)
    for i, clip in enumerate(clips):
        idx = [0, 2, 4, 6][::-1] if rng.integers(2) else [0, 2, 4, 6]
        for k, j in enumerate(idx):
            out[i, k] = frame_src.downscale(clip[j], scale) / 255.0
    return out.reshape(P, B, 4, h, w, 3)


def schedule(seed: int, mix: dict, count: int) -> list:
    """The N of requests 0 .. count - 1."""
    rng = np.random.default_rng([int(seed), 2])
    ns = list(mix["n_times"])
    out = []
    while len(out) < count:
        out += [ns[i] for i in rng.permutation(len(ns))]
    return out[:count]


def times_of(n: int, batch: int) -> np.ndarray:
    return np.tile(np.arange(n, dtype=np.float32) / n, (batch, 1))


def sampled(seed: int, limits: dict, ns: list) -> list:
    """The checked requests (the cell's `sample` of its first
    `sample_from`): drawn from the seed, with every N in."""
    rng = np.random.default_rng([int(seed), 3])
    pick = set(int(i) for i in rng.choice(int(limits["sample_from"]),
                                          int(limits["sample"]),
                                          replace=False))
    for n in set(ns):
        if not any(i < len(ns) and ns[i] == n for i in pick):
            pick.add(next(i for i in range(len(ns)) if ns[i] == n))
    return sorted(pick)


class _Spans:
    """The harness's spans inside `Evaluator.infer` for the traced run: the
    plan and each replay of the bucket's graph (the rest of a request is
    the copy to the host and its wait)."""

    def __init__(self, ev, spans):
        from motif_tpu_torch import eval as ev_mod

        plan, self.cls = ev._plan, ev_mod._Bucket
        self.run = run = ev_mod._Bucket._run

        def _plan(*a, **kw):
            with spans("plan"):
                return plan(*a, **kw)

        def _run(bucket, fwd):
            with spans("replay"):
                return run(bucket, fwd)
        ev._plan = _plan
        ev_mod._Bucket._run = _run

    def close(self, ev):
        self.cls._run = self.run
        ev.__dict__.pop("_plan", None)


def run(cell, args, h) -> dict:
    """One run of a clip cell on `h.device`. Returns the harness's record
    (see run.py)."""
    torch = h.torch
    from motif_tpu_torch.eval import Evaluator
    from motif_tpu_torch.models.factory import define_g

    mix, cfg = cell.traffic, cell.config
    dev = h.device
    scale = int(cfg["scale"])
    model = define_g(dict(cfg["network_G"]), device=dev, n_frames=4)
    h.log("set-up: model built")
    weights.load(model, args.seed, cfg["init"])
    ev = Evaluator(model, scale=scale, iters=int(cfg["eval_iters"]),
                   chunk=int(cfg["eval_chunk"]), family=cfg["family"],
                   device=dev)
    pool = lq_pool(args.seed, mix, scale)
    h_lq, w_lq = mix["lq_hw"]
    out_hw = (h_lq * scale, w_lq * scale)
    ns = schedule(args.seed, mix, int(mix["max_requests"]))
    check_idx = set(sampled(args.seed, cell.limits, ns))
    B = int(mix["batch"])
    h.log("set-up: weights and inputs made")

    def request(i):
        return pool[i % len(pool)], times_of(ns[i], B)

    # set-up: every shape this traffic sends, through the timed entry
    for n in sorted(set(mix["n_times"])):
        ev.infer(pool[0], times_of(n, B), out_hw)
    h.sync()
    h.log("set-up: warmed up and captured")
    ops = None
    if args.trace:
        calls: list = []
        with trace.profiled(torch, h.spans) as tr, \
                wrapped(torch, calls, h.spans):
            for n in sorted(set(mix["n_times"])):
                ev._infer_eager(pool[1 % len(pool)], times_of(n, B), out_hw)
        ops = op_times(calls, tr)
        h.log(f"kernel ops (bound ms, device ms, calls): {ops}")
    h.sync()
    h.mark_setup()
    h.log(f"set-up done: {ev.captures} capture(s)")

    # the window
    reqs, kept = [], {}
    sl = trace.Slice(torch, h.spans, bool(args.trace),
                     int(mix.get("trace_skip", 0)), int(mix["trace_requests"]))
    spans = _Spans(ev, h.spans) if args.trace else None
    t_start = time.perf_counter()
    t_stop = t_start + args.seconds
    i = 0
    while time.perf_counter() < t_stop and i < len(ns):
        sl.before(i)
        lq, t = request(i)
        t0 = time.perf_counter()
        with h.spans("request"):
            frames, stats = ev.infer(lq, t, out_hw)
        t1 = time.perf_counter()
        reqs.append({"n": ns[i], "ms": (t1 - t0) * 1e3, "t0": t0, "t1": t1})
        if i in check_idx:
            kept[i] = (frames.copy(), stats)
        sl.after(i)
        i += 1
    sl.close()
    t_end = time.perf_counter()
    if spans is not None:
        spans.close(ev)
    window_s = t_end - t_start
    n_frames = sum(r["n"] for r in reqs) * B
    ms = np.asarray([r["ms"] for r in reqs])
    rec = h.record()
    rec.update(
        attempted=len(reqs), failed=0, window_s=window_s, requests=reqs,
        trace=sl.trace, trace_host=sl.host, ops=ops,
        peak=float(cfg["peak_flop_per_s"]),
        e2e={"hr_frames_per_s": n_frames / window_s,
             "request_ms_p95": float(np.percentile(ms, 95))})
    h.read_memory()
    h.log(f"window done: {len(reqs)} requests in {window_s:.3f} s")
    del ev, model
    h.free()

    # the check: the reference over the same weights and inputs
    checks, flops = compare(cell, args, h, kept, request, out_hw, ns,
                            len(check_idx))
    rec["checks"] = checks
    h.log(f"checked {len(kept)} requests against the reference")
    if args.trace:
        rec["flops_of_n"] = flops
    return rec


def _frame_quantile(rows, q: float):
    """The worst row's q-quantile of |rows| (a row is a frame's values)."""
    k = max(1, min(rows.shape[1], int(np.ceil(q * rows.shape[1]))))
    return float(rows.abs().kthvalue(k, dim=1).values.max())


def compare(cell, args, h, kept: dict, request, out_hw, ns, due: int):
    """Each kept answer against the reference's. Readings: of the worst
    frame, the median, the 99th and the 99.9th percentile of its values'
    |difference| (`frame_median_abs_max`, `frame_p99_abs_max`,
    `frame_p999_abs_max`: a fault in one channel, a band of rows or a tile
    region over a thousandth of a frame lifts the last), the largest
    relative difference of the flow statistics (`flow_stats_rel`), the
    worst frame's RMS difference, all frames' RMS difference and the
    largest difference; and `answers_missing`, the sampled requests (`due`
    of them) that left no answer to check, which is compared with the
    limit 0 whatever the cell's limits name. The cell's limits name the
    other compared readings. Returns (checks, {N: model FLOPs of a request
    of N times, unpadded, when traced})."""
    torch, dev, cfg = h.torch, h.device, cell.config
    from benchmark.counts.flops import counting
    from benchmark.reference import infer as ref

    with reference.precise(torch):
        model = ref.build(cfg, dev)
        weights.load(model, args.seed, cfg["init"])
        frame_err, stat_err, frame_rms, sq, count = 0.0, 0.0, 0.0, 0.0, 0
        frame_med, frame_p99, frame_p999 = 0.0, 0.0, 0.0
        for i, (frames, stats) in sorted(kept.items()):
            lq, t = request(i)
            want, want_stats = ref.infer(
                model, lq, t, out_hw, int(cfg["scale"]),
                int(cfg["eval_chunk"]), int(cfg["eval_iters"]), dev)
            got = torch.as_tensor(frames, device=dev)
            d = (got - want).double()
            frame_err = max(frame_err, float(d.abs().max()))
            rows = d.reshape(d.shape[0] * d.shape[1], -1)
            frame_rms = max(frame_rms,
                            float(rows.pow(2).mean(1).max().sqrt()))
            frame_med = max(frame_med, _frame_quantile(rows, 0.5))
            frame_p99 = max(frame_p99, _frame_quantile(rows, 0.99))
            frame_p999 = max(frame_p999, _frame_quantile(rows, 0.999))
            sq += float(d.pow(2).sum())
            count += d.numel()
            for a, b in zip(stats, want_stats):
                stat_err = max(stat_err, abs(a - b) / max(abs(b), 1e-12))
        flops = {}
        if args.trace:
            lq, _ = request(0)
            chunk = int(cfg["eval_chunk"])
            per_k = {}
            for n in sorted(set(cell.traffic["n_times"])):
                total = 0
                for start in range(0, n, chunk):
                    k = min(chunk, n - start)
                    if k not in per_k:
                        with counting() as c:
                            ref.infer(model, lq, times_of(k, lq.shape[0]),
                                      out_hw, int(cfg["scale"]), k,
                                      int(cfg["eval_iters"]), dev)
                        per_k[k] = c["flops"]
                    total += per_k[k]
                flops[n] = total
        del model
    readings = {"frame_median_abs_max": frame_med,
                "frame_p99_abs_max": frame_p99,
                "frame_p999_abs_max": frame_p999,
                "flow_stats_rel": float(stat_err),
                "frame_rms_max": frame_rms,
                "frames_rms": (sq / max(count, 1)) ** 0.5,
                "frames_max_abs": frame_err,
                "answers_missing": float(due - len(kept))}
    h.log(f"readings: {readings}")
    lim = dict(cell.limits["compared"], answers_missing=0.0)
    from benchmark.harness import check
    return [check(k, readings[k], lim[k]) for k in lim], flops


def control(cell, args, h) -> dict:
    """The control of `correct`: the answers of the same sampled requests
    made by the reference itself with TF32 on (the nearest precision below
    the configuration's float32), in the program's place, then compared as
    a run compares the program's."""
    torch, dev, cfg, mix = h.torch, h.device, cell.config, cell.traffic
    from benchmark.reference import infer as ref

    scale = int(cfg["scale"])
    pool = lq_pool(args.seed, mix, scale)
    h_lq, w_lq = mix["lq_hw"]
    out_hw = (h_lq * scale, w_lq * scale)
    ns = schedule(args.seed, mix, int(mix["max_requests"]))
    B = int(mix["batch"])

    def request(i):
        return pool[i % len(pool)], times_of(ns[i], B)

    h.mark_setup()
    kept = {}
    due = sampled(args.seed, cell.limits, ns)
    with reference.precise(torch, tf32=True):
        model = ref.build(cfg, dev)
        weights.load(model, args.seed, cfg["init"])
        for i in due:
            lq, t = request(i)
            frames, stats = ref.infer(model, lq, t, out_hw, scale,
                                      int(cfg["eval_chunk"]),
                                      int(cfg["eval_iters"]), dev)
            kept[i] = (frames.cpu().numpy(), stats)
        del model
    h.read_memory()
    h.free()
    checks, _ = compare(cell, args, h, kept, request, out_hw, ns, len(due))
    return {"setup_s": h.setup_s, "attempted": len(kept), "failed": 0,
            "checks": checks, "e2e": {}, "window_s": 0.0}
