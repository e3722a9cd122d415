"""Where the card idles inside each traced request, from the program's own
spans (PERF.md's split of the idle): one traced run of a clip cell, then,
for each request of the traced slice that `_program.requests` sets on its
own run of device operations, the device's idle inside `infer` split by
cause (`_program.idle_split`: the graph's own, inside a replay or before
an operation already issued, and the host's by the child of `infer` open
then), beside MoTIF's parts per HR frame against the busy and graph-own
time per frame, the share of the device's time that repeats `motion` and
`encoder` across a request's chunks, and the idle between requests. The
run's own result line comes first, then one `idle_split` JSON line:

    python3 benchmark/idle_split.py --workload <clip cell> --seed <n>
        --seconds <s> --trace 1

It runs on the card, as run.py does, and reports no metric."""

import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != os.path.dirname(
                            os.path.abspath(__file__))]

from benchmark import run  # noqa: E402
from benchmark.metrics import _program  # noqa: E402


def split(rec) -> dict:
    """The split of a traced clip run's record (see the module), in ms."""
    roots = _program.roots(rec) or []
    reqs = _program.requests(rec) or []
    out = {"requests": len(roots), "read": len(reqs)}
    if not reqs:
        return out
    by_cause: dict = {}
    busy = inside = parts = repeat = frames = with_parts = 0.0
    rows = []
    for q in reqs:
        s = _program.idle_split(q)
        own = sum(g1 - g0 for g0, g1 in _program.gaps(q)
                  if any(x <= g0 and g1 <= y for x, y in q["replays"]))
        b = _program.busy_us(q)
        for k, v in s.items():
            by_cause[k] = by_cause.get(k, 0.0) + v
        busy, inside = busy + b, inside + own
        a = q["root"]["attrs"]
        rows.append({"n": a.get("n"), "idle_ms": (q["hi"] - q["lo"] - b)
                     / 1e3, "graph_ms": s["graph"] / 1e3})
        if "parts_ms" in a:
            with_parts += (b + s["graph"]) / 1e3
            frames += a["frames"]
            parts += sum(a["parts_ms"].values()) * a["forwards"]
            repeat += (a["forwards"] - 1) * (a["parts_ms"]["motion"]
                                             + a["parts_ms"]["encoder"])
    idle = sum(by_cause.values())
    (h0, h1) = rec["trace_host"]
    out.update(
        idle_ms_per_request={k: v / 1e3 / len(reqs)
                             for k, v in sorted(by_cause.items())},
        graph_inside_replays_ms=inside / 1e3 / len(reqs),
        accounted_pct=100.0 * (idle - by_cause.get("infer", 0.0)) / idle,
        idle_ms_median=statistics.median(r["idle_ms"] for r in rows),
        graph_ms_median=statistics.median(r["graph_ms"] for r in rows),
        between_requests_ms=((h1 - h0) * 1e3 - sum(
            r["end"] - r["start"] for r, _ in roots) / 1e6)
        / max(len(roots) - 1, 1),
        per_request=rows)
    if frames:
        out.update(
            parts_ms_per_frame=parts / frames,
            busy_graph_ms_per_frame=with_parts / frames,
            parts_over_busy_graph_pct=100.0 * parts / with_parts,
            repeat_share_pct=100.0 * repeat / (busy / 1e3))
    return out


def main(argv=None) -> int:
    store = {}
    real = run.report

    def report(cell, kind, rec, args):
        store["rec"] = rec
        return real(cell, kind, rec, args)

    run.report = report
    try:
        rc = run.main(argv)
    finally:
        run.report = real
    if "rec" not in store:
        return rc or 1
    out = split(store["rec"])
    print("idle_split " + json.dumps(out), flush=True)
    return rc or (0 if out["read"] else 1)


if __name__ == "__main__":
    sys.exit(main())
