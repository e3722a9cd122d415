"""The program's own spans (`motif_tpu_torch.obs`) of a traced run beside
the trace's device intervals, and what the readers of the Entry and Model
metrics make of them.

The profiler's device timestamps do not keep to the host's clock inside a
traced slice: a request's run of device operations reads up to about 1%
longer or shorter than the host's time between its copies, runs shift by
milliseconds against the host between requests, and the slice's first
and last operations can be missing. Two ways of setting the records
beside the trace:

- the slice line (`slice_line`): the host's perf_counter onto the
  profiler's clock through the traced slice's two ends
  (`rec["trace_host"]`, `rec["trace"].window`). `infer_idle_ms.clips`
  reads each request's span through it, so where the device's timeline
  has shifted a request's edge can gain or lose a device operation;
- each request on its own operations (`requests`): the trace's device
  operations cut into runs at the copies to the device (`segments`),
  each request's run put onto the host's clock through two points of
  its own, the end of its copies in (which an idle card runs as soon as
  `infer.copy_in` issues them) and the end of its last copy out (when
  `infer.wait` returns), and its replays found by the run's order: each
  chunk's operations lie between the copy of its times and the copies
  that gather its output (`Memcpy DtoD`). A run whose length or copies
  do not fit its request is not read. `idle_split` splits the idle of
  what is read by cause (`benchmark/idle_split.py`; no metric reads it).

The program's span records lie inside the slice by the host's clock
alone (`roots`); the part metrics and `infer_bucket_ms.clips` read them
so. A checkout whose program keeps no spans, a run without a trace or
without device intervals (the CPU) gives nothing to read.
"""

from __future__ import annotations

from benchmark import trace

TOL = 0.02       # a run's length against the host's: the trace's rate error
COPY_IN, COPY_DD, COPY_OUT = "HtoD", "DtoD", "DtoH"
# the children of `infer` that issue device work, in their order
ISSUERS = ("infer.copy_in", "infer.replay", "infer.gather", "infer.copy_out")


def segments(tr) -> list:
    """The device's operations, oldest first, cut into runs: a run starts
    at a copy to the device that follows any other operation (or none)."""
    out: list = []
    for op in sorted(tr.device, key=lambda r: r[1]):
        if COPY_IN in op[0] and (not out or COPY_IN not in out[-1][-1][0]):
            out.append([])
        if out:
            out[-1].append(op)
    return out


def roots(rec):
    """[(the `infer` record, its children)] of the requests inside the
    traced slice on the host's clock, oldest first, or None."""
    tr, host = rec.get("trace"), rec.get("trace_host")
    if tr is None or host is None or not tr.device:
        return None
    try:
        from motif_tpu_torch import obs
    except ImportError:
        return None
    lo, hi = host[0] * 1e9, host[1] * 1e9
    recs = [r for r in obs.spans() if lo <= r["start"] and r["end"] <= hi]
    kids: dict = {}
    for r in recs:
        kids.setdefault(r["parent"], []).append(r)
    return [(r, kids.get(r["id"], [])) for r in sorted(
        (r for r in recs if r["name"] == "infer" and r["parent"] is None),
        key=lambda r: r["start"])] or None


def slice_line(rec):
    """The host's perf_counter_ns onto the profiler's clock (us) through
    the traced slice's two ends, or None."""
    (h0, h1), (w0, w1) = rec["trace_host"], rec["trace"].window
    if h1 <= h0 or w1 <= w0:
        return None
    per = (w1 - w0) / ((h1 - h0) * 1e9)
    return lambda ns: w0 + (ns - h0 * 1e9) * per


def requests(rec):
    """The traced slice's requests that can be set on their own device
    operations, oldest first, each a dict on the host's clock (us): `root`
    (the `infer` record), `lo` / `hi` (its ends), `kids` (its children,
    each with `lo` / `hi`, by start), `ops` (its device operations, (name,
    start, end)) and `replays` ((start, end) of each chunk's replay). A
    request and a run go together where each is the other's nearest, by
    the end of `infer.copy_in` on the slice line and the run's start (the
    slice can miss its first request's copies). None where there is
    nothing to read."""
    rs, line = roots(rec), None
    if rs:
        line = slice_line(rec)
    segs = segments(rec["trace"]) if line is not None else []
    rs = [(r, kids) for r, kids in rs or ()
          if any(k["name"] == "infer.copy_in" for k in kids)]
    if not rs or not segs:
        return None
    at = [line(next(k for k in kids if k["name"] == "infer.copy_in")["end"])
          for _, kids in rs]
    out = []
    for i, (root, kids) in enumerate(rs):
        j = min(range(len(segs)), key=lambda j: abs(segs[j][0][1] - at[i]))
        if min(range(len(rs)), key=lambda i: abs(segs[j][0][1] - at[i])) \
                != i:
            continue
        q = aligned(root, kids, segs[j])
        if q is not None:
            out.append(q)
    return out or None


def aligned(root: dict, kids: list, seg: list):
    """One request (see `requests`) from its `infer` record, its children
    and a run of device operations, or None where the run does not fit:
    its length between the two points off the host's by more than `TOL`,
    no copy to the device at its start or to the host at its end, or its
    device-to-device copies not the same number for each chunk."""
    by = {k["name"]: k for k in kids}
    chunks = root["attrs"].get("chunks")
    if not chunks or "infer.copy_in" not in by or "infer.wait" not in by:
        return None
    n_in = next((i for i, op in enumerate(seg) if COPY_IN not in op[0]),
                len(seg))
    dd = [i for i, op in enumerate(seg) if COPY_DD in op[0]]
    if not n_in or COPY_OUT not in seg[-1][0] or len(dd) % chunks \
            or len(dd) < 2 * chunks:
        return None
    a, b = max(op[2] for op in seg[:n_in]), max(op[2] for op in seg)
    ha, hb = by["infer.copy_in"]["end"] / 1e3, by["infer.wait"]["end"] / 1e3
    if b <= a or hb <= ha or abs((b - a) / (hb - ha) - 1) > TOL:
        return None
    per = (hb - ha) / (b - a)            # host us per trace us

    def at(t):
        return ha + (t - a) * per
    ops = [(n, at(s), at(e)) for n, s, e in seg]
    step = len(dd) // chunks
    replays = [ops[dd[k * step] + 1:dd[k * step + 1]]
               for k in range(chunks)]
    return {"root": root, "lo": root["start"] / 1e3, "hi": root["end"] / 1e3,
            "kids": sorted((dict(k, lo=k["start"] / 1e3, hi=k["end"] / 1e3)
                            for k in kids), key=lambda k: k["lo"]),
            "ops": ops,
            "replays": [(min(s for _, s, _ in r), max(e for _, _, e in r))
                        for r in replays if r]}


def busy_us(q: dict) -> float:
    """The device's busy microseconds inside the request's `infer` span."""
    return sum(e - s for s, e in trace.merged(
        ((s, e) for _, s, e in q["ops"]), q["lo"], q["hi"]))


def gaps(q: dict) -> list:
    """The device's idle intervals inside the request's `infer` span."""
    out, at = [], q["lo"]
    for s, e in trace.merged(((s, e) for _, s, e in q["ops"]),
                             q["lo"], q["hi"]):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if q["hi"] > at:
        out.append((at, q["hi"]))
    return out


def idle_split(q: dict) -> dict:
    """The device's idle microseconds inside one request's `infer` span, by
    cause. `graph`: the gaps that are the graph's own, either between two
    operations of one replay (one launch issued them all) or before an
    operation already issued when the gap began (the issuing child opened
    last before the gap's end, a chunk's `infer.replay` or a copy's
    `infer.copy_in` / `infer.copy_out` or an `infer.gather`, had closed
    at the gap's start). Every other gap is the host's, each part of it
    put down to the child of `infer` open then (under its name), and to
    `infer` itself where none is."""
    own = q["replays"]
    issuers = [k for k in q["kids"] if k["name"] in ISSUERS]
    out = {"graph": 0.0}
    for g0, g1 in gaps(q):
        before = [k for k in issuers if k["lo"] <= g1]
        if any(x <= g0 and g1 <= y for x, y in own) or (
                g1 < q["hi"] and before and before[-1]["hi"] <= g0):
            out["graph"] += g1 - g0
            continue
        rest = g1 - g0
        for k in q["kids"]:
            part = min(g1, k["hi"]) - max(g0, k["lo"])
            if part > 0:
                out[k["name"]] = out.get(k["name"], 0.0) + part
                rest -= part
        out["infer"] = out.get("infer", 0.0) + max(rest, 0.0)
    return out


def part_ms_per_frame(rec, part: str):
    """MoTIF's part `part` (`motif_tpu_torch.models.motif.PARTS`): the sum
    over the traced requests of its device ms in the request's last replay
    times the request's forwards, over the sum of their HR frames."""
    rows = [r["attrs"] for r, _ in roots(rec) or ()
            if "parts_ms" in r["attrs"]]
    frames = sum(a["frames"] for a in rows)
    if not rows or frames <= 0:
        return None
    return sum(a["parts_ms"][part] * a["forwards"] for a in rows) / frames
