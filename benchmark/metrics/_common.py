"""What several readers share."""

from __future__ import annotations

import numpy as np

from benchmark import trace


def roofline(rec, op: str):
    """The op's summed bound over its summed device time, in percent, from
    the traced run's pass over the kernel ops."""
    ops = rec.get("ops") or {}
    if op not in ops or ops[op][1] <= 0:
        return None
    bound_ms, device_ms, _ = ops[op]
    return 100.0 * bound_ms / device_ms


def idle_pct(rec):
    tr = rec.get("trace")
    if tr is None or trace.window_us(tr) <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - trace.busy_us(tr) / trace.window_us(tr))


def untraced(rec, rows):
    """The rows (requests or steps) outside the traced slice."""
    tr = rec.get("trace")
    if tr is None:
        return rows
    lo, hi = rec["trace_host"]
    return [r for r in rows if r["t1"] <= lo or r["t0"] >= hi]


def median(values):
    return float(np.median(values)) if len(values) else None
