"""Reading a torch.profiler trace: the device's intervals (kernels,
copies, sets), the harness's spans (record_function ranges on the host),
and what the per-layer metrics and the breakdown are made of. Times are
microseconds on the profiler's clock, which host and device events share.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


# the harness's span names in every traffic kind (record_function ranges)
SPAN_NAMES = ("traced_window", "request", "plan", "replay", "loader_next",
              "step", "fwd", "bwd", "opt", "op.splat", "op.dcn", "op.siren")


@dataclass
class Trace:
    device: list = field(default_factory=list)   # (name, start, end)
    spans: list = field(default_factory=list)    # (name, start, end)
    window: tuple = (0.0, 0.0)                   # the traced window


@contextlib.contextmanager
def profiled(torch, spans):
    """Profile the block (host and CUDA); yields a Trace filled when the
    block ends. The window is the `traced_window` span inside it."""
    from torch.profiler import ProfilerActivity, profile

    out = Trace()
    cuda = torch.cuda.is_available()
    prof = profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if cuda else []))
    with prof:
        with spans("traced_window"):
            yield out
            if cuda:
                torch.cuda.synchronize()
    fill(out, prof.events())


class Slice:
    """The traced slice of a window: the profiler on from row `start` for
    `count` rows (requests or steps) when `on`. `before(i)` precedes row
    i, `after(i)` follows it, `close()` ends a slice the window cut short.
    `trace` is the Trace, `host` its host-clock interval."""

    def __init__(self, torch, spans, on: bool, start: int, count: int):
        self.torch, self.spans, self.on = torch, spans, on
        self.start, self.count = start, count
        self.trace, self.host, self._cm = None, None, None

    def before(self, i: int) -> None:
        if self.on and i == self.start:
            self._cm = profiled(self.torch, self.spans)
            self.trace = self._cm.__enter__()
            self.host = [time.perf_counter(), None]

    def after(self, i: int) -> None:
        if self._cm is not None and i + 1 == self.start + self.count:
            self.close()

    def close(self) -> None:
        if self._cm is not None:
            if self.torch.cuda.is_available():
                self.torch.cuda.synchronize()
            self.host[1] = time.perf_counter()
            self._cm.__exit__(None, None, None)
            self._cm = None
            self.host = tuple(self.host)


def fill(out: Trace, events) -> None:
    """The device's operations and the host's ranges of `events`. A
    record_function range (the harness's spans, and the program's own such
    as `dcn_im2col.backward`) also shows on the device's timeline as an
    annotation under its own name: every device event named as a host
    event is such an annotation, and is left out of the device's
    operations."""
    host, device = [], []
    for e in events:
        dt = str(getattr(e, "device_type", "")).rsplit(".", 1)[-1]
        tr = e.time_range
        row = (e.name, float(tr.start), float(tr.end))
        if dt == "CUDA":
            device.append(row)
        elif dt == "CPU":
            host.append(row)
    on_host = {r[0] for r in host}
    out.spans = [r for r in host if r[0] in SPAN_NAMES]
    out.device = [r for r in device if r[0] not in on_host]
    out.device.sort(key=lambda r: r[1])
    win = [s for s in out.spans if s[0] == "traced_window"]
    if win:
        out.window = (win[0][1], win[0][2])


def merged(intervals, lo: float, hi: float) -> list:
    """The union of (start, end) intervals clipped to [lo, hi], sorted."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(tr: Trace, lo: float | None = None, hi: float | None = None):
    lo = tr.window[0] if lo is None else lo
    hi = tr.window[1] if hi is None else hi
    return sum(e - s for s, e in merged(((s, e) for _, s, e in tr.device),
                                        lo, hi))


def window_us(tr: Trace) -> float:
    return tr.window[1] - tr.window[0]


def device_ops(tr: Trace, top: int = 10) -> list:
    """[name, seconds] of the device operations that took most time in the
    window."""
    tot: dict = {}
    lo, hi = tr.window
    for name, s, e in tr.device:
        if e > lo and s < hi:
            tot[name] = tot.get(name, 0.0) + (min(e, hi) - max(s, lo))
    rows = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [[n, v / 1e6] for n, v in rows]


def idle_gaps(tr: Trace, names, top: int = 10) -> list:
    """[span, seconds]: the device's idle time in the window, each gap named
    by the innermost of the harness's spans `names` open on the host at
    the gap's middle ("none" outside them), summed by name, longest first."""
    lo, hi = tr.window
    busy = merged(((s, e) for _, s, e in tr.device), lo, hi)
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    spans = [s for s in tr.spans if s[0] in names]
    tot: dict = {}
    for s, e in gaps:
        mid = (s + e) / 2
        open_ = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        name = min(open_, key=lambda sp: sp[2] - sp[1])[0] if open_ else "none"
        tot[name] = tot.get(name, 0.0) + (e - s)
    rows = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [[n, v / 1e6] for n, v in rows]


def device_us_within(tr: Trace, lo: float, hi: float) -> float:
    """Summed durations of the device events whose middle lies within
    [lo, hi] (the middle, so that a skew of a few microseconds between the
    host's and the device's timestamps moves no event in or out of a span
    that the device is idle around)."""
    return sum(e - s for _, s, e in tr.device if lo <= (s + e) / 2 <= hi)
