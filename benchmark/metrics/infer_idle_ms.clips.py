"""Entry (`Evaluator.infer`): the median over the traced requests of the
program's `infer` span less the device's busy time inside it (the union
of device intervals), in milliseconds, the span set on the profiler's
clock by the slice line (`_program.slice_line`): what leaves the card idle
inside a request, the host's work and the graph's own gaps together.
Where the device's timeline has shifted against the host's, an operation
at a request's edge can fall into or out of its span."""

from benchmark import trace
from benchmark.metrics._common import median
from benchmark.metrics._program import roots, slice_line


def read(rec):
    rs = roots(rec)
    line = slice_line(rec) if rs else None
    if line is None:
        return None
    tr = rec["trace"]
    rows = []
    for r, _ in rs:
        lo, hi = line(r["start"]), line(r["end"])
        rows.append((hi - lo - trace.busy_us(tr, lo, hi)) / 1e3)
    return median(rows)
