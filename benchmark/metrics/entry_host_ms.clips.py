"""Entry (`Evaluator.infer`): the median over the traced requests of the
request's host-clock milliseconds less the milliseconds in which the
device ran its work (the union of device intervals inside the request's
span): the bucket look-up, padding, copies and waits around the replays."""

from benchmark import trace
from benchmark.metrics._common import median


def read(rec):
    tr = rec.get("trace")
    if tr is None or not tr.device:
        return None
    rows = [(e - s) / 1e3 - trace.busy_us(tr, s, e) / 1e3
            for name, s, e in tr.spans if name == "request"]
    return median(rows)
