"""Model (`MoTIF.forward`): the model's operations of the requests served
outside the traced slice (each request at its own N, unpadded, counted by
FlopCounterMode over the reference) over their time and the configuration's
peak, in percent."""

from benchmark.metrics._common import untraced


def read(rec):
    flops = rec.get("flops_of_n")
    rows = untraced(rec, rec["requests"])
    if not flops or not rows:
        return None
    ops = sum(flops[r["n"]] for r in rows)
    seconds = sum(r["ms"] for r in rows) / 1e3
    return 100.0 * ops / (seconds * rec["peak"])
