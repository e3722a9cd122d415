"""Model (`MoTIF.forward`'s train branch and its backward): the forward
and backward operations of one step (FlopCounterMode over the reference's
loss and `backward()` at the batch's shapes) times the steps outside the
traced slice, over their time and the configuration's peak, in percent."""

from benchmark.metrics._common import untraced


def read(rec):
    flops = rec.get("flops_per_step")
    rows = untraced(rec, rec.get("steps") or [])
    if not flops or not rows:
        return None
    seconds = sum(r["t1"] - r["t0"] for r in rows)
    return 100.0 * flops * len(rows) / (seconds * rec["peak"])
