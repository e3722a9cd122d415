"""Entry (`Evaluator.infer`): the median over the traced requests of the
program's `infer.bucket` span in milliseconds: the bucket's look-up, with
the walk over every parameter and buffer that stamps the weights, the
key and the sign of alpha."""

from benchmark.metrics._common import median
from benchmark.metrics._program import roots


def read(rec):
    rows = [(k["end"] - k["start"]) / 1e6 for _, kids in roots(rec) or ()
            for k in kids if k["name"] == "infer.bucket"]
    return median(rows) if rows else None
