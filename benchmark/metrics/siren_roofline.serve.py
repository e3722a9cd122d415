"""Kernel op `siren` of a serving cell: its bound (counts/bounds_lowp.py,
from each call's shapes and element sizes, the tensor cores' rate for
16-bit products) over the device time of every kernel its calls launched,
summed over the traced run's eager pass of one request of each N, in
percent."""

from benchmark.metrics._common import roofline


def read(rec):
    return roofline({"ops": rec.get("ops_lowp")}, "siren")
