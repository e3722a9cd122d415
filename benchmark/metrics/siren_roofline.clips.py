"""Kernel op `siren`: its bound (counts/bounds.py, from each call's
shapes) over the device time of every kernel its calls launched, summed
over the traced run's eager pass of one request of each N, in percent."""

from benchmark.metrics._common import roofline


def read(rec):
    return roofline(rec, "siren")
