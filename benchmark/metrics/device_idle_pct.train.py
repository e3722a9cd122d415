"""Device: the share of the traced slice of the window in which no
operation ran on the card (1 - the union of device intervals over the
slice), in percent."""

from benchmark.metrics._common import idle_pct


def read(rec):
    return idle_pct(rec)
