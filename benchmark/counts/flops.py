"""Model operations by `torch.utils.flop_counter.FlopCounterMode`, run over
the benchmark's plain reference: the same count whatever implements the
work (convolutions and matrix products; the gathers, the splat's sums and
the sines are not counted, so a share of the peak is a floor)."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def counting():
    """Yields a dict whose `flops` is filled when the block ends."""
    from torch.utils.flop_counter import FlopCounterMode

    out = {}
    mode = FlopCounterMode(display=False)
    with mode:
        yield out
    out["flops"] = int(mode.get_total_flops())
