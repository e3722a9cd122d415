"""Model (`MoTIF.forward`): the device milliseconds of its `decode` part
per HR frame returned, over the traced requests: the part's time between
its two marks in the request's last graph replay (CUDA events that the
capture made nodes of the graph) times the request's forwards, summed,
over the summed HR frames."""

from benchmark.metrics._program import part_ms_per_frame


def read(rec):
    return part_ms_per_frame(rec, "decode")
