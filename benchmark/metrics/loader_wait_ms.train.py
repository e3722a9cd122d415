"""Data (`data/pipeline.py::BatchLoader` through `device_prefetch`): the
milliseconds the step loop waited for the next batch, by the harness's
clock around each `next()`, summed over the window and divided by its
steps."""


def read(rec):
    steps = rec.get("steps") or []
    if not steps:
        return None
    return 1e3 * sum(r["wait"] for r in steps) / len(steps)
