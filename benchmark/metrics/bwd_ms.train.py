"""Train (`trainer.Trainer.step`): the median, over the traced run's
steps outside its profiled slice, of the step's backward milliseconds
(`aux["ms"]["backward"]`, each part ended by a device synchronisation under
`sync_times=True`)."""

from benchmark.metrics._common import median, untraced


def read(rec):
    parts = [r["ms"]["backward"] for r in untraced(rec, rec.get("steps", []))
             if r.get("ms")]
    return median(parts)
