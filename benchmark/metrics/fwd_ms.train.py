"""Train (`trainer.Trainer.step`): the median, over the traced run's
steps outside its profiled slice, of the step's forward milliseconds
(`aux["ms"]["forward"]`, each part ended by a device synchronisation under
`sync_times=True`)."""

from benchmark.metrics._common import median, untraced


def read(rec):
    parts = [r["ms"]["forward"] for r in untraced(rec, rec.get("steps", []))
             if r.get("ms")]
    return median(parts)
