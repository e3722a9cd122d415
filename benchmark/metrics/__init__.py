"""Per-layer metrics: `<metric>.py` holds `read(rec)`, which takes the
metric from the run's record (its trace, the harness's spans and counts)
and returns a number, or None where there is nothing to read."""
