"""What every cell shares: finding a cell's files by name, the run's
environment, the harness's spans, the device record and the result line.

A cell is an entry of `workloads` in BENCHMARK.json. Its configuration is
`configs/<config>.json` (the `file` of its entry under `configs`), its
traffic mix `traffic/<traffic>.json`, whose `kind` names the generator
module `traffic/<kind>.py`, its limits of `correct` are in
`workloads/<cell>.json`, and each per-layer metric is read by
`metrics/<metric>.py`. Nothing here names a cell, a mix or a metric.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
PROGRAM = "motif_tpu_torch"
# top-level module names that may not be loaded in the process that prints
# the result: JAX and the JAX package (compared whole: the port's name
# begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "motif_tpu")


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    entry: dict            # the cell's entry in BENCHMARK.json
    config: dict           # configs/<config>.json
    traffic: dict          # traffic/<traffic>.json
    limits: dict           # workloads/<cell>.json: the limits of `correct`
    end_to_end: list       # BENCHMARK.json's end-to-end metrics of this cell
    per_layer: list        # BENCHMARK.json's per-layer metrics of this cell
    bench: dict = field(repr=False, default_factory=dict)


def _of_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell `name` of BENCHMARK.json (or of `bench`, a dict of its
    form) and everything it names, found by name."""
    if bench is None:
        bench = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(known: {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(os.path.join(ROOT, configs[entry["config"]]["file"]))
    traffic = read_json(os.path.join(BENCH, "traffic",
                                     entry["traffic"] + ".json"))
    limits = read_json(os.path.join(BENCH, "workloads", name + ".json"))
    return Cell(name, entry, config, traffic, limits,
                [m for m in bench["end_to_end"] if _of_cell(m, name)],
                [m for m in bench["per_layer"] if _of_cell(m, name)], bench)


def load_module(kind: str, name: str):
    """`<kind>/<name>.py` under the benchmark, loaded by its path (metric
    names hold dots)."""
    path = os.path.join(BENCH, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def prepare_environment() -> None:
    """Before torch is imported: every cache at a fixed path inside the
    checkout (the kernels' own build directory is `build/kernels/`), few
    host threads, and no JAX pulled in by a library."""
    cache = os.path.join(ROOT, "build", "benchmark_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "4")


def import_program():
    """The program under test from this checkout, or exit: a checkout
    without it runs nothing."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    try:
        import motif_tpu_torch
    except ImportError as e:
        raise SystemExit(f"the program {PROGRAM} is not in this checkout: {e}")
    where = os.path.dirname(os.path.abspath(motif_tpu_torch.__file__))
    if os.path.dirname(where) != ROOT:
        raise SystemExit(f"{PROGRAM} was found at {where}, outside the "
                         f"checkout {ROOT}")
    return motif_tpu_torch


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_record(torch, count: int = 1, trace: dict | None = None) -> dict:
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": count,
           "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                        for i in range(count)))}
    if trace is not None:
        dev["busy_s"] = trace["busy_s"]
        dev["window_s"] = trace["window_s"]
    return dev


def checks_text(checks: list) -> str:
    """The compared numbers, each beside its limit, as plain lines."""
    return "\n".join(f"{c['name']}: {c['value']!r} (limit {c['limit']!r}, "
                     f"{'ok' if c['ok'] else 'FAILED'})" for c in checks)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: list, breakdown: dict | None = None
                ) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    # the compared numbers come last, each with its limit
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return json.dumps(out)


def check(name: str, value: float, limit: float) -> dict:
    """One compared number: correct while value <= limit (a NaN fails)."""
    value = float(value)
    return {"name": name, "value": value, "limit": float(limit),
            "ok": bool(value <= limit)}
