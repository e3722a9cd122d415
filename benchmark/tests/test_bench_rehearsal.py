"""Both traffic kinds end to end on the CPU at a tiny width (the program's
plain versions stand in for its kernels), the result line's keys, and the
runs' refusals: no card, no program, JAX loaded."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _run(name, **kw):
    cell = tiny.cell(name)
    kind = harness.load_module("traffic", cell.traffic["kind"])
    host = tiny.cpu_host()
    rec = kind.run(cell, tiny.args(**kw), host)
    rec["memory"] = host.memory
    return cell, kind, rec


def test_clips_end_to_end():
    cell, kind, rec = _run("ours-clips", seconds=600.0)
    assert rec["attempted"] >= 1 and rec["failed"] == 0
    assert all(c["ok"] for c in rec["checks"]), rec["checks"]
    e2e = rec["e2e"]
    assert e2e["hr_frames_per_s"] > 0 and e2e["request_ms_p95"] > 0


def test_clips_traced_reads_its_metrics():
    from benchmark import run

    cell, kind, rec = _run("ours-clips", seconds=600.0, trace=1)
    metrics, dev, breakdown = run.report(cell, kind, rec, tiny.args(trace=1))
    # no device here: the device's readers find nothing and say so
    assert "mfu.clips" in metrics and metrics["mfu.clips"]["value"] > 0
    assert "device_idle_pct.clips" not in metrics
    assert set(rec["ops"]) == {"splat", "dcn", "siren"}
    assert set(breakdown) == {"device_ops", "idle_gaps"}


def test_train_end_to_end(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cell, kind, rec = _run("ours44-train", seconds=0.5)
    assert rec["attempted"] >= 1
    assert all(c["ok"] for c in rec["checks"]), rec["checks"]
    assert rec["e2e"]["train_hr_frames_per_s"] > 0


def test_train_traced_reads_its_metrics(tmp_path, monkeypatch):
    from benchmark import run

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cell, kind, rec = _run("ours44-train", seconds=30.0, trace=1)
    assert rec["trace_host"] is not None and rec["attempted"] >= 2
    metrics, dev, breakdown = run.report(cell, kind, rec, tiny.args(trace=1))
    for name in ("fwd_ms.train", "bwd_ms.train", "loader_wait_ms.train",
                 "mfu.train"):
        assert metrics[name]["value"] > 0, name
    assert [g[0] for g in breakdown["idle_gaps"]]


def test_result_line_keys():
    checks = [harness.check("a", 1e-7, 1e-5), harness.check("b", 2.0, 1.0)]
    line = json.loads(harness.result_line(
        False, 3, 0, {"x": {"value": 1.0, "unit": "s"}},
        {"platform": "gpu", "kind": "k", "count": 1,
         "memory_peak_bytes": 1}, checks,
        {"device_ops": [], "idle_gaps": []}))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["checks"]["b"] == {"value": 2.0, "limit": 1.0}
    assert not checks[1]["ok"] and checks[0]["ok"]
    assert not harness.check("nan", float("nan"), 1.0)["ok"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    root = os.path.join(harness.BENCH, sub)
    for d, _, files in os.walk(root):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        names = set(_imports(path))
        assert not names & {"motif_tpu_torch", "motif_tpu", "jax", "flax"}, \
            path


def test_no_source_imports_jax():
    for path in _sources():
        assert not set(_imports(path)) & set(harness.FORBIDDEN), path


def test_no_jax_loaded_after_a_rehearsal(tmp_path):
    """In a fresh process: a traced clip rehearsal and a training one, then
    the top-level names of every loaded module (compared whole)."""
    code = (
        "import sys, torch; torch.set_num_threads(2)\n"
        "from benchmark import harness\n"
        "from benchmark.tests import tiny\n"
        "for name, kw in (('ours-clips', dict(trace=1, seconds=1.0)),"
        " ('ours44-train', dict(seconds=0.2))):\n"
        "    cell = tiny.cell(name)\n"
        "    kind = harness.load_module('traffic', cell.traffic['kind'])\n"
        "    kind.run(cell, tiny.args(**kw), tiny.cpu_host())\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print('PROGRAM', 'motif_tpu_torch' in tops)\n"
        "print('FORBIDDEN', sorted(tops & {'jax', 'jaxlib', 'flax', "
        "'motif_tpu'}))\n")
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PROGRAM True" in out.stdout
    assert "FORBIDDEN []" in out.stdout


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ours-clips",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_a_checkout_without_the_program_runs_nothing(tmp_path):
    """BENCHMARK.json and the benchmark alone: the program is not found in
    the checkout, so nothing runs."""
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from benchmark import harness\n"
            "harness.import_program()\n"
            "print('RAN')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "RAN" not in out.stdout
