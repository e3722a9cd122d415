"""Tiny cells for rehearsing the harness on the CPU: the cell's own files
with the model's width cut to 16 and the traffic's sizes cut, run through
the traffic kinds with the plain versions of the kernels (the program's
CPU path)."""

from __future__ import annotations

import copy
import os
import types

import torch

from benchmark import harness

TINY_CONFIG = {"nf": 16}
# the window ends after `max_requests` (all `sample_from` of them), not
# after its seconds, so a slow host still serves every sampled request
TINY_CLIPS = {"lq_hw": [16, 24], "pool": 2, "max_requests": 6,
              "trace_skip": 1, "trace_requests": 3}


TINY_TREE = {"hw": [64, 96], "clips": 4, "frames": 25}
TINY_DATA = {"batch_size": 2, "GT_size": 64, "LQ_size": 16}


def bench() -> dict:
    """BENCHMARK.json with the held-back cells' entries (held_back.json)
    added, so that the CPU tests rehearse those cells too."""
    out = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    held = harness.read_json(os.path.join(harness.BENCH, "held_back.json"))
    for key in ("workloads", "end_to_end", "per_layer"):
        out[key] = out[key] + held[key]
    return out


def cell(name: str):
    """The cell `name` (of BENCHMARK.json or held back) with the width, the
    sizes and the RAFT iterations cut for the CPU."""
    c = copy.deepcopy(harness.load_cell(name, bench()))
    c.config["network_G"].update(TINY_CONFIG, iters=2)
    c.config["eval_iters"] = 2
    if c.traffic["kind"] == "clips":
        c.traffic.update(TINY_CLIPS)
        c.limits.update(sample_from=6, sample=2)
    else:
        c.traffic["tree"].update(TINY_TREE)
        c.traffic["datasets"]["train"].update(TINY_DATA)
        c.traffic.update(trace_skip=0, trace_steps=1)
    return c


def cpu_host():
    """The harness's Host on the CPU."""
    from benchmark.run import Host

    return Host(torch, torch.device("cpu"))


def args(seed=3_000_000_017, seconds=0.5, trace=0, control=None):
    return types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace,
                                 control=control)
