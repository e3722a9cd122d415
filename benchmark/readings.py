"""The readings that the limits of `correct` are set from, for many seeds
in one process (PERF.md gives them): for each seed, a short run of the cell
(`--seconds`, the window's own entry and load) or, with `--control`, the
control in the program's place, then the comparison a run makes. One JSON
line a seed on standard output:

    python3 benchmark/readings.py --workload <cell> --seeds <n>,<n>,...
        --seconds <s> [--control tf32|half] [--sample-from <k>]

`--sample-from` draws a clip cell's checked answers from its first k
requests instead of the cell's own `sample_from`, for a shorter window.

It runs on the card, as run.py does, and reports no metric."""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != os.path.dirname(
                            os.path.abspath(__file__))]

from benchmark import harness, run  # noqa: E402


def main(argv=None) -> int:
    p = run.argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", choices=("tf32", "half"), default=None)
    p.add_argument("--sample-from", type=int, default=None)
    a = p.parse_args(argv)
    harness.prepare_environment()
    cell = harness.load_cell(a.workload)
    if a.sample_from:
        cell.limits["sample_from"] = a.sample_from
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    harness.import_program()
    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kind = harness.load_module("traffic", cell.traffic["kind"])
    for seed in (int(s) for s in a.seeds.split(",")):
        args = run.parse(["--workload", a.workload, "--seed", str(seed),
                          "--seconds", str(a.seconds)]
                         + (["--control", a.control] if a.control else []))
        host = run.Host(torch, device)
        rec = (kind.control if a.control else kind.run)(cell, args, host)
        print(json.dumps({"seed": seed, "control": a.control,
                          "attempted": rec["attempted"],
                          "checks": {c["name"]: c["value"]
                                     for c in rec["checks"]}}), flush=True)
        del rec
        host.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
