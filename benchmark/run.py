"""The benchmark of motif_tpu_torch, one run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. It sets up (the program's kernels from its
build directory in the checkout, the cell's model with weights from the
seed on the card, the cell's shapes warmed), measures for `--seconds`,
checks what the window produced against the plain reference, and prints
one JSON line last: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer metrics),
`device`, with `--trace 1` `breakdown`, and `checks`, each compared number
beside its limit (also the last lines of standard error).

It exits with another code than 0, and prints no result, without a CUDA
card (or fewer cards than the cell asks for), without the program in the
checkout, or when JAX or the JAX package is loaded once the window has
closed. `--control tf32` reads the control of `correct` instead of a run:
the reference with TF32 on in the program's place; `--control half`
(training cells) a planted fault: half of each batch left out (PERF.md).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != os.path.dirname(
                            os.path.abspath(__file__))]

from benchmark import harness  # noqa: E402


class Host:
    """What a traffic kind asks of the harness: the device, the harness's
    spans (record_function ranges, read back from a trace), the set-up's
    end, the device record, and freeing the program."""

    def __init__(self, torch, device, count: int = 1):
        self.torch, self.device, self.count = torch, device, count
        self.cuda = device.type == "cuda"
        self.spans = torch.profiler.record_function
        self.setup_s = None
        self.memory = None

    def log(self, msg: str):
        print(f"[{time.perf_counter() - T0:.2f} s] {msg}", file=sys.stderr,
              flush=True)

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def mark_setup(self):
        self.sync()
        self.setup_s = time.perf_counter() - T0

    def record(self) -> dict:
        return {"setup_s": self.setup_s}

    def read_memory(self):
        self.sync()
        self.memory = (harness.device_record(self.torch, self.count)
                       if self.cuda else {"platform": "cpu"})

    def free(self):
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32", "half"), default=None)
    return p.parse_args(argv)


def per_layer(cell, rec) -> dict:
    """Each per-layer metric of the cell from its own reader; a reader
    that finds nothing returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        v = harness.load_module("metrics", m["name"]).read(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def report(cell, kind, rec, args) -> tuple:
    """(metrics, device, breakdown) of a finished run."""
    from benchmark import trace

    dev = dict(rec["memory"])
    if args.control:
        return {}, dev, None
    if not args.trace:
        metrics = {m["name"]: {"value": float(rec["e2e"][m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": float(rec["setup_s"]), "unit": "s"}
        return metrics, dev, None
    tr = rec["trace"]
    dev["busy_s"] = trace.busy_us(tr) / 1e6
    dev["window_s"] = trace.window_us(tr) / 1e6
    breakdown = {"device_ops": trace.device_ops(tr),
                 "idle_gaps": trace.idle_gaps(tr, kind.SPANS)}
    return per_layer(cell, rec), dev, breakdown


def main(argv=None) -> int:
    faulthandler.enable()
    args = parse(argv)
    harness.prepare_environment()
    cell = harness.load_cell(args.workload)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell {cell.name} needs {chips} CUDA card(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    harness.import_program()
    torch.set_num_threads(4)
    tf32 = bool(cell.config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kind = harness.load_module("traffic", cell.traffic["kind"])
    host = Host(torch, device, chips)
    host.log("set-up: torch and the program imported")
    if args.control:
        rec = kind.control(cell, args, host)
    else:
        rec = kind.run(cell, args, host)
    rec["memory"] = host.memory
    metrics, dev, breakdown = report(cell, kind, rec, args)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: {bad} loaded in the process that reports",
              file=sys.stderr)
        return 3
    checks = rec["checks"]
    correct = all(c["ok"] for c in checks)
    print(harness.checks_text(checks), file=sys.stderr, flush=True)
    print(harness.result_line(correct, rec["attempted"], rec["failed"],
                              metrics, dev, checks, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
