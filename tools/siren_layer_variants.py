#!/usr/bin/env python3
"""Time variants of the float32 SIREN's streamed-weight layer kernel
(motif_tpu_torch/csrc/siren_layer.cu) on one NVIDIA GPU.

    python3 tools/siren_layer_variants.py VARIANTS SHAPES

VARIANTS is a JSON object {name: [[old, new], ...]}: each variant is the
source with those textual substitutions (such as another `Gemm<...>`
configuration; [] is the source as it is), compiled with the package's nvcc
flags into build/siren_layer_variants/ and loaded with ctypes. SHAPES is a
JSON list of [K, N, tokens, sine]. For each shape: `addmm` + `sin` (cuBLAS)
once, then every variant twice in turns, each held bit-equal to the plain
version (F.linear + sin) and timed in device ms by CUDA-graph replay
(chip_smoke.device_ms); one JSON line a shape, with the bound.

Example (the choice of the N <= 64 configuration):

    python3 tools/siren_layer_variants.py \\
      '{"base": [], "minb2": [["Gemm<256, 64, 16, 4, 16, 1>;",
                               "Gemm<256, 64, 16, 4, 16, 2>;"]]}' \\
      '[[1049, 64, 393216, true], [256, 3, 114688, false]]'
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from motif_tpu_torch.models.siren import hidden_bound  # noqa: E402
from motif_tpu_torch.ops import kernels  # noqa: E402
from motif_tpu_torch.ops import siren_kernel as sk  # noqa: E402

OUT = os.path.join(ROOT, "build", "siren_layer_variants")


def build(variants: dict) -> dict:
    """Every variant compiled at once; {name: its library}."""
    src = open(kernels.CSRC / "siren_layer.cu").read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise ValueError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
               "-o", os.path.join(OUT, f"lib{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(json.dumps({"variant": name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]}), flush=True)
        lib = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
        fn = lib.siren_layer_forward
        fn.argtypes = sk._SIGNATURES_LAYER["siren_layer_forward"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("siren_layer_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    libs = build(json.loads(sys.argv[1]))
    for K, N, n, sine in json.loads(sys.argv[2]):
        g = torch.Generator(device=dev).manual_seed(6)
        w = ((torch.rand((N, K), device=dev, generator=g) * 2 - 1)
             * hidden_bound(K, 30.0))
        b = torch.rand((N,), device=dev, generator=g) * 0.2 - 0.1
        x = torch.rand((n, K), device=dev, generator=g) * 2 - 1
        packed = sk.pack([w], [b])
        want = sk.siren_mlp_plain(x, [w], [b], 30.0, sine)
        out = torch.empty_like(want)

        def library():
            y = torch.addmm(b, x, w.t())
            return torch.sin(30.0 * y) if sine else y
        row = {"K": K, "N": N, "tokens": n, "sine": sine,
               "library_ms": cs.device_ms(library, reps=10),
               "bound_ms": cs.siren_bound(n, [K, N], sine, False)[0]}
        for _ in range(2):
            for name, fn in libs.items():
                def run(fn=fn):
                    err = fn(x.data_ptr(), K, packed.data_ptr(),
                             out.data_ptr(), N, n, K, N, 30.0, int(sine), 0,
                             kernels.stream_handle(dev))
                    kernels.check(err, name)
                out.zero_()
                run()
                torch.cuda.synchronize()
                row.setdefault(name, []).append(
                    cs.device_ms(run, reps=10) if torch.equal(out, want)
                    else f"not bit-equal: {cs.max_err(out, want)}")
        print(json.dumps(row), flush=True)
        del x, w, b, want, out, packed
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
