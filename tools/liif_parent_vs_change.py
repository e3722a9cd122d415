#!/usr/bin/env python3
"""A LIIF (VideoINR) request and VideoINR's float32 SIRENs, timed on one
NVIDIA GPU for the checkout first on sys.path, so that two checkouts can be
compared in turns in one call:

    for t in parent change change parent; do
      PYTHONPATH=<that checkout> python3 -P tools/liif_parent_vs_change.py $t
    done

Prints one JSON line: the request of chip_smoke's phase 9 (2 LQ frames
64x112 -> 256x448, 3 times, full width, random weights from seed 0)
through Evaluator.infer, its captured median of 20 (host ms) and one
replay of its graph (device ms, chip_smoke.graph_ms); then each SIREN at a
request's and at a LIIF step's tokens (chip_smoke.VIDEOINR_SIRENS,
LIIF_SIRENS) in device ms by graph replay. TF32 off.
"""

import json
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from motif_tpu_torch.ops import kernels
from motif_tpu_torch.ops import siren_kernel as sk


def main() -> int:
    if not torch.cuda.is_available():
        print("liif_parent_vs_change: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels.build()
    model, ev, _, _ = cs.build_baseline_request(dev, "LIIF")
    h, w = cs.BASE_LQ
    hw = (4 * h, 4 * w)
    lq = np.random.default_rng(0).random((1, 2, h, w, 3), dtype=np.float32)
    t3 = np.linspace(0, 1, 3, dtype=np.float32)[None]
    for _ in range(2):                  # capture, then a first replay
        ev.infer(lq, t3, hw)
    ms = []
    for _ in range(20):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ev.infer(lq, t3, hw)
        ms.append((time.perf_counter() - t) * 1e3)
    g_ms, chunks = cs.graph_ms(ev, lq, t3, hw, reps=10)
    out = {"tag": sys.argv[1], "card": cs.card_line(),
           "liif_request_captured_ms_median": float(np.median(ms)),
           "liif_request_graph_ms": g_ms, "chunks": chunks}
    del model, ev
    torch.cuda.empty_cache()
    mlps = {**{f"request_{k}": v for k, v in cs.VIDEOINR_SIRENS.items()},
            **{f"train_{k}": v for k, v in cs.LIIF_SIRENS.items()}}
    for name, (cin, hidden, cout, n_tok) in mlps.items():
        x, ws, bs = cs.siren_case(dev, [cin] + hidden + [cout], n_tok,
                                  torch.float32, False)
        out[name] = cs.device_ms(lambda: sk.siren_mlp(x, ws, bs), reps=10)
        del x, ws, bs
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
