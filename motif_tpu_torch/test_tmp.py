"""The (spatial scale x temporal rate) sweep of the port, the counterpart
of the repository's test_tmp.py: the eval CLI (`motif_tpu_torch.test`)
once per (s, t), the yml's scale and its dataset's `time` set to each
entry between runs (reference test_tmp.py:305-314):

    python -m motif_tpu_torch.test_tmp [-opt configs/test_vimeo44.yml]
        [--s_scales 1 2 4] [--t_scales 6] [--checkpoint P]
        [--max_clips N] [--device cpu]

A scale of 1 keeps the yml's. Returns {(s, t): the eval summary}. The
model runs on CUDA unless `--device` names another device.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-opt", type=str, default="configs/test_vimeo44.yml")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--max_clips", type=int, default=None)
    p.add_argument("--s_scales", type=float, nargs="*", default=[1.0],
                   help="spatial scales to sweep (reference test_tmp.py:305)")
    p.add_argument("--t_scales", type=int, nargs="*", default=[6],
                   help="temporal rates to sweep (reference test_tmp.py:306)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: CUDA)")
    args = p.parse_args(argv)

    from motif_tpu_torch import test as test_cli

    results = {}
    for s in args.s_scales:
        for t in args.t_scales:
            print(f"=== s_scale {s} t_scale {t} ===", flush=True)
            argv_t = ["-opt", args.opt]
            if args.checkpoint:
                argv_t += ["--checkpoint", args.checkpoint]
            if args.max_clips:
                argv_t += ["--max_clips", str(args.max_clips)]
            if args.device:
                argv_t += ["--device", args.device]
            overrides = {"time": t}
            if s != 1.0:
                overrides["scale"] = int(s) if float(s).is_integer() else s
            results[(s, t)] = test_cli.main(argv_t, overrides=overrides)
    for (s, t), r in results.items():
        print(f"s{s} t{t}: psnr {r['psnr']:.3f} ssim {r['ssim']:.4f}")
    return results


if __name__ == "__main__":
    main()
