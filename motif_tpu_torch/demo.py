"""Streaming video inference of the port, the counterpart of the
repository's demo.py: over a folder of frames, each pair of consecutive
frames gives `time_scale` frames (times i / time_scale) at `space_scale`
times the size, saved as numbered PNGs (and muxed into a video with
`--fps`):

    python -m motif_tpu_torch.demo --frames_dir in/ --out_dir out/
        [--space_scale 4] [--time_scale 8] [--model Ours|TMNet]
        [--checkpoint P] [--downsample F] [--fps N] [--device cpu]

The frames are cropped to a multiple of 4 (after `--downsample`, a MATLAB
bicubic resize); a pair (f0, f1) goes in as the four LQ frames [f0, f0,
f1, f1]. The model is the yml-less `define_g({"which_model_G": model})`,
with random weights from seed 0 unless `--checkpoint` names a reference
`.pth`, a `step_<n>` train state (the port's, or `motif_tpu`'s orbax
directory) or a models root (`checkpoint.load_checkpoint`). Every pair goes through one
`Evaluator.infer` bucket: on CUDA one graph, captured at the first pair
and replayed for each pair after (the JAX package jits one forward for
the stream's one shape). The model runs on CUDA unless `--device` names
another device; `--fps 0` (the default) never calls ffmpeg.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--model", default="Ours")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--space_scale", type=int, default=4)
    p.add_argument("--time_scale", type=int, default=8)
    p.add_argument("--downsample", type=float, default=1.0,
                   help="pre-downsample the inputs (the reference uses 1/8 "
                        "against running out of memory, demo.py:80-81)")
    p.add_argument("--fps", type=int, default=0,
                   help="mux a video at this fps (needs ffmpeg)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: CUDA)")
    args = p.parse_args(argv)

    import numpy as np

    from motif_tpu_torch.checkpoint import load_checkpoint
    from motif_tpu_torch.eval import Evaluator
    from motif_tpu_torch.models.factory import define_g
    from motif_tpu_torch.ops.resize import imresize_matlab_np
    from motif_tpu_torch.utils.video import (create_video, read_seq_imgs,
                                             save_img)

    frames = read_seq_imgs(args.frames_dir)
    if args.downsample != 1.0:
        frames = np.stack([imresize_matlab_np(f * 255, args.downsample) / 255
                           for f in frames], 0).astype(np.float32)
    T, H, W, _ = frames.shape
    H4, W4 = H // 4 * 4, W // 4 * 4
    frames = frames[:, :H4, :W4]
    print(f"{T} frames at {H4}x{W4}, x{args.space_scale} space, "
          f"x{args.time_scale} time", flush=True)

    model = define_g({"which_model_G": args.model}, device=args.device)
    if args.checkpoint:
        print(f"loaded checkpoint {load_checkpoint(model, args.checkpoint)}",
              flush=True)
    HH, WW = H4 * args.space_scale, W4 * args.space_scale
    times = np.asarray([[i / args.time_scale
                         for i in range(args.time_scale)]], np.float32)
    # all times in one chunk: one forward a pair, as the JAX demo calls it
    ev = Evaluator(model, scale=args.space_scale, iters=4,
                   chunk=args.time_scale, family=args.model,
                   device=args.device)

    os.makedirs(args.out_dir, exist_ok=True)
    n_out, pair_s = 0, []
    for i in range(T - 1):
        pair = frames[i:i + 2]
        x = np.stack([pair[0], pair[0], pair[1], pair[1]], 0)[None]
        t0 = time.perf_counter()
        out, _ = ev.infer(x, times, (HH, WW))   # (time_scale, 1, HH, WW, 3)
        pair_s.append(time.perf_counter() - t0)
        for k in range(out.shape[0]):
            save_img(out[k, 0], os.path.join(args.out_dir, f"{n_out:06d}.png"))
            n_out += 1
        print(f"pair {i + 1}/{T - 1} → {n_out} frames", flush=True)

    if args.fps:
        create_video("", args.out_dir,
                     os.path.join(args.out_dir, "output.mp4"), args.fps)
    return {"pairs": T - 1, "frames": n_out, "out_hw": (HH, WW),
            "captures": ev.captures, "pair_seconds": pair_s}


if __name__ == "__main__":
    main()
