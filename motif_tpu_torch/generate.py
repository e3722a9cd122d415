"""Image dump of the port, the counterpart of the repository's
generate.py: the yml's `network_G` over the first clips of its
`datasets.train` section through `Evaluator.infer`, with each time's
output, ground truth and 5x mean absolute difference saved as PNGs:

    python -m motif_tpu_torch.generate [-opt test.yml] [--max_clips 1]
        [--out_dir test_out] [--device cpu]

As the JAX CLI does, it evaluates the model's random init from seed 0:
`--checkpoint` is accepted and ignored (generate.py:14,37-39, a quirk of
both packages, ROADMAP.md). The model runs on CUDA unless `--device`
names another device.
"""

from __future__ import annotations

import argparse
import os


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-opt", type=str, default="test.yml")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="ignored, as the JAX CLI ignores it")
    p.add_argument("--max_clips", type=int, default=1)
    p.add_argument("--out_dir", type=str, default="test_out")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: CUDA)")
    args = p.parse_args(argv)

    import numpy as np

    from motif_tpu_torch.data import BatchLoader, create_dataset
    from motif_tpu_torch.eval import Evaluator
    from motif_tpu_torch.models.factory import define_g
    from motif_tpu_torch.utils import config as cfg
    from motif_tpu_torch.utils.video import save_img

    opt = cfg.parse(args.opt, is_train=False)
    dataset = create_dataset(opt["datasets"]["train"])
    loader = BatchLoader(dataset, batch_size=1, shuffle=False)
    if args.checkpoint:
        print(f"generate: --checkpoint {args.checkpoint} is ignored, as the "
              "JAX CLI ignores it: the outputs are the random init's",
              flush=True)
    model = define_g(opt["network_G"], device=args.device)
    ev = Evaluator(model, scale=int(opt.get("scale") or 4), iters=4,
                   device=args.device)

    os.makedirs(args.out_dir, exist_ok=True)
    clips = 0
    for it, batch in enumerate(loader.epoch(0)):
        if it >= args.max_clips:
            break
        gt = batch["gt"][:, 1:-1]
        H, W = gt.shape[2], gt.shape[3]
        fake, _ = ev.infer(batch["lq"], batch["times"], (H, W))
        for n in range(fake.shape[0]):
            out = os.path.join(args.out_dir, f"clip{it}_t{n}")
            save_img(fake[n, 0], f"{out}_out.png")
            save_img(gt[0, n], f"{out}_gt.png")
            diff = np.abs(fake[n, 0] - gt[0, n]).mean(-1, keepdims=True
                                                       ).repeat(3, -1)
            save_img(diff * 5.0, f"{out}_diff.png")
        print(f"clip {it}: saved {fake.shape[0]} frames to {args.out_dir}",
              flush=True)
        clips += 1
    return clips


if __name__ == "__main__":
    main()
