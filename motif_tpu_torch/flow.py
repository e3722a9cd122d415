"""Flow inspection of the port, the counterpart of the repository's
flow.py: the yml's `network_G` forward (`use_gt=False`, 4 RAFT iterations)
over the first clips of its `datasets.train` section at scale x the LQ
size, its predicted flow fields un-normalised to HR pixels (x 20 · HH / h)
and saved as Middlebury `.flo` files and colour-wheel PNGs, with the mean
|flow| printed per clip:

    python -m motif_tpu_torch.flow [-opt test.yml] [--checkpoint P]
        [--max_clips 2] [--out_dir flow_out] [--device cpu]

`--checkpoint` (else the yml's `path.pretrain_model_G`) loads as the eval
CLI loads it (`checkpoint.load_checkpoint`); a path that does not exist
leaves the random init from seed 0, with a warning. The model runs on
CUDA unless `--device` names another device.
"""

from __future__ import annotations

import argparse
import os


def main(argv: list[str] | None = None) -> list[float]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-opt", type=str, default="test.yml")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="reference .pth, step_<n> train state or models "
                        "root to load")
    p.add_argument("--max_clips", type=int, default=2)
    p.add_argument("--out_dir", type=str, default="flow_out")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: CUDA)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from motif_tpu_torch import resolve_device
    from motif_tpu_torch.checkpoint import load_checkpoint
    from motif_tpu_torch.data import BatchLoader, create_dataset
    from motif_tpu_torch.models.factory import define_g
    from motif_tpu_torch.utils import config as cfg
    from motif_tpu_torch.utils.flow_io import flow_to_image, write_flow
    from motif_tpu_torch.utils.video import save_img

    dev = resolve_device(args.device)
    opt = cfg.parse(args.opt, is_train=False)
    dataset = create_dataset(opt["datasets"]["train"])
    loader = BatchLoader(dataset, batch_size=1, shuffle=False)
    model = define_g(opt["network_G"], device=dev)
    dtype = next(model.parameters()).dtype

    ckpt = args.checkpoint or opt["path"].get("pretrain_model_G")
    if ckpt and os.path.exists(ckpt):
        print(f"loaded checkpoint {load_checkpoint(model, ckpt)}", flush=True)
    elif ckpt:
        print(f"WARNING: checkpoint {ckpt} not found — flows come from "
              "randomly initialized weights", flush=True)

    os.makedirs(args.out_dir, exist_ok=True)
    scale = int(opt.get("scale") or 4)
    means = []
    for it, batch in enumerate(loader.epoch(0)):
        if it >= args.max_clips:
            break
        lq, times = batch["lq"], batch["times"]
        H, W = lq.shape[2] * scale, lq.shape[3] * scale
        with torch.inference_mode():       # in the parameters' dtype
            _, flow, _ = model(torch.as_tensor(lq, dtype=dtype, device=dev),
                               torch.as_tensor(times, dtype=dtype,
                                               device=dev), (H, W),
                               use_gt=False, iters=4)
        flow = flow.cpu().numpy() * 20.0 * (H / lq.shape[2])  # un-normalise
        for d in range(flow.shape[0]):
            out = os.path.join(args.out_dir, f"clip{it}_flow{d}")
            save_img(flow_to_image(flow[d]).astype(np.float32) / 255.0,
                     f"{out}.png")
            write_flow(f"{out}.flo", flow[d])
        means.append(float(np.abs(flow).mean()))
        print(f"clip {it}: |flow| mean {means[-1]:.3f} px, "
              f"saved {flow.shape[0]} fields", flush=True)
    return means


if __name__ == "__main__":
    main()
