"""Evaluation CLI of the port, the counterpart of the repository's test.py
(yml-driven, the reference test protocol):

    python -m motif_tpu_torch.test -opt test.yml [--checkpoint P]
        [--max_clips N] [--device cpu]

It builds the yml's `network_G` (`define_g`), loads `--checkpoint` (else
the yml's `path.pretrain_model_G`): a reference `.pth`, a `step_<n>` train
state of `python -m motif_tpu_torch.train` or of `motif_tpu` (an orbax
directory), or their models root (`experiments/<name>/models`, read at its
newest step), strictly
(`checkpoint.load_checkpoint`; a path that does not exist leaves the
random init from seed 0, with a warning), evaluates the
`datasets.train` section clip by clip and writes the per-clip PSNRs and
SSIMs to ./psnrs/<name>.npy and ./psnrs/<name>_ssim.npy. It prints and
returns `EvalResults.summary()`. The model runs on CUDA unless `--device`
names another device.

The baselines evaluate the same way (configs/test_vid4_{liif,zsm,tmnet,
edvr,superslomo}.yml: LIIF, ZSM, TMNet, EDVR, Super_SloMo), each called
as `Evaluator` calls its family; they report no flow statistics.

A four-anchor model (Ours_44 / Ours_4, e.g. configs/test_vimeo44.yml) on
`Vimeo_test_44` takes the septuplet window's frames 0, 2, 4, 6 as its LQ
(`datasets.SEPTUPLET_LQ`): the window's inputs are its two end frames,
and the model takes four.
"""

from __future__ import annotations

import argparse
import logging
import os


def main(argv: list[str] | None = None, overrides: dict | None = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-opt", type=str, default="test.yml")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="reference .pth, step_<n> train state or "
                             "models root to load")
    parser.add_argument("--max_clips", type=int, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: CUDA)")
    args, _ = parser.parse_known_args(argv)

    from motif_tpu_torch.checkpoint import load_checkpoint
    from motif_tpu_torch.data import BatchLoader, create_dataset
    from motif_tpu_torch.data.datasets import SEPTUPLET_LQ
    from motif_tpu_torch.eval import Evaluator
    from motif_tpu_torch.models.factory import (EVAL_CHUNK, FOUR_ANCHOR,
                                                define_g)
    from motif_tpu_torch.utils import config as cfg

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    logger = logging.getLogger("base")

    opt = cfg.parse(args.opt, is_train=False)
    if overrides:
        # the test_tmp.py sweep path (reference test_tmp.py:305-314 mutates
        # opt['scale'] / dataset 'time' between runs)
        for k, v in overrides.items():
            if k in ("scale",):
                opt[k] = v
                opt["datasets"]["train"]["scale"] = v
                opt["datasets"]["train"]["d_scale"] = v
            else:
                opt["datasets"]["train"][k] = v
    dataset_opt = opt["datasets"]["train"]  # the reference test.yml uses 'train'
    net_opt = opt["network_G"]
    which = net_opt.get("which_model_G") or "Ours"
    septuplet = which in FOUR_ANCHOR and dataset_opt["mode"] == "Vimeo_test_44"
    dataset = create_dataset(dataset_opt,
                             lq_index=SEPTUPLET_LQ if septuplet else None)
    loader = BatchLoader(dataset, batch_size=1, shuffle=False)
    logger.info("dataset %s: %d clips", dataset_opt["mode"], len(dataset))

    # a LIIF's SIRENs are as wide as its LQ frames make them (2 in the
    # eval ymls, 4 where a yml's ref_num asks for a trained model's 4)
    model = define_g(net_opt, device=args.device,
                     n_frames=len(dataset[0]["lq"]) if which == "LIIF" else 2)

    ckpt = args.checkpoint or opt["path"].get("pretrain_model_G")
    if ckpt:
        if os.path.exists(ckpt):
            logger.info("loaded checkpoint %s", load_checkpoint(model, ckpt))
        else:
            logger.warning("checkpoint %s not found — evaluating random init", ckpt)

    ev = Evaluator(model, scale=int(opt.get("scale") or 4), iters=4,
                   chunk=EVAL_CHUNK.get(which, 3), family=which,
                   device=args.device)

    def limited():
        for i, b in enumerate(loader.epoch(0)):
            if args.max_clips and i >= args.max_clips:
                break
            yield b

    res = ev.run(limited(), save_psnr_dir="./psnrs", logger=logger,
                 name=str(opt.get("name") or "psnrs"))
    s = res.summary()
    logger.info("FINAL: %s", s)
    print(s)
    return s


if __name__ == "__main__":
    main()
