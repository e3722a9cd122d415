"""Training CLI of the port, the counterpart of the repository's train.py
(yml-driven, the reference train.py):

    python -m motif_tpu_torch.train -opt configs/train_smoke.yml
        [--max_steps N] [--device cpu]

It builds the yml's `network_G` (`define_g`: the `Ours` family or the
four-anchor Ours_44 / Ours_4, at setting 5), the `datasets.train` set
(`vimeo`; for a four-anchor model with its precomputed flows unless the
yml says `load_flows: false`, as the JAX package's train.py does) in
shuffled batches of `batch_size` (`dataset_ratio` passes over it an
epoch), and a `Trainer`
from the `train` section; it resumes from the latest `step_<n>` under
`path.models`, trains to `train.niter` steps (or `--max_steps`), appends a
JSON line to `<experiments_root>/train_log.jsonl` every
`logger.print_freq` steps and saves the train state every
`logger.save_checkpoint_freq` steps and at the end. The model runs on CUDA
unless `--device` names another device. `main` returns the last step's
aux. The arbitrary-scale modes (`*_a`, ROADMAP.md §A.7), the other MoTIF
variants (§A.8) and the baselines (§A.9) raise.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np


def main(argv: list[str] | None = None, overrides: dict | None = None):
    """The CLI; `overrides` (nested, by yml section) are merged into the
    yml before it is read."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-opt", type=str, required=True,
                        help="path to the yml")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="train to this step instead of train.niter")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: CUDA)")
    args, _ = parser.parse_known_args(argv)

    import torch

    from motif_tpu_torch import checkpoint
    from motif_tpu_torch.data import (BatchLoader, create_dataset,
                                      device_prefetch)
    from motif_tpu_torch.models.factory import define_g, unported
    from motif_tpu_torch.trainer import Trainer
    from motif_tpu_torch.utils import config as cfg

    opt = cfg.parse(args.opt, is_train=True, overrides=overrides)
    os.makedirs(opt["path"]["experiments_root"] or "experiments",
                exist_ok=True)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s: %(message)s")
    logger = logging.getLogger("base")

    seed = (opt.get("train") or {}).get("manual_seed") or 0
    np.random.seed(seed)

    net_opt = opt["network_G"]
    which = net_opt.get("which_model_G") or "Ours"
    reason = unported(which)
    if reason or not which.startswith("Ours"):
        raise NotImplementedError(
            f"train: no training of {reason or f'[{which}]'} in the port "
            "(baselines: ROADMAP.md §A.9)")
    dataset_opt = dict(opt["datasets"]["train"])
    mode = dataset_opt.get("mode") or ""
    if mode.endswith("_a"):
        raise NotImplementedError(
            f"train: the arbitrary-scale mode [{mode}] and its batch collate "
            "are not ported (ROADMAP.md §A.7)")
    model = define_g(net_opt, device=args.device)
    device = next(model.parameters()).device
    if model.n_anchors == 4 and mode == "vimeo":
        # Ours_44 trains on the precomputed flow npys (Vimeo7_dataset.py:
        # 143,152): RAFT does not run in a step
        dataset_opt.setdefault("load_flows", True)
    dataset = create_dataset(dataset_opt)
    batch_size = int(dataset_opt.get("batch_size") or 1)
    loader = BatchLoader(dataset, batch_size=batch_size, shuffle=True,
                         seed=seed,
                         epoch_ratio=int(opt.get("dataset_ratio") or 200))
    if len(loader) == 0:
        raise ValueError(
            f"train: {len(dataset)} clips x dataset_ratio make no batch of "
            f"{batch_size}; raise dataset_ratio")
    gt_size = int(dataset_opt.get("GT_size") or 128)
    # Ours_ZSM trains without the flow distillation term
    trainer = Trainer(model, cfg.trainer_config_from_opt(opt),
                      (gt_size, gt_size), iters=int(net_opt.get("iters") or 12),
                      flow_loss=which != "Ours_ZSM", seed=seed, family=which)
    logger.info("model built on %s: %d params", device,
                sum(p.numel() for p in model.parameters()))

    ckpt_dir = opt["path"]["models"] or "experiments/models"
    start = checkpoint.latest_step(ckpt_dir)
    epoch = 0
    if start:
        checkpoint.restore_train_state(ckpt_dir, start, trainer)
        epoch = int(checkpoint.restore_meta(ckpt_dir, start).get("epoch", 0))
        logger.info("resumed from step %d (epoch %d)", start, epoch)

    niter = args.max_steps or int(opt["train"]["niter"])
    log = opt.get("logger") or {}
    save_freq = int(log.get("save_checkpoint_freq") or 5000)
    print_freq = int(log.get("print_freq") or 100)
    log_path = os.path.join(opt["path"]["experiments_root"] or ".",
                            "train_log.jsonl")

    step = trainer.step_count
    aux = None
    t0 = time.time()
    with open(log_path, "a") as log_f:
        while step < niter:
            for batch in device_prefetch(loader.epoch(epoch), device):
                if step >= niter:
                    break
                aux = trainer.step(batch)
                step += 1
                if step % print_freq == 0:
                    s_it = (time.time() - t0) / max(1, print_freq)
                    logger.info("step %d/%d loss %.4f l_pix %.4f lr %.2e "
                                "use_gt %s (%.2f s/it)", step, niter,
                                float(aux["loss"]), float(aux["l_pix"]),
                                aux["lr"], aux["use_gt"], s_it)
                    log_f.write(json.dumps({
                        "step": step, "loss": float(aux["loss"]),
                        "l_pix": float(aux["l_pix"]),
                        "flow_l": float(aux.get("flow_l", 0.0)),
                        "lr": aux["lr"], "use_gt": aux["use_gt"],
                        "s_per_it": s_it, "epoch": epoch,
                        "time": time.time()}) + "\n")
                    log_f.flush()
                    t0 = time.time()
                if step % save_freq == 0:
                    checkpoint.save_train_state(ckpt_dir, step, trainer,
                                                meta={"epoch": epoch})
                    logger.info("saved checkpoint at step %d", step)
            epoch += 1
    if checkpoint.latest_step(ckpt_dir) != step:
        checkpoint.save_train_state(ckpt_dir, step, trainer,
                                    meta={"epoch": epoch})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    logger.info("training done at step %d", step)
    return aux


if __name__ == "__main__":
    main()
