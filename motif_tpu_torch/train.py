"""Training CLI of the port, the counterpart of the repository's train.py
(yml-driven, the reference train.py):

    python -m motif_tpu_torch.train -opt configs/train_smoke.yml
        [--max_steps N] [--device cpu]
    torchrun --nproc_per_node=N -m motif_tpu_torch.train -opt ...

It builds the yml's `network_G` (`define_g`: the `Ours` family at any
setting, the four-anchor Ours_44 / Ours_4, the linear-motion Ours_7, or
the `LIIF` baseline, VideoINR, for the 4 LQ frames every training mode
gives),
the `datasets.train` set (`vimeo`, for a four-anchor model with its
precomputed flows unless the yml says `load_flows: false`, as the JAX
package's train.py does; `Adobe`, `Adobe_4`, `Adobe_flow`; the
arbitrary-scale `Adobe_a` and `vimeo_a`) in shuffled batches of
`batch_size` (`dataset_ratio` passes over it an epoch), and a `Trainer`
from the `train` section. An arbitrary-scale mode's batches come from
`collate_adobe_arbitrary` with `LQ_size` (default 64, 32 for `vimeo_a`)
and a `random.Random(manual_seed)`: each batch has its own output size (a
multiple of 8 from LQ_size to 2·LQ_size, LQ_size / 2 at the input), read
from its GT. RAFT needs 64 px a side at the output, so `LQ_size: 32`
(every `_a` yml of configs/grid/) fails at the first step in both
packages; `LQ_size: 64` runs. The CLI resumes from the latest `step_<n>`
under `path.models` (the port's own train state, or `motif_tpu`'s orbax
step directory: `checkpoint.restore_train_state`), trains to
`train.niter` steps (or `--max_steps`),
appends a JSON line to `<experiments_root>/train_log.jsonl` every
`logger.print_freq` steps and saves the train state every
`logger.save_checkpoint_freq` steps and at the end. The model runs on CUDA
unless `--device` names another device. `main` returns the last step's
aux. The baselines other than LIIF and `Ours_flow` (a flow precomputer,
not a trained model) raise, as the JAX package's train.py refuses them.

Under torchrun (WORLD_SIZE > 1) each process joins the group (NCCL on
CUDA, on the card of its LOCAL_RANK; gloo on the CPU), reads its shard of
the dataset (`parallel.host_shard_indices`) in batches of batch_size /
world, which must divide, its loader and collate seeded at seed + rank as
in the JAX package's multi-host runs, and the gradients are summed over
the processes (`Trainer`): a step is one of the global batch. Every process
resumes from rank 0's newest step; rank 0 alone writes the train states
and the log.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import logging
import os
import random
import time

import numpy as np


def setup(opt: dict, device=None, rng: random.Random | None = None,
          dataset_seed: int | None = None):
    """The parts of a training run of a parsed yml (`utils.config.parse`):
    (model, loader, trainer). The model is `define_g`'s on `device` (CUDA
    unless another device is named); the loader shuffles from the yml's
    `manual_seed`; an arbitrary-scale mode's collate draws from `rng`
    (default `random.Random(manual_seed)`). `dataset_seed` seeds the
    dataset's own draws (None: fresh entropy, as the JAX package's CLI
    leaves them). In a process group of several processes: this rank's
    shard of the dataset in batches of batch_size / world, the loader's
    and the default collate's seeds plus the rank, and the model's
    weights made rank 0's."""
    import dataclasses

    from motif_tpu_torch.data import (BatchLoader, Subset,
                                      collate_adobe_arbitrary, collate_stack,
                                      create_dataset)
    from motif_tpu_torch.models.factory import define_g
    from motif_tpu_torch.parallel import dist
    from motif_tpu_torch.trainer import Trainer
    from motif_tpu_torch.utils import config as cfg

    seed = (opt.get("train") or {}).get("manual_seed") or 0
    net_opt = opt["network_G"]
    which = net_opt.get("which_model_G") or "Ours"
    # the JAX package's train.py:47-52: LIIF, or the Ours family
    if which != "LIIF" and (not which.startswith("Ours")
                            or which == "Ours_flow"):
        raise NotImplementedError(
            f"train: no training recipe for [{which}] (the grid trains "
            "Ours* and LIIF; Ours_flow is a flow precomputer)")
    dataset_opt = dict(opt["datasets"]["train"])
    mode = dataset_opt.get("mode") or ""
    arbitrary = mode.endswith("_a")     # Adobe_a / vimeo_a: batch collate
    rank, world = dist.rank(), dist.world_size()
    # every training mode gives 4 LQ frames (a window's 0, 2, 4, 6)
    model = define_g(net_opt, device=device, n_frames=4)
    dist.broadcast_params(model)
    if getattr(model, "n_anchors", 2) == 4 and mode == "vimeo":
        # Ours_44 trains on the precomputed flow npys (Vimeo7_dataset.py:
        # 143,152): RAFT does not run in a step
        dataset_opt.setdefault("load_flows", True)
    dataset = create_dataset(dataset_opt)
    if dataset_seed is not None:
        dataset = dataclasses.replace(dataset, seed=dataset_seed)
    if world > 1:
        # the JAX package's train.py:66-74: each process its shard of the
        # sample list and its share of the global batch
        dataset = Subset(dataset, dist.host_shard_indices(len(dataset)))
    global_batch = int(dataset_opt.get("batch_size") or 1)
    if global_batch % world:
        raise ValueError(f"train: batch_size {global_batch} does not divide "
                         f"over {world} processes")
    batch_size = global_batch // world
    collate = collate_stack
    if arbitrary:
        # collate_function(_vimeo), data/__init__.py:91-173: a d_scale a
        # batch, the LQ made by MATLAB bicubic, GT sizes in buckets of 16
        lq_size = int(dataset_opt.get("LQ_size") or
                      (32 if mode == "vimeo_a" else 64))
        collate = functools.partial(collate_adobe_arbitrary,
                                    lq_size=lq_size,
                                    rng=rng or random.Random(seed + rank))
    loader = BatchLoader(dataset, batch_size=batch_size, shuffle=True,
                         seed=seed + rank, collate=collate,
                         epoch_ratio=int(opt.get("dataset_ratio") or 200))
    if len(loader) == 0:
        raise ValueError(
            f"train: {len(dataset)} clips x dataset_ratio make no batch of "
            f"{batch_size}; raise dataset_ratio")
    gt_size = int(dataset_opt.get("GT_size") or 128)
    # Ours_ZSM trains without the flow distillation term; an
    # arbitrary-scale batch's output size is its GT's
    trainer = Trainer(model, cfg.trainer_config_from_opt(opt),
                      None if arbitrary else (gt_size, gt_size),
                      iters=int(net_opt.get("iters") or 12),
                      flow_loss=which != "Ours_ZSM", seed=seed, family=which)
    return model, loader, trainer


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
    from motif_tpu_torch.data import device_prefetch
    from motif_tpu_torch.parallel import dist
    from motif_tpu_torch.utils import config as cfg

    opt = cfg.parse(args.opt, is_train=True, overrides=overrides)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s: %(message)s")
    logger = logging.getLogger("base")
    own_group = not torch.distributed.is_initialized()
    rank, world, _ = dist.init_from_env(
        torch.device(args.device).type if args.device else "cuda")
    lead = rank == 0
    if lead:
        os.makedirs(opt["path"]["experiments_root"] or "experiments",
                    exist_ok=True)

    np.random.seed((opt.get("train") or {}).get("manual_seed") or 0)
    model, loader, trainer = setup(opt, args.device)
    device = next(model.parameters()).device
    logger.info("model built on %s: %d params (rank %d of %d)", device,
                sum(p.numel() for p in model.parameters()), rank, world)

    ckpt_dir = opt["path"]["models"] or "experiments/models"
    start = dist.broadcast_object(checkpoint.latest_step(ckpt_dir))
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
    with (open(log_path, "a") if lead else contextlib.nullcontext()) as log_f:
        while step < niter:
            for batch in device_prefetch(loader.epoch(epoch), device):
                if step >= niter:
                    break
                aux = trainer.step(batch)
                step += 1
                if step % print_freq == 0 and lead:
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
                if step % save_freq == 0 and lead:
                    checkpoint.save_train_state(ckpt_dir, step, trainer,
                                                meta={"epoch": epoch})
                    logger.info("saved checkpoint at step %d", step)
            epoch += 1
    if lead and checkpoint.latest_step(ckpt_dir) != step:
        checkpoint.save_train_state(ckpt_dir, step, trainer,
                                    meta={"epoch": epoch})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if world > 1:
        torch.distributed.barrier()      # rank 0's last save is on disk
        if own_group:
            torch.distributed.destroy_process_group()
    logger.info("training done at step %d", step)
    return aux


if __name__ == "__main__":
    main()
