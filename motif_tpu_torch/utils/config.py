"""The yml configuration, the counterpart of motif_tpu/utils/config.py for
the reference option.py schema: the same keys, missing keys read as None
(`NoneDict`), the same per-dataset phase and scale and the same
experiment-directory layout.

The yml is read with `yaml.safe_load`; PyYAML is imported on first use.

`trainer_config_from_opt` reads the `train` section as the JAX package
does, its quirk included: `teacher_forcing_steps: 0` (or absent) means
150000, the reference's hard-coded decay, because the JAX package reads
the value with `or`.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Any


class NoneDict(dict):
    """Missing keys read as None (option.py:85-99)."""

    def __missing__(self, key):
        return None


def _to_nonedict(obj: Any) -> Any:
    if isinstance(obj, dict):
        return NoneDict({k: _to_nonedict(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_to_nonedict(v) for v in obj]
    return obj


def merge(opt: dict, overrides: dict) -> None:
    """Nested update: a dict value updates the section it names."""
    for k, v in overrides.items():
        if isinstance(v, dict) and isinstance(opt.get(k), dict):
            merge(opt[k], v)
        else:
            opt[k] = v


def parse(opt_path: str, is_train: bool = True,
          overrides: dict | None = None) -> NoneDict:
    """option.parse equivalent (option.py:9-68): load yml, infer per-dataset
    phase/scale, set experiment directory layout. `overrides` are merged
    into the yml first (`merge`), so that the layout follows them."""
    import yaml

    with open(opt_path) as f:
        opt = yaml.safe_load(f)
    if overrides:
        merge(opt, overrides)

    opt["is_train"] = is_train
    scale = opt.get("scale", 4)

    for phase, dataset in (opt.get("datasets") or {}).items():
        phase = phase.split("_")[0]
        dataset["phase"] = phase
        dataset["scale"] = scale
        if dataset.get("dataroot_GT"):
            dataset["dataroot_GT"] = osp.expanduser(dataset["dataroot_GT"])
        if dataset.get("dataroot_LQ"):
            dataset["dataroot_LQ"] = osp.expanduser(dataset["dataroot_LQ"])

    opt.setdefault("path", {})
    opt["path"]["root"] = opt["path"].get("root") or os.getcwd()
    if is_train:
        exp_root = osp.join(opt["path"]["root"], "experiments", str(opt.get("name")))
        opt["path"].setdefault("experiments_root", exp_root)
        opt["path"].setdefault("models", osp.join(exp_root, "models"))
        opt["path"].setdefault("training_state", osp.join(exp_root, "training_state"))
        opt["path"].setdefault("log", exp_root)
        opt["path"].setdefault("val_images", osp.join(exp_root, "val_images"))
        if "debug" in str(opt.get("name")):
            opt["train"]["val_freq"] = 8
            opt["logger"]["print_freq"] = 1
            opt["logger"]["save_checkpoint_freq"] = 8
    else:
        results_root = osp.join(opt["path"]["root"], "results", str(opt.get("name")))
        opt["path"].setdefault("results_root", results_root)
        opt["path"].setdefault("log", results_root)

    return _to_nonedict(opt)


def check_resume(opt: NoneDict, resume_iter: int) -> None:
    """option.check_resume (option.py:102-117): point pretrain_model_G at
    the checkpoint for the resumed iteration."""
    if opt["path"].get("resume_state"):
        opt["path"]["pretrain_model_G"] = osp.join(
            opt["path"]["models"], f"{resume_iter}_G.pth")


def trainer_config_from_opt(opt: NoneDict):
    """A TrainerConfig from the reference `train` section; a missing (or
    zero) value takes the JAX package's default."""
    from motif_tpu_torch.trainer import TrainerConfig

    t = opt.get("train") or {}
    return TrainerConfig(
        lr=float(t.get("lr_G") or 4e-4),
        beta1=float(t.get("beta1") or 0.9),
        beta2=float(t.get("beta2") or 0.99),
        weight_decay=float(t.get("weight_decay_G") or 0.0),
        pixel_criterion=t.get("pixel_criterion") or "cb",
        pixel_weight=float(t.get("pixel_weight") or 1.0),
        lr_scheme=t.get("lr_scheme") or "CosineAnnealingLR_Restart",
        t_period=tuple(t.get("T_period") or (150000,) * 4),
        restarts=tuple(t.get("restarts") or (150000, 300000, 450000)),
        restart_weights=tuple(t.get("restart_weights") or (1, 1, 1)),
        eta_min=float(t.get("eta_min") or 1e-7),
        lr_steps=tuple(t.get("lr_steps") or ()),
        lr_gamma=float(t.get("lr_gamma") or 0.5),
        warmup_iter=int(t.get("warmup_iter") or -1),
        # the reference hard-codes the 150k teacher-forcing decay
        # (VideoSR_base_model.py:127-158); a short run sets its own, and
        # 0 reads as 150000 (the JAX package's `or`)
        teacher_forcing_steps=int(t.get("teacher_forcing_steps") or 150000),
    )
