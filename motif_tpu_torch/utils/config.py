"""The yml configuration, the counterpart of motif_tpu/utils/config.py for
the reference option.py schema: the same keys, missing keys read as None
(`NoneDict`), the same per-dataset phase and scale and the same
experiment-directory layout.

The yml is read with `yaml.safe_load`; PyYAML is imported on first use.

The trainer's settings (`trainer_config_from_opt` in the JAX package) are
not ported: training is not. The JAX package reads an explicit
`teacher_forcing_steps: 0` as 150000; the port decides that when it takes
the trainer.
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


def parse(opt_path: str, is_train: bool = True) -> NoneDict:
    """option.parse equivalent (option.py:9-68): load yml, infer per-dataset
    phase/scale, set experiment directory layout."""
    import yaml

    with open(opt_path) as f:
        opt = yaml.safe_load(f)

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
