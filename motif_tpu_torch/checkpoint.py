"""The weight bridge: a `motif_tpu` flax params tree → this package's
`state_dict` — the inverse of motif_tpu/checkpoint.py::port_torch_state_dict.

The flax tree mirrors the reference torch module tree with Sequential /
ModuleList indices merged into the preceding name ("net.0.linear" →
"net_0" / "linear"). That merge cannot be undone from the tree alone
("L1_dcnpack_1" is an attribute, "flow_process_1" an index), so the bridge
walks the port's own keys and maps each to its flax path:

  * conv kernels HWIO → OIHW (PWC-Net's transposed convs → (in, out, kh,
    kw)), linear kernels IO → OI;
  * EDVR's ModuleDict level keys merge like indices ("offset_conv1.l3" →
    "offset_conv1_l3");
  * the scanned `feature_extraction` / `recon_trunk` / `reconstruction`
    stacks (one `block` subtree with a leading block axis) are unstacked
    into `.0 ... .k-1`;
  * `pcd_h` / `pcd_c` stay separate subtrees, as in the reference;
  * `g_filter`, the reference's fixed blur (not a parameter of either
    package), is not produced.

`load_reference_checkpoint` loads a reference-format `.pth` into a port
model, strictly; `load_checkpoint` takes that, a train state of this
package or a directory of them, as the eval CLI's `--checkpoint` does.

The train state (`save_train_state`, `restore_train_state`, `restore_meta`,
`latest_step`) is the counterpart of motif_tpu/checkpoint.py:236-276 in
torch's own format: {model, optimizer, step} by `torch.save` in a file
`<dir>/step_<n>`, with the same `.meta.json` sidecar and the same
latest-step rule. The JAX package's orbax directories are not read
(ROADMAP.md §A.9). In a data-parallel run (`train.main` under torchrun)
rank 0 alone saves, and every rank restores the step rank 0 found newest.
"""

from __future__ import annotations

import json
import os
import re
from typing import Iterable, Mapping

import numpy as np
import torch

SCANNED_BLOCK_FAMILIES = ("feature_extraction", "recon_trunk",
                          "reconstruction")


def torch_key_to_flax_path(key: str) -> tuple:
    """'a.b.0.linear.weight' → ('a', 'b_0', 'linear', 'kernel'); EDVR's
    'offset_conv1.l3.weight' → ('offset_conv1_l3', 'kernel')."""
    out: list = []
    for p in key.split("."):
        if out and (p.isdigit() or p in ("l1", "l2", "l3")):
            out[-1] = f"{out[-1]}_{p}"
        else:
            out.append(p)
    if out[-1] == "weight":
        out[-1] = "kernel"
    return tuple(out)


def _lookup(params: Mapping, path: tuple) -> np.ndarray:
    node = params
    for i, p in enumerate(path):
        if p not in node:
            m = re.fullmatch(r"(.+)_(\d+)", p)
            if m and m.group(1) in SCANNED_BLOCK_FAMILIES \
                    and m.group(1) in node:
                # stacked scan layout: <fam>/block/... with a leading axis
                leaf = _lookup(node[m.group(1)]["block"], path[i + 1:])
                return np.asarray(leaf)[int(m.group(2))]
            raise KeyError("/".join(path))
        node = node[p]
    return np.asarray(node)


# the reference's transposed convs (PWC-Net's up-samplers), whose torch
# weights are (in, out, kh, kw)
TRANSPOSED_CONV_NAMES = ("moduleUpflow", "moduleUpfeat")


def _to_torch_layout(path: tuple, a: np.ndarray) -> np.ndarray:
    if path[-1] == "kernel":
        if a.ndim == 4 and any(n in path for n in TRANSPOSED_CONV_NAMES):
            return np.transpose(a, (2, 3, 0, 1))   # HWIO → (in, out, kh, kw)
        if a.ndim == 4:      # conv HWIO → OIHW
            return np.transpose(a, (3, 2, 0, 1))
        if a.ndim == 2:      # linear IO → OI
            return np.transpose(a, (1, 0))
    return a


def state_dict_from_flax(params: Mapping, keys: Iterable[str]) -> dict:
    """The port's state_dict for `keys` (the port module's own
    `state_dict().keys()`) from a flax params tree of numpy arrays. Raises
    KeyError naming the first key the tree lacks."""
    out = {}
    for key in keys:
        path = torch_key_to_flax_path(key)
        arr = _to_torch_layout(path, _lookup(params, path))
        out[key] = torch.tensor(arr)
    return out


def load_flax_params(model: torch.nn.Module, params: Mapping) -> None:
    """Load a flax params tree into `model` with strict=True."""
    sd = state_dict_from_flax(params, model.state_dict().keys())
    model.load_state_dict(sd, strict=True)


# keys of a reference state dict that are not parameters of the port: the
# fixed blur, batch-norm counters, and RAFT's norm3, which the reference
# registers twice (the same tensors arrive as downsample.1)
REFERENCE_ONLY_KEYS = ("g_filter", "num_batches_tracked", ".norm3.")


def reference_state_dict(path: str) -> dict:
    """The state dict of a reference-format `.pth` / `.pt`, as the port's
    modules name their parameters.

    The file is read on the CPU; a `state_dict` or `params` wrapper is
    unwrapped, DataParallel's `module.` prefix stripped and every key
    holding one of `REFERENCE_ONLY_KEYS` dropped. An orbax directory, the
    JAX package's own format, raises NotImplementedError (ROADMAP.md
    §A.9)."""
    if not path.endswith((".pth", ".pt")):
        kind = "an orbax checkpoint directory" if os.path.isdir(path) \
            else "not a .pth / .pt file"
        raise NotImplementedError(
            f"{path}: {kind}; the port loads reference .pth state dicts only "
            "(ROADMAP.md §A.9)")
    sd = torch.load(path, map_location="cpu")
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if "params" in sd and not hasattr(sd["params"], "shape"):
        sd = sd["params"]
    out = {}
    for key, value in sd.items():
        key = key.removeprefix("module.")
        if not any(s in key for s in REFERENCE_ONLY_KEYS):
            out[key] = value
    return out


def load_reference_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load a reference-format `.pth` / `.pt` (`reference_state_dict`) into
    `model` with strict=True: a missing or unexpected key raises and names
    itself. (The JAX package merges a checkpoint over its init and keeps
    what the file lacks.)"""
    model.load_state_dict(reference_state_dict(path), strict=True)


def load_checkpoint(model: torch.nn.Module, path: str) -> str:
    """Load into `model`, strictly, whichever of these `path` is, and
    return the file it read:

      * a reference-format `.pth` / `.pt` (`load_reference_checkpoint`);
      * a models root (`experiments/<name>/models`): its newest `step_<n>`
        (`latest_step`), as the JAX package's test.py resolves a checkpoint
        root (motif_tpu/checkpoint.py:196-203);
      * a `step_<n>` file of `save_train_state`: its `model` entry.

    A missing or unexpected key, or a shape that differs, raises naming
    the keys at fault; so does a file that is not such a train state, or a
    models root without one. An orbax directory of the JAX package raises
    NotImplementedError (ROADMAP.md §A.9)."""
    if path.endswith((".pth", ".pt")):
        load_reference_checkpoint(model, path)
        return path
    if os.path.isdir(path) and not re.fullmatch(r"step_\d+",
                                                os.path.basename(path)):
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"{path}: no step_<n> train state in "
                                    "this directory")
        path = _step_path(path, step)
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: an orbax train-state directory of the JAX package; the "
            "port loads its own torch train states only (ROADMAP.md §A.9)")
    state = torch.load(path, map_location="cpu")
    if not isinstance(state, dict) or "model" not in state:
        raise ValueError(f"{path}: not a train state of this package (no "
                         "'model' entry) nor a reference .pth / .pt")
    try:
        model.load_state_dict(state["model"], strict=True)
    except RuntimeError as e:
        raise RuntimeError(f"{path}: {e}") from e
    return path


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.abspath(os.path.join(ckpt_dir, f"step_{step}"))


def save_train_state(ckpt_dir: str, step: int, trainer,
                     meta: dict | None = None) -> None:
    """`trainer.state_dict()` ({model, optimizer, step}) to
    `<ckpt_dir>/step_<step>`, written whole or not at all, and `meta` (the
    epoch and so on, as the reference's .state file keeps it beside the
    iteration) to `step_<step>.meta.json`."""
    path = _step_path(ckpt_dir, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(trainer.state_dict(), tmp)
    os.replace(tmp, path)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)


def restore_train_state(ckpt_dir: str, step: int, trainer):
    """Load `<ckpt_dir>/step_<step>` into `trainer` (its model, optimizer and
    step count) and return it. An orbax directory, the JAX package's
    format, raises NotImplementedError (ROADMAP.md §A.9)."""
    path = _step_path(ckpt_dir, step)
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: an orbax train-state directory of the JAX package; the "
            "port restores its own torch train states only (ROADMAP.md §A.9)")
    trainer.load_state_dict(torch.load(path, map_location="cpu"))
    return trainer


def restore_meta(ckpt_dir: str, step: int) -> dict:
    path = _step_path(ckpt_dir, step) + ".meta.json"
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def latest_step(ckpt_dir: str) -> int | None:
    """The largest n of the `step_<n>` entries in `ckpt_dir`, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None
