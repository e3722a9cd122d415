"""The weight bridge: a `motif_tpu` flax params tree → this package's
`state_dict` — the inverse of motif_tpu/checkpoint.py::port_torch_state_dict.

The flax tree mirrors the reference torch module tree with Sequential /
ModuleList indices merged into the preceding name ("net.0.linear" →
"net_0" / "linear"). That merge cannot be undone from the tree alone
("L1_dcnpack_1" is an attribute, "flow_process_1" an index), so the bridge
walks the port's own keys and maps each to its flax path:

  * conv kernels HWIO → OIHW, linear kernels IO → OI;
  * the scanned `feature_extraction` / `recon_trunk` stacks (one `block`
    subtree with a leading block axis) are unstacked into `.0 ... .k-1`;
  * `pcd_h` / `pcd_c` stay separate subtrees, as in the reference;
  * `g_filter`, the reference's fixed blur (not a parameter of either
    package), is not produced.

`load_reference_checkpoint` loads a reference-format `.pth` into a port
model, strictly.
"""

from __future__ import annotations

import os
import re
from typing import Iterable, Mapping

import numpy as np
import torch

SCANNED_BLOCK_FAMILIES = ("feature_extraction", "recon_trunk")


def torch_key_to_flax_path(key: str) -> tuple:
    """'a.b.0.linear.weight' → ('a', 'b_0', 'linear', 'kernel')."""
    out: list = []
    for p in key.split("."):
        if out and p.isdigit():
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


def _to_torch_layout(path: tuple, a: np.ndarray) -> np.ndarray:
    if path[-1] == "kernel":
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


def load_reference_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load a reference-format `.pth` / `.pt` state dict into `model`.

    The file is read on the CPU; a `state_dict` or `params` wrapper is
    unwrapped, DataParallel's `module.` prefix stripped and every key
    holding one of `REFERENCE_ONLY_KEYS` dropped, then the rest loads with
    strict=True: a missing or unexpected key raises and names itself. (The
    JAX package merges a checkpoint over its init and keeps what the file
    lacks.) An orbax directory, the JAX package's own format, raises
    NotImplementedError (ROADMAP.md §A.5)."""
    if not path.endswith((".pth", ".pt")):
        kind = "an orbax checkpoint directory" if os.path.isdir(path) \
            else "not a .pth / .pt file"
        raise NotImplementedError(
            f"{path}: {kind}; the port loads reference .pth state dicts only "
            "(ROADMAP.md §A.5)")
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
    model.load_state_dict(out, strict=True)
