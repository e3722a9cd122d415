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
package or of the JAX package, or a directory of them, as the eval CLI's
`--checkpoint` does.

The train state (`save_train_state`, `restore_train_state`, `restore_meta`,
`latest_step`) is the counterpart of motif_tpu/checkpoint.py:236-276 in
torch's own format: {model, optimizer, step} by `torch.save` in a file
`<dir>/step_<n>`, with the same `.meta.json` sidecar and the same
latest-step rule. The JAX package's orbax step directories are read too,
without JAX: `read_orbax_tree` rebuilds the tree orbax's raw restore gives
from `_METADATA` and the OCDBT / zarr store under it (`ocdbt.py`), and
`load_optax_train_state` maps its params, Adam's or AdamW's moments and
counts onto a Trainer. The port writes its own format only. In a
data-parallel run (`train.main` under torchrun) rank 0 alone saves, and
every rank restores the step rank 0 found newest.
"""

from __future__ import annotations

import json
import os
import re
from typing import Iterable, Mapping

import numpy as np
import torch

from motif_tpu_torch import ocdbt

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


def _lookup(params: Mapping, path: tuple, used: set | None = None,
            at: tuple = ()):
    """The leaf of `params` at the port key's flax `path`, a numpy array
    (or a torch tensor where the tree holds one: bfloat16 leaves of an
    orbax state); `used` collects the tree paths read."""
    node = params
    for i, p in enumerate(path):
        if p not in node:
            m = re.fullmatch(r"(.+)_(\d+)", p)
            if m and m.group(1) in SCANNED_BLOCK_FAMILIES \
                    and m.group(1) in node:
                # stacked scan layout: <fam>/block/... with a leading axis
                leaf = _lookup(node[m.group(1)]["block"], path[i + 1:], used,
                               at + path[:i] + (m.group(1), "block"))
                return leaf[int(m.group(2))]
            raise KeyError("/".join(path))
        node = node[p]
    if used is not None:
        used.add(at + path)
    return node if isinstance(node, torch.Tensor) else np.asarray(node)


# the reference's transposed convs (PWC-Net's up-samplers), whose torch
# weights are (in, out, kh, kw)
TRANSPOSED_CONV_NAMES = ("moduleUpflow", "moduleUpfeat")


def _permute(a, axes):
    return a.permute(axes) if isinstance(a, torch.Tensor) else \
        np.transpose(a, axes)


def _to_torch_layout(path: tuple, a):
    if path[-1] == "kernel":
        if a.ndim == 4 and any(n in path for n in TRANSPOSED_CONV_NAMES):
            return _permute(a, (2, 3, 0, 1))   # HWIO → (in, out, kh, kw)
        if a.ndim == 4:      # conv HWIO → OIHW
            return _permute(a, (3, 2, 0, 1))
        if a.ndim == 2:      # linear IO → OI
            return _permute(a, (1, 0))
    return a


def _tensor(a) -> torch.Tensor:
    """A contiguous tensor that owns a copy of `a`."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().clone()
    return torch.tensor(a)


def state_dict_from_flax(params: Mapping, keys: Iterable[str]) -> dict:
    """The port's state_dict for `keys` (the port module's own
    `state_dict().keys()`) from a flax params tree of numpy arrays. Raises
    KeyError naming the first key the tree lacks."""
    out = {}
    for key in keys:
        path = torch_key_to_flax_path(key)
        out[key] = _tensor(_to_torch_layout(path, _lookup(params, path)))
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
    holding one of `REFERENCE_ONLY_KEYS` dropped. Anything else raises
    NotImplementedError: an orbax directory of the JAX package holds a flax
    tree, which maps onto a model's keys only (`load_checkpoint`)."""
    if not path.endswith((".pth", ".pt")):
        kind = "an orbax checkpoint directory, which load_checkpoint reads " \
            "into a model" if os.path.isdir(path) else "not a .pth / .pt file"
        raise NotImplementedError(
            f"{path}: {kind}; reference_state_dict reads reference .pth "
            "state dicts only")
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
    return the file or directory it read:

      * a reference-format `.pth` / `.pt` (`load_reference_checkpoint`);
      * a models root (`experiments/<name>/models`): its newest `step_<n>`
        (`latest_step`), as the JAX package's test.py resolves a checkpoint
        root (motif_tpu/checkpoint.py:196-203);
      * a `step_<n>` file of `save_train_state`: its `model` entry;
      * an orbax directory of the JAX package (a `step_<n>` train state or
        a bare params tree): its `params` subtree, or the tree itself, as
        motif_tpu/checkpoint.py:207-210 takes either (`load_orbax_params`).

    A missing or unexpected key, or a shape that differs, raises naming
    the keys at fault (where the JAX package warns and keeps the random
    init of a mismatched subtree); so does a file that is not such a train
    state, a directory without orbax's `_METADATA`, or a models root
    without a step."""
    if path.endswith((".pth", ".pt")):
        load_reference_checkpoint(model, path)
        return path
    if os.path.isdir(path) and not os.path.exists(
            os.path.join(path, "_METADATA")) and not re.fullmatch(
                r"step_\d+", os.path.basename(os.path.normpath(path))):
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"{path}: no step_<n> train state in "
                                    "this directory")
        path = _step_path(path, step)
    if os.path.isdir(path):
        load_orbax_params(model, path)
        return path
    state = torch.load(path, map_location="cpu")
    if not isinstance(state, dict) or "model" not in state:
        raise ValueError(f"{path}: not a train state of this package (no "
                         "'model' entry) nor a reference .pth / .pt")
    _load_strict(model, state["model"], path)
    return path


def _load_strict(model: torch.nn.Module, sd: dict, where: str) -> None:
    try:
        model.load_state_dict(sd, strict=True)
    except RuntimeError as e:
        raise RuntimeError(f"{where}: {e}") from e


# ---------------------------------------------------------------------------
# the JAX package's orbax train states, read without JAX
# ---------------------------------------------------------------------------

# orbax's empty values by their `_METADATA` value_type, as its raw restore
# gives them (a NamedTuple such as optax's EmptyState comes back as None)
ORBAX_EMPTY = {"None": lambda: None, "NamedTuple": lambda: None,
               "Dict": dict, "List": list, "Tuple": tuple}
ORBAX_ARRAYS = ("jax.Array", "np.ndarray", "scalar")


def _orbax_step_dir(path: str) -> str:
    """`path` if it holds orbax's `_METADATA`, else its newest `step_<n>`
    (`latest_step`), as motif_tpu/checkpoint.py:196-203 resolves a root.
    Raises FileNotFoundError naming the `_METADATA` it did not find."""
    if not os.path.exists(os.path.join(path, "_METADATA")):
        step = latest_step(path)
        if step is not None:
            path = _step_path(path, step)
    meta = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta):
        raise FileNotFoundError(f"{meta}: not found; {path} is not an orbax "
                                "checkpoint directory nor a models root whose "
                                "newest step is one")
    return os.path.abspath(path)


def read_orbax_tree(path: str):
    """The tree that orbax's raw restore (`ocp.StandardCheckpointer()
    .restore(path)`) gives for the orbax checkpoint at `path` (a step
    directory, or a models root read at its newest step), without JAX:
    the same nesting and keys (a dict for dict keys, a list for sequence
    keys: optax's state tuple), numpy arrays for its arrays (a
    torch.bfloat16 tensor for a bfloat16 one), Python numbers for its
    scalars, and None / {} / [] / () for its empty values. The OCDBT
    store and its zarr v2 arrays are read by `ocdbt.py`."""
    path = _orbax_step_dir(path)
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise NotImplementedError(
            f"{path}: use_ocdbt {meta.get('use_ocdbt')}, use_zarr3 "
            f"{meta.get('use_zarr3')}; this reader reads OCDBT stores of zarr "
            "v2 arrays, orbax's default, which the JAX package writes")
    store = ocdbt.OcdbtStore(path)
    root: dict = {}
    kinds = {id(root): 2}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        node = root
        for depth, k in enumerate(keys):
            seen = kinds.setdefault(id(node), k["key_type"])
            if seen != k["key_type"] or seen not in (1, 2):
                raise ValueError(f"{path}: key {keys[:depth + 1]}: key type "
                                 f"{k['key_type']} where a dict (2) or a "
                                 "sequence (1) was read")
            if depth + 1 < len(keys):
                node = node.setdefault(str(k["key"]), {})
        kind = entry["value_metadata"].get("value_type")
        name = ".".join(str(k["key"]) for k in keys)
        if kind in ORBAX_EMPTY:
            value = ORBAX_EMPTY[kind]()
        elif kind in ORBAX_ARRAYS:
            value = ocdbt.read_array(store, name)
            if kind == "scalar":
                value = value.item()
        else:
            raise NotImplementedError(f"{path}: leaf {name} holds a "
                                      f"{kind!r}; this reader reads arrays, "
                                      "scalars and empty values")
        node[str(keys[-1]["key"])] = value
    return _as_sequences(root, kinds, path)


def _as_sequences(node, kinds: dict, path: str):
    if not isinstance(node, dict) or id(node) not in kinds:
        return node
    out = {k: _as_sequences(v, kinds, path) for k, v in node.items()}
    if kinds[id(node)] != 1:
        return out
    if sorted(out) != [str(i) for i in range(len(out))]:
        raise ValueError(f"{path}: sequence indices {sorted(out)} are not "
                         f"0..{len(out) - 1}")
    return [out[str(i)] for i in range(len(out))]


def _map_leaves(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def _unstack_pcd_pairs(tree):
    """motif_tpu/checkpoint.py::_unstack_pcd_pairs on numpy leaves: a
    'pcd_hc' subtree with a leading [h, c] axis (an interim layout of the
    JAX package's DeformableConvLSTM) becomes the 'pcd_h' / 'pcd_c' pair,
    so old trees load as the JAX package loads them."""
    if not isinstance(tree, Mapping):
        return tree
    tree = dict(tree)
    if "pcd_hc" in tree and "pcd_h" not in tree:
        hc = tree.pop("pcd_hc")
        tree["pcd_h"] = _map_leaves(lambda a: a[0], hc)
        tree["pcd_c"] = _map_leaves(lambda a: a[1], hc)
    return {k: _unstack_pcd_pairs(v) for k, v in tree.items()}


def _leaf_paths(tree, at: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaf_paths(v, at + (k,))
        else:
            yield at + (k,)


def state_dict_from_tree(tree: Mapping, keys: Iterable[str],
                         where: str) -> dict:
    """`state_dict_from_flax` of a flax tree read from a file, held both
    ways: a key the tree lacks and a leaf no key reads both raise KeyError,
    naming them (at most 10 of each) and `where`."""
    tree = _unstack_pcd_pairs(tree)
    out, missing, used = {}, [], set()
    for key in keys:
        path = torch_key_to_flax_path(key)
        try:
            leaf = _lookup(tree, path, used)
        except KeyError:
            missing.append(key)
            continue
        out[key] = _tensor(_to_torch_layout(path, leaf))
    extra = sorted("/".join(p) for p in set(_leaf_paths(tree)) - used)
    if missing or extra:
        raise KeyError(f"{where}: the tree does not match the model: "
                       f"{len(missing)} keys missing {missing[:10]}, "
                       f"{len(extra)} leaves unexpected {extra[:10]}")
    return out


def load_orbax_params(model: torch.nn.Module, path: str) -> None:
    """Load the orbax checkpoint at `path` (`read_orbax_tree`) into
    `model`: its `params` subtree, or the bare params tree, strictly."""
    tree = read_orbax_tree(path)
    if isinstance(tree, Mapping) and "params" in tree:
        tree = tree["params"]
    sd = state_dict_from_tree(tree, model.state_dict().keys(), path)
    _load_strict(model, sd, path)


def load_optax_train_state(trainer, tree: Mapping,
                           where: str = "the train state") -> None:
    """Map a `motif_tpu.trainer.TrainState` read from orbax
    (`read_orbax_tree`) onto `trainer`: its params into the model, its
    optax state into the optimiser, its step into `step_count`.

    optax.adam keeps (ScaleByAdamState(count, mu, nu), the schedule's
    state); optax.adamw, with a weight decay, puts the decay's empty state
    between them (motif_tpu/trainer.py:72-78). Each parameter's mu and nu
    (through the same bridge as its weight) become torch's exp_avg and
    exp_avg_sq: the same moments, since torch's Adam and AdamW divide by
    the same bias corrections of the same count, which becomes each
    parameter's `step`. The optimiser's own `load_state_dict` puts them on
    the parameter's device and dtype and the step where its kind keeps it
    (on the device for fused or capturable Adam). A tree of the other
    optimiser (three entries against two) raises."""
    if not isinstance(tree, Mapping) or not {"params", "opt_state",
                                             "step"} <= set(tree):
        raise KeyError(f"{where}: not a train state: its top keys are "
                       f"{sorted(tree) if isinstance(tree, Mapping) else tree}"
                       ", not params, opt_state and step")
    opt = tree["opt_state"]
    names = {2: "Adam", 3: "AdamW"}
    want = 3 if trainer.cfg.weight_decay else 2
    if len(opt) != want:
        raise ValueError(
            f"{where}: opt_state holds {len(opt)} entries "
            f"({names.get(len(opt), 'neither Adam nor AdamW')}); the "
            f"trainer's optimiser is {names[want]} ({want} entries: "
            "scale_by_adam, [add_decayed_weights,] the schedule)")
    adam = opt[0]
    if not isinstance(adam, Mapping) or not {"count", "mu", "nu"} <= set(
            adam):
        raise KeyError(f"{where}: opt_state[0] is not scale_by_adam's "
                       "state (count, mu, nu)")
    model = trainer.model
    sd = state_dict_from_tree(tree["params"], model.state_dict().keys(),
                              f"{where} params")
    named = list(model.named_parameters())
    names_of = {id(p): n for n, p in named}
    keys = [n for n, _ in named]
    mu = state_dict_from_tree(adam["mu"], keys, f"{where} opt_state/0/mu")
    nu = state_dict_from_tree(adam["nu"], keys, f"{where} opt_state/0/nu")
    _load_strict(model, sd, where)
    count = torch.tensor(float(int(adam["count"])), dtype=torch.float32)
    osd = trainer.optimizer.state_dict()
    state, i = {}, 0
    for group in trainer.optimizer.param_groups:
        for p in group["params"]:
            n = names_of[id(p)]
            state[i] = {"step": count.clone(), "exp_avg": mu[n],
                        "exp_avg_sq": nu[n]}
            i += 1
    osd["state"] = state
    trainer.optimizer.load_state_dict(osd)
    trainer.step_count = int(tree["step"])


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
    step count) and return it: a file of `save_train_state`, or an orbax
    directory of the JAX package (`read_orbax_tree`,
    `load_optax_train_state`)."""
    path = _step_path(ckpt_dir, step)
    if os.path.isdir(path):
        load_optax_train_state(trainer, read_orbax_tree(path), path)
        return trainer
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
