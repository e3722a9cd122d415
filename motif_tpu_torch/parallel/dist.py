"""Process groups and the gradient sum of data-parallel training — the
port's own copy of what it needs from motif_tpu/parallel/mesh.py, on
torch.distributed.

The JAX package shards a global batch over its device mesh and lets XLA
sum the gradients (its losses are sums over the batch, motif_tpu/losses.py,
so the gradient of the global batch is the sum of the shards'). Here each
process holds one card (or the CPU) and a shard of the dataset
(`host_shard_indices`), computes the gradient of its part of the global
batch, and `all_reduce_grads` sums them: every process then holds the
gradient of the global batch and steps its optimiser alike. torch's
DistributedDataParallel averages instead (1 / world of the right value)
and refuses parameters autograd did not reach (Ours_7's unused STINF, the
teacher's RAFT), so the port sums the gradients itself, after the
Trainer's zero-fill of those parameters.

A run is launched by torchrun, which sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT (`init_from_env`); without them the process is
alone (rank 0 of 1) and nothing here communicates.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def rank() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of processes, 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def init_from_env(device_type: str = "cuda") -> tuple[int, int, int]:
    """Join the process group torchrun's environment describes, NCCL on
    CUDA and gloo on the CPU, when WORLD_SIZE > 1 and no group exists yet.
    Returns (rank, world size, local rank); (0, 1, 0) for a lone
    process."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if world > 1 and not dist.is_initialized():
        if device_type == "cuda":
            torch.cuda.set_device(local)
        dist.init_process_group(
            backend="nccl" if device_type == "cuda" else "gloo",
            init_method="env://", rank=int(os.environ["RANK"]),
            world_size=world)
    return rank(), world_size(), local


def host_shard_indices(n_items: int, process_index: int | None = None,
                       process_count: int | None = None) -> np.ndarray:
    """The dataset indices of one process: every process_count-th from
    process_index (motif_tpu/parallel/mesh.py:32-38, the reference's
    DistIterSampler rank striding). Defaults: this process's rank and the
    world size."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    return np.arange(pi, n_items, pc)


def epoch_permutation(n_items: int, epoch: int, ratio: int = 1) -> np.ndarray:
    """An epoch-seeded permutation over a ratio-enlarged dataset
    (motif_tpu/parallel/mesh.py:41-46)."""
    g = np.random.default_rng(epoch)
    total = n_items * ratio
    return g.permutation(total) % n_items


def all_reduce_grads(params) -> None:
    """Sum every parameter's `.grad` over the processes of the group, in
    place, in one collective over a flat buffer per dtype (a group of one
    runs it too). Every parameter must have a gradient (the Trainer
    zero-fills those autograd missed). Without a group: nothing."""
    if not dist.is_initialized():
        return
    by_dtype: dict = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the processes of the group (a new tensor); t itself
    without a group."""
    if not dist.is_initialized():
        return t
    t = t.detach().clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def broadcast_params(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of `module` made rank `src`'s (nothing
    without a group)."""
    if not dist.is_initialized():
        return
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src)


def broadcast_object(obj, src: int = 0):
    """Rank `src`'s `obj` (picklable) on every process (`obj` itself
    without a group)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]
