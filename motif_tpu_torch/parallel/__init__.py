"""Data-parallel training over torch.distributed, the counterpart of
motif_tpu/parallel: the JAX package shards the batch over a device mesh and
the file list over hosts; the port runs one process per card, each on its
shard of the dataset, and sums the gradients over the processes."""

from motif_tpu_torch.parallel.dist import (  # noqa: F401
    all_reduce_grads,
    all_reduce_sum,
    broadcast_object,
    broadcast_params,
    epoch_permutation,
    host_shard_indices,
    init_from_env,
    rank,
    world_size,
)
