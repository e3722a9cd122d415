"""Data-parallel training of the port (motif_tpu_torch/parallel/dist.py):
the dataset shard and the epoch permutation bit-equal to
motif_tpu/parallel/mesh.py's, and one MoTIF step over two gloo processes
on the CPU against motif_tpu's single-device step over the global batch
(tests/_parallel_parity.py; Ours_7: tests/test_torch_parallel7.py)."""

import numpy as np
import pytest
import torch

from _parallel_parity import check, data_parallel_step, single_steps
from motif_tpu.parallel import mesh
from motif_tpu_torch.parallel import dist


@pytest.mark.parametrize("n,pi,pc", [(10, 0, 1), (10, 1, 2), (11, 2, 3),
                                     (7, 3, 4), (3, 2, 4)])
def test_host_shard_indices_match_mesh(n, pi, pc):
    got = dist.host_shard_indices(n, pi, pc)
    want = mesh.host_shard_indices(n, pi, pc)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_host_shard_indices_default_to_a_lone_process():
    assert not torch.distributed.is_initialized()
    assert (dist.rank(), dist.world_size()) == (0, 1)
    assert np.array_equal(dist.host_shard_indices(5), np.arange(5))


@pytest.mark.parametrize("n,epoch,ratio", [(10, 0, 1), (7, 3, 200),
                                           (1, 5, 4)])
def test_epoch_permutation_matches_mesh(n, epoch, ratio):
    got = dist.epoch_permutation(n, epoch, ratio)
    want = mesh.epoch_permutation(n, epoch, ratio)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_lone_process_collectives_are_the_identity():
    t = torch.ones(3)
    assert dist.all_reduce_sum(t) is t
    assert dist.broadcast_object({"a": 1}) == {"a": 1}


def test_two_gloo_ranks_sum_to_the_global_batch_gradient(tmp_path):
    check(data_parallel_step("ours", tmp_path), single_steps("ours"))
