"""A data-parallel step of the linear-motion Ours_7 over two gloo processes
on the CPU against motif_tpu's single-device step over the global batch:
its unused STINF takes a zero gradient, which the ranks sum like any other
(torch's DistributedDataParallel would refuse it). How and tolerances:
tests/_parallel_parity.py."""

from _parallel_parity import check, data_parallel_step, single_steps


def test_two_gloo_ranks_sum_to_the_global_batch_gradient_ours7(tmp_path):
    ranks = data_parallel_step("ours7", tmp_path)
    check(ranks, single_steps("ours7"))
    unused = [k for k in ranks[0]["grads"] if k.startswith("flow_imnet.")]
    assert unused and all(
        float(ranks[0]["grads"][k].abs().max()) == 0 for k in unused)
