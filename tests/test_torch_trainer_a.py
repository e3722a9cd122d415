"""One optimiser step of the port's Trainer against motif_tpu's on an
arbitrary-scale batch (out_hw=None), in float64: MoTIF at setting 6 (warp_to_many: the directions side by side into the
synthesis net, each with its extras).
How: tests/_trainer_parity.py (the collate's batch with d_scale pinned to
4, LQ 16² -> GT 64², 2 times, use_gt False; the loss and its parts 1e-9
relative, each gradient 1e-10 of its tensor's largest).
"""

import pytest

from _trainer_parity import check_gradients, check_step, one_step


@pytest.fixture(scope="module")
def steps():
    return one_step("s6")


def test_step_matches_motif_tpu(steps):
    check_step(steps)


def test_gradients_match_motif_tpu(steps):
    check_gradients(steps)
