"""Resuming from a motif_tpu orbax train state (Adam): motif_tpu's Trainer
takes two optax steps of MoTIF(setting=5, channel=16, front_rbs=1,
back_rbs=2) in float64 and saves; the port's `restore_train_state` and
motif_tpu's each take one more step from that directory
(tests/_orbax_parity.py::resume_steps). The loss and its parts (1e-9
relative), the lr and the draw, every gradient (1e-10 of its tensor's
largest |g|) and the moments after the step agree, as in
tests/test_torch_trainer.py; the update from motif_tpu's own gradients
lands on motif_tpu's parameters.
"""

import pytest
import torch

from _orbax_parity import check_resumed_step, check_resumed_update, \
    resume_steps

WEIGHT_DECAY = 0.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("models")
    return resume_steps(WEIGHT_DECAY, str(ckpt)), str(ckpt)


def test_resumed_step_matches_motif_tpu(resumed):
    check_resumed_step(resumed[0])


def test_resumed_update_matches_motif_tpu(resumed):
    check_resumed_update(resumed[0], resumed[1], WEIGHT_DECAY)
