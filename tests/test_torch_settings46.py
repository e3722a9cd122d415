"""Settings 4 and 6 and the linear-motion Ours_7 against motif_tpu in
float64: the forward of each case of tests/_settings_parity.py (one JAX
compile each; settings 2 and 3 and the fused decode are in
tests/test_torch_settings.py, with the trees' bridge)."""

import pytest
import torch

from _settings_parity import check_forward


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", ["s4", "s6", "ours7"])
def test_forward_matches_motif_tpu(case):
    check_forward(case)
