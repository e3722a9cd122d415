"""`Ours_flow`, the flow / psies precomputer, against motif_tpu's
FlowPrecompute in float64: RAFT-small (random weights from a seed, bridged
to the flax tree) on the 12 directed pairs of 4 LR frames 16x16 at HR
64x64, iters 2; the 8 kept flows and their psies to 1e-6 (both packages
compute the same float64 formulas; the readings are ~1e-13)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motif_tpu import checkpoint as jckpt
from motif_tpu.models import factory as jfactory
from motif_tpu.models.flow_precompute import FlowPrecompute as JFlowPrecompute
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch.models import factory
from motif_tpu_torch.models.flow_precompute import FlowPrecompute

ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_flows_and_psies_match_motif_tpu():
    torch.manual_seed(4)
    m = FlowPrecompute(scale=4).double().eval()
    with jax.enable_x64(True):
        params = jax.tree.map(np.asarray,
                              jckpt.port_torch_state_dict(m.state_dict()))
    tckpt.load_flax_params(m, params)
    x = np.random.default_rng(0).random((1, 4, 16, 16, 3))
    with jax.enable_x64(True):
        want = jax.jit(lambda p, a: JFlowPrecompute(scale=4).apply(
            {"params": p}, a, iters=2))(params, jnp.asarray(x))
    got = m(torch.from_numpy(x), iters=2)
    assert got[1] == want[1] == 0
    flow, psies = got[0].numpy(), got[2].numpy()
    # 8 rows a clip: anchors 1 and 2 to all four frames (MoTIF(n_anchors=2)
    # takes 4; both packages keep the reference's 8, ROADMAP.md §C)
    assert flow.shape == (8, 16, 16, 2) and psies.shape == (8, 16, 16, 3)
    assert np.abs(flow).max() > 0 and np.isfinite(psies).all()
    np.testing.assert_array_equal(flow[[1, 6]], 0.0)     # 1->1, 2->2
    np.testing.assert_allclose(flow, np.asarray(want[0]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(psies, np.asarray(want[2]), rtol=0, atol=ATOL)


def test_define_g_builds_the_precomputer_as_motif_tpu():
    net = {"which_model_G": "Ours_flow", "scale": 2}
    m, jm = factory.define_g(net, device="cpu"), jfactory.define_g(net)
    assert isinstance(m, FlowPrecompute) and m.scale == jm.scale == 2
    assert all(k.startswith("flow_predictor.") for k in m.state_dict())
    with pytest.raises(ValueError, match="4 frames"):
        m(torch.zeros(1, 2, 16, 16, 3))
