"""A full-width MoTIF served from a motif_tpu orbax train state by the
port: `checkpoint.load_checkpoint` on the step directory and on its
models root gives the model that the bridge (`load_flax_params`) gives
from the same params, bit for bit, and a request served from it on the
CPU (LQ 16x16 -> HR 64x64, 3 times) matches motif_tpu's `load_params` of
the same directory and its Evaluator.

The state: the full-width Ours params (setting 5, channel 64, 5 + 40
blocks) drawn by the port's init from seed 3, bridged by
`motif_tpu.checkpoint.port_torch_state_dict` in float64 and saved under
x64 with seeded Adam moments by `motif_tpu.checkpoint.save_train_state`.
Both packages serve in float64 (the JAX Evaluator's float32 padding
swapped for float64, as tests/test_torch_eval.py does), RAFT iters 2;
motif_tpu's `load_params` merges the file over a tree of zeros, so every
weight it serves came from the file. Tolerance on the frames and the
flow statistics: the eval parity tolerance of tests/test_torch_eval.py,
1e-6.
"""

import types

import jax
import numpy as np
import pytest
import torch

from _orbax_parity import full_width_params, optax_state
from motif_tpu import checkpoint as jckpt
from motif_tpu import eval as jeval
from motif_tpu.models.motif import MoTIF as JMoTIF
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch.eval import Evaluator
from motif_tpu_torch.models.motif import build_motif

ITERS = 2
FRAME_ATOL = 1e-6
STEP = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    params = full_width_params(np.float64, seed=3)
    root = tmp_path_factory.mktemp("models")
    with jax.enable_x64(True):
        jckpt.save_train_state(str(root), STEP, optax_state(params, 0.0,
                                                            step=STEP))
    return root, params


def _model(seed):
    return build_motif(device="cpu", seed=seed).double()


@pytest.mark.parametrize("which", ["root", "step_dir"])
def test_load_checkpoint_equals_the_bridge(saved, which):
    root, params = saved
    want = _model(0)
    tckpt.load_flax_params(want, params)
    got = _model(1)
    path = root if which == "root" else root / f"step_{STEP}"
    assert tckpt.load_checkpoint(got, str(path)) == str(root / f"step_{STEP}")
    want_sd = want.state_dict()
    assert list(got.state_dict()) == list(want_sd)
    for k, v in got.state_dict().items():
        assert v.dtype == torch.float64 and torch.equal(v, want_sd[k]), k


def test_a_request_served_from_it_matches_motif_tpu(saved):
    root, params = saved
    model = _model(1)
    tckpt.load_checkpoint(model, str(root))
    rng = np.random.default_rng(5)
    lq = rng.random((1, 4, 16, 16, 3))
    times = np.asarray([[0.25, 0.5, 0.75]])
    got, got_stats = Evaluator(model, iters=ITERS, device="cpu").infer(
        lq, times, (64, 64))
    assert got.shape == (3, 1, 64, 64, 3)

    np64 = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                    if not k.startswith("__")})
    np64.float32 = np.float64
    zeros = jax.tree.map(np.zeros_like, params)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jeval, "np", np64)
        loaded = jckpt.load_params(str(root), zeros)
        want, want_stats = jeval.Evaluator(JMoTIF(), loaded,
                                           iters=ITERS).infer(lq, times,
                                                              (64, 64))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=FRAME_ATOL)
    np.testing.assert_allclose(got_stats, np.asarray(want_stats), rtol=0,
                               atol=FRAME_ATOL)
