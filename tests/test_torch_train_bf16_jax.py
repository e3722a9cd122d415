"""A MoTIF step under the precision knobs (`compute_dtype="bfloat16"`,
`splat_dtype="float16"`, `fused_decode`) against motif_tpu's step under the
same knobs (its float16-sum splat is the `base` scatter: the `scan`
backend it trains with by default sums in the inputs' type), both measured
against the port's float64 step (tests/test_torch_train_bf16.py): no
parameter's gradient further from the float64 step, in L2 relative to its
norm, than 2 x motif_tpu's plus 1e-2, and the loss likewise (2 x plus
1e-3). Readings at channel 16, 1 / 2 blocks, 16² -> 64², 2 times: the port
up to 0.19 a parameter, motif_tpu further (its one-hot DCN rounds the hat
weights to bfloat16: 0.20 in the encoder as a whole against the port's
0.026). One JAX train-step compile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motif_tpu import checkpoint as jckpt
from motif_tpu import trainer as jtrainer
from motif_tpu.models.motif import MoTIF as JMoTIF
from motif_tpu.parallel import make_mesh, replicate
from motif_tpu_torch import checkpoint as tckpt
from test_torch_train_bf16 import (BACK, CH, FRONT, KNOBS, _batch, _cfg,
                                   _perturbed, port_step, step_gate)
from motif_tpu_torch.models.motif import MoTIF

B1 = 0.9


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def steps():
    torch.manual_seed(5)
    state = _perturbed(MoTIF(CH, FRONT, BACK)).state_dict()
    f64 = port_step(state, torch.float64, fused_decode=True)
    with jax.enable_x64(True):
        params = jax.tree.map(np.asarray, jckpt.port_torch_state_dict(
            {k: v.double() for k, v in state.items()}))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    jm = JMoTIF(setting=5, channel=CH, front_rbs=FRONT, back_rbs=BACK,
                splat_method="base", **KNOBS)
    tr = jtrainer.Trainer(jm, _cfg(jtrainer.TrainerConfig), out_hw=None,
                          iters=1, mesh=make_mesh(1), seed=0)
    st = jax.device_put(jtrainer.TrainState(
        params=params, opt_state=tr.tx.init(params),
        step=jnp.asarray(1, jnp.int32)), replicate(tr.mesh))
    tr._host_step = 1
    new, jaux = tr.step(st, {k: jnp.asarray(v.astype(np.float32))
                             for k, v in _batch().items()})
    assert jaux["use_gt"] is False
    jgrads = jax.tree.map(lambda m: np.asarray(m, np.float64) / (1 - B1),
                          new.opt_state[0].mu)
    jgrads = tckpt.state_dict_from_flax(jgrads, f64[1].keys())
    return {"knobs": port_step(state, torch.float32, **KNOBS),
            "float64": f64,
            "motif_tpu": ({"loss": float(jaux["loss"])},
                          {k: v.double() for k, v in jgrads.items()})}


def test_bfloat16_step_matches_motif_tpu(steps):
    port = step_gate(steps["knobs"], steps["float64"])
    ref = step_gate(steps["motif_tpu"], steps["float64"])
    for k, r in port["l2_rel"].items():
        assert r <= 2 * ref["l2_rel"][k] + 1e-2, (k, r, ref["l2_rel"][k])
    assert port["loss_rel"] <= 2 * ref["loss_rel"] + 1e-3, (
        port["loss_rel"], ref["loss_rel"])


def test_motif_tpu_reaches_what_the_port_reaches(steps):
    """The same parameters take a gradient in both packages' steps."""
    _, port = steps["knobs"]
    _, ref = steps["motif_tpu"]
    for k, g in port.items():
        assert (float(g.abs().max()) > 0) == (float(ref[k].abs().max()) > 0), k
