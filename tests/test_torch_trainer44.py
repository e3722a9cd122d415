"""The port's Trainer on the four-anchor MoTIF against motif_tpu's: one
optimiser step of MoTIF(setting=5, n_anchors=4, channel=16, front_rbs=1,
back_rbs=2) on LR 16² → HR 64², N = 2 target times, batch 1, in float64,
on precomputed flows as the reference Vimeo recipe trains Ours_44: the
batch carries `flow` (B, 16, 16, 16, 2) and `flow_gt` (B, N, 4, 64, 64, 2),
RAFT runs in neither package, and the flow-distillation term reads the
batch's `flow_gt`. Once with teacher forcing (use_gt True: the splat
takes `flow_gt`) and once without.

As in tests/test_torch_trainer.py: one flax init bridged into the port
with the DCN offset convs perturbed; teacher_forcing_steps = 1 makes the
draws deterministic (use_gt True at step 0, False from step 1);
motif_tpu's gradients are read from optax's first moment, mu / (1 - b1).
Tolerances: the loss and its parts 1e-9 relative, each parameter's
gradient 1e-10 of its tensor's largest |g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motif_tpu import trainer as jtrainer
from motif_tpu.models.motif import MoTIF as JMoTIF
from motif_tpu.parallel import make_mesh, replicate
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch.models.motif import MoTIF
from motif_tpu_torch.trainer import Trainer, TrainerConfig

CH, FRONT, BACK = 16, 1, 2
B, N, LR, HR = 1, 2, 16, 64
ITERS = 1
B1 = 0.9
LOSS_RTOL = 1e-9
GRAD_TOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmodel():
    return JMoTIF(setting=5, channel=CH, front_rbs=FRONT, back_rbs=BACK,
                  n_anchors=4)


def _perturb_offsets(tree, rng):
    out = {}
    for k, v in tree.items():
        if k == "conv_offset_mask":
            out[k] = {"kernel": rng.standard_normal(v["kernel"].shape) * 0.05,
                      "bias": rng.standard_normal(v["bias"].shape) * 1.5}
        elif isinstance(v, dict):
            out[k] = _perturb_offsets(v, rng)
        else:
            out[k] = v
    return out


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"lq": rng.random((B, 4, LR, LR, 3)),
            "gt": rng.random((B, N + 2, HR, HR, 3)),
            "times": np.sort(rng.random((B, N)), -1),
            "flow": rng.standard_normal((B, 16, LR, LR, 2)) * 2.0,
            "flow_gt": rng.standard_normal((B, N, 4, HR, HR, 2)) * 3.0}


@pytest.fixture(scope="module")
def params64():
    """The init takes the flows too, as motif_tpu's Trainer.init_state
    passes them: flow_predictor is made on a dummy input."""
    b = _batch()
    params = jax.jit(lambda k: _jmodel().init(
        k, jnp.zeros((1, 4, LR, LR, 3), jnp.float32),
        jnp.zeros((1, N), jnp.float32), (HR, HR), iters=1, train=True,
        target_frames=jnp.zeros((1, N + 2, HR, HR, 3), jnp.float32),
        flows=(jnp.asarray(b["flow"], jnp.float32),
               jnp.asarray(b["flow_gt"], jnp.float32))))(
            jax.random.PRNGKey(0))["params"]
    tree = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    return _perturb_offsets(tree, np.random.default_rng(7))


def _port(params):
    m = MoTIF(CH, FRONT, BACK, n_anchors=4).double()
    tckpt.load_flax_params(m, params)
    return m


def _cfg(cls=TrainerConfig, **kw):
    return cls(teacher_forcing_steps=1, **kw)


@pytest.fixture(scope="module")
def jax_steps(params64):
    """motif_tpu's Trainer.step from step 0 (use_gt True) and from step 1
    (use_gt False), each from the same params: (aux, gradient tree)."""
    out = {}
    batch = _batch()
    with jax.enable_x64(True):
        tr = jtrainer.Trainer(_jmodel(), _cfg(jtrainer.TrainerConfig),
                              iters=ITERS, mesh=make_mesh(1), seed=0)
        for step0 in (0, 1):
            params = jax.tree.map(jnp.asarray, params64)
            state = jtrainer.TrainState(
                params=params, opt_state=tr.tx.init(params),
                step=jnp.asarray(step0, jnp.int32))
            state = jax.device_put(state, replicate(tr.mesh))
            tr._host_step = step0
            new, aux = tr.step(state, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
            grads = jax.tree.map(lambda m: np.asarray(m) / (1 - B1),
                                 new.opt_state[0].mu)
            aux = {k: (v if k == "use_gt" else np.asarray(v))
                   for k, v in aux.items()}
            out[aux["use_gt"]] = (aux, grads)
    return out


@pytest.fixture(scope="module")
def port_steps(params64):
    out = {}
    for step0 in (0, 1):
        model = _port(params64)
        calls = []
        model.flow_predictor.register_forward_hook(
            lambda *a: calls.append(1))
        tr = Trainer(model, _cfg(), iters=ITERS, seed=0, family="Ours_44")
        tr.step_count = step0
        aux = tr.step(_batch())
        assert calls == []                       # RAFT never ran
        grads = {k: p.grad.detach().clone()
                 for k, p in model.named_parameters()}
        out[aux["use_gt"]] = (aux, grads, model)
    return out


@pytest.mark.parametrize("use_gt", [True, False])
def test_step_matches_motif_tpu(jax_steps, port_steps, use_gt):
    want, _ = jax_steps[use_gt]
    got, _, _ = port_steps[use_gt]
    assert want["use_gt"] is got["use_gt"] is use_gt
    for k in ("loss", "l_pix", "flow_l"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert np.float32(got["lr"]) == np.float32(want["lr"])


@pytest.mark.parametrize("use_gt", [True, False])
def test_gradients_match_motif_tpu(jax_steps, port_steps, use_gt):
    _, jgrads = jax_steps[use_gt]
    _, grads, model = port_steps[use_gt]
    want = tckpt.state_dict_from_flax(jgrads, grads.keys())
    nonzero = 0
    for k, g in grads.items():
        w = want[k].numpy()
        scale = max(float(np.abs(w).max()), 1e-300)
        err = float(np.abs(g.numpy() - w).max()) / scale
        assert err <= GRAD_TOL, (k, err)
        nonzero += bool(np.abs(w).max() > 0)
    raft = [k for k in grads if k.startswith("flow_predictor.")]
    assert all(float(grads[k].abs().max()) == 0.0 for k in raft)
    assert nonzero == len(grads) - len(raft) - 4  # norms + shuffle w, b


def test_flow_loss_reads_the_batch_teacher(port_steps):
    """The flow-distillation term is charbonnier(flow, flow_gt) with the
    batch's flow_gt: a step with another flow_gt changes it, and the step
    without a flow loss weight does not depend on flow_gt when use_gt is
    off."""
    _, _, model = port_steps[False]
    a, b = _batch(), _batch()
    b["flow_gt"] = b["flow_gt"] * 0.5
    tr = Trainer(model, _cfg(), iters=ITERS, seed=0, family="Ours_44")
    la = tr.loss(a, use_gt=False)[1]
    lb = tr.loss(b, use_gt=False)[1]
    assert float(la["flow_l"]) != float(lb["flow_l"])
    assert float(la["l_pix"]) == float(lb["l_pix"])
