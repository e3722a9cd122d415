"""The port's Trainer against motif_tpu's: one optimiser step of
MoTIF(setting=5, channel=16, front_rbs=1, back_rbs=2) on LR 16² → HR 64², N
= 2 target times, RAFT iters 1, batch 1, in float64, once with teacher
forcing (use_gt True) and once without.

One flax init is bridged into the port with the DCN offset convs perturbed
(offsets that are not the zeros of init). teacher_forcing_steps = 1 makes
both draws deterministic: the ratio is 1 at step 0 (use_gt True) and 0
from step 1 on (use_gt False), so each branch is one trainer whose step
count starts at 0 or 1.

motif_tpu's gradients are read from optax's first moment after the step,
mu / (1 - b1) (mu starts at 0), not from the updated parameters: Adam's
first update is about ±lr whatever the gradient's size. Tolerances: the
loss and its parts 1e-9 relative, the lr bit for bit, each parameter's
gradient 1e-10 of its tensor's largest |g| (both packages compute the same
float64 formulas in other orders; the readings are below 4e-15).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from motif_tpu import trainer as jtrainer
from motif_tpu.models.motif import MoTIF as JMoTIF
from motif_tpu.parallel import make_mesh, replicate
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch.models.motif import MoTIF
from motif_tpu_torch.trainer import Trainer, TrainerConfig, make_optimizer

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
    return JMoTIF(setting=5, channel=CH, front_rbs=FRONT, back_rbs=BACK)


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


@pytest.fixture(scope="module")
def params64():
    params = jax.jit(lambda k: _jmodel().init(
        k, jnp.zeros((1, 4, LR, LR, 3), jnp.float32),
        jnp.zeros((1, N), jnp.float32), (HR, HR), iters=1))(
            jax.random.PRNGKey(0))["params"]
    tree = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    return _perturb_offsets(tree, np.random.default_rng(7))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"lq": rng.random((B, 4, LR, LR, 3)),
            "gt": rng.random((B, N + 2, HR, HR, 3)),
            "times": np.sort(rng.random((B, N)), -1)}


def _port(params):
    m = MoTIF(CH, FRONT, BACK).double()
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
            # the step donates its state: fresh arrays each time
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
        tr = Trainer(model, _cfg(), iters=ITERS, seed=0)
        tr.step_count = step0
        aux = tr.step(_batch())
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
    # RAFT and the unused norm_gamma / norm_beta / shuffle take zero
    # gradients in both; everything upstream of the loss takes some
    raft = [k for k in grads if k.startswith("flow_predictor.")]
    assert all(float(grads[k].abs().max()) == 0.0 for k in raft)
    assert nonzero == len(grads) - len(raft) - 4  # norms + shuffle w, b


def test_teacher_forcing_draws_match_motif_tpu():
    """20 steps of the host draw with the ratio decaying over 10 steps:
    the same use_gt sequence from the same seed (motif_tpu's compiled
    steps stubbed out; only the draw runs)."""
    jt = jtrainer.Trainer(_jmodel(), jtrainer.TrainerConfig(
        teacher_forcing_steps=10), mesh=make_mesh(1), seed=5)
    jt._host_step = 0
    for key in [(True, (HR, HR)), (False, (HR, HR))]:
        jt._steps[key] = lambda s, b: (s, {})
    batch = {"gt": np.zeros((1, N + 2, HR, HR, 3))}
    want = [jt.step(None, batch)[1]["use_gt"] for _ in range(20)]
    pt = Trainer(MoTIF(8, 1, 1), TrainerConfig(teacher_forcing_steps=10),
                 seed=5)
    got = []
    for _ in range(20):
        got.append(pt.draw_use_gt())
        pt.step_count += 1
    assert got == want
    assert True in got and False in got


def test_resume_equals_a_straight_run(params64, tmp_path):
    """Two steps, a save, a restore into a fresh trainer and one more step
    equal three steps straight, bit for bit (the same batches fed)."""
    batches = [_batch(s) for s in (1, 2, 3)]

    def fresh():
        return Trainer(_port(params64), _cfg(), iters=ITERS, seed=0)

    straight = fresh()
    losses = [float(straight.step(b)["loss"]) for b in batches]

    first = fresh()
    resumed = [float(first.step(b)["loss"]) for b in batches[:2]]
    tckpt.save_train_state(str(tmp_path), 2, first, meta={"epoch": 3})
    assert tckpt.latest_step(str(tmp_path)) == 2
    assert tckpt.restore_meta(str(tmp_path), 2) == {"epoch": 3}
    second = Trainer(MoTIF(CH, FRONT, BACK).double(), _cfg(), iters=ITERS,
                     seed=0)
    tckpt.restore_train_state(str(tmp_path), 2, second)
    assert second.step_count == 2
    resumed.append(float(second.step(batches[2])["loss"]))
    assert resumed == losses
    for (k, a), b in zip(straight.model.state_dict().items(),
                         second.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = straight.optimizer.state_dict(), second.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_optimizer_step_matches_optax(weight_decay):
    """make_optimizer's Adam / AdamW against optax.adam / adamw over three
    steps of the same gradients and lr schedule, zero gradients included,
    float64: the updated parameters to 1e-12 relative."""
    cfg = TrainerConfig(lr=1e-3, weight_decay=weight_decay,
                        lr_scheme="MultiStepLR_Restart", lr_steps=(2,),
                        restarts=(0,), restart_weights=(1,))
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((3, 5))
    grads = [rng.standard_normal((3, 5)) for _ in range(3)]
    grads[1][0] = 0.0
    with jax.enable_x64(True):
        tx, sched = jtrainer.make_optimizer(cfg)
        p = jnp.asarray(p0)
        st = tx.init(p)
        for g in grads:
            up, st = tx.update(jnp.asarray(g), st, p)
            p = optax.apply_updates(p, up)
        want = np.asarray(p)
    t = torch.nn.Parameter(torch.tensor(p0))
    opt, tsched = make_optimizer(cfg, [t])
    for i, g in enumerate(grads):
        t.grad = torch.tensor(g)
        for group in opt.param_groups:
            group["lr"] = float(tsched(i))
        assert np.float32(tsched(i)) == np.float32(sched(i))
        opt.step()
    np.testing.assert_allclose(t.detach().numpy(), want, rtol=1e-12, atol=0)


def test_every_parameter_is_stepped(params64):
    """A parameter autograd did not reach (RAFT) still takes an optimiser
    step with a zero gradient, as optax steps every leaf."""
    tr = Trainer(_port(params64), _cfg(), iters=ITERS, seed=0)
    before = copy.deepcopy(tr.model.state_dict())
    tr.step(_batch())
    st = tr.optimizer.state_dict()["state"]
    assert len(st) == len(tr.params)
    for i, p in enumerate(tr.params):
        assert p.grad is not None
        assert float(st[i]["step"]) == 1.0
    moved = [k for k, v in tr.model.state_dict().items()
             if not torch.equal(v, before[k])]
    assert moved and not any(k.startswith("flow_predictor.") for k in moved)


def test_a_step_after_an_eval_of_the_same_model(params64):
    """An inference-mode forward first (as Evaluator.infer runs it) leaves
    the model's cached tables and resize matrices usable by a training
    step: the step equals the one on a model that never ran an eval."""
    batch = _batch()
    evald = Trainer(_port(params64), _cfg(), iters=ITERS, seed=0)
    with torch.inference_mode():
        evald.model(torch.as_tensor(batch["lq"]),
                    torch.as_tensor(batch["times"]), (HR, HR), iters=ITERS)
    fresh = Trainer(_port(params64), _cfg(), iters=ITERS, seed=0)
    assert float(evald.step(batch)["loss"]) == float(fresh.step(batch)["loss"])
