"""What tests/test_torch_parallel.py and test_torch_parallel7.py share: one
data-parallel optimiser step of the port on the CPU, two gloo processes
(tests/_dp_worker.py, `torch.multiprocessing` spawn, a `file://`
rendezvous under the test's tmp_path) on two halves of a global batch of
2, against motif_tpu's single-device step over the global batch and the
port's own single-process step over it, in float64: MoTIF (setting 5) or
the linear-motion Ours_7, whose STINF takes no gradient (zero-filled, then
summed), channel 16, 1 / 2 residual blocks, LQ 16² -> GT 64², 2 times,
RAFT iters 1, use_gt False (teacher_forcing_steps 1 from step 1).

The summed gradient is the global batch's because the losses are sums
over the batch (motif_tpu/losses.py): tolerances as
tests/test_torch_trainer.py (the loss 1e-9 relative, each gradient 1e-10
of its tensor's largest against motif_tpu, whose gradient is read from
optax's mu / (1 - b1)); against the port's own global step 1e-12; both
ranks hold the same parameters after the step, bit for bit, and drew
use_gt from the same generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.multiprocessing as mp

import _dp_worker
from motif_tpu import checkpoint as jckpt
from motif_tpu import trainer as jtrainer
from motif_tpu.models.motif import MoTIF as JMoTIF
from motif_tpu.parallel import make_mesh, replicate
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch.models.motif import MoTIF
from motif_tpu_torch.trainer import Trainer, TrainerConfig

CH, FRONT, BACK = 16, 1, 2
WORLD = 2
B1 = 0.9
LOSS_RTOL = 1e-9
GRAD_TOL = 1e-10
SELF_TOL = 1e-12
CASES = {"ours": dict(setting=5), "ours7": dict(setting=3,
                                                linear_motion=True)}


def _batch():
    rng = np.random.default_rng(0)
    return {"lq": rng.random((WORLD, 4, 16, 16, 3)),
            "gt": rng.random((WORLD, 4, 64, 64, 3)),
            "times": np.asarray([[0.25, 0.625], [0.375, 0.75]])}


def _state(case):
    torch.manual_seed(3)
    m = MoTIF(CH, FRONT, BACK, **CASES[case]).double()
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for n, p in m.named_parameters():
            if "conv_offset_mask" in n:
                scale = 0.05 if n.endswith("weight") else 1.5
                p.copy_(torch.randn(p.shape, generator=g,
                                    dtype=torch.float64) * scale)
        m.alpha.fill_(0.5)
    return m.state_dict()


def _family(case):
    return "Ours_7" if case == "ours7" else "Ours"


def data_parallel_step(case, tmp):
    """The two ranks' records (`_dp_worker.run`)."""
    state = _state(case)
    torch.save({"model": dict(channel=CH, front_rbs=FRONT, back_rbs=BACK,
                              **CASES[case]),
                "state": state, "family": _family(case),
                "batch": {k: torch.as_tensor(v) for k, v in
                          _batch().items()}}, f"{tmp}/spec.pt")
    mp.start_processes(_dp_worker.run, args=(WORLD, str(tmp)), nprocs=WORLD,
                       join=True, start_method="spawn")
    return [torch.load(f"{tmp}/rank{r}.pt") for r in range(WORLD)]


def single_steps(case):
    """(motif_tpu's (aux, gradients), the port's (aux, gradients)) of one
    step over the whole global batch in one process."""
    state = _state(case)
    with jax.enable_x64(True):
        params = jax.tree.map(np.asarray, jckpt.port_torch_state_dict(state))
        jm = JMoTIF(channel=CH, front_rbs=FRONT, back_rbs=BACK,
                    **CASES[case])
        tr = jtrainer.Trainer(jm, jtrainer.TrainerConfig(
            teacher_forcing_steps=1), out_hw=None, iters=1,
            mesh=make_mesh(1), seed=0)
        p = jax.tree.map(jnp.asarray, params)
        st = jax.device_put(jtrainer.TrainState(
            params=p, opt_state=tr.tx.init(p),
            step=jnp.asarray(1, jnp.int32)), replicate(tr.mesh))
        tr._host_step = 1
        new, jaux = tr.step(st, {k: jnp.asarray(v)
                                 for k, v in _batch().items()})
        jgrads = jax.tree.map(lambda m: np.asarray(m) / (1 - B1),
                              new.opt_state[0].mu)
        jaux = {k: (v if k == "use_gt" else float(v))
                for k, v in jaux.items()}
    model = MoTIF(CH, FRONT, BACK, **CASES[case]).double()
    model.load_state_dict(state)
    ptr = Trainer(model, TrainerConfig(teacher_forcing_steps=1), out_hw=None,
                  iters=1, seed=0, family=_family(case))
    ptr.step_count = 1
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        aux = ptr.step(_batch())
    finally:
        torch.set_num_threads(threads)
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    want = tckpt.state_dict_from_flax(jgrads, grads.keys())
    return (jaux, want), ({k: (float(v) if isinstance(v, torch.Tensor)
                               else v) for k, v in aux.items()}, grads)


def _rel(got, want):
    scale = max(float(want.abs().max()), 1e-300)
    return float((got - want).abs().max()) / scale


def check(ranks, singles):
    """Every assertion of the module's docstring."""
    (jaux, jgrads), (paux, pgrads) = singles
    r0, r1 = ranks
    assert r0["world"] == r1["world"] == WORLD and r0["sync"] and r1["sync"]
    assert r0["aux"]["use_gt"] is r1["aux"]["use_gt"] is jaux["use_gt"] \
        is False
    assert r0["next_draw"] == r1["next_draw"]
    for k in ("loss", "l_pix", "flow_l"):
        assert r0["aux"][k] == r1["aux"][k], k
        np.testing.assert_allclose(r0["aux"][k], jaux[k], rtol=LOSS_RTOL,
                                   err_msg=k)
        np.testing.assert_allclose(r0["aux"][k], paux[k], rtol=SELF_TOL,
                                   err_msg=k)
    for k, g in r0["grads"].items():
        assert torch.equal(g, r1["grads"][k]), k
        assert torch.equal(r0["params"][k], r1["params"][k]), k
        assert _rel(g, jgrads[k]) <= GRAD_TOL, (k, _rel(g, jgrads[k]))
        assert _rel(g, pgrads[k]) <= SELF_TOL, (k, _rel(g, pgrads[k]))
