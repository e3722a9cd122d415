"""What tests/test_torch_trainer_a.py and test_torch_trainer7.py share:
one optimiser step of the port's Trainer against motif_tpu's on an
arbitrary-scale batch, in float64, of MoTIF at a setting or of the
linear-motion Ours_7, at channel 16, 1 / 2 residual blocks, RAFT iters 1,
batch 1 (each case in its own file: one JAX train-step compile each).

The batch is `collate_adobe_arbitrary`'s (the port's; the JAX package's
gives the same, tests/test_torch_adobe_data.py) over raw frames made from
a seed, with d_scale pinned to 4 (a crop of 128 from LQ_size 32: LQ 16²,
GT 64², the smallest output RAFT takes), 2 target times; both Trainers
read its output size from its GT (out_hw=None) and drop its 'out_hw'.
teacher_forcing_steps = 1 and a step count of 1 make the draw use_gt =
False (the predicted motion splats). As in tests/test_torch_trainer.py:
motif_tpu's gradients from optax's first moment mu / (1 - b1); the loss
and its parts 1e-9 relative, each gradient 1e-10 of its tensor's largest.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import torch

from motif_tpu import checkpoint as jckpt
from motif_tpu import trainer as jtrainer
from motif_tpu.models.motif import MoTIF as JMoTIF
from motif_tpu.parallel import make_mesh, replicate
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch.data.pipeline import collate_adobe_arbitrary
from motif_tpu_torch.models.motif import MoTIF
from motif_tpu_torch.trainer import Trainer, TrainerConfig

CH, FRONT, BACK = 16, 1, 2
N, LQ_SIZE = 2, 32
ITERS = 1
B1 = 0.9
LOSS_RTOL = 1e-9
GRAD_TOL = 1e-10
CASES = {"s6": (6, False), "ours7": (3, True)}


class _ScaleFour(random.Random):
    """The collate's generator with its d_scale draw pinned to 4."""

    def uniform(self, a, b):
        return 4.0


def _batch():
    rng = np.random.default_rng(0)
    item = {"lq_raw": [rng.random((136, 144, 3), dtype=np.float32)
                       for _ in range(4)],
            "gt_raw": [rng.random((136, 144, 3), dtype=np.float32)
                       for _ in range(N + 2)],
            "times": np.asarray([0.25, 0.625], np.float32)}
    batch = collate_adobe_arbitrary([item], lq_size=LQ_SIZE,
                                    rng=_ScaleFour(3))
    assert batch["lq"].shape == (1, 4, 16, 16, 3)
    assert batch["gt"].shape == (1, N + 2, 64, 64, 3)
    assert batch["out_hw"] == (64, 64)
    return {k: (v.astype(np.float64) if isinstance(v, np.ndarray) else v)
            for k, v in batch.items()}


def _cfg(cls):
    return cls(teacher_forcing_steps=1)


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


def one_step(case):
    """(case, motif_tpu's (aux, gradient tree), the port's (aux, grads))
    of one step from the same float64 parameters and batch, torch on one
    thread."""
    setting, linear = CASES[case]
    torch.manual_seed(setting)
    port = MoTIF(CH, FRONT, BACK, setting=setting,
                 linear_motion=linear).double()
    with jax.enable_x64(True):
        params = jax.tree.map(np.asarray,
                              jckpt.port_torch_state_dict(port.state_dict()))
    params = _perturb_offsets(params, np.random.default_rng(7))
    params["alpha"] = np.full((1,), 0.5)
    tckpt.load_flax_params(port, params)
    batch = _batch()

    jmodel = JMoTIF(setting=setting, channel=CH, front_rbs=FRONT,
                    back_rbs=BACK, linear_motion=linear)
    with jax.enable_x64(True):
        tr = jtrainer.Trainer(jmodel, _cfg(jtrainer.TrainerConfig),
                              out_hw=None, iters=ITERS, mesh=make_mesh(1),
                              seed=0)
        p = jax.tree.map(jnp.asarray, params)
        state = jax.device_put(jtrainer.TrainState(
            params=p, opt_state=tr.tx.init(p), step=jnp.asarray(1, jnp.int32)),
            replicate(tr.mesh))
        tr._host_step = 1
        new, jaux = tr.step(state, {k: (jnp.asarray(v) if isinstance(
            v, np.ndarray) else v) for k, v in batch.items()})
        jgrads = jax.tree.map(lambda m: np.asarray(m) / (1 - B1),
                              new.opt_state[0].mu)
        jaux = {k: (v if k == "use_gt" else np.asarray(v))
                for k, v in jaux.items()}

    ptr = Trainer(port, _cfg(TrainerConfig), out_hw=None, iters=ITERS, seed=0,
                  family="Ours_7" if linear else "Ours")
    ptr.step_count = 1
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        aux = ptr.step(batch)
    finally:
        torch.set_num_threads(threads)
    grads = {k: p.grad.detach().clone() for k, p in port.named_parameters()}
    return case, (jaux, jgrads), (aux, grads)


def check_step(steps):
    _, (want, _), (got, _) = steps
    assert want["use_gt"] is got["use_gt"] is False
    for k in ("loss", "l_pix", "flow_l"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert np.float32(got["lr"]) == np.float32(want["lr"])


def check_gradients(steps):
    case, (_, jgrads), (_, grads) = steps
    want = tckpt.state_dict_from_flax(jgrads, grads.keys())
    reached = set()
    for k, g in grads.items():
        w = want[k].numpy()
        scale = max(float(np.abs(w).max()), 1e-300)
        err = float(np.abs(g.numpy() - w).max()) / scale
        assert err <= GRAD_TOL, (k, err)
        if np.abs(w).max() > 0:
            reached.add(k.split(".")[0])
    # what the loss reaches: the encoder, the SIRENs it runs, and for
    # MoTIF the flow-context convs and alpha; the linear-motion fork runs
    # neither the flow-context convs nor the STINF
    want_reached = {"encoder", "imnet", "synth_net"}
    if case == "s6":
        want_reached |= {"flow_process", "flow_imnet", "alpha"}
    assert reached == want_reached
