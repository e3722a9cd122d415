"""One optimiser step of the port's Trainer on the `LIIF` family (VideoINR)
against motif_tpu's, in float64: nf 16, 1 / 1 residual blocks, the 4 LQ
frames every training mode gives (7 fused frames, the SIRENs 463 / 525 /
1049 wide), batch 1, LQ 16² -> GT 64², 2 target times, on an `Adobe`
batch (the yml's fixed output size) and on an `_a` batch
(`collate_adobe_arbitrary`'s, tests/_trainer_parity.py, the output size
read from its GT).

The flax tree is the port's init bridged by motif_tpu.checkpoint, the DCN
offset convs perturbed. motif_tpu's gradients are read from optax's first
moment, mu / (1 - b1). Both batches have the same shapes, so one compiled
JAX step (out_hw read from the GT) serves both. Tolerances: the loss 1e-9
relative, each gradient 1e-10 of its tensor's largest |g| (as
tests/test_torch_trainer.py), the parameters after Adam 1e-9 absolute
(Adam's first update is lr * g / (|g| + eps): a gradient near eps moves it
by lr times its relative error). LIIF has no teacher forcing: neither
package draws from its generator in the step.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _trainer_parity import _batch as arbitrary_batch
from motif_tpu import checkpoint as jckpt
from motif_tpu import trainer as jtrainer
from motif_tpu.models.videoinr import VideoINR as JVideoINR
from motif_tpu.parallel import make_mesh, replicate
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch.models.videoinr import VideoINR
from motif_tpu_torch.trainer import Trainer, TrainerConfig

NF, FRONT, BACK = 16, 1, 1
N, LR, HR = 2, 16, 64
B1 = 0.9
LOSS_RTOL = 1e-9
GRAD_TOL = 1e-10
PARAM_ATOL = 1e-9
SEED = 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _adobe_batch():
    rng = np.random.default_rng(1)
    return {"lq": rng.random((1, 4, LR, LR, 3)),
            "gt": rng.random((1, N + 2, HR, HR, 3)),
            "times": np.asarray([[0.25, 0.625]])}


@pytest.fixture(scope="module")
def params64():
    torch.manual_seed(0)
    port = VideoINR(NF, FRONT, BACK, n_frames=4).double()
    with jax.enable_x64(True):
        params = jax.tree.map(np.asarray,
                              jckpt.port_torch_state_dict(port.state_dict()))
    return _perturb_offsets(params, np.random.default_rng(7))


@pytest.fixture(scope="module")
def steps(params64):
    """{batch kind: (motif_tpu's (aux, grads, params after), the port's
    (aux, grads, params after, the next draw of its generator))}."""
    batches = {"adobe": (_adobe_batch(), (HR, HR)),
               "arbitrary": (arbitrary_batch(), None)}
    out = {}
    with jax.enable_x64(True):
        jt = jtrainer.Trainer(JVideoINR(nf=NF, front_rbs=FRONT,
                                        back_rbs=BACK),
                              jtrainer.TrainerConfig(), out_hw=None,
                              mesh=make_mesh(1), seed=SEED, family="LIIF")
        jt._host_step = 0
        want = {}
        for kind, (batch, _) in batches.items():
            p = jax.tree.map(jnp.asarray, params64)
            state = jax.device_put(jtrainer.TrainState(
                params=p, opt_state=jt.tx.init(p),
                step=jnp.asarray(0, jnp.int32)), replicate(jt.mesh))
            jt._host_step = 0
            new, aux = jt.step(state, {k: (jnp.asarray(v) if isinstance(
                v, np.ndarray) else v) for k, v in batch.items()})
            want[kind] = (
                {k: (v if k == "use_gt" else np.asarray(v))
                 for k, v in aux.items()},
                jax.tree.map(lambda m: np.asarray(m) / (1 - B1),
                             new.opt_state[0].mu),
                jax.tree.map(np.asarray, new.params))
        jdraw = jt._rng.random()
    for kind, (batch, out_hw) in batches.items():
        model = VideoINR(NF, FRONT, BACK, n_frames=4).double()
        tckpt.load_flax_params(model, params64)
        tr = Trainer(model, TrainerConfig(), out_hw=out_hw, seed=SEED,
                     family="LIIF")
        aux = tr.step(batch)
        grads = {k: p.grad.detach().clone()
                 for k, p in model.named_parameters()}
        after = {k: p.detach().clone() for k, p in model.named_parameters()}
        out[kind] = (want[kind], (aux, grads, after, tr._rng.random()))
    return out, jdraw


@pytest.mark.parametrize("kind", ["adobe", "arbitrary"])
def test_liif_step_matches_motif_tpu(steps, kind):
    """The loss (no flow term, no teacher forcing) and the lr."""
    (want, _, _), (got, _, _, _) = steps[0][kind]
    assert want["use_gt"] is got["use_gt"] is False
    assert "flow_l" not in got and "flow_l" not in want
    for k in ("loss", "l_pix"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert np.float32(got["lr"]) == np.float32(want["lr"])


@pytest.mark.parametrize("kind", ["adobe", "arbitrary"])
def test_liif_gradients_match_motif_tpu(steps, kind):
    """Every gradient to 1e-10 of its tensor's largest; the unused
    upsampling head takes none in both, every other module some."""
    (_, jgrads, _), (_, grads, _, _) = steps[0][kind]
    want = tckpt.state_dict_from_flax(jgrads, grads.keys())
    reached = set()
    for k, g in grads.items():
        w = want[k].numpy()
        scale = max(float(np.abs(w).max()), 1e-300)
        err = float(np.abs(g.numpy() - w).max()) / scale
        assert err <= GRAD_TOL, (k, err)
        if np.abs(w).max() > 0:
            reached.add(k.split(".")[0])
    head = {"upconv1", "upconv2", "HRconv", "conv_last"}
    assert not reached & head
    assert {"conv_first", "feature_extraction", "pcd_align", "ConvBLSTM",
            "recon_trunk", "feat_imnet", "flow_imnet",
            "encode_imnet"} <= reached


@pytest.mark.parametrize("kind", ["adobe", "arbitrary"])
def test_liif_parameters_after_adam_match_motif_tpu(steps, kind):
    (_, _, jafter), (_, _, after, _) = steps[0][kind]
    want = tckpt.state_dict_from_flax(jafter, after.keys())
    for k, p in after.items():
        err = float(np.abs(p.numpy() - want[k].numpy()).max())
        assert err <= PARAM_ATOL, (k, err)


def test_liif_step_draws_nothing(steps):
    """After a LIIF step the generator's next draw is its first from the
    seed, in both packages (motif_tpu/trainer.py:205-206 sets use_gt
    False without a draw)."""
    out, jdraw = steps
    first = random.Random(SEED).random()
    assert jdraw == first
    assert all(got[3] == first for _, got in out.values())
