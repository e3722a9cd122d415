"""The port's modules against motif_tpu on one flax init each, bridged with
motif_tpu_torch.checkpoint, in float64 on the CPU (plain kernel versions):
RAFT-small, PCDAlign, BiDeformableConvLSTM and ZSMEncoder. Every
conv_offset_mask is perturbed, so the DCN offsets are real (they are zero
at init).

Tolerance: atol 1e-8. Both sides compute the same float64 formulas; the
RAFT updates and the recurrent alignment amplify the summation-order
differences (~1e-15) by a few orders at most.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motif_tpu.models.encoder import ZSMEncoder as JZSMEncoder
from motif_tpu.models.pcd import BiDeformableConvLSTM as JBiLSTM
from motif_tpu.models.pcd import PCDAlign as JPCDAlign
from motif_tpu.models.raft import RAFT as JRAFT
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch.models.encoder import ZSMEncoder
from motif_tpu_torch.models.pcd import BiDeformableConvLSTM, PCDAlign
from motif_tpu_torch.models.raft import RAFT


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU forwards here are many small ops: one thread runs them
    as fast and does not contend with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-8
NF = 16


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


def _init64(module, *args, **kw):
    params = jax.jit(lambda k: module.init(k, *args, **kw))(
        jax.random.PRNGKey(0))["params"]
    params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    return _perturb_offsets(params, np.random.default_rng(11))


def _port(module, params):
    module = module.double()
    tckpt.load_flax_params(module, params)
    return module.eval()


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)


def test_raft_small(rng):
    img1 = rng.random((2, 64, 72, 3)) * 255.0
    img2 = rng.random((2, 64, 72, 3)) * 255.0
    jm = JRAFT()
    params = _init64(jm, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 3)),
                     iters=1)
    with jax.enable_x64(True):
        want = jm.apply({"params": params}, jnp.asarray(img1),
                        jnp.asarray(img2), iters=2)
    with torch.no_grad():
        got = _port(RAFT(), params)(torch.from_numpy(img1),
                                    torch.from_numpy(img2), iters=2)
    assert got.shape == (2, 64, 72, 2)
    _close(got, want)


def _pyramid(rng, B, H, W):
    return [rng.standard_normal((B, H // s, W // s, NF)) for s in (1, 2, 4)]


def test_pcd_align(rng):
    fea1, fea2 = _pyramid(rng, 2, 16, 20), _pyramid(rng, 2, 16, 20)
    jm = JPCDAlign(NF, groups=8)
    params = _init64(jm, [jnp.zeros(a.shape, jnp.float32) for a in fea1],
                     [jnp.zeros(a.shape, jnp.float32) for a in fea2])
    with jax.enable_x64(True):
        want = jm.apply({"params": params}, [jnp.asarray(a) for a in fea1],
                        [jnp.asarray(a) for a in fea2])
    with torch.no_grad():
        got = _port(PCDAlign(NF, 8), params)(
            [torch.from_numpy(a) for a in fea1],
            [torch.from_numpy(a) for a in fea2])
    assert got.shape == (2, 16, 20, 2 * NF)
    _close(got, want)


def test_bidirectional_deformable_convlstm(rng):
    x = rng.standard_normal((1, 3, 16, 12, NF))
    jm = JBiLSTM(NF, groups=8)
    params = _init64(jm, jnp.zeros(x.shape, jnp.float32))
    with jax.enable_x64(True):
        want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = _port(BiDeformableConvLSTM(NF, 8), params)(torch.from_numpy(x))
    assert got.shape == x.shape
    _close(got, want)


@pytest.mark.parametrize("n_frames", [2, 3])
def test_zsm_encoder(rng, n_frames):
    x = rng.random((1, n_frames, 16, 12, 3))
    jm = JZSMEncoder(NF, front_rbs=1, back_rbs=2)
    params = _init64(jm, jnp.zeros(x.shape, jnp.float32))
    with jax.enable_x64(True):
        want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = _port(ZSMEncoder(NF, 1, 2), params)(torch.from_numpy(x))
    assert got.shape == (1, 2 * n_frames - 1, 16, 12, NF)
    _close(got, want)
