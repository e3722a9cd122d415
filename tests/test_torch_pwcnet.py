"""PWC-Net of the port against motif_tpu's (tests/test_pwcnet.py holds
motif_tpu's against torch's own layers): ConvTranspose2d and the bridge
of its (in, out, kh, kw) weight, the local cost volume, the masked
backward warp, and PWCNet / PWCNetLight whole, each tree bridged strictly
from the port's init from a seed, in float64 on seeded inputs (LR 64x128;
the refiner and every level run), atol 1e-10 (1e-12 for the ops)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _settings_parity import _flat
from motif_tpu import checkpoint as jckpt
from motif_tpu.models import pwcnet as jpwc
from motif_tpu.models.layers import ConvTranspose2d as JConvT
from motif_tpu.ops.corr import local_corr as jlocal_corr
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch.models import pwcnet
from motif_tpu_torch.models.layers import ConvTranspose2d
from motif_tpu_torch.ops import local_corr


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree64(module):
    with jax.enable_x64(True):
        return jax.tree.map(np.asarray, jckpt.port_torch_state_dict(
            module.double().state_dict()))


@pytest.mark.parametrize("cin,cout", [(2, 2), (6, 2), (5, 3)])
def test_conv_transpose_matches_motif_tpu(cin, cout):
    torch.manual_seed(cin)
    m = ConvTranspose2d(cin, cout, 4, 2, 1)
    tree = _tree64(torch.nn.ModuleDict({"moduleUpflow": m}))
    assert tree["moduleUpflow"]["kernel"].shape == (4, 4, cin, cout)
    x = np.random.default_rng(cin).standard_normal((2, 5, 7, cin))
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    with jax.enable_x64(True):
        want = JConvT(cout, 4, 2, 1).apply({"params": tree["moduleUpflow"]},
                                          jnp.asarray(x))
    assert got.shape == (2, 10, 14, cout)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-12)
    # and back: the flax tree loads into the port strictly, bit for bit
    m2 = torch.nn.ModuleDict({"moduleUpflow": ConvTranspose2d(cin, cout)})
    tckpt.load_flax_params(m2.double(), tree)
    assert torch.equal(m2["moduleUpflow"].weight, m.weight)


@pytest.mark.parametrize("shape,d", [((2, 8, 11, 5), 4), ((1, 6, 6, 3), 2)])
def test_local_corr_matches_motif_tpu(shape, d):
    rng = np.random.default_rng(d)
    f1, f2 = rng.standard_normal(shape), rng.standard_normal(shape)
    got = local_corr(torch.from_numpy(f1), torch.from_numpy(f2), d).numpy()
    with jax.enable_x64(True):
        want = jlocal_corr(jnp.asarray(f1), jnp.asarray(f2), d)
    assert got.shape == shape[:3] + ((2 * d + 1) ** 2,)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-12)


def test_masked_backwarp_matches_motif_tpu():
    rng = np.random.default_rng(0)
    img = rng.random((2, 8, 10, 3))
    flow = rng.standard_normal((2, 8, 10, 2)) * 2
    got = pwcnet._masked_backwarp(torch.from_numpy(img),
                                  torch.from_numpy(flow)).numpy()
    with jax.enable_x64(True):
        want = jpwc._masked_backwarp(jnp.asarray(img), jnp.asarray(flow))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-12)
    out = pwcnet._masked_backwarp(torch.from_numpy(img),
                                  torch.full((2, 8, 10, 2), 100.0,
                                             dtype=torch.float64))
    assert float(out.abs().sum()) == 0.0


@pytest.mark.parametrize("which", ["PWCNet", "PWCNetLight"])
def test_pwcnet_matches_motif_tpu(which):
    """motif_tpu's init tree (jax.eval_shape) is the port's bridged tree,
    shape for shape; the forward of both on the same tree and frames."""
    torch.manual_seed(0)
    m = getattr(pwcnet, which)()
    jm = getattr(jpwc, which)()
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 3))),
        jax.random.PRNGKey(0))["params"]
    tree = _tree64(m)
    assert {p: np.shape(v) for p, v in _flat(tree)} == \
        {p: tuple(v.shape) for p, v in _flat(shapes)}
    tckpt.load_flax_params(m, tree)
    rng = np.random.default_rng(1)
    a, b = rng.random((1, 64, 128, 3)), rng.random((1, 64, 128, 3))
    b = 0.7 * a + 0.3 * b                     # a flow worth estimating
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    with jax.enable_x64(True):
        want = jax.jit(lambda p, x, y: jm.apply({"params": p}, x, y))(
            tree, jnp.asarray(a), jnp.asarray(b))
    assert got.shape == (1, 16, 32, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-10)
