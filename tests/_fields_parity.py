"""What tests/test_torch_fields.py and test_torch_fields2.py share: the
MoTIF fields that no reference config turns on (groups > 1, trans,
res_liff, local_ensemble, siren=False), a port model and its float64 flax
tree per field, and the forward held against motif_tpu's in float64 (one
JAX compile a field, so the fields are spread over two files)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _settings_parity import _flat, _perturb_offsets
from motif_tpu import checkpoint as jckpt
from motif_tpu.models.motif import MoTIF as JMoTIF
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch.models.motif import MoTIF

CH, FRONT, BACK = 16, 1, 2
H = W = 16
HH = WW = 64
ITERS = 2
ATOL = 1e-10
FIELDS = {"groups2": {"groups": 2}, "trans": {"trans": True},
          "res_liff": {"res_liff": True},
          "local_ensemble": {"local_ensemble": True},
          "conv_synth": {"siren": False}}


def jmodel(field, **kw):
    return JMoTIF(setting=5, channel=CH, front_rbs=FRONT, back_rbs=BACK,
                  **FIELDS[field], **kw)


def port(field, **kw):
    return MoTIF(CH, FRONT, BACK, **FIELDS[field], **kw)


def jshapes(field):
    """motif_tpu's init tree of the field, its shapes (jax.eval_shape)."""
    return jax.eval_shape(lambda k: jmodel(field).init(
        k, jnp.zeros((1, 4, H, W, 3)), jnp.zeros((1, 3)), (HH, WW),
        iters=1), jax.random.PRNGKey(0))["params"]


def tree_shapes(tree):
    return {p: tuple(np.shape(v)) for p, v in _flat(tree)}


def params64(field):
    """The port's init of the field from a seed, bridged to a float64 flax
    tree, the DCN offset convs perturbed and alpha = 0.5 (z > 0: the max
    splat runs)."""
    torch.manual_seed(sorted(FIELDS).index(field))
    sd = port(field).double().state_dict()
    with jax.enable_x64(True):
        tree = jax.tree.map(np.asarray, jckpt.port_torch_state_dict(sd))
    tree = _perturb_offsets(tree, np.random.default_rng(7))
    tree["alpha"] = np.full((1,), 0.5)
    return tree


def inputs():
    rng = np.random.default_rng(3)
    return rng.random((1, 4, H, W, 3)), np.asarray([[0.2, 0.5, 0.875]])


def port_forward(field, params, **kw):
    m = port(field).double()
    tckpt.load_flax_params(m, params)
    x, tt = inputs()
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x), torch.from_numpy(tt), (HH, WW),
                       iters=ITERS, **kw)
    return [g.numpy() for g in got]


def check_forward(field):
    """The field's port forward against motif_tpu's, in float64: frames
    and flows to ATOL, the teacher flows bit for bit."""
    params = params64(field)
    got = port_forward(field, params)
    x, tt = inputs()
    jm = jmodel(field)
    with jax.enable_x64(True):
        want = jax.jit(lambda p, a, t: jm.apply(
            {"params": p}, a, t, (HH, WW), iters=ITERS))(
                params, jnp.asarray(x), jnp.asarray(tt))
    G = FIELDS[field].get("groups", 1)
    assert got[0].shape == (3, 1, HH, WW, 3) and np.isfinite(got[0]).all()
    assert got[1].shape == (2 * 3 * G, HH, WW, 2)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
