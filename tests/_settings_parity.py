"""What tests/test_torch_settings.py and test_torch_settings46.py share:
the cases (settings 2, 3, 4, 6, Ours_7 and setting 2 with the fused
decode), a port model and its float64 flax tree per case, and the forward
held against motif_tpu's in float64 (each case one JAX compile, so the
cases are spread over two files)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from motif_tpu import checkpoint as jckpt
from motif_tpu.models.motif import MoTIF as JMoTIF
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch.models.motif import MoTIF

CH, FRONT, BACK = 16, 1, 2
H = W = 16
HH = WW = 64
ITERS = 2
ATOL = 1e-6
# id: (setting, linear_motion, fused_decode)
# (settings 1 and 2 switch the same properties: s2 stands for both)
CASES = {"s2": (2, False, False),
         "s3": (3, False, False), "s4": (4, False, False),
         "s6": (6, False, False), "ours7": (3, True, False),
         "s2-fused": (2, False, True)}


def _jmodel(setting, linear, fused=False):
    return JMoTIF(setting=setting, channel=CH, front_rbs=FRONT,
                  back_rbs=BACK, linear_motion=linear, fused_decode=fused)


def _port(setting, linear, fused=False):
    return MoTIF(CH, FRONT, BACK, setting=setting, linear_motion=linear,
                 fused_decode=fused)


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


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _params64(setting, linear):
    torch.manual_seed(setting + 10 * linear)
    sd = _port(setting, linear).double().state_dict()
    with jax.enable_x64(True):
        tree = jax.tree.map(np.asarray, jckpt.port_torch_state_dict(sd))
    tree = _perturb_offsets(tree, np.random.default_rng(7))
    tree["alpha"] = np.full((1,), 0.5)
    return tree


def check_forward(case):
    """The case's port forward against motif_tpu's: frames and flows to
    ATOL, the teacher flows bit for bit."""
    setting, linear, fused = CASES[case]
    params = _params64(setting, linear)
    m = _port(setting, linear, fused).double()
    tckpt.load_flax_params(m, params)
    rng = np.random.default_rng(3)
    x = rng.random((1, 4, H, W, 3))
    tt = np.asarray([[0.2, 0.5, 0.875]])
    jm = _jmodel(setting, linear, fused)
    with jax.enable_x64(True):
        want = jax.jit(lambda p, a, t: jm.apply(
            {"params": p}, a, t, (HH, WW), iters=ITERS))(
                params, jnp.asarray(x), jnp.asarray(tt))
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x), torch.from_numpy(tt), (HH, WW),
                       iters=ITERS)
    frames = got[0].numpy()
    assert frames.shape == (3, 1, HH, WW, 3) and np.isfinite(frames).all()
    np.testing.assert_allclose(frames, np.asarray(want[0]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
