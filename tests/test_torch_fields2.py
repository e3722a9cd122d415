"""The MoTIF fields local_ensemble, siren=False and trans against
motif_tpu (groups > 1 and res_liff in test_torch_fields.py), as there:
channel 16, 1 / 2 residual blocks, LR 16x16 -> HR 64x64, 3 times, iters
2, float64, atol 1e-10.

motif_tpu's `trans` raises at any size: it reshapes the weight
generator's (n²B, H, W, G) output to (n², n², B, H, W, G, 1)
(motif_tpu/models/motif.py:387). The port reads the weights as (n, n, B,
...), the shape that gives the rest of the forward its (nB, H, W, ch)
features. So trans is held here in parts: motif_tpu raising; the port's
flow-context arm against the same arm written with motif_tpu's own
layers (Conv2d, LateralBlock, lrelu) at the (n, n) shape on the bridged
parameters; the port's whole forward finite and of its shapes; and its
tree through the bridge both ways."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _fields_parity import (CH, H, HH, W, WW, check_forward, inputs, jmodel,
                            params64, port, port_forward, tree_shapes)
from motif_tpu import checkpoint as jckpt
from motif_tpu.models.layers import Conv2d, LateralBlock, lrelu
from motif_tpu_torch import checkpoint as tckpt


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("field", ["local_ensemble", "conv_synth"])
def test_field_forward_matches_motif_tpu(field):
    check_forward(field)


def test_trans_raises_in_motif_tpu():
    x, tt = inputs()
    with pytest.raises(TypeError, match="cannot reshape"):
        jax.eval_shape(lambda k: jmodel("trans").init(
            k, jnp.asarray(x), jnp.asarray(tt), (HH, WW), iters=1),
            jax.random.PRNGKey(0))


class _TransArm(fnn.Module):
    """motif_tpu's trans arm (motif.py:368-392) with its layers and names,
    the weights read at (n, n, B, ...)."""
    ch: int
    G: int = 1
    n: int = 2

    @fnn.compact
    def __call__(self, ff):
        n, G, ch = self.n, self.G, self.ch
        B = ff.shape[0] // (n * n)
        y = Conv2d(ch // 2, 3, 1, 1, name="flow_process_0")(ff)
        y = Conv2d(ch, 3, 1, 1, name="flow_process_1")(y)
        y = lrelu(y)
        for i in range(3, 8):
            y = LateralBlock(ch, name=f"flow_process_{i}")(y)
        y = lrelu(y)
        ffe = Conv2d(ch, 3, 1, 1, padding_mode="reflect",
                     name="flow_process_9")(y)
        wgt = LateralBlock(ch, name="weight_generator_0")(ffe)
        wgt = lrelu(wgt)
        wgt = Conv2d(G, 3, 1, 1, padding_mode="reflect",
                     name="weight_generator_2")(wgt)
        _, Hh, Ww, _ = ffe.shape
        wgt = jax.nn.softmax(wgt.reshape(n, n, B, Hh, Ww, G, 1), axis=1)
        ffg = ffe.reshape(n, n, B, Hh, Ww, G, -1)
        return (ffg * wgt).sum(1).reshape(n * B, Hh, Ww, -1)


@pytest.mark.parametrize("groups", [1, 2])
def test_trans_arm_matches_motif_tpu_layers(groups):
    """The port's `_trans_context` on seeded flows and reliability maps
    against `_TransArm` on the same bridged parameters, float64."""
    torch.manual_seed(groups)
    m = port("trans", groups=groups).double()
    with jax.enable_x64(True):
        tree = jax.tree.map(np.asarray,
                            jckpt.port_torch_state_dict(m.state_dict()))
    rng = np.random.default_rng(groups)
    B, n = 1, 2
    flow = rng.standard_normal((n * n * B, H, W, 2)) * 3.0
    psies = rng.random((n * n * B, H, W, 3))
    tab = m._shape_tables(H, W, HH, WW, HH, WW, torch.float64, None,
                          torch.device("cpu"))
    with torch.no_grad():
        got = m._trans_context(torch.from_numpy(flow),
                               torch.from_numpy(psies), tab, B, H, W,
                               lambda a: a).numpy()
    rsd = np.asarray([[0, 0], [0, 8], [8, 0], [8, 8]], np.float32) / 8.0
    ff = np.concatenate([flow / 20.0, psies, np.broadcast_to(
        rsd[:, None, None, None], (4, B, H, W, 2)).reshape(4 * B, H, W, 2)],
        -1)
    sub = {k: v for k, v in tree.items()
           if k.startswith(("flow_process", "weight_generator"))}
    with jax.enable_x64(True):
        want = _TransArm(CH, groups).apply({"params": sub}, jnp.asarray(ff))
    assert got.shape == (n * B, H, W, CH)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-12)


def test_trans_forward_and_bridge():
    """The port's trans model: its tree (flow_process_0 at ch / 2 wide from
    7 inputs, weight_generator_0 / _2 at G outputs) bridges both ways, and
    the forward gives finite frames of the request's shape."""
    m = port("trans", groups=2)
    tree = jckpt.port_torch_state_dict(m.state_dict())
    shapes = tree_shapes(tree)
    assert shapes[("flow_process_0", "kernel")] == (3, 3, 7, CH // 2)
    assert shapes[("weight_generator_2", "kernel")] == (3, 3, CH, 2)
    assert ("weight_generator_0", "layers_2", "kernel") in shapes
    m2 = port("trans", groups=2)
    tckpt.load_flax_params(m2, jax.tree.map(np.asarray, tree))
    for a, b in zip(m.parameters(), m2.parameters()):
        assert torch.equal(a, b)
    frames, flow, flow_gt = port_forward("trans", params64("trans"))
    assert frames.shape == (3, 1, HH, WW, 3) and np.isfinite(frames).all()
    assert flow.shape == (6, HH, WW, 2) and np.isfinite(flow).all()
    assert not np.any(flow_gt)
