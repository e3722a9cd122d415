"""The MoTIF fields that no reference config turns on against motif_tpu
(groups > 1 and res_liff here; local_ensemble, siren=False and trans in
test_torch_fields2.py): the parameter tree of each (the bridge's strict
load) and the forward in float64.

Each field is one port model at channel 16, 1 / 2 residual blocks, random
weights from a seed, bridged to a flax tree
(motif_tpu.checkpoint.port_torch_state_dict) with the DCN offset convs
perturbed and alpha = 0.5; both packages run LR 16x16 -> HR 64x64, 3
times, iters 2, in float64, the port on the CPU (plain kernel versions).
Tolerance on frames and flows: atol 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _fields_parity import (FIELDS, HH, WW, check_forward, inputs, jmodel,
                            jshapes, params64, port, tree_shapes)
from motif_tpu import checkpoint as jckpt
from motif_tpu_torch import checkpoint as tckpt


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("field", ["groups2", "res_liff", "local_ensemble",
                                   "conv_synth"])
def test_bridge_loads_each_fields_tree_strictly(field):
    """motif_tpu's init tree of the field (its shapes, by jax.eval_shape)
    is the tree the port's parameters bridge to, leaf for leaf and shape
    for shape, and the bridge loads it into the port with strict=True."""
    shapes = jshapes(field)
    m = port(field)
    assert tree_shapes(jckpt.port_torch_state_dict(m.state_dict())) == \
        tree_shapes(shapes)
    zeros = jax.tree.map(lambda v: np.zeros(v.shape, np.float32), shapes)
    tckpt.load_flax_params(m, zeros)
    assert all(float(p.detach().abs().max()) == 0 for p in m.parameters())


@pytest.mark.parametrize("field", ["groups2", "res_liff"])
def test_field_forward_matches_motif_tpu(field):
    check_forward(field)


def test_groups_with_fused_decode_or_warp_to_many_raise_in_both():
    """groups > 1 with fused_decode, or at setting 6 (warp_to_many),
    raises NotImplementedError in both packages (tests/test_motif.py:85)."""
    params = params64("groups2")
    x, tt = inputs()
    with pytest.raises(NotImplementedError):
        jmodel("groups2", fused_decode=True).apply(
            {"params": params}, jnp.asarray(x, jnp.float32),
            jnp.asarray(tt, jnp.float32), (HH, WW), iters=1)
    for kw in ({"fused_decode": True}, {"setting": 6}):
        m = port("groups2", **kw)
        with pytest.raises(NotImplementedError), torch.no_grad():
            m(torch.from_numpy(x).float(), torch.from_numpy(tt).float(),
              (HH, WW), iters=1)


def test_fields_turn_the_fused_decode_off():
    """As in the JAX package, fused_decode folds no SIREN layer when a
    field is on (res_liff, local_ensemble, siren=False), and a field
    leaves the plain model's parameters as they were."""
    for field in ("res_liff", "local_ensemble", "conv_synth"):
        m = port(field, fused_decode=True)
        assert m.fused_decode and not m.use_fused
        assert not m.flow_imnet.skip_first_linear
    base = set(port("groups2").state_dict()) - {"flow_imnet.net.3.weight",
                                                "flow_imnet.net.3.bias"}
    assert base <= set(port("res_liff").state_dict())
    assert port("groups2").flow_imnet.net[3].weight.shape == (6, 256)


def test_linear_motion_takes_no_field():
    from motif_tpu_torch.models.motif import MoTIF

    for kw in FIELDS.values():
        with pytest.raises(ValueError):
            MoTIF(16, 1, 2, setting=3, linear_motion=True, **kw)
