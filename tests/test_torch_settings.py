"""The MoTIF settings 1-4 and 6 and the linear-motion Ours_7 against
motif_tpu: the parameter tree of each (the bridge's strict load) and the
forward in float64.

The setting changes three parameters' shapes (the flow-context conv's
fan-in, 4 or 7 channels per target; the synthesis SIREN's fan-in, by the
extras and by warp_to_many's side-by-side directions) and what the forward
does with z, the extras and the directions. Each case is one port model
at channel 16, 1 / 2 residual blocks, random weights from a seed, bridged
to a flax tree (motif_tpu.checkpoint.port_torch_state_dict) with the DCN
offset convs perturbed and alpha = 0.5 (z > 0, so the max splat runs
where predict_Z is on); both packages run LR 16x16 -> HR 64x64, 3 times,
iters 2, in float64, the port on the CPU (plain kernel versions).
Tolerance on frames and flows: atol 1e-6, as tests/test_torch_motif.py
holds setting 5 (the readings are ~1e-16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _settings_parity import (CASES, CH, FRONT, BACK, H, HH, W, WW, _flat,
                              _jmodel, _port, check_forward)
from motif_tpu import checkpoint as jckpt
from motif_tpu.models import factory as jfactory
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch.models import factory
from motif_tpu_torch.models.motif import MoTIF


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", ["s2", "s3", "s4", "s6", "ours7"])
def test_bridge_loads_each_settings_tree_strictly(case):
    """motif_tpu's init tree of the case (its shapes, by jax.eval_shape)
    is the tree the port's parameters bridge to, leaf for leaf and shape
    for shape, and the bridge loads it into the port with strict=True."""
    setting, linear, _ = CASES[case]
    shapes = jax.eval_shape(lambda k: _jmodel(setting, linear).init(
        k, jnp.zeros((1, 4, H, W, 3)), jnp.zeros((1, 3)), (HH, WW),
        iters=1), jax.random.PRNGKey(0))["params"]
    want = {p: tuple(v.shape) for p, v in _flat(shapes)}
    m = _port(setting, linear)
    got = {p: tuple(np.shape(v)) for p, v in _flat(
        jckpt.port_torch_state_dict(m.state_dict()))}
    assert got == want
    zeros = jax.tree.map(lambda v: np.zeros(v.shape, np.float32), shapes)
    tckpt.load_flax_params(m, zeros)
    assert all(float(p.detach().abs().max()) == 0 for p in m.parameters())


@pytest.mark.parametrize("case", ["s2", "s3", "s2-fused"])
def test_forward_matches_motif_tpu(case):
    check_forward(case)


@pytest.mark.parametrize("which,setting", [
    ("Ours", 1), ("Ours", 2), ("Ours", 3), ("Ours", 4), ("Ours", 6),
    ("Ours_ZSM", 6), ("Ours_7", 6), ("Ours_7", 5), ("Ours_4", 3)])
def test_define_g_builds_each_setting_as_motif_tpu(which, setting):
    """The setting (and Ours_7's fixed setting 3 and linear motion) of the
    model each package builds, at nf 16, and the port's parameter shapes
    against motif_tpu's tree for the same `network_G`."""
    net = {"which_model_G": which, "nf": 16, "setting": setting}
    m, jm = factory.define_g(net, device="cpu"), jfactory.define_g(net)
    assert (m.setting, m.linear_motion, m.n_anchors) == (
        jm.setting, jm.linear_motion, jm.n_anchors)
    assert m.setting == (3 if which == "Ours_7" else setting)
    for prop in ("input_Z", "predict_Z", "decoder_Z", "warp_to_many"):
        assert getattr(m, prop) == getattr(jm, prop), prop
    assert m.use_fused is False


def test_fused_decode_is_off_under_warp_to_many():
    """motif.py:423-425: the fold assumes merged directions; the knob
    stays set, the SIRENs take their whole inputs."""
    m = _port(6, False, fused=True)
    assert m.fused_decode and not m.use_fused
    assert not any(net.skip_first_linear
                   for net in (m.flow_imnet, m.imnet, m.synth_net))
    m5 = _port(5, False, fused=True)
    assert m5.use_fused and m5.synth_net.skip_first_linear


def test_ours7_refuses_the_knobs_it_does_not_run():
    m = _port(3, True)
    m.configure(splat_dtype="float16", decode_chunks=2)
    for knob in ({"fused_decode": True}, {"compute_dtype": "bfloat16"},
                 {"raft_resolution": 0.5}):
        with pytest.raises(ValueError, match="Ours_7"):
            m.configure(**knob)
    with pytest.raises(ValueError, match="setting"):
        MoTIF(CH, FRONT, BACK, setting=7)
