"""The four-anchor MoTIF (Ours_44 / Ours_4) of the port against motif_tpu's
MoTIF(n_anchors=4): the weight bridge and the strict .pth load of its
tree, the forward with live RAFT, on precomputed flows and with the fused
decode, Evaluator.infer with family Ours_44, and the eval CLI over
configs/test_vimeo44.yml against motif_tpu's Evaluator.run.

One flax init of MoTIF(setting=5, n_anchors=4, channel=16, front_rbs=1,
back_rbs=2) is bridged into the port with conv_offset_mask perturbed (the
DCN offsets are not the zeros of init). Both packages run LR 16x16 → HR
64x64 in float64, the port on the CPU (plain kernel versions). The times
put round(t·6) on odd and even frames of the encoder's 7 and on a half
that rounds to even (0.75·6 = 4.5 → 4), the last included.
Tolerance on frames and flows: atol 1e-6, as for the two-anchor slice
(the readings are ~3e-16).
"""

import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motif_tpu import checkpoint as jckpt
from motif_tpu import eval as jeval
from motif_tpu.data import datasets as jdatasets
from motif_tpu.models import factory as jfactory
from motif_tpu.models.motif import MoTIF as JMoTIF
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch import test as tcli
from motif_tpu_torch.data import BatchLoader, create_dataset, read_img
from motif_tpu_torch.data.datasets import SEPTUPLET_LQ
from motif_tpu_torch.eval import Evaluator
from motif_tpu_torch.models import factory
from motif_tpu_torch.models.motif import MoTIF, build_motif
from motif_tpu_torch.utils import config

ROOT = pathlib.Path(__file__).resolve().parents[1]
VID4 = ROOT / "data" / "Vid4"
CH, FRONT, BACK = 16, 1, 2
B, H, W = 1, 16, 16
HH = WW = 64
N = 4
ITERS = 1
ATOL = 1e-6
TIMES = np.asarray([[0.1, 0.25, 0.75, 1.0]])      # round(t·6): 1, 2, 4, 6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmodel(**kw):
    return JMoTIF(setting=5, channel=CH, front_rbs=FRONT, back_rbs=BACK,
                  n_anchors=4, **kw)


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


@pytest.fixture(scope="module")
def init_tree():
    params = jax.jit(lambda k: _jmodel().init(
        k, jnp.zeros((1, 4, H, W, 3), jnp.float32),
        jnp.zeros((1, N), jnp.float32), (HH, WW), iters=1))(
            jax.random.PRNGKey(0))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def params64(init_tree):
    tree = jax.tree.map(lambda a: np.asarray(a, np.float64), init_tree)
    return _perturb_offsets(tree, np.random.default_rng(7))


def _port(params, **knobs):
    m = MoTIF(CH, FRONT, BACK, n_anchors=4, **knobs).double()
    tckpt.load_flax_params(m, params)
    return m.eval()


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.random((B, 4, H, W, 3))
    lr_flow = rng.standard_normal((B, 16, H, W, 2)) * 2.0
    flow_gt = rng.standard_normal((B, N, 4, HH, WW, 2)) * 3.0
    return x, lr_flow, flow_gt


def test_bridge_round_trip_is_identity(init_tree):
    """flax → port state_dict → motif_tpu.checkpoint.port_torch_state_dict
    gives back the n = 4 tree; the port loads it with strict=True, and its
    parameter set is the two-anchor model's (flow_process.0: 4 groups of
    7 inputs)."""
    m = MoTIF(CH, FRONT, BACK, n_anchors=4)
    sd = tckpt.state_dict_from_flax(init_tree, m.state_dict().keys())
    m.load_state_dict(sd, strict=True)
    back = jckpt.port_torch_state_dict(m.state_dict())
    want = dict(_flat(init_tree))
    got = dict(_flat(jax.tree.map(np.asarray, back)))
    assert set(got) == set(want)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a, err_msg="/".join(path))
    conv = m.flow_process[0]
    assert conv.weight.shape == (CH, 7, 3, 3) and conv.groups == 4
    assert set(m.state_dict()) == set(MoTIF(CH, FRONT, BACK).state_dict())


def test_reference_pth_loads_strictly(params64, init_tree, tmp_path):
    """A reference-format .pth of the n = 4 tree (module. prefix, g_filter,
    RAFT's norm3 alias, a batch-norm counter) loads into the port strictly,
    and motif_tpu reads the same file back to the same tree."""
    sd = _port(params64).state_dict()
    ref = {f"module.{k}": v for k, v in sd.items()}
    ref["module.g_filter.weight"] = torch.ones(3, 1, 5, 5)
    ref["module.flow_predictor.fnet.norm1.num_batches_tracked"] = \
        torch.tensor(3)
    ref["module.flow_predictor.fnet.layer1.0.norm3.weight"] = torch.ones(8)
    pth = tmp_path / "best44.pth"
    torch.save({"state_dict": ref}, pth)
    m = MoTIF(CH, FRONT, BACK, n_anchors=4).double()
    tckpt.load_reference_checkpoint(m, str(pth))
    for k, v in m.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with jax.enable_x64(True):
        loaded = jckpt.load_params(str(pth), init_tree)
    for path, a in _flat(jax.tree.map(np.asarray, loaded)):
        want = params64
        for p in path:
            want = want[p]
        np.testing.assert_array_equal(a, want, err_msg="/".join(path))


CASES = {
    # live RAFT on the 12 cross pairs, no teacher
    "raft": (dict(), dict()),
    # the dataset's flows in place of RAFT and of the teacher, splatting
    # with the teacher flow
    "flows": (dict(), dict(flows=True, train=True, use_gt=True)),
    # only the LR flows precomputed, the predicted flow splatted
    "lr_flow": (dict(), dict(flows="lr")),
    "fused_decode": (dict(fused_decode=True), dict()),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_motif_tpu(params64, case):
    knobs, call = CASES[case]
    x, lr_flow, flow_gt = _inputs()
    flows = {True: (lr_flow, flow_gt), "lr": (lr_flow, None)}.get(
        call.get("flows"))
    kw = dict(iters=ITERS, train=call.get("train", False),
              use_gt=call.get("use_gt", False))
    with jax.enable_x64(True):
        jflows = None if flows is None else tuple(
            None if f is None else jnp.asarray(f) for f in flows)
        want = jax.jit(lambda p, a, t, f: _jmodel(**knobs).apply(
            {"params": p}, a, t, (HH, WW), flows=f, **kw))(
                params64, jnp.asarray(x), jnp.asarray(TIMES), jflows)
    model = _port(params64, **knobs)
    calls = []
    model.flow_predictor.register_forward_hook(lambda *a: calls.append(1))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(TIMES), (HH, WW),
                    flows=None if flows is None else tuple(
                        None if f is None else torch.from_numpy(f)
                        for f in flows), **kw)
    assert len(calls) == (0 if flows is not None else 1)
    frames = got[0].numpy()
    assert frames.shape == (N, B, HH, WW, 3) and np.isfinite(frames).all()
    assert got[1].shape == (4 * B * N, HH, WW, 2)
    np.testing.assert_allclose(frames, np.asarray(want[0]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0,
                               atol=ATOL)
    if call.get("flows") is True:           # the teacher is the dataset's
        assert np.abs(got[2].numpy()).max() > 0


def test_residual_is_the_encoder_frame_at_round_t6(params64):
    """The synthesis net's residual rows read feat_t[:, round(t·6)] per
    time, rounding half to even: swapping the encoder output's frames 1
    and 5 (fused frames, which no anchor reads) moves the time at 0.1 (0.6
    → 1) and no other; 0.75 (4.5) rounds to 4, not 5."""
    model = _port(params64)
    x, _, _ = _inputs()
    seen = []
    h = model.synth_net.register_forward_hook(
        lambda mod, inp, out: seen.append(inp[0].clone()))
    enc = model.encoder.forward

    def swapped(a):
        out = enc(a)
        return out[:, [0, 5, 2, 3, 4, 1, 6]]
    with torch.no_grad():
        model(torch.from_numpy(x), torch.from_numpy(TIMES), (HH, WW),
              iters=ITERS)
        model.encoder.forward = swapped
        model(torch.from_numpy(x), torch.from_numpy(TIMES), (HH, WW),
              iters=ITERS)
    h.remove()
    off = 64 + 2 + CH + 3    # [output (q_feat_o | flow | q_feat) | extra |
    res = slice(off, off + CH)          # residual | t]
    a, b = (s.reshape(N, HH * WW, -1)[..., res] for s in seen)
    assert not torch.equal(a[0], b[0])
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]) \
        and torch.equal(a[3], b[3])


def test_evaluator_infer_matches_motif_tpu(params64, monkeypatch):
    """family Ours_44: one time a forward (chunk 1) in both packages, a
    non-/4 LQ (15x14 → padded 16x16) with 3 times."""
    np64 = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                    if not k.startswith("__")})
    np64.float32 = np.float64
    monkeypatch.setattr(jeval, "np", np64)
    rng = np.random.default_rng(5)
    lq = rng.random((1, 4, 15, 14, 3))
    times = np.asarray([[1 / 6, 0.5, 5 / 6]])
    with jax.enable_x64(True):
        jev = jeval.Evaluator(_jmodel(), params64, iters=ITERS,
                              family="Ours_44")
        want, want_stats = jev.infer(lq, times, (60, 56))
    ev = Evaluator(_port(params64), iters=ITERS, family="Ours_44",
                   device="cpu")
    assert (ev.family, ev.chunk) == (jev.family, jev.chunk) == ("Ours_44", 1)
    got, got_stats = ev.infer(lq, times, (60, 56))
    assert got.shape == (3, 1, 60, 56, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_stats, want_stats, rtol=0, atol=ATOL)


@pytest.mark.parametrize("which", ["Ours_44", "Ours_4"])
def test_define_g_builds_four_anchors_as_motif_tpu(which):
    net = config.parse(str(ROOT / "configs" / "test_vimeo44.yml"),
                       is_train=False)["network_G"] | {"nf": 16,
                                                       "which_model_G": which}
    m, jm = factory.define_g(net, device="cpu"), jfactory.define_g(net)
    assert m.n_anchors == jm.n_anchors == 4
    assert m.positions == (0.0, 2.0, 4.0, 6.0)
    assert factory.define_g(net | {"which_model_G": "Ours"},
                            device="cpu").n_anchors == 2


def test_septuplet_lq_of_vimeo_test_44():
    """Vimeo_test_44 (ref_num 2) gives the window's two end frames as LQ;
    `lq_index=SEPTUPLET_LQ` gives its frames 0, 2, 4, 6 read from the LR
    root, the rest of each item as motif_tpu's."""
    opt = {"mode": "Vimeo_test_44", "dataroot_GT": str(VID4 / "HR"),
           "dataroot_LQ": str(VID4 / "LR"), "ref_num": 2}
    got = create_dataset(opt, lq_index=SEPTUPLET_LQ)
    want = jdatasets.create_dataset(opt)
    assert len(got) == len(want) == 4
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert g["key"] == w["key"]
        for k in ("gt", "times"):
            np.testing.assert_array_equal(g[k], w[k])
        np.testing.assert_array_equal(g["lq"][[0, 3]], w["lq"])
        files = [got.gt_list[i][j] for j in SEPTUPLET_LQ]
        np.testing.assert_array_equal(g["lq"], np.stack(
            [read_img(str(VID4 / "LR" / f)) for f in files]))
        assert g["lq"].shape == (4, 16, 24, 3)
        assert g["times"].shape == (7,)


def test_cli_over_test_vimeo44_matches_motif_tpu_run(tmp_path, monkeypatch):
    """`main` over configs/test_vimeo44.yml at nf 16 (full depth) on one
    Vid4 clip from a reference .pth (DCN offsets perturbed), its model made
    float64: the four-anchor model on the septuplet LQ, 7 times one at a
    time, against motif_tpu's Evaluator.run in float64 with the same
    weights on the same items (motif_tpu's own Vimeo_test_44 items have two
    LQ frames, which its four-anchor MoTIF refuses). Tolerance on every
    metric: 1e-9, as for the two-anchor CLI."""
    yml = tmp_path / "vimeo44_16.yml"
    text = (ROOT / "configs" / "test_vimeo44.yml").read_text()
    assert "nf: 64\n" in text and "name: vimeo44\n" in text
    yml.write_text(text.replace("nf: 64\n", "nf: 16\n"))
    model = build_motif(16, device="cpu", seed=3, n_anchors=4)
    rng = np.random.default_rng(11)
    sd = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
              np.float32) * (0.05 if k.endswith("weight") else 1.5))
          if "conv_offset_mask" in k else v
          for k, v in model.state_dict().items()}
    pth = tmp_path / "w44.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, pth)
    define_g = factory.define_g
    monkeypatch.setattr(factory, "define_g",
                        lambda *a, **kw: define_g(*a, **kw).double())
    monkeypatch.chdir(tmp_path)
    roots = {"dataroot_GT": str(VID4 / "HR"), "dataroot_LQ": str(VID4 / "LR")}
    s = tcli.main(["-opt", str(yml), "--device", "cpu", "--max_clips", "1",
                   "--checkpoint", str(pth)], overrides=roots)

    net = config.parse(str(yml), is_train=False)["network_G"]
    params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                          jckpt.port_torch_state_dict(sd))
    ds = create_dataset({"mode": "Vimeo_test_44", "ref_num": 2, **roots},
                        lq_index=SEPTUPLET_LQ)
    np64 = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                    if not k.startswith("__")})
    np64.float32 = np.float64
    monkeypatch.setattr(jeval, "np", np64)
    with jax.enable_x64(True):
        jev = jeval.Evaluator(jfactory.define_g(net), params, iters=4,
                              family="Ours_44")
        want = jev.run([next(BatchLoader(ds).epoch(0))])
    w = want.summary()
    assert s["n_clips"] == w["n_clips"] == 1 and set(s) == set(w)
    for k in s:
        assert np.isfinite(s[k])
        assert s[k] == pytest.approx(w[k], rel=0, abs=1e-9), k
    psnrs = np.load(tmp_path / "psnrs" / "vimeo44.npy", allow_pickle=True)
    ssims = np.load(tmp_path / "psnrs" / "vimeo44_ssim.npy", allow_pickle=True)
    assert psnrs.shape == ssims.shape == (1, 7)
    np.testing.assert_allclose(psnrs.astype(np.float64),
                               np.asarray(want.psnrs_all), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ssims.astype(np.float64),
                               np.asarray(want.ssim_all), rtol=0, atol=1e-9)
