"""The port's eval harness on the baselines against motif_tpu's: for each
family (LIIF, ZSM, TMNet, EDVR, Super_SloMo) `Evaluator.infer` as
tests/test_eval_dispatch.py sets it up, a reference-named `.pth` that loads
strictly and gives motif_tpu's frames, `define_g` on the family's
configs/test_vid4_*.yml, and the CLI over that yml (cut to nf 16, 1 / 1
residual blocks) on one data/Vid4 clip against motif_tpu's Evaluator.run.

One flax init per family at nf 16 (EDVR at 2 frames, as its yml; every
conv_offset_mask perturbed so the DCN offsets are real) is bridged into the
port. Both packages run in float64, the port on the CPU (plain kernel
versions); the JAX Evaluator pads into float32, so its module's numpy is
swapped for one whose float32 is float64 (motif_tpu itself is unchanged),
and the CLI's model is made float64 where define_g builds it. Tolerance on
the frames and every metric: 1e-9.
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
from motif_tpu.data import pipeline as jpipeline
from motif_tpu.models import factory as jfactory
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch import test as tcli
from motif_tpu_torch.eval import Evaluator
from motif_tpu_torch.models import baselines as tb
from motif_tpu_torch.models import factory
from motif_tpu_torch.models.videoinr import VideoINR
from motif_tpu_torch.utils import config

ROOT = pathlib.Path(__file__).resolve().parents[1]
VID4 = ROOT / "data" / "Vid4"
TOL = 1e-9
NF = 16
# family: its yml, its class in the port, the LQ frames it takes
FAMILIES = {"LIIF": ("liif", VideoINR, 2), "ZSM": ("zsm", tb.ZSM, 2),
            "TMNet": ("tmnet", tb.TMNet, 2), "EDVR": ("edvr", tb.EDVR, 2),
            "Super_SloMo": ("superslomo", tb.SuperSloMo, 2)}
CUT = {"nf": NF, "front_RBs": 1, "back_RBs": 1}
LQ_HW, OUT_HW = (16, 24), (64, 96)      # the Vid4 clips' LR and HR


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU forwards here are many small ops: one thread runs them
    as fast and does not contend with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _yml(family):
    return ROOT / "configs" / f"test_vid4_{FAMILIES[family][0]}.yml"


def _network_g(family, **extra):
    return config.parse(str(_yml(family)), is_train=False)["network_G"] \
        | extra


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


def _init_args(family, n_in):
    """Init inputs as motif_tpu's test.py::_init_params traces them."""
    x0 = jnp.zeros((1, n_in, *LQ_HW, 3), jnp.float32)
    if family == "LIIF":
        return x0, jnp.zeros((1, 2), jnp.float32), OUT_HW
    if family == "TMNet":
        return x0, jnp.full((1, 1), 0.5, jnp.float32)
    if family == "Super_SloMo":
        return x0, 2
    return (x0,)


def _np64():
    np64 = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                    if not k.startswith("__")})
    np64.float32 = np.float64
    return np64


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """(family, the JAX model of its cut yml, float64 params, motif_tpu's
    Evaluator in float64) — one JAX compile per family serves every test."""
    name = request.param
    net = _network_g(name, **CUT)
    jm = jfactory.define_g(net)
    n_in = FAMILIES[name][2]
    params = jax.jit(lambda k: jm.init(k, *_init_args(name, n_in)))(
        jax.random.PRNGKey(0))["params"]
    params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    params = _perturb_offsets(params, np.random.default_rng(7))
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jeval, "np", _np64())
        yield name, net, params, jeval.Evaluator(
            jm, params, iters=4, chunk=factory.EVAL_CHUNK.get(name, 3),
            family=name)


def _inputs(n_in):
    rng = np.random.default_rng(0)
    lq = rng.random((1, n_in, *LQ_HW, 3))
    return lq, np.linspace(0, 1, 3)[None]


@pytest.fixture(scope="module")
def jax_frames(family):
    name, _, _, jev = family
    lq, times = _inputs(FAMILIES[name][2])
    with jax.enable_x64(True):
        frames, stats = jev.infer(lq, times, OUT_HW)
    assert stats is None
    return frames


def _port(net, params):
    m = factory.build_baseline(net, device="cpu").double()
    tckpt.load_flax_params(m, params)
    return m


def _port_infer(name, model):
    lq, times = _inputs(FAMILIES[name][2])
    frames, stats = Evaluator(model, iters=4, family=name,
                              device="cpu").infer(lq, times, OUT_HW)
    assert stats is None and frames.dtype == np.float64
    return frames


def test_infer_matches_motif_tpu(family, jax_frames):
    """Evaluator.infer: 2 LQ frames 16x24 → 3 times at 64x96, each family
    called its own way (LIIF's list stacked, EDVR's centre frame repeated,
    Super-SloMo on the end frames with factor 2, TMNet on the interior
    time, ZSM without times)."""
    name, net, params, _ = family
    got = _port_infer(name, _port(net, params))
    assert got.shape == jax_frames.shape == (3, 1, *OUT_HW, 3)
    np.testing.assert_allclose(got, jax_frames, rtol=0, atol=TOL)
    if name == "EDVR":
        np.testing.assert_array_equal(got[0], got[2])


def _reference_pth(path, state_dict):
    """A state dict as the reference saves one: DataParallel's module.
    prefix in a {"state_dict": ...} wrapper."""
    torch.save({"state_dict": {f"module.{k}": v
                               for k, v in state_dict.items()}}, path)
    return path


def test_reference_pth_loads_strictly_and_gives_motif_tpu_frames(
        family, jax_frames, tmp_path):
    """The port's reference-named state dict as a `.pth`: loaded strictly
    into a fresh model (every key present, none extra) it gives motif_tpu's
    frames, and motif_tpu's own loader reads the same parameters from it."""
    name, net, params, _ = family
    sd = _port(net, params).state_dict()
    pth = _reference_pth(tmp_path / "best.pth", sd)
    m = factory.build_baseline(net, device="cpu").double()
    tckpt.load_reference_checkpoint(m, str(pth))
    for k, v in m.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with jax.enable_x64(True):
        loaded = jckpt.load_params(str(pth), params)
    assert not jckpt.verify_port(params, jckpt.load_reference_checkpoint(
        str(pth)))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), b), loaded, params)
    np.testing.assert_allclose(_port_infer(name, m), jax_frames, rtol=0,
                               atol=TOL)
    sd.pop(next(iter(sd)))
    with pytest.raises(RuntimeError, match="Missing key"):
        tckpt.load_reference_checkpoint(m, str(_reference_pth(
            tmp_path / "short.pth", sd)))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_define_g_builds_the_yml(name):
    """define_g on the family's yml at its full width: the port's class,
    the yml's depth, and every parameter where motif_tpu's define_g puts
    it, with its shape (its init traced, not run)."""
    net = _network_g(name)
    m = factory.define_g(net, device="cpu")
    assert type(m) is FAMILIES[name][1]
    assert not m.training and next(m.parameters()).dtype == torch.float32
    if name != "Super_SloMo":
        trunk = "reconstruction" if name == "EDVR" else "recon_trunk"
        assert len(getattr(m, trunk)) == net["back_RBs"] == 40
        assert len(m.feature_extraction) == net["front_RBs"] == 5
        assert m.conv_first.weight.shape[0] == net["nf"]
    jm = jfactory.define_g(net)
    shapes = jax.eval_shape(lambda k: jm.init(k, *_init_args(
        name, FAMILIES[name][2])), jax.random.PRNGKey(0))["params"]
    sd = m.state_dict()
    got = tckpt.state_dict_from_flax(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes),
        sd.keys())
    assert all(got[k].shape == v.shape for k, v in sd.items())
    n_leaves = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert n_leaves == sum(v.numel() for v in sd.values())


def test_cli_matches_motif_tpu_run(family, tmp_path, monkeypatch):
    """`python -m motif_tpu_torch.test` over the family's yml cut to nf 16
    and 1 / 1 blocks, on the first Vid4 clip, from a reference `.pth` of
    the shared parameters, its model made float64; against motif_tpu's
    Evaluator.run on the same clip. Summary and per-frame PSNR / SSIM
    files to 1e-9; no flow statistics for a baseline."""
    name, net, params, jev = family
    text, full = _yml(name).read_text(), _network_g(name)
    for key, v in CUT.items():
        old = f"  {key}: {full[key]}\n"
        assert old in text, old
        text = text.replace(old, f"  {key}: {v}\n")
    yml = tmp_path / f"{name}.yml"
    yml.write_text(text)
    pth = _reference_pth(tmp_path / "w.pth", _port(net, params).state_dict())
    build = factory.define_g
    monkeypatch.setattr(factory, "define_g",
                        lambda opt, device=None: build(opt, device).double())
    monkeypatch.chdir(tmp_path)
    ds = dict(config.parse(str(yml), is_train=False)["datasets"]["train"],
              dataroot_GT=str(VID4 / "HR"), dataroot_LQ=str(VID4 / "LR"))
    s = tcli.main(["-opt", str(yml), "--device", "cpu", "--max_clips", "1",
                   "--checkpoint", str(pth)],
                  overrides={k: ds[k] for k in ("dataroot_GT",
                                                "dataroot_LQ")})
    stem = config.parse(str(yml), is_train=False)["name"]
    loader = jpipeline.BatchLoader(jdatasets.create_dataset(ds))
    with jax.enable_x64(True):
        want = jev.run([next(loader.epoch(0))])
    w = want.summary()
    assert "flow_err" not in s and set(s) == set(w) and s["n_clips"] == 1
    for k in s:
        assert s[k] == pytest.approx(w[k], rel=0, abs=TOL), k
    for suffix, ref in (("", want.psnrs_all), ("_ssim", want.ssim_all)):
        got = np.load(tmp_path / "psnrs" / f"{stem}{suffix}.npy",
                      allow_pickle=True)
        np.testing.assert_allclose(got.astype(np.float64),
                                   np.asarray(ref, np.float64), rtol=0,
                                   atol=TOL)
