"""The port's eval harness against motif_tpu's: Evaluator.run over the four
data/Vid4 clips (Adobe_test_3: LR 16x24 → HR 64x96, 3 times), the family
dispatch, the reference .pth loader, define_g and the CLI.

One flax init of MoTIF(setting=5, channel=16, front_rbs=1, back_rbs=2) is
bridged into the port with conv_offset_mask perturbed (the DCN offsets are
not the zeros of init). Both packages run it in float64, the port on the
CPU (plain kernel versions); the JAX Evaluator pads into float32, so its
module's numpy is swapped for one whose float32 is float64 (motif_tpu
itself is unchanged). Tolerance on every metric: 1e-9 (both sides compute
the same float64 formulas; the frames agree to ~1e-12).
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
from motif_tpu.models.motif import MoTIF as JMoTIF
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch import test as tcli
from motif_tpu_torch.data import BatchLoader, create_dataset
from motif_tpu_torch.eval import EvalResults, Evaluator, resolve_family
from motif_tpu_torch.models import factory
from motif_tpu_torch.models.motif import MoTIF, build_motif
from motif_tpu_torch.utils import config

ROOT = pathlib.Path(__file__).resolve().parents[1]
VID4 = ROOT / "data" / "Vid4"
DATASET = {"mode": "Adobe_test_3", "dataroot_GT": str(VID4 / "HR"),
           "dataroot_LQ": str(VID4 / "LR"), "ref_num": 4}
CH, FRONT, BACK = 16, 1, 2
ITERS = 2
TOL = 1e-9
FRAME_ATOL = 1e-6
LISTS = ("psnr", "psnr_anchor", "psnr_inter", "psnr_center", "ssim", "l1",
         "flows", "flows_0", "psnrs_all", "ssim_all")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU forwards here are thousands of small ops: one thread
    each runs as fast alone and does not contend with the other test
    workers' threads."""
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


def _jmodel():
    return JMoTIF(setting=5, channel=CH, front_rbs=FRONT, back_rbs=BACK)


@pytest.fixture(scope="module")
def init_tree():
    params = jax.jit(lambda k: _jmodel().init(
        k, jnp.zeros((1, 4, 16, 16, 3), jnp.float32),
        jnp.zeros((1, 3), jnp.float32), (64, 64), iters=1))(
            jax.random.PRNGKey(0))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def params64(init_tree):
    tree = jax.tree.map(lambda a: np.asarray(a, np.float64), init_tree)
    return _perturb_offsets(tree, np.random.default_rng(7))


def _port(params):
    m = MoTIF(CH, FRONT, BACK).double()
    tckpt.load_flax_params(m, params)
    return m.eval()


@pytest.fixture(scope="module")
def jax_evaluator(params64):
    """motif_tpu's Evaluator in float64 (its numpy's float32 swapped while
    the fixture lives)."""
    np64 = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                    if not k.startswith("__")})
    np64.float32 = np.float64
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jeval, "np", np64)
        yield jeval.Evaluator(_jmodel(), params64, iters=ITERS)


@pytest.fixture(scope="module")
def runs(jax_evaluator, params64, tmp_path_factory):
    """Evaluator.run of both packages over the Vid4 clips, each writing its
    .npy files to a directory of its own."""
    jdir, tdir = (tmp_path_factory.mktemp(n) for n in ("jax", "port"))
    jloader = jpipeline.BatchLoader(jdatasets.create_dataset(DATASET))
    want = jax_evaluator.run(jloader.epoch(0), save_psnr_dir=str(jdir),
                             name="vid4")
    tloader = BatchLoader(create_dataset(DATASET))
    got = Evaluator(_port(params64), iters=ITERS, device="cpu").run(
        tloader.epoch(0), save_psnr_dir=str(tdir), name="vid4")
    return got, want, tdir, jdir


@pytest.mark.parametrize("name", LISTS)
def test_run_matches_motif_tpu(runs, name):
    got, want, _, _ = runs
    g, w = getattr(got, name), getattr(want, name)
    assert len(g) == len(w) == 4
    np.testing.assert_allclose(np.asarray(g, np.float64),
                               np.asarray(w, np.float64), rtol=0, atol=TOL)


def test_summary_matches_motif_tpu(runs):
    got, want, _, _ = runs
    s, w = got.summary(), want.summary()
    assert set(s) == set(w) and s["n_clips"] == w["n_clips"] == 4
    for k in s:
        assert np.isfinite(s[k])
        assert s[k] == pytest.approx(w[k], rel=0, abs=TOL), k


@pytest.mark.parametrize("suffix", ["", "_ssim"], ids=["psnrs", "ssims"])
def test_run_writes_the_same_npy_files(runs, suffix):
    _, _, tdir, jdir = runs
    g = np.load(tdir / f"vid4{suffix}.npy", allow_pickle=True)
    w = np.load(jdir / f"vid4{suffix}.npy", allow_pickle=True)
    assert g.dtype == w.dtype == object and g.shape == w.shape == (4, 3)
    np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                               rtol=0, atol=TOL)


FAMILIES = ["Ours", "Ours_7", "Ours_flow", "Ours_back", "Ours_44", "Ours_4",
            "LIIF", "EDVR", "ZSM", "Zooming", "TMNet", "Super_SloMo", "VSR"]


@pytest.mark.parametrize("family", FAMILIES)
def test_family_dispatch_matches_motif_tpu(family):
    """Every Ours_* but the 4-anchor pair is Ours; Ours_44 / Ours_4 take
    one time a forward; the baselines are themselves and take every time in
    one call; an unknown family raises. The family never reaches the model
    as a serving knob."""
    jev = jeval.Evaluator(None, None, chunk=3, family=family)
    assert resolve_family(family, 3) == (jev.family, jev.chunk)
    four = family in factory.FOUR_ANCHOR
    m = build_motif(CH, FRONT, BACK, device="cpu", decode_chunks=2,
                    n_anchors=4 if four else 2)
    knobs = m.knobs()
    if family == "VSR":
        with pytest.raises(NotImplementedError, match="not known"):
            Evaluator(m, family=family, device="cpu")
    else:
        ev = Evaluator(m, family=family, device="cpu")
        assert (ev.family, ev.chunk) == (jev.family, jev.chunk)
        assert ev.chunked == jev._chunked
        if ev.chunked:
            assert ev.chunk == (1 if four else 3)
    assert m.knobs() == knobs


def _reference_pth(path, state_dict, wrap=True):
    """A state dict as the reference saves one: DataParallel's module.
    prefix, the fixed blur, a batch-norm counter and RAFT's norm3 alias,
    in a {"state_dict": ...} wrapper."""
    sd = {f"module.{k}": v for k, v in state_dict.items()}
    sd["module.g_filter.weight"] = torch.ones(3, 1, 5, 5)
    sd["module.flow_predictor.fnet.norm1.num_batches_tracked"] = torch.tensor(3)
    sd["module.flow_predictor.fnet.layer1.0.norm3.weight"] = torch.ones(8)
    torch.save({"state_dict": sd} if wrap else sd, path)
    return path


def test_reference_pth_loads_strictly_and_gives_motif_tpu_frames(
        params64, init_tree, jax_evaluator, tmp_path):
    sd = _port(params64).state_dict()
    pth = _reference_pth(tmp_path / "best.pth", sd)
    m = MoTIF(CH, FRONT, BACK).double()
    tckpt.load_reference_checkpoint(m, str(pth))
    for k, v in m.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with jax.enable_x64(True):
        loaded = jckpt.load_params(str(pth), init_tree)
    item = create_dataset(DATASET)[1]
    lq, times = item["lq"][None], item["times"][None]
    saved, jax_evaluator.params = jax_evaluator.params, loaded
    try:
        with jax.enable_x64(True):
            want, want_stats = jax_evaluator.infer(lq, times, (64, 96))
    finally:
        jax_evaluator.params = saved
    got, got_stats = Evaluator(m.eval(), iters=ITERS, device="cpu").infer(
        lq, times, (64, 96))
    assert got.shape == (3, 1, 64, 96, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=FRAME_ATOL)
    np.testing.assert_allclose(got_stats, want_stats, rtol=0, atol=FRAME_ATOL)


def test_reference_pth_names_missing_and_unexpected_keys(tmp_path):
    m = build_motif(CH, FRONT, BACK, device="cpu")
    sd = dict(m.state_dict())
    sd.pop("alpha")
    sd["extra_head.weight"] = torch.zeros(2)
    pth = _reference_pth(tmp_path / "w.pth", sd, wrap=False)
    with pytest.raises(RuntimeError, match="alpha") as e:
        tckpt.load_reference_checkpoint(m, str(pth))
    assert "extra_head.weight" in str(e.value)
    with pytest.raises(NotImplementedError, match="load_checkpoint"):
        tckpt.load_reference_checkpoint(m, str(tmp_path))


def _network_g(**extra):
    return config.parse(str(ROOT / "test.yml"), is_train=False)["network_G"] \
        | extra


def test_define_g_keeps_the_trunk_depth_whatever_the_yml_says():
    m = factory.define_g(_network_g(back_RBs=2, front_RBs=1, groups=4),
                         device="cpu")
    assert len(m.encoder.recon_trunk) == 40
    assert len(m.encoder.feature_extraction) == 5
    assert m.channel == 64
    assert m.knobs() == build_motif(16, device="cpu").knobs()


def test_define_g_reads_the_serving_knobs_as_motif_tpu():
    net = _network_g(nf=16, fused_decode=True, compute_dtype="bfloat16",
                     splat_dtype="float16", raft_resolution=0.5,
                     decode_chunks=3, splat_method="base")
    m, jm = factory.define_g(net, device="cpu"), jfactory.define_g(net)
    assert m.channel == jm.channel == 16
    assert m.knobs() == {k: getattr(jm, k) for k in m.knobs()}


@pytest.mark.parametrize("which,setting,want", [
    ("Ours", 3, None), ("Ours_44", 3, None), ("Ours_4", 6, None),
    ("Ours_7", 5, None), ("Ours_flow", 5, None), ("LIIF", 3, None),
    ("ZSM", 3, None), ("Zooming", 3, None), ("TMNet", 3, None),
    ("EDVR", 3, None), ("Super_SloMo", 3, None), ("VSR", 5, "not recognized"),
])
def test_define_g_raises_for_what_is_not_ported(which, setting, want):
    """Every family of motif_tpu's define_g builds, at nf 16 here: MoTIF
    at the yml's setting (Ours_7 at 3), the flow precomputer, the
    baselines whatever `setting` says (the JAX package reads it for MoTIF
    only); an unknown family raises."""
    net = _network_g(which_model_G=which, setting=setting)
    if want is None:
        m = factory.define_g(net | {"nf": 16}, device="cpu")
        jm = jfactory.define_g(net)
        assert type(m).__name__ == type(jm).__name__
        if which.startswith("Ours") and which != "Ours_flow":
            assert (m.setting, m.n_anchors, m.linear_motion) == (
                jm.setting, jm.n_anchors, jm.linear_motion)
        return
    with pytest.raises(NotImplementedError, match=want):
        factory.define_g(net, device="cpu")


def test_cli_equals_evaluator_run(tmp_path, monkeypatch):
    """`main` over test.yml at nf 16 (full depth: 5 + 40 blocks) on one
    clip, from a reference .pth, against the port's own Evaluator.run on
    the same model and loader."""
    yml = tmp_path / "eval16.yml"
    text = (ROOT / "test.yml").read_text()
    assert "nf: 64\n" in text and "name: tmp\n" in text
    yml.write_text(text.replace("nf: 64\n", "nf: 16\n").replace(
        "name: tmp\n", "name: eval16\n"))
    model = build_motif(16, device="cpu", seed=3)
    pth = _reference_pth(tmp_path / "w16.pth", model.state_dict())
    monkeypatch.chdir(tmp_path)
    s = tcli.main(["-opt", str(yml), "--device", "cpu", "--max_clips", "1",
                   "--checkpoint", str(pth)],
                  overrides={"dataroot_GT": DATASET["dataroot_GT"],
                             "dataroot_LQ": DATASET["dataroot_LQ"]})
    loader = BatchLoader(create_dataset(DATASET))
    res = Evaluator(model, iters=4, chunk=3, device="cpu").run(
        [next(loader.epoch(0))])
    assert isinstance(res, EvalResults)
    assert s["n_clips"] == 1
    assert s == pytest.approx(res.summary(), rel=1e-12, abs=0)
    psnrs = np.load(tmp_path / "psnrs" / "eval16.npy", allow_pickle=True)
    ssims = np.load(tmp_path / "psnrs" / "eval16_ssim.npy", allow_pickle=True)
    np.testing.assert_allclose(psnrs.astype(np.float64),
                               np.asarray(res.psnrs_all), rtol=1e-12)
    np.testing.assert_allclose(ssims.astype(np.float64),
                               np.asarray(res.ssim_all), rtol=1e-12)
