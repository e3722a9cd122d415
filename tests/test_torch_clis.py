"""The port's last entry points on the CPU, each with a stand-in for
`define_g` at width 16 (1 / 2 residual blocks, float64): `python -m
motif_tpu_torch.demo` (one pair's frames held against motif_tpu's
model.apply at the same weights, float64, 1e-10; the PNGs are those
frames), `generate` (out / GT / diff PNGs of Evaluator.infer's frames;
`--checkpoint` ignored as the JAX CLI ignores it), `flow` (the .flo files
and pictures of the model's flows, x 20 · HH / h), and `test_tmp` (the
sweep's calls to the eval CLI against the JAX CLI's, and one real entry on
a data/Vid4 clip). Every CLI raises without a card unless given
`--device cpu`."""

import pathlib
import sys
import types
from unittest import mock

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motif_tpu import checkpoint as jckpt
from motif_tpu.models.motif import MoTIF as JMoTIF
from motif_tpu_torch import demo, flow, generate, test_tmp
from motif_tpu_torch.eval import Evaluator
from motif_tpu_torch.models import factory
from motif_tpu_torch.models.motif import MoTIF
from motif_tpu_torch.utils import flow_io, video

ROOT = pathlib.Path(__file__).resolve().parents[1]
VID4 = ROOT / "data" / "Vid4"
CH, FRONT, BACK = 16, 1, 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(opt, device=None, **kw):
    """define_g's stand-in: a MoTIF at width 16 with seeded weights, alpha
    0.5 (the max splat runs), float64, on `device` (the device rule
    kept)."""
    from motif_tpu_torch import resolve_device

    dev = resolve_device(device)
    torch.manual_seed(0)
    m = MoTIF(CH, FRONT, BACK, n_anchors=4 if opt.get("which_model_G")
              in factory.FOUR_ANCHOR else 2)
    with torch.no_grad():
        m.alpha.fill_(0.5)
    return m.double().to(dev).eval()


@pytest.fixture()
def small(monkeypatch):
    monkeypatch.setattr(factory, "define_g", _small)


def _record_infer(monkeypatch):
    seen = []
    infer = Evaluator.infer

    def keep(self, lq, times, out_hw):
        out = infer(self, lq, times, out_hw)
        seen.append((lq, times, out_hw, out[0]))
        return out
    monkeypatch.setattr(Evaluator, "infer", keep)
    return seen


def _frames_dir(tmp_path, n=3, h=18, w=21):
    d = tmp_path / "frames"
    d.mkdir()
    rng = np.random.default_rng(4)
    base = rng.random((h, w, 3))
    for i in range(n):
        img = np.clip(np.roll(base, i, axis=1) * 0.9 + 0.05, 0, 1)
        video.save_img(img, str(d / f"{i:05d}.png"))
    return d


@pytest.mark.parametrize("cli,argv", [
    (demo, ["--frames_dir", "x", "--out_dir", "y"]),
    (generate, []), (flow, []), (test_tmp, ["-opt", str(ROOT / "test.yml")])])
def test_clis_run_on_cuda_unless_told(cli, argv, monkeypatch, tmp_path):
    """No card and no --device: the CLI raises (no fall back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(ROOT)
    if cli is demo:
        argv = ["--frames_dir", str(_frames_dir(tmp_path)), "--out_dir",
                str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)


def test_demo_pair_matches_motif_tpu(small, tmp_path, monkeypatch):
    """3 frames 18x21 (cropped to 16x20) at x4 space, x2 time: 2 pairs, 4
    PNGs of 64x80; pair 0's frames against motif_tpu's forward of [f0,
    f0, f1, f1] at times 0, 1/2 on the same weights."""
    frames_dir = _frames_dir(tmp_path)
    seen = _record_infer(monkeypatch)
    out = tmp_path / "out"
    res = demo.main(["--frames_dir", str(frames_dir), "--out_dir", str(out),
                     "--time_scale", "2", "--device", "cpu"])
    assert res["pairs"] == 2 and res["frames"] == 4
    assert res["out_hw"] == (64, 80) and res["captures"] == 0
    assert sorted(p.name for p in out.iterdir()) == [
        f"{i:06d}.png" for i in range(4)]
    lq, times, out_hw, got = seen[0]
    f = video.read_seq_imgs(str(frames_dir))[:, :16, :20]
    np.testing.assert_array_equal(lq, np.stack([f[0], f[0], f[1], f[1]])[None])
    np.testing.assert_array_equal(times, [[0.0, 0.5]])
    assert got.shape == (2, 1, 64, 80, 3)
    for k in range(2):
        png = cv2.imread(str(out / f"{k:06d}.png"))
        np.testing.assert_array_equal(png, video.tensor2img(got[k, 0]))
    m = _small({}, 'cpu')
    with jax.enable_x64(True):
        params = jax.tree.map(np.asarray,
                              jckpt.port_torch_state_dict(m.state_dict()))
        want = jax.jit(lambda p, x, t: JMoTIF(
            channel=CH, front_rbs=FRONT, back_rbs=BACK).apply(
                {"params": p}, x, t, (64, 80), use_gt=False, iters=4)[0])(
            params, jnp.asarray(lq, jnp.float64),
            jnp.asarray(times, jnp.float64))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-10)


def test_demo_downsample_and_checkpoint(small, tmp_path, monkeypatch):
    """--downsample 0.5 (MATLAB bicubic) before the crop, and --checkpoint
    loaded strictly (a step file of the stand-in's own weights + 1)."""
    frames_dir = _frames_dir(tmp_path, 2, 42, 48)
    m = _small({}, 'cpu')
    with torch.no_grad():
        for p in m.parameters():
            p.add_(1e-3)
    torch.save({"model": m.state_dict(), "optimizer": {}, "step": 1},
               tmp_path / "step_1")
    seen = _record_infer(monkeypatch)
    res = demo.main(["--frames_dir", str(frames_dir), "--out_dir",
                     str(tmp_path / "o"), "--time_scale", "1",
                     "--downsample", "0.5", "--checkpoint",
                     str(tmp_path / "step_1"), "--device", "cpu"])
    assert res["out_hw"] == (80, 96) and res["frames"] == 1
    assert seen[0][0].shape == (1, 4, 20, 24, 3)     # 21 rows cropped to 20
    m2 = _small({}, 'cpu')
    with torch.no_grad():
        for p in m2.parameters():
            p.add_(1e-3)
    want, _ = Evaluator(m2, iters=4, chunk=1, device="cpu").infer(
        seen[0][0], seen[0][1], (80, 96))
    np.testing.assert_array_equal(seen[0][3], want)


def _yml(tmp_path, name="test.yml"):
    text = (ROOT / name).read_text()
    assert "./data/Vid4/" in text
    yml = tmp_path / f"cut_{name.replace('/', '_')}"
    yml.write_text(text.replace("./data/Vid4/", f"{VID4}/"))
    return yml


def test_generate_saves_the_evaluators_frames(small, tmp_path, monkeypatch):
    seen = _record_infer(monkeypatch)
    out = tmp_path / "gen"
    n = generate.main(["-opt", str(_yml(tmp_path)), "--out_dir", str(out),
                       "--device", "cpu"])
    assert n == 1 and len(seen) == 1
    lq, times, out_hw, fake = seen[0]
    N = fake.shape[0]
    names = sorted(p.name for p in out.iterdir())
    assert names == sorted(f"clip0_t{k}_{s}.png" for k in range(N)
                           for s in ("out", "gt", "diff"))
    for k in range(N):
        np.testing.assert_array_equal(cv2.imread(str(out / f"clip0_t{k}_out"
                                                           ".png")),
                                      video.tensor2img(fake[k, 0]))
    # --checkpoint is accepted and ignored: the same frames
    seen.clear()
    generate.main(["-opt", str(_yml(tmp_path)), "--out_dir", str(out),
                   "--checkpoint", str(tmp_path / "absent.pth"),
                   "--device", "cpu"])
    np.testing.assert_array_equal(seen[0][3], fake)


def test_flow_writes_the_models_flows(small, tmp_path, capsys):
    out = tmp_path / "fl"
    means = flow.main(["-opt", str(_yml(tmp_path)), "--out_dir", str(out),
                       "--max_clips", "1", "--device", "cpu"])
    assert len(means) == 1
    flos = sorted(out.glob("*.flo"))
    assert len(flos) == len(list(out.glob("*.png"))) == 2 * 3
    from motif_tpu_torch.data import create_dataset
    from motif_tpu_torch.utils import config

    opt = config.parse(str(_yml(tmp_path)), is_train=False)
    item = create_dataset(opt["datasets"]["train"])[0]
    lq = torch.from_numpy(item["lq"][None]).double()
    t = torch.from_numpy(item["times"][None]).double()
    h = lq.shape[2]
    with torch.no_grad():
        _, fl, _ = _small({}, 'cpu')(lq, t, (4 * h, 4 * lq.shape[3]), iters=4)
    want = fl.numpy() * 20.0 * (4 * h / h)
    for d in range(want.shape[0]):
        got = flow_io.read_flow(str(out / f"clip0_flow{d}.flo"))
        np.testing.assert_array_equal(got, want[d].astype(np.float32))
        np.testing.assert_array_equal(
            cv2.imread(str(out / f"clip0_flow{d}.png")),
            video.tensor2img(flow_io.flow_to_image(want[d]).astype(
                np.float32) / 255.0))
    assert means[0] == pytest.approx(float(np.abs(want).mean()), rel=1e-12)
    assert "WARNING: checkpoint ./saved_checkpoints/best.pth not found" in \
        capsys.readouterr().out


def test_test_tmp_sweeps_as_the_jax_cli(monkeypatch):
    """The eval CLI's calls of a sweep (s 1, 2, 2.5 x t 3, 6): the same
    yml, flags and overrides as the JAX test_tmp.py passes its test.py."""
    calls, jcalls = [], []

    def fake_main(argv=None, overrides=None):
        calls.append((list(argv), dict(overrides)))
        return {"psnr": 30.0, "ssim": 0.9}

    def jfake_main(overrides=None):
        jcalls.append((list(sys.argv[1:]), dict(overrides)))
        return {"psnr": 30.0, "ssim": 0.9}
    from motif_tpu_torch import test as tcli

    monkeypatch.setattr(tcli, "main", fake_main)
    monkeypatch.setitem(sys.modules, "test",
                        types.SimpleNamespace(main=jfake_main))
    sweep = ["--s_scales", "1", "2", "2.5", "--t_scales", "3", "6",
             "--checkpoint", "c.pth", "--max_clips", "2"]
    res = test_tmp.main(sweep)
    import test_tmp as jtest_tmp

    with mock.patch.object(sys, "argv", ["test_tmp.py"] + sweep):
        jtest_tmp.main()
    assert calls == jcalls and len(calls) == 6
    assert calls[2][1] == {"time": 3, "scale": 2}
    assert calls[4][1] == {"time": 3, "scale": 2.5}
    assert set(res) == {(s, t) for s in (1.0, 2.0, 2.5) for t in (3, 6)}


def test_test_tmp_runs_the_eval_cli(small, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = test_tmp.main(["-opt", str(_yml(tmp_path)), "--max_clips", "1",
                         "--t_scales", "3", "--device", "cpu"])
    (s, t), = res
    assert (s, t) == (1.0, 3) and res[(s, t)]["n_clips"] == 1
    assert np.isfinite(res[(s, t)]["psnr"])
