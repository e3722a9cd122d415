"""The eval CLI on the port's own checkpoints, and the deterministic plain
backwards the training gates' state is reached with.

`python -m motif_tpu_torch.test --checkpoint` takes a models root (read at
its newest `step_<n>`, as motif_tpu's test.py resolves a checkpoint root),
a `step_<n>` train state of `python -m motif_tpu_torch.train`, a
reference `.pth`, or motif_tpu's orbax train state (its step directory or
its models root), each loaded strictly (`checkpoint.load_checkpoint`):
`train.main` runs two steps of configs/train_smoke.yml at width 16 on the
CPU, then the CLI evaluates one data/Vid4 clip through test.yml cut to the
same width from the models root and from its step file, and gives the
trained model's frames (bit for bit on the CPU), not the random init's.

Under torch.use_deterministic_algorithms the plain DCN backward (its
`scatter_add_` summed in a fixed order) and the reflect padding (two
`index_select`s, whose backward has a deterministic path) give today's
values: within 1e-12 in float64.
"""

import pathlib
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from motif_tpu_torch import checkpoint, train
from motif_tpu_torch import test as tcli
from motif_tpu_torch.eval import Evaluator
from motif_tpu_torch.models.factory import define_g
from motif_tpu_torch.models.layers import Conv2d, reflect_pad
from motif_tpu_torch.ops import dcn

ROOT = pathlib.Path(__file__).resolve().parents[1]
VIMEO = ROOT / "data" / "vimeo"
VID4 = ROOT / "data" / "Vid4"
NF = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The models root of two training steps of train_smoke.yml (Ours,
    GT 64, batch 1, iters 2) at width 16 on the CPU."""
    tmp = tmp_path_factory.mktemp("train")
    train.main(["-opt", str(ROOT / "configs" / "train_smoke.yml"),
                "--max_steps", "2", "--device", "cpu"], overrides={
        "network_G": {"nf": NF}, "path": {"root": str(tmp)},
        "dataset_ratio": 1,
        "datasets": {"train": {"dataroot_GT": str(VIMEO / "GT"),
                               "dataroot_LQ": str(VIMEO / "LR"),
                               "cache_keys": str(VIMEO / "keys.txt")}}})
    models = tmp / "experiments" / "smoke" / "models"
    assert checkpoint.latest_step(str(models)) == 2
    return models


def _cli_frames(tmp_path, monkeypatch, ckpt):
    """The frames and inputs of the eval CLI over test.yml (cut to width
    16) on the first Vid4 clip with `--checkpoint ckpt`."""
    text = (ROOT / "test.yml").read_text()
    assert "  nf: 64\n" in text
    yml = tmp_path / "test16.yml"
    yml.write_text(text.replace("  nf: 64\n", f"  nf: {NF}\n"))
    seen = []
    infer = Evaluator.infer

    def keep(self, lq, times, out_hw):
        out = infer(self, lq, times, out_hw)
        seen.append((lq, times, out_hw, out[0]))
        return out
    monkeypatch.chdir(tmp_path)
    with mock.patch.object(Evaluator, "infer", keep):
        tcli.main(["-opt", str(yml), "--checkpoint", str(ckpt),
                   "--max_clips", "1", "--device", "cpu"],
                  overrides={"dataroot_GT": str(VID4 / "HR"),
                             "dataroot_LQ": str(VID4 / "LR")})
    assert len(seen) == 1
    return seen[0]


@pytest.fixture(scope="module")
def init_frames(tmp_path_factory):
    """The CLI's frames on a checkpoint path that does not exist: the
    random init from seed 0, which the training started from."""
    tmp = tmp_path_factory.mktemp("init")
    with pytest.MonkeyPatch.context() as mp:
        return _cli_frames(tmp, mp, tmp / "absent.pth")[3]


@pytest.mark.parametrize("which", ["root", "step_file"])
def test_cli_evaluates_the_trained_weights(trained, init_frames, which,
                                           tmp_path, monkeypatch):
    """`--checkpoint <models>` and `--checkpoint <models>/step_2` both give
    the frames of the model in step_2's `model` entry, not the init's."""
    ckpt = trained if which == "root" else trained / "step_2"
    lq, times, out_hw, got = _cli_frames(tmp_path, monkeypatch, ckpt)
    model = define_g({"which_model_G": "Ours", "nf": NF, "setting": 5},
                     device="cpu")
    model.load_state_dict(torch.load(trained / "step_2")["model"])
    want, _ = Evaluator(model, iters=4, device="cpu").infer(lq, times,
                                                            out_hw)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - init_frames).max() > 1e-4


@pytest.mark.parametrize("which", ["root", "step_dir"])
def test_cli_evaluates_an_orbax_state(which, tmp_path, monkeypatch):
    """motif_tpu's orbax train state of the width-16 model the CLI builds
    (its weights moved off the init, with seeded Adam moments, written by
    motif_tpu.checkpoint.save_train_state): `--checkpoint <models>` and
    `--checkpoint <models>/step_3` give that model's frames."""
    import jax
    from _orbax_parity import optax_state
    from motif_tpu import checkpoint as jckpt

    model = _state(0.25)
    tree = jax.tree.map(np.asarray, jckpt.port_torch_state_dict(
        model.state_dict()))
    models = tmp_path / "models"
    jckpt.save_train_state(str(models), 3, optax_state(tree, 0.0, step=3))
    ckpt = models if which == "root" else models / "step_3"
    lq, times, out_hw, got = _cli_frames(tmp_path, monkeypatch, ckpt)
    want, _ = Evaluator(model, iters=4, device="cpu").infer(lq, times,
                                                            out_hw)
    np.testing.assert_array_equal(got, want)


def _state(seed=0):
    model = define_g({"which_model_G": "Ours", "nf": NF, "setting": 5},
                     device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.add_(seed)
    return model


def test_load_checkpoint_reads_the_newest_step(tmp_path):
    """A models root resolves to its newest step_<n> (not its .meta.json),
    a step file to itself; each loads strictly and names the file read."""
    for step, seed in ((1, 1.0), (3, 3.0), (2, 2.0)):
        torch.save({"model": _state(seed).state_dict(), "optimizer": {},
                    "step": step}, tmp_path / f"step_{step}")
    (tmp_path / "step_3.meta.json").write_text("{}")
    m = _state()
    assert checkpoint.load_checkpoint(m, str(tmp_path)) == \
        str(tmp_path / "step_3")
    torch.testing.assert_close(m.alpha, torch.full((1,), -17.0))
    assert checkpoint.load_checkpoint(m, str(tmp_path / "step_1")) == \
        str(tmp_path / "step_1")
    torch.testing.assert_close(m.alpha, torch.full((1,), -19.0))


def test_a_reference_pth_still_loads_strictly(tmp_path):
    want = _state(0.5)
    sd = {f"module.{k}": v for k, v in want.state_dict().items()}
    torch.save({"state_dict": sd}, tmp_path / "best.pth")
    m = _state()
    checkpoint.load_checkpoint(m, str(tmp_path / "best.pth"))
    for a, b in zip(m.state_dict().values(), want.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    sd.pop("module.alpha")
    torch.save({"state_dict": sd}, tmp_path / "short.pth")
    with pytest.raises(RuntimeError, match="alpha"):
        checkpoint.load_checkpoint(m, str(tmp_path / "short.pth"))


def test_a_mismatched_step_file_names_its_keys(tmp_path):
    sd = dict(_state().state_dict())
    sd.pop("alpha")
    sd["extra_head.weight"] = torch.zeros(2)
    sd["norm_gamma"] = torch.ones(1, 4, 1)
    path = tmp_path / "step_4"
    torch.save({"model": sd, "optimizer": {}, "step": 4}, path)
    with pytest.raises(RuntimeError) as e:
        checkpoint.load_checkpoint(_state(), str(tmp_path))
    for name in (str(path), "alpha", "extra_head.weight", "norm_gamma"):
        assert name in str(e.value)


@pytest.mark.parametrize("what", ["empty_root", "orbax_step", "not_a_state"])
def test_what_is_not_a_train_state_raises(tmp_path, what):
    if what == "empty_root":
        err, path = FileNotFoundError, tmp_path
    elif what == "orbax_step":      # a directory without orbax's _METADATA
        (tmp_path / "step_5").mkdir()
        err, path = FileNotFoundError, tmp_path
    else:
        path = tmp_path / "step_1"
        torch.save({"weights": torch.zeros(2)}, path)
        err = ValueError
    with pytest.raises(err, match=str(path.name) if what != "empty_root"
                       else "step_<n>"):
        checkpoint.load_checkpoint(_state(), str(path))


def _dcn_case(seed=0, B=2, H=7, W=9, G=2, cg=3, K=3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, H, W, G * cg, generator=g, dtype=torch.float64)
    off = torch.randn(B, H, W, G * K * K * 2, generator=g,
                      dtype=torch.float64) * 2.0
    mask = torch.rand(B, H, W, G * K * K, generator=g, dtype=torch.float64)
    g_cols = torch.randn(B * H * W, G * K * K * cg, generator=g,
                         dtype=torch.float64)
    return x, off, mask, g_cols, (K, 1, 1, 1, G)


def test_deterministic_dcn_backward_equals_the_default():
    """The plain DCN backward under torch's deterministic algorithms (the
    training gates' state) against the same backward without, in float64:
    within 1e-12 of each gradient's largest value; twice bit-equal."""
    x, off, mask, g_cols, conv = _dcn_case()
    want = dcn.dcn_im2col_backward_plain(x, off, mask, g_cols, *conv)
    torch.use_deterministic_algorithms(True)
    try:
        got = dcn.dcn_im2col_backward_plain(x, off, mask, g_cols, *conv)
        again = dcn.dcn_im2col_backward_plain(x, off, mask, g_cols, *conv)
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b, c in zip(got, want, again):
        assert a.dtype == torch.float64 and torch.equal(a, c)
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


@pytest.mark.parametrize("ph,pw", [(1, 1), (2, 1), (0, 2)])
def test_reflect_pad_equals_f_pad(ph, pw):
    """`reflect_pad` gives F.pad's reflect values bit for bit, and its
    gradient within 1e-12 in float64."""
    g = torch.Generator().manual_seed(ph * 3 + pw)
    x = torch.randn(2, 3, 6, 7, generator=g, dtype=torch.float64,
                    requires_grad=True)
    want = F.pad(x, (pw, pw, ph, ph), mode="reflect")
    got = reflect_pad(x, ph, pw)
    assert torch.equal(got, want)
    ct = torch.randn(want.shape, generator=g, dtype=torch.float64)
    (gw,) = torch.autograd.grad(want, x, ct)
    (gg,) = torch.autograd.grad(got, x, ct)
    assert float((gg - gw).abs().max()) <= 1e-12


def test_reflect_conv_backward_runs_deterministically():
    """A reflect-padded Conv2d (MoTIF's last flow-context conv) under
    torch's deterministic algorithms: the same output and gradients as
    without, twice bit-equal."""
    torch.manual_seed(0)
    conv = Conv2d(4, 5, 3, 1, 1, padding_mode="reflect").double()
    x = torch.randn(2, 6, 7, 4, dtype=torch.float64, requires_grad=True)

    def grads():
        out = conv(x)
        return (out.detach(), *torch.autograd.grad(out.square().sum(),
                                                   (x, conv.weight)))
    want = grads()
    torch.use_deterministic_algorithms(True)
    try:
        got, again = grads(), grads()
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, c)
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
