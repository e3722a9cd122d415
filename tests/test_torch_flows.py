"""The port's precomputed-flow path against motif_tpu's: Vimeo7Dataset with
`load_flows` item for item, the batch pipeline carrying the flows, the
flow tool (`python -m motif_tpu_torch.precompute_flows`) against the JAX
tool's formulas, and `python -m motif_tpu_torch.train` on a four-anchor
model (Ours_44, width 16, on the CPU) trained on the files the tool wrote.

Everything writes into a temporary copy of data/vimeo (2 septuplets, GT
128², LR 32²); the repository's data/ is only read.
"""

import json
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motif_tpu import checkpoint as jckpt
from motif_tpu.data import datasets as jdatasets
from motif_tpu.models.raft import RAFT as JRAFT
from motif_tpu.ops.resize import interpolate_bilinear as jinterp
from motif_tpu_torch import checkpoint, precompute_flows, train
from motif_tpu_torch.data import (BatchLoader, collate_stack, create_dataset,
                                  device_prefetch)

ROOT = pathlib.Path(__file__).resolve().parents[1]
VIMEO = ROOT / "data" / "vimeo"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _copy_vimeo(dst: pathlib.Path) -> pathlib.Path:
    shutil.copytree(VIMEO, dst)
    return dst


@pytest.fixture(scope="module")
def seeded_flows(tmp_path_factory):
    """data/vimeo copied with seeded flow files of the reference's shapes:
    lr_flow_12.npy (16, 2, 32, 32) and hr_gt_flow.npy (28, 2, 128, 128)."""
    root = _copy_vimeo(tmp_path_factory.mktemp("seeded") / "vimeo")
    rng = np.random.default_rng(11)
    for key in ("00001/0001", "00001/0002"):
        np.save(root / "LR" / key / "lr_flow_12.npy",
                (rng.standard_normal((16, 2, 32, 32)) * 2).astype(np.float32))
        np.save(root / "GT" / key / "hr_gt_flow.npy",
                (rng.standard_normal((28, 2, 128, 128)) * 5).astype(np.float32))
    return root


def _vimeo_opt(root, **kw):
    opt = {"mode": "vimeo", "dataroot_GT": str(root / "GT"),
           "dataroot_LQ": str(root / "LR"),
           "cache_keys": str(root / "keys.txt"), "scale": 4,
           "phase": "train", "random_reverse": True, "use_flip": True,
           "use_rot": True, "load_flows": True}
    opt.update(kw)
    return opt


@pytest.mark.parametrize("seed", [0, 3, 8])
@pytest.mark.parametrize("gt_size", [64, 128])
def test_vimeo_items_with_flows_are_bit_equal(seeded_flows, gt_size, seed):
    """Twelve draws from the same seed, every augmentation on: the same
    frames, times, LR flows and teacher flows, bit for bit, in the model's
    layout; reversed and unreversed clips both occur."""
    opt = _vimeo_opt(seeded_flows, GT_size=gt_size)
    got, want = create_dataset(opt), jdatasets.create_dataset(opt)
    got._rng.seed(seed)
    want._rng.seed(seed)
    lq = gt_size // 4
    reversed_ = set()
    for k in range(12):
        a, b = got[k % 2], want[k % 2]
        assert set(a) == set(b) == {"lq", "gt", "times", "key", "flow",
                                    "flow_gt"}
        for key in ("lq", "gt", "times", "flow", "flow_gt"):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a["flow"].shape == (16, lq, lq, 2)
        assert a["flow_gt"].shape == (7, 4, gt_size, gt_size, 2)
        reversed_.add(bool(a["times"][0] == 1.0))
    assert reversed_ == {True, False}


def test_vimeo_flows_follow_the_frames_augmentation(seeded_flows):
    """Without augmentation an item's flows are the files' arrays in the
    model's layout (channel last, flow_gt (t, anchor)); reversed, times and
    anchors flip together."""
    root = seeded_flows
    lr = np.load(root / "LR" / "00001" / "0001" / "lr_flow_12.npy")
    hr = np.load(root / "GT" / "00001" / "0001" / "hr_gt_flow.npy")
    ds = create_dataset(_vimeo_opt(root, phase="val", random_reverse=False))
    item = ds[0]
    np.testing.assert_array_equal(item["flow"], lr.transpose(0, 2, 3, 1))
    np.testing.assert_array_equal(
        item["flow_gt"], hr.reshape(7, 4, 2, 128, 128).transpose(0, 1, 3, 4, 2))
    ds = create_dataset(_vimeo_opt(root, phase="val"))
    ds._rng.random = lambda: 0.0                       # always reverse
    item = ds[0]
    assert item["times"][0] == 1.0
    np.testing.assert_array_equal(
        item["flow"][1 * 4 + 2], lr[(3 - 1) * 4 + (3 - 2)].transpose(1, 2, 0))
    np.testing.assert_array_equal(
        item["flow_gt"][0, 1],
        hr.reshape(7, 4, 2, 128, 128)[6, 2].transpose(1, 2, 0))


def test_the_pipeline_carries_the_flows(seeded_flows):
    """collate_stack stacks the flow arrays like the frames, BatchLoader
    yields them, and device_prefetch passes them through on the CPU."""
    ds = create_dataset(_vimeo_opt(seeded_flows, GT_size=64))
    items = [ds[0], ds[1]]
    batch = collate_stack(items)
    assert batch["flow"].shape == (2, 16, 16, 16, 2)
    assert batch["flow_gt"].shape == (2, 7, 4, 64, 64, 2)
    np.testing.assert_array_equal(batch["flow_gt"][1], items[1]["flow_gt"])
    loader = BatchLoader(ds, batch_size=2, shuffle=True, seed=0)
    got = list(device_prefetch(loader.epoch(0), "cpu"))
    assert len(got) == 1 and got[0]["flow"].shape == (2, 16, 16, 16, 2)


def _jax_tool_flows(raft_sd, lqs, gts, iters):
    """tools/precompute_flows.py's formulas on motif_tpu's RAFT and
    interpolate_bilinear, float64: (lr (16, 2, h, w), hr (28, 2, H, W))."""
    params = jckpt.port_torch_state_dict(
        {k: v.double() for k, v in raft_sd.items()})
    apply = jax.jit(lambda p, a, b: JRAFT().apply(
        {"params": p}, a * 255.0, b * 255.0, iters=iters))

    def raft(a, b):
        return np.asarray(apply(params, jnp.asarray(a), jnp.asarray(b)))
    h, w = lqs.shape[1:3]
    HH, WW = gts.shape[1:3]
    lqs_hr = np.asarray(jinterp(jnp.asarray(lqs), (HH, WW)))
    src = np.concatenate([np.repeat(lqs_hr[i:i + 1], 4, 0) for i in range(4)])
    dst = np.tile(lqs_hr, (4, 1, 1, 1))
    lr = np.asarray(jinterp(jnp.asarray(raft(src, dst)), (h, w))) * (h / HH)
    for i in range(4):
        lr[i * 4 + i] = 0.0
    hr = raft(np.tile(gts[[0, 2, 4, 6]], (7, 1, 1, 1)), np.repeat(gts, 4, 0))
    return lr.transpose(0, 3, 1, 2), hr.transpose(0, 3, 1, 2)


def test_clip_flows_match_the_jax_tool():
    """The port's two arrays against the JAX tool's formulas with the same
    RAFT weights (seed 0), float64, at a 64² GT: 1e-9."""
    rng = np.random.default_rng(4)
    gts = rng.random((7, 64, 64, 3))
    lqs = rng.random((4, 16, 16, 3))
    raft = precompute_flows.build_raft(None, "cpu").double()
    lr, hr = precompute_flows.clip_flows(raft, lqs, gts, iters=2)
    with jax.enable_x64(True):
        jlr, jhr = _jax_tool_flows(raft.state_dict(), lqs, gts, 2)
    assert lr.shape == (16, 2, 16, 16) and hr.shape == (28, 2, 64, 64)
    assert all(not lr[i * 5].any() for i in range(4)) and np.abs(lr).max() > 0
    np.testing.assert_allclose(lr, jlr, rtol=0, atol=1e-9)
    np.testing.assert_allclose(hr, jhr, rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def tool_flows(tmp_path_factory):
    """data/vimeo copied, then the tool's files written there by `main`
    from a whole-model reference .pth (its flow_predictor keys), RAFT
    iters 1 on the CPU; the model's weights ride along for the checks."""
    from motif_tpu_torch.models.motif import build_motif

    tmp = tmp_path_factory.mktemp("tool")
    root = _copy_vimeo(tmp / "vimeo")
    model = build_motif(16, 1, 2, device="cpu", seed=5, n_anchors=4)
    pth = tmp / "best.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in
                               model.state_dict().items()}}, pth)
    argv = ["--gt_root", str(root / "GT"), "--lq_root", str(root / "LR"),
            "--keys", str(root / "keys.txt"), "--checkpoint", str(pth),
            "--iters", "1", "--device", "cpu"]
    written = precompute_flows.main(argv)
    return root, model, argv, written


def test_tool_writes_the_reference_layout(tool_flows):
    """Both clips get lr_flow_12.npy (16, 2, 32, 32) and hr_gt_flow.npy
    (28, 2, 128, 128), float32, from the .pth's RAFT; a second run skips
    them and --overwrite writes them again, the same."""
    root, model, argv, written = tool_flows
    assert written == 2
    from motif_tpu_torch.data import read_img

    for key in ("00001/0001", "00001/0002"):
        lr = np.load(root / "LR" / key / "lr_flow_12.npy")
        hr = np.load(root / "GT" / key / "hr_gt_flow.npy")
        assert lr.dtype == hr.dtype == np.float32
        assert lr.shape == (16, 2, 32, 32) and hr.shape == (28, 2, 128, 128)
    lqs = np.stack([read_img(str(root / "LR" / key / f"im{i}.png"))
                    for i in (1, 3, 5, 7)])
    gts = np.stack([read_img(str(root / "GT" / key / f"im{i}.png"))
                    for i in range(1, 8)])
    want = precompute_flows.clip_flows(model.flow_predictor.eval(), lqs, gts,
                                       iters=1)
    np.testing.assert_array_equal(lr, want[0])
    np.testing.assert_array_equal(hr, want[1])
    assert precompute_flows.main(argv) == 0
    assert precompute_flows.main(argv + ["--overwrite"]) == 2
    np.testing.assert_array_equal(
        np.load(root / "GT" / key / "hr_gt_flow.npy"), hr)


def test_tool_reads_a_bare_raft_pth(tmp_path, tool_flows):
    _, model, _, _ = tool_flows
    pth = tmp_path / "raft.pth"
    torch.save(model.flow_predictor.state_dict(), pth)
    raft = precompute_flows.build_raft(str(pth), "cpu")
    for k, v in raft.state_dict().items():
        assert torch.equal(v, model.flow_predictor.state_dict()[k]), k


def test_train_cli_on_ours44_with_the_tools_flows(tool_flows, tmp_path,
                                                  monkeypatch):
    """train_smoke.yml with Ours_44 at width 16 (full depth) on the CPU:
    load_flows is on by default for a four-anchor model, RAFT runs in no
    step, the batches carry the tool's flows; 2 steps, then a resume to 3."""
    root = tool_flows[0]
    from motif_tpu_torch.models.raft import RAFT
    from motif_tpu_torch.trainer import Trainer

    raft_calls, flows_seen = [], []
    monkeypatch.setattr(RAFT, "forward",
                        lambda *a, **k: raft_calls.append(1))
    step = Trainer.step

    def spy(self, batch, **kw):
        flows_seen.append((batch["flow"].shape, batch["flow_gt"].shape))
        return step(self, batch, **kw)
    monkeypatch.setattr(Trainer, "step", spy)

    def run(steps):
        yml = ROOT / "configs" / "train_smoke.yml"
        return train.main(
            ["-opt", str(yml), "--max_steps", str(steps), "--device", "cpu"],
            overrides={"network_G": {"nf": 16, "which_model_G": "Ours_44"},
                       "path": {"root": str(tmp_path)}, "dataset_ratio": 1,
                       "datasets": {"train": {
                           "dataroot_GT": str(root / "GT"),
                           "dataroot_LQ": str(root / "LR"),
                           "cache_keys": str(root / "keys.txt")}}})
    aux = run(2)
    assert np.isfinite(float(aux["loss"])) and np.isfinite(
        float(aux["flow_l"]))
    assert raft_calls == []
    assert flows_seen == [((1, 16, 16, 16, 2), (1, 7, 4, 64, 64, 2))] * 2
    exp = tmp_path / "experiments" / "smoke"
    models = str(exp / "models")
    assert checkpoint.latest_step(models) == 2
    run(3)
    lines = [json.loads(ln) for ln in (exp / "train_log.jsonl").open()]
    assert [ln["step"] for ln in lines] == [1, 2, 3]
    assert checkpoint.latest_step(models) == 3 and raft_calls == []
    state = torch.load(exp / "models" / "step_3")
    assert state["step"] == 3
    assert state["model"]["flow_process.0.weight"].shape == (16, 7, 3, 3)
