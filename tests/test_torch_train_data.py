"""The port's training data and CLI against motif_tpu's: Vimeo7Dataset
items bit for bit over the repository's data/vimeo (2 clips, GT 128², LR
32²) with every augmentation on, the `vimeo` mode of create_dataset, the
trainer settings of a yml (`trainer_config_from_opt`, its 0 → 150000 quirk
included), `check_resume`, `device_prefetch` on the CPU, and
`python -m motif_tpu_torch.train` for two steps at width 16 on the CPU,
then a resume.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from motif_tpu import trainer as jtrainer
from motif_tpu.data import datasets as jdatasets
from motif_tpu.utils import config as jconfig
from motif_tpu_torch import checkpoint, train
from motif_tpu_torch.data import datasets, device_prefetch
from motif_tpu_torch.utils import config

ROOT = pathlib.Path(__file__).resolve().parents[1]
VIMEO = ROOT / "data" / "vimeo"


def _vimeo_opt(**kw):
    opt = {"mode": "vimeo", "dataroot_GT": str(VIMEO / "GT"),
           "dataroot_LQ": str(VIMEO / "LR"),
           "cache_keys": str(VIMEO / "keys.txt"), "scale": 4,
           "phase": "train", "random_reverse": True, "use_flip": True,
           "use_rot": True}
    opt.update(kw)
    return opt


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("gt_size", [64, 128])
def test_vimeo_items_are_bit_equal(gt_size, seed):
    """Twelve draws (both clips, every augmentation on) from the same seed:
    the same frames, times and keys, bit for bit."""
    opt = _vimeo_opt(GT_size=gt_size)
    got, want = datasets.create_dataset(opt), jdatasets.create_dataset(opt)
    assert isinstance(got, datasets.Vimeo7Dataset)
    assert len(got) == len(want) == 2
    got._rng.seed(seed)
    want._rng.seed(seed)
    seen = set()
    for k in range(12):
        a, b = got[k % 2], want[k % 2]
        assert a["key"] == b["key"]
        for key in ("lq", "gt", "times"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a["lq"].shape == (4, gt_size // 4, gt_size // 4, 3)
        assert a["gt"].shape == (9, gt_size, gt_size, 3)
        seen.add(a["times"][0])
    assert seen == {0.0, 1.0}            # both the forward and the reverse


def test_vimeo_draws_match_without_random_reverse():
    """The reverse is drawn whether or not it is used, as motif_tpu draws
    it: without random_reverse the crops and flips that follow are still
    the same draws, item for item."""
    opt = _vimeo_opt(GT_size=64, random_reverse=False)
    got, want = datasets.create_dataset(opt), jdatasets.create_dataset(opt)
    got._rng.seed(5)
    want._rng.seed(5)
    for k in range(8):
        a, b = got[k % 2], want[k % 2]
        for key in ("lq", "gt", "times"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a["times"][0] == 0.0


def test_vimeo_without_augmentation_outside_the_train_phase():
    opt = _vimeo_opt(phase="val", random_reverse=False)
    got, want = datasets.create_dataset(opt), jdatasets.create_dataset(opt)
    for k in range(2):
        for key in ("lq", "gt", "times"):
            np.testing.assert_array_equal(got[k][key], want[k][key])
    assert got[0]["gt"].shape == (9, 128, 128, 3)


@pytest.mark.parametrize("kw,what", [({"load_flows": True}, "hr_gt_flow"),
                                     ({"data_type": "lmdb"}, "meta_info")])
def test_vimeo_flows_and_lmdb_raise(kw, what):
    """An item whose flow files are missing (the repository's data/vimeo
    ships none; flows: tests/test_torch_flows.py) raises, naming the file,
    as motif_tpu's does; so does an LMDB dataset over a folder that is not
    a pack (no meta_info.pkl; packs: tests/test_torch_lmdb_native.py)."""
    if "load_flows" in kw:
        ds = datasets.create_dataset(_vimeo_opt(**kw))
        with pytest.raises(FileNotFoundError, match=what):
            ds[0]
        with pytest.raises(FileNotFoundError, match=what):
            jdatasets.create_dataset(_vimeo_opt(**kw))[0]
        return
    for create in (datasets.create_dataset, jdatasets.create_dataset):
        with pytest.raises(FileNotFoundError, match=what):
            create(_vimeo_opt(**kw))


YMLS = ["configs/train_smoke.yml", "configs/train_Ours_vimeo.yml",
        "configs/train_overfit.yml", "configs/train_overfit_ext.yml",
        "test.yml"]


@pytest.mark.parametrize("yml", YMLS)
def test_trainer_config_from_opt_matches_motif_tpu(yml):
    got = config.trainer_config_from_opt(config.parse(str(ROOT / yml)))
    want = jconfig.trainer_config_from_opt(jconfig.parse(str(ROOT / yml)))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("value,steps", [(0, 150000), (None, 150000),
                                         (4, 4)])
def test_teacher_forcing_steps_zero_means_150000(value, steps):
    """The JAX package reads the value with `or`: 0 (or none) is the
    reference's 150000. The port keeps the quirk."""
    opt = config._to_nonedict({"train": {} if value is None else
                               {"teacher_forcing_steps": value}})
    assert config.trainer_config_from_opt(opt).teacher_forcing_steps == \
        jconfig.trainer_config_from_opt(opt).teacher_forcing_steps == steps


def test_check_resume_matches_motif_tpu():
    for resume in ("state/7.state", None):
        opts = [m._to_nonedict({"path": {"models": "/m",
                                         "resume_state": resume}})
                for m in (config, jconfig)]
        config.check_resume(opts[0], 7)
        jconfig.check_resume(opts[1], 7)
        assert opts[0] == opts[1]


def test_device_prefetch_is_the_identity_on_the_cpu():
    batches = [{"lq": np.full((1, 2), i), "key": [str(i)]} for i in range(5)]
    for dev in (None, "cpu", torch.device("cpu")):
        out = list(device_prefetch(iter(batches), dev))
        assert len(out) == 5 and all(a is b for a, b in zip(out, batches))


def _train(tmp_path, steps, **over):
    yml = ROOT / "configs" / "train_smoke.yml"
    overrides = {"network_G": {"nf": 16},
                 "path": {"root": str(tmp_path)},
                 "dataset_ratio": 1,
                 "datasets": {"train": {
                     "dataroot_GT": str(VIMEO / "GT"),
                     "dataroot_LQ": str(VIMEO / "LR"),
                     "cache_keys": str(VIMEO / "keys.txt")}}}
    for k, v in over.items():
        overrides.setdefault(k, {}).update(v)
    return train.main(["-opt", str(yml), "--max_steps", str(steps),
                       "--device", "cpu"], overrides=overrides)


@pytest.fixture(scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_cli_runs_saves_and_resumes(tmp_path, one_torch_thread):
    """Two steps of train_smoke.yml (Ours, GT 64, batch 1, iters 2) at
    width 16 on the CPU: finite losses, a log line a step, the final
    train state; a second run to step 3 resumes from it."""
    aux = _train(tmp_path, 2)
    assert np.isfinite(float(aux["loss"])) and aux["use_gt"] in (True, False)
    exp = tmp_path / "experiments" / "smoke"
    lines = [json.loads(ln) for ln in (exp / "train_log.jsonl").open()]
    assert [ln["step"] for ln in lines] == [1, 2]
    assert set(lines[0]) == {"step", "loss", "l_pix", "flow_l", "lr",
                             "use_gt", "s_per_it", "epoch", "time"}
    assert checkpoint.latest_step(str(exp / "models")) == 2
    assert checkpoint.restore_meta(str(exp / "models"), 2) == {"epoch": 1}
    _train(tmp_path, 3)
    lines = [json.loads(ln) for ln in (exp / "train_log.jsonl").open()]
    assert [ln["step"] for ln in lines] == [1, 2, 3]
    assert checkpoint.latest_step(str(exp / "models")) == 3
    state = torch.load(exp / "models" / "step_3")
    assert state["step"] == 3 and set(state) == {"model", "optimizer",
                                                 "step"}


@pytest.mark.parametrize("over,what", [
    ({"network_G": {"which_model_G": "LIIF"}}, None),
    ({"network_G": {"which_model_G": "Ours_7"}}, None),
    ({"datasets": {"train": {"mode": "vimeo_a", "LQ_size": 64}}}, None),
    ({"network_G": {"which_model_G": "EDVR"}}, "no training recipe")])
def test_train_cli_raises_for_what_is_not_ported(tmp_path, over, what,
                                                 one_torch_thread):
    """LIIF (VideoINR on the 4 LQ frames), Ours_7 and the arbitrary-scale
    vimeo_a (the collate at LQ_size 64, the output size from the batch, on
    data/vimeo's frames resized to 256x256: its crops reach 240 px) train a
    step at width 16; a baseline the grid does not train raises, as the
    JAX package's train.py refuses it."""
    if what is None:
        if over.get("datasets"):
            import cv2

            gt = tmp_path / "vimeo" / "GT"
            for key in ("00001/0001", "00001/0002"):
                (gt / key).mkdir(parents=True)
                for v in range(1, 8):
                    img = cv2.imread(str(VIMEO / "GT" / key / f"im{v}.png"))
                    cv2.imwrite(str(gt / key / f"im{v}.png"),
                                cv2.resize(img, (256, 256)))
            over["datasets"]["train"]["dataroot_GT"] = str(gt)
        aux = _train(tmp_path, 1, **over)
        assert np.isfinite(float(aux["loss"]))
        return
    with pytest.raises(NotImplementedError, match=what):
        _train(tmp_path, 1, **over)


def test_orbax_train_state_raises(tmp_path):
    (tmp_path / "step_5").mkdir()
    assert checkpoint.latest_step(str(tmp_path)) == 5
    with pytest.raises(NotImplementedError, match="A.9"):
        checkpoint.restore_train_state(str(tmp_path), 5, None)


def test_trainer_config_fields_match_motif_tpu():
    assert [f.name for f in dataclasses.fields(config.trainer_config_from_opt(
        config._to_nonedict({})))] == \
        [f.name for f in dataclasses.fields(jtrainer.TrainerConfig)]
