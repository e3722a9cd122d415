"""The port's eval data against motif_tpu's, with no model: `read_img` bit
for bit on every PNG of the repository, every item of the eval datasets,
the MATLAB resize, and the batch loader."""

import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest

from motif_tpu.data import datasets as jdatasets
from motif_tpu.data import pipeline as jpipeline
from motif_tpu.ops import resize as jresize
from motif_tpu_torch.data import datasets, pipeline
from motif_tpu_torch.ops import resize

ROOT = pathlib.Path(__file__).resolve().parents[1]
PNGS = sorted((ROOT / "data").rglob("*.png"))
VID4 = ROOT / "data" / "Vid4"


def test_read_img_is_bit_equal_on_every_png():
    assert len(PNGS) == 92
    for path in PNGS:
        got, want = datasets.read_img(str(path)), jdatasets.read_img(str(path))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), err_msg=str(path))


def test_read_img_raises_on_a_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        datasets.read_img(str(tmp_path / "none.png"))


def test_the_eval_modules_import_neither_opencv_nor_pyyaml():
    """cv2 and yaml are imported where a frame or a yml is read, not when
    the package is imported."""
    code = ("import sys\n"
            "sys.modules['cv2'] = sys.modules['yaml'] = None\n"
            "import motif_tpu_torch.test, motif_tpu_torch.data, "
            "motif_tpu_torch.utils.config, motif_tpu_torch.eval\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=120)


def _items_equal(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert set(g) == set(w) and g["key"] == w["key"]
        for k in ("lq", "gt", "times"):
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{i} {k}")


@pytest.mark.parametrize("opt", [
    dict(mode="Adobe_test_3"),
    dict(mode="Vimeo_test_44"),
    dict(mode="Vimeo_test_44", ref_num=2),
    dict(mode="Adobe_test", videos=datasets.VID4_VIDEOS, ref_num=2),
    dict(mode="Gopro_test_a", dataroot_GT=str(VID4 / "HR"),
         videos=datasets.VID4_VIDEOS, time=3),
    dict(mode="Gopro_test_a", dataroot_GT=str(VID4 / "HR"),
         videos=datasets.VID4_VIDEOS, time=2),
], ids=["adobe_test_3", "vimeo_test_44", "vimeo_test_44-ref2",
        "adobe_test-ref2", "gopro_test_a-time3", "gopro_test_a-time2"])
def test_eval_datasets_match_motif_tpu(opt):
    """On 8-frame clips Vimeo_test_44 (a 19-frame window) and Gopro_test_a
    at time 3 have no window; ref_num 2 and time 2 give each clip some."""
    opt = {"dataroot_GT": str(VID4 / "HR"), "dataroot_LQ": str(VID4 / "LR"),
           **opt}
    got, want = datasets.create_dataset(opt), jdatasets.create_dataset(opt)
    _items_equal(got, want)
    if opt["mode"] == "Adobe_test_3":
        assert len(got) == 4
        assert got[0]["lq"].shape == (4, 16, 24, 3)
        assert got[0]["gt"].shape == (5, 64, 96, 3)


@pytest.mark.parametrize("mode", ["Adobe", "Adobe_4", "Adobe_flow",
                                  "Adobe_a", "vimeo_a"])
def test_training_modes_raise(mode, tmp_path):
    """The training modes the port once refused now build as motif_tpu's
    do (their items: tests/test_torch_adobe_data.py); an unknown mode
    raises in both, and so does an LMDB pack without its meta_info.pkl
    (LMDB packs read as motif_tpu's: tests/test_torch_lmdb_native.py)."""
    import cv2

    vimeo = mode.startswith("vimeo")
    root = tmp_path / ("GT" if vimeo else "HR")
    d = root / ("00001/0001" if vimeo else "clip")
    d.mkdir(parents=True)
    for i in range(7 if vimeo else 10):
        cv2.imwrite(str(d / (f"im{i + 1}.png" if vimeo else f"{i:03d}.png")),
                    np.zeros((8, 8, 3), np.uint8))
    (tmp_path / "keys.txt").write_text("00001/0001\n")
    opt = {"mode": mode, "dataroot_GT": str(root),
           "dataroot_LQ": str(root),
           "cache_keys": str(tmp_path / "keys.txt")}
    got, want = datasets.create_dataset(opt), jdatasets.create_dataset(opt)
    assert type(got).__name__ == type(want).__name__
    assert len(got) == len(want) == 1
    assert getattr(got, "load_flows", None) == getattr(want, "load_flows",
                                                       None)
    with pytest.raises(NotImplementedError, match="not recognized"):
        datasets.create_dataset({"mode": "no_such_mode"})
    for create in (datasets.create_dataset, jdatasets.create_dataset):
        with pytest.raises(FileNotFoundError, match="meta_info.pkl"):
            create({**opt, "mode": "vimeo", "data_type": "lmdb"})


@pytest.mark.parametrize("shape,scale", [((32, 48, 3), 0.25), ((33, 47, 3), 0.5),
                                         ((30, 45, 3), 1 / 3), ((16, 24, 3), 2.0)])
def test_imresize_matlab_np_is_bit_equal(shape, scale):
    img = np.random.default_rng(0).random(shape) * 255.0
    got, want = resize.imresize_matlab_np(img, scale), \
        jresize.imresize_matlab_np(img, scale)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        resize.matlab_resize_matrix(shape[0], 8, scale),
        jresize.matlab_resize_matrix(shape[0], 8, scale))


class _Toy:
    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise KeyError(f"item {i}")
        return {"x": np.full((2,), i, np.float32), "key": f"k{i}"}


@pytest.mark.parametrize("kw", [
    dict(batch_size=1), dict(batch_size=3), dict(batch_size=3, drop_last=False),
    dict(batch_size=2, shuffle=True, seed=5),
    dict(batch_size=3, shuffle=True, epoch_ratio=2, drop_last=False),
], ids=["b1", "b3", "b3-keep-last", "shuffle", "shuffle-ratio2"])
def test_batch_loader_matches_motif_tpu(kw):
    for epoch in (0, 1):
        got = list(pipeline.BatchLoader(_Toy(10), **kw).epoch(epoch))
        want = list(jpipeline.BatchLoader(_Toy(10), **kw).epoch(epoch))
        assert len(got) == len(want) == len(pipeline.BatchLoader(_Toy(10), **kw))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["x"], w["x"])
            assert g["key"] == w["key"]


def test_batch_loader_raises_the_loading_error_and_stops_its_thread():
    before = threading.active_count()
    with pytest.raises(KeyError, match="item 4"):
        list(pipeline.BatchLoader(_Toy(10, fail_at=4)).epoch())
    it = pipeline.BatchLoader(_Toy(10)).epoch()
    assert next(it)["key"] == ["k0"]
    it.close()                              # a consumer that stops early
    assert threading.active_count() == before
