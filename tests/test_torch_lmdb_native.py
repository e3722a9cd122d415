"""The port's LMDB packs (data/lmdb_io.py) and native host core
(native/) against motif_tpu's: the lmdb readers on the duck-typed stub
environment of tests/test_data_flow_lmdb.py, Vimeo7Dataset(data_type=
"lmdb") item for item, the missing-package advice; the native core built
from the port's own preprocess.cpp bit for bit against motif_tpu.native,
each numpy fallback bit for bit against motif_tpu's, and the
arbitrary-scale collate on either package's core."""

import builtins
import os
import random

import numpy as np
import pytest

import motif_tpu.native as jnative
from motif_tpu.data import datasets as jdatasets
from motif_tpu.data import lmdb_io as jlmdb
from motif_tpu.data import pipeline as jpipeline
from motif_tpu_torch import native
from motif_tpu_torch.data import datasets, lmdb_io, pipeline
from test_data_flow_lmdb import _make_pack, _StubEnv


def test_lmdb_meta_and_read_match_motif_tpu(tmp_path):
    keys = [f"00001_0001_{v}" for v in range(1, 8)]
    store, raw = _make_pack(tmp_path, keys)
    assert lmdb_io.read_meta(str(tmp_path)) == jlmdb.read_meta(str(tmp_path))
    for size in ("3_8_12", "3x8x12", (3, 8, 12)):
        assert lmdb_io.parse_size(size) == jlmdb.parse_size(size) == (3, 8, 12)
    env = _StubEnv(store)
    for k in keys:
        got = lmdb_io.read_img_lmdb(env, k, "3_8_12")
        np.testing.assert_array_equal(got, jlmdb.read_img_lmdb(env, k,
                                                               "3_8_12"))
        assert got.flags["C_CONTIGUOUS"] and got.dtype == np.float32
    gray = {b"g": raw[keys[0]][..., :1].tobytes()}
    np.testing.assert_array_equal(
        lmdb_io.read_img_lmdb(_StubEnv(gray), "g", "1_8_12"),
        jlmdb.read_img_lmdb(_StubEnv(gray), "g", "1_8_12"))
    with pytest.raises(KeyError):
        lmdb_io.read_img_lmdb(env, "missing", "3_8_12")


def test_open_lmdb_without_the_package_gives_advice(monkeypatch):
    real = builtins.__import__

    def no_lmdb(name, *a, **kw):
        if name == "lmdb":
            raise ImportError("No module named 'lmdb'")
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_lmdb)
    with pytest.raises(ImportError, match="data_type='img'"):
        lmdb_io.open_lmdb("/nonexistent")


def test_vimeo7_lmdb_items_match_motif_tpu(tmp_path, monkeypatch):
    """Vimeo7Dataset(data_type='lmdb', load_flows=True) over two clips:
    the keys from the pack's catalogue and every item bit for bit against
    motif_tpu's from the same seed, and each environment opened once per
    process."""
    keys = [f"00001_000{c}_{v}" for c in (1, 2) for v in range(1, 8)]
    for c in (1, 2):
        for side in ("gt", "lq"):
            os.makedirs(tmp_path / side / "00001" / f"000{c}", exist_ok=True)
    gt_store, _ = _make_pack(tmp_path / "gt", keys, (3, 32, 48))
    lq_store, _ = _make_pack(tmp_path / "lq", keys, (3, 8, 12))
    rng = np.random.default_rng(0)
    for c in (1, 2):
        np.save(tmp_path / "gt" / "00001" / f"000{c}" / "hr_gt_flow.npy",
                rng.normal(size=(28, 2, 32, 48)).astype(np.float32))
        np.save(tmp_path / "lq" / "00001" / f"000{c}" / "lr_flow_12.npy",
                rng.normal(size=(16, 2, 8, 12)).astype(np.float32))
    stores = {str(tmp_path / "gt"): gt_store, str(tmp_path / "lq"): lq_store}
    opened = []

    def fake_open(path):
        opened.append(path)
        return _StubEnv(stores[path])
    monkeypatch.setattr(lmdb_io, "open_lmdb", fake_open)
    monkeypatch.setattr(jlmdb, "open_lmdb", lambda p: _StubEnv(stores[p]))
    kw = dict(keys=None, gt_size=16, scale=4, data_type="lmdb",
              load_flows=True, seed=3)
    ds = datasets.Vimeo7Dataset(str(tmp_path / "gt"), str(tmp_path / "lq"),
                                **kw)
    jds = jdatasets.Vimeo7Dataset(str(tmp_path / "gt"), str(tmp_path / "lq"),
                                  **kw)
    assert list(ds.keys) == list(jds.keys) == ["00001_0001", "00001_0002"]
    for i in (0, 1, 0):
        got, want = ds[i], jds[i]
        assert set(got) == set(want)
        for k in ("lq", "gt", "times", "flow", "flow_gt"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["lq"].shape == (4, 4, 4, 3) and got["gt"].shape == (9, 16, 16,
                                                                  3)
    assert sorted(opened) == sorted(stores)


def test_native_core_builds_from_the_ports_source():
    """The core is built from motif_tpu_torch/native/preprocess.cpp into
    build/native/, and that source is motif_tpu's but for its header."""
    assert native.available() == jnative.available()
    if not native.available():
        pytest.skip("no C++ toolchain")
    assert native._library_path((*native.FLAGS, native.OPENMP)).exists() or \
        native._library_path(native.FLAGS).exists()
    assert native.num_threads() >= 1
    body = native.SRC.read_text().split("#include <cmath>", 1)[1]
    jbody = open(jnative._SRC).read().split("#include <cmath>", 1)[1]
    assert body.replace("motif_tpu_torch/", "motif_tpu/") == jbody


@pytest.mark.parametrize("scale,aa", [(0.25, True), (0.37, True),
                                      (1 / 7.0, True), (0.5, False),
                                      (2.0, True)])
def test_native_core_is_motif_tpus_bit_for_bit(scale, aa):
    if not native.available():
        pytest.skip("no C++ toolchain")
    rng = np.random.default_rng(int(scale * 100))
    imgs = rng.random((3, 37, 41, 3), dtype=np.float32) * 255
    np.testing.assert_array_equal(native.matlab_resize_batch(imgs, scale, aa),
                                  jnative.matlab_resize_batch(imgs, scale,
                                                              aa))
    u8 = rng.integers(0, 256, (9, 11, 3)).astype(np.uint8)
    np.testing.assert_array_equal(native.u8bgr_to_f32rgb(u8),
                                  jnative.u8bgr_to_f32rgb(u8))
    a = imgs[:, :, :, :] / 255
    b = np.clip(a + rng.standard_normal(a.shape).astype(np.float32) * 0.05,
                0, 1)
    np.testing.assert_array_equal(native.y_psnr_batch(a, b),
                                  jnative.y_psnr_batch(a, b))


def test_fallbacks_are_motif_tpus_bit_for_bit(monkeypatch):
    """Without the core each function runs its numpy version: bit for bit
    motif_tpu's numpy versions (the resize within 2e-5 of the core)."""
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    assert not native.available()
    rng = np.random.default_rng(9)
    imgs = rng.random((2, 19, 23, 3), dtype=np.float32)
    for scale in (0.25, 0.5, 2.0):
        np.testing.assert_array_equal(native.matlab_resize_batch(imgs, scale),
                                      jnative.matlab_resize_batch(imgs,
                                                                  scale))
    u8 = rng.integers(0, 256, (4, 5, 3)).astype(np.uint8)
    np.testing.assert_array_equal(native.u8bgr_to_f32rgb(u8),
                                  jnative.u8bgr_to_f32rgb(u8))
    b = np.clip(imgs + 0.01, 0, 1)
    np.testing.assert_array_equal(native.y_psnr_batch(imgs, b),
                                  jnative.y_psnr_batch(imgs, b))
    monkeypatch.undo()
    if native.available():
        np.testing.assert_allclose(native.matlab_resize_batch(imgs, 0.5),
                                   jnative.matlab_resize_batch(imgs, 0.5),
                                   rtol=0, atol=2e-5)


def test_build_falls_back_when_no_compiler(monkeypatch, tmp_path):
    """No g++: the core is not available and the numpy versions run; a
    compiler that fails: the same, with its output kept."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.available() and native.BUILD_LOG == "g++ not found"
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native.shutil, "which", lambda name: "/bin/false")
    assert not native.available()
    assert not list(tmp_path.glob("*.so"))
    out = native.u8bgr_to_f32rgb(np.full((1, 1, 3), 255, np.uint8))
    np.testing.assert_array_equal(out, np.ones((1, 1, 3), np.float32))



class _Pinned(random.Random):
    def __init__(self, seed, d):
        super().__init__(seed)
        self.d = d

    def uniform(self, a, b):
        super().uniform(a, b)
        return self.d


@pytest.mark.parametrize("gt_size", [128, 176, 256])
def test_collate_on_either_core(gt_size):
    """collate_adobe_arbitrary on the port's core bit for bit against
    motif_tpu's collate on motif_tpu's core (same code, same compiler,
    same flags), in three size buckets."""
    if not native.available():
        pytest.skip("no C++ toolchain")
    rng = np.random.default_rng(gt_size)
    items = [{"lq_raw": [rng.random((262, 270, 3), dtype=np.float32)
                         for _ in range(4)],
              "gt_raw": [rng.random((262, 270, 3), dtype=np.float32)
                         for _ in range(5)],
              "times": rng.random(3).astype(np.float32)} for _ in range(2)]
    d = (gt_size + 7.5) / 64
    got = pipeline.collate_adobe_arbitrary(items, 64, _Pinned(gt_size, d))
    want = jpipeline.collate_adobe_arbitrary(items, 64, _Pinned(gt_size, d))
    assert got["out_hw"] == want["out_hw"] == (gt_size // 2, gt_size // 2)
    for k in ("lq", "gt", "times"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_read_img_goes_through_the_core(tmp_path, monkeypatch):
    """read_img converts a uint8 frame with the native core, as motif_tpu's
    does; without the core, with the numpy division, as motif_tpu's."""
    import cv2

    img = np.random.default_rng(2).integers(0, 256, (7, 9, 3), np.uint8)
    cv2.imwrite(str(tmp_path / "f.png"), img)
    p = str(tmp_path / "f.png")
    np.testing.assert_array_equal(datasets.read_img(p),
                                  jdatasets.read_img(p))
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    np.testing.assert_array_equal(datasets.read_img(p),
                                  jdatasets.read_img(p))

