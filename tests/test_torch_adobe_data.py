"""The port's training data for the Adobe and arbitrary-scale modes
against motif_tpu's, with no model: the items of `Adobe` / `Adobe_4` /
`Adobe_flow` / `Adobe_a` / `vimeo_a` bit for bit (the same draws from
`random.Random(seed)`, the flows' flips and transpose included), the
arbitrary-scale collate bit for bit against motif_tpu's numpy fallback
and within 2e-5 of its native core in every size bucket, and every yml of
configs/grid/ the port trains, from the yml to `define_g`, the dataset
and one collated batch, against motif_tpu on a synthetic tree.

The trees are built as tests/test_config_lint.py and
tests/test_data_flow_lmdb.py build theirs: random PNGs (GT 4x the LQ),
the flow arrays of `Adobe_flow` in the reference layout.
"""

import contextlib
import dataclasses
import functools
import glob
import os
import random

import numpy as np
import pytest
import torch

from motif_tpu import native
from motif_tpu_torch import native as tnative
from motif_tpu.data import datasets as jdatasets
from motif_tpu.data import pipeline as jpipeline
from motif_tpu.models import factory as jfactory
from motif_tpu.utils import config as jconfig
from motif_tpu_torch.data import datasets, pipeline
from motif_tpu_torch.models.motif import MoTIF
from motif_tpu_torch.models.videoinr import VideoINR
from motif_tpu_torch.utils import config

GRID = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..",
                                     "configs", "grid", "*.yml")))
# every recipe trains in the port, the 4 LIIF ones (train_INR_*) too
TRAINED = GRID
LIIF = [p for p in GRID if os.path.basename(p).startswith("train_INR_")]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    import cv2

    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("adobe_data")

    def frames(d, n, hw, names=None):
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            name = names[i] if names else f"{i:03d}.png"
            cv2.imwrite(str(d / name),
                        rng.integers(0, 255, (*hw, 3), np.uint8))

    adobe = root / "adobe"
    for clip in ("clip0", "clip1"):
        frames(adobe / "HR" / clip, 19, (136, 144))
        frames(adobe / "LR" / clip, 19, (34, 36))
        for n1, n2 in (("000", "002"), ("008", "010")):
            base = str(adobe / "LR" / clip / f"{n1}_{n2}")
            np.save(base + "_flow.npy",
                    rng.normal(size=(4, 2, 34, 36)).astype(np.float32))
            np.save(base + "_psies.npy",
                    rng.normal(size=(4, 3, 34, 36)).astype(np.float32))
            np.save(base + "_flow_GT.npy",
                    rng.normal(size=(18, 2, 136, 144)).astype(np.float32))
    vimeo = root / "vimeo"
    for key in ("00001_0001", "00001_0002"):
        a, b = key.split("_")
        frames(vimeo / "GT" / a / b, 7, (136, 144),
               [f"im{v}.png" for v in range(1, 8)])
        frames(vimeo / "LQ" / a / b, 7, (34, 36),
               [f"im{v}.png" for v in range(1, 8)])
    with open(vimeo / "keys.txt", "w") as f:
        f.write("00001/0001\n00001/0002\n")
    return {"adobe": adobe, "vimeo": vimeo}


def _opt(trees, mode, **kw):
    if mode.startswith("vimeo"):
        v = trees["vimeo"]
        return {"mode": mode, "dataroot_GT": str(v / "GT"),
                "dataroot_LQ": str(v / "LQ"),
                "cache_keys": str(v / "keys.txt"), **kw}
    a = trees["adobe"]
    return {"mode": mode, "dataroot_GT": str(a / "HR"),
            "dataroot_LQ": str(a / "LR"), **kw}


def _equal(got, want, what=""):
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
        elif isinstance(w, list) and w and isinstance(w[0], np.ndarray):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")
        else:
            assert g == w, (what, k)


def _flip_draws(seed, sample_num, lq_hw, lq_size):
    """The (hflip, vflip, rot90) an Adobe dataset from `seed` draws for
    its first item: the times, the corner, then the three flips."""
    r = random.Random(seed)
    r.sample(range(9), sample_num)
    r.randint(0, max(0, lq_hw[0] - lq_size))
    r.randint(0, max(0, lq_hw[1] - lq_size))
    return tuple(r.random() < 0.5 for _ in range(3))


@pytest.mark.parametrize("mode", ["Adobe", "Adobe_4", "Adobe_flow"])
def test_septuplet_items_match_motif_tpu(trees, mode):
    """Seeds until the first item has drawn every combination of hflip,
    vflip and rot90 (for Adobe_flow: the flows with their sign fixes, the
    psies without); each item bit for bit, and the other items of one
    dataset in turn (its generator moves on)."""
    opt = _opt(trees, mode, sample_num=3, GT_size=64)
    seen = set()
    for seed in range(64):
        got = dataclasses.replace(datasets.create_dataset(opt), seed=seed)
        want = dataclasses.replace(jdatasets.create_dataset(opt), seed=seed)
        assert len(got) == len(want) == 4
        _equal(got[0], want[0], f"seed {seed}")
        seen.add(_flip_draws(seed, 3, (34, 36), 16))
        if len(seen) == 8:
            break
    assert len(seen) == 8
    for i in range(1, 4):
        _equal(got[i], want[i], f"item {i}")
    if mode == "Adobe_flow":
        item = got[0]
        assert item["flow"].shape == (4, 16, 16, 2)
        assert item["psies"].shape == (4, 16, 16, 3)
        assert item["flow_gt"].shape == (3, 2, 64, 64, 2)


@pytest.mark.parametrize("mode", ["Adobe_a", "vimeo_a"])
def test_arbitrary_items_match_motif_tpu(trees, mode):
    opt = _opt(trees, mode, sample_num=3)
    got = dataclasses.replace(datasets.create_dataset(opt), seed=3)
    want = dataclasses.replace(jdatasets.create_dataset(opt), seed=3)
    assert len(got) == len(want) == (4 if mode == "Adobe_a" else 2)
    for i in range(len(want)):
        g, w = got[i], want[i]
        _equal(g, w, f"item {i}")
        assert len(g["lq_raw"]) == 4 and len(g["gt_raw"]) == 5


class _Pinned(random.Random):
    """A generator whose d_scale draw is `d`; every other draw its own."""

    def __init__(self, seed, d):
        super().__init__(seed)
        self.d = d

    def uniform(self, a, b):
        super().uniform(a, b)
        return self.d


BUCKETS = list(range(128, 257, 16))     # LQ_size 64: crops 128 .. 256


@pytest.mark.parametrize("gt_size", BUCKETS)
def test_collate_matches_motif_tpu_in_every_bucket(gt_size, monkeypatch):
    """LQ_size 64, d_scale pinned inside the bucket (each seed's own
    corner and flips): bit for bit against motif_tpu's collate on its
    numpy fallback (the port's native core unloaded too), within 2e-5
    against its native core (the port's on its own native core)."""
    rng = np.random.default_rng(gt_size)
    items = [{"lq_raw": [rng.random((262, 270, 3), dtype=np.float32)
                         for _ in range(4)],
              "gt_raw": [rng.random((262, 270, 3), dtype=np.float32)
                         for _ in range(5)],
              "times": rng.random(3).astype(np.float32)} for _ in range(2)]
    d = (gt_size + 7.5) / 64
    got = pipeline.collate_adobe_arbitrary(items, 64, _Pinned(gt_size, d))
    assert got["out_hw"] == (gt_size // 2, gt_size // 2)
    assert got["lq"].shape == (2, 4, 32, 32, 3)
    assert got["gt"].shape == (2, 5, gt_size // 2, gt_size // 2, 3)
    if native.available():
        near = jpipeline.collate_adobe_arbitrary(items, 64,
                                                 _Pinned(gt_size, d))
        assert near["out_hw"] == got["out_hw"]
        for k in ("lq", "gt"):
            np.testing.assert_allclose(got[k], near[k], rtol=0, atol=2e-5)
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    got = pipeline.collate_adobe_arbitrary(items, 64, _Pinned(gt_size, d))
    want = jpipeline.collate_adobe_arbitrary(items, 64, _Pinned(gt_size, d))
    _equal(got, want)


def test_collate_draws_as_motif_tpu():
    """Unpinned: the same d_scale, corner and flips from the same seeds
    (the sizes and the frames of 6 batches, the numpy fallback)."""
    rng = np.random.default_rng(1)
    items = [{"lq_raw": [rng.random((130, 140, 3), dtype=np.float32)
                         for _ in range(4)],
              "gt_raw": [rng.random((130, 140, 3), dtype=np.float32)
                         for _ in range(3)],
              "times": np.asarray([0.5], np.float32)}]
    a, b = random.Random(11), random.Random(11)
    with _resize_fallback():
        for _ in range(6):
            _equal(pipeline.collate_adobe_arbitrary(items, 32, a),
                   jpipeline.collate_adobe_arbitrary(items, 32, b))


def test_grid_counts():
    """31 training ymls, all trained by the port, 4 of them LIIF."""
    assert len(GRID) == 31 and len(TRAINED) == 31 and len(LIIF) == 4


@contextlib.contextmanager
def _resize_fallback():
    """Both packages' MATLAB resize on its numpy fallback (each native core
    unloaded for that call only, as tests/test_native.py unloads
    motif_tpu's); the frame decoding keeps the native cores, which agree
    bit for bit."""
    reals = [(mod, mod.matlab_resize_batch) for mod in (native, tnative)]

    def fallback(mod, real):
        def resize(*a, **kw):
            saved = mod._load
            mod._load = lambda: None
            try:
                return real(*a, **kw)
            finally:
                mod._load = saved
        return resize
    for mod, real in reals:
        mod.matlab_resize_batch = fallback(mod, real)
    try:
        yield
    finally:
        for mod, real in reals:
            mod.matlab_resize_batch = real


@pytest.mark.parametrize("path", TRAINED,
                         ids=[os.path.basename(p) for p in TRAINED])
def test_grid_yml_builds_and_batches_as_motif_tpu(path, trees):
    """yml -> `train.setup` (the model at full width, the yml's model and
    setting, its dataset on the synthetic tree at GT 64, batch 1, and the
    Trainer of its family) -> one batch (an `_a` mode through the collate
    at its yml's LQ_size, d_scale pinned to 4 as
    tests/test_config_lint.py pins it): the batch equals motif_tpu's."""
    from motif_tpu_torch import train

    opt, jopt = config.parse(path, is_train=True), \
        jconfig.parse(path, is_train=True)
    dopt = dict(opt["datasets"]["train"])
    mode = dopt["mode"]
    dopt.update(_opt(trees, mode), GT_size=64, batch_size=1,
                sample_num=min(int(dopt.get("sample_num") or 3), 3))
    net = opt["network_G"]
    m, _, tr = train.setup({**opt, "datasets": {"train": dopt}}, "cpu")
    jm = jfactory.define_g(jopt["network_G"])
    if net["which_model_G"] == "LIIF":   # the 4 LQ frames of every mode
        assert isinstance(m, VideoINR) and m.nf == jm.nf == 64
        assert m.n_frames == 4 and tr.family == "LIIF"
        assert not tr.flow_loss
    else:
        assert isinstance(m, MoTIF) and m.channel == jm.channel == 64
        assert (m.setting, m.linear_motion, m.n_anchors) == (
            jm.setting, jm.linear_motion, jm.n_anchors)
    kw, jkw = {}, {}
    if mode.endswith("_a"):
        lq = int(dopt["LQ_size"])
        kw["collate"] = functools.partial(pipeline.collate_adobe_arbitrary,
                                          lq_size=lq, rng=_Pinned(0, 4.0))
        jkw["collate"] = functools.partial(jpipeline.collate_adobe_arbitrary,
                                           lq_size=lq, rng=_Pinned(0, 4.0))
    ds = dataclasses.replace(datasets.create_dataset(dopt), seed=0)
    jds = dataclasses.replace(jdatasets.create_dataset(dopt), seed=0)
    with _resize_fallback():
        got = next(iter(pipeline.BatchLoader(ds, batch_size=1,
                                             **kw).epoch(0)))
        want = next(iter(jpipeline.BatchLoader(jds, batch_size=1,
                                               **jkw).epoch(0)))
    _equal(got, want, os.path.basename(path))
    assert got["gt"].shape[2:4] == (64, 64)


@pytest.mark.parametrize("path", LIIF, ids=lambda p: os.path.basename(p))
def test_liif_recipes_point_at_what_waits(path, tmp_path):
    """The LIIF ymls, which waited for LIIF training, train: their Trainer
    takes the family with no flow loss; what the port still refuses
    (Ours_flow, a flow precomputer; a baseline the grid does not train)
    raises in the CLI and in Trainer."""
    from motif_tpu_torch import train
    from motif_tpu_torch.trainer import Trainer, TrainerConfig

    opt = config.parse(path, is_train=True)
    assert opt["network_G"]["which_model_G"] == "LIIF"
    tr = Trainer(torch.nn.Linear(1, 1), TrainerConfig(), family="LIIF")
    assert tr.family == "LIIF" and not tr.flow_loss
    assert tr.draw_use_gt() is False
    for which in ("Ours_flow", "EDVR"):
        with pytest.raises(NotImplementedError, match="no training"):
            Trainer(torch.nn.Linear(1, 1), TrainerConfig(), family=which)
        with pytest.raises(NotImplementedError, match="no training"):
            train.main(["-opt", path, "--device", "cpu"],
                       overrides={"path": {"root": str(tmp_path)},
                                  "network_G": {"which_model_G": which}})


def _lq32_batch():
    """An Adobe_a batch at the grid's LQ_size 32 with d_scale 2.5: a crop
    of 80, GT (and the output) 40 px, LQ 16 px."""
    rng = np.random.default_rng(2)
    item = {"lq_raw": [rng.random((96, 96, 3), dtype=np.float32)
                       for _ in range(4)],
            "gt_raw": [rng.random((96, 96, 3), dtype=np.float32)
                       for _ in range(4)],
            "times": np.asarray([0.25, 0.75], np.float32)}
    batch = pipeline.collate_adobe_arbitrary([item], 32, _Pinned(0, 2.5))
    assert batch["out_hw"] == (40, 40) and batch["lq"].shape[2] == 16
    return batch


def test_lq_size_32_is_refused_by_both_packages():
    """RAFT's 4-level correlation pyramid needs 64 px a side at the
    output: motif_tpu asserts it while tracing, the port raises at the
    same place (ROADMAP.md §C)."""
    import jax
    import jax.numpy as jnp

    from motif_tpu.models.motif import MoTIF as JMoTIF

    batch = _lq32_batch()
    lq, tt = batch["lq"], batch["times"]
    jm = JMoTIF(setting=5, channel=16, front_rbs=1, back_rbs=1)
    with pytest.raises(AssertionError, match="too small for a 4-level"):
        jax.eval_shape(lambda k: jm.init(k, jnp.asarray(lq), jnp.asarray(tt),
                                         (40, 40), iters=1),
                       jax.random.PRNGKey(0))
    m = MoTIF(16, 1, 1)
    with pytest.raises(ValueError, match="too small for a 4-level"):
        m(torch.from_numpy(lq), torch.from_numpy(tt), (40, 40), iters=1)
