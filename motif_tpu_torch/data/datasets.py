"""The eval datasets, the counterpart of motif_tpu/data/datasets.py for the
reference test modes.

Every item is channel-last RGB float32 in [0, 1]:
  {'lq': (N_in, H, W, 3), 'gt': (N+2, HH, WW, 3), 'times': (N,), 'key': str}
where gt[0] / gt[-1] are the two anchor frames (the duplicated endpoints of
the reference's gt_sampled_idx).

Frames are decoded by cv2 (imported on first use, as in the JAX package),
and the conversion to float is the JAX package's, bit for bit (`read_img`).

Windows follow Adobe_test* / Gopro_test (Adobe_test_3.py:88-109):
  inputs = frames[i : i + (1+interval)*(ref_num-1) + 1 : 1+interval]
  gts    = frames[i + (1+interval)*k : i + (1+interval)*(k+1) + 1],
  k = (ref_num-1)//2, window stride 1+interval.

The Vimeo septuplet training set (`vimeo`) follows Vimeo7_dataset.py:112-205
as the JAX package does, with the same draws from `random.Random(seed)` in
the same order: reverse, crop, hflip, vflip, rot90. Its precomputed flows
(Ours_44, ROADMAP.md §A.8) and LMDB packs (§A.7) are not ported; the other
training modes (Adobe, Adobe_4, Adobe_flow, Adobe_a, vimeo_a) raise
(§A.7).
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
import random
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from motif_tpu_torch.ops.resize import imresize_matlab_np

VID4_VIDEOS = ["walk", "foliage", "city", "calendar"]
GOPRO_VIDEOS = [  # Gopro_test.py:89-93
    "GOPR0384_11_00", "GOPR0384_11_05", "GOPR0385_11_01", "GOPR0396_11_00",
    "GOPR0410_11_00", "GOPR0854_11_00", "GOPR0862_11_00", "GOPR0868_11_00",
    "GOPR0869_11_00", "GOPR0871_11_00", "GOPR0881_11_01",
]
TRAINING_MODES = ("Adobe", "Adobe_4", "Adobe_flow", "Adobe_a",
                  "vimeo_a")
# the JAX package's native core converts uint8 with `s * (1.0f / 255.0f)`
# (a float32 multiply), which differs from `s / 255` by one float32 ulp for
# about half of the byte values
_INV255 = np.float32(1 / 255)


def read_img(path: str) -> np.ndarray:
    """A frame as RGB float32 [0, 1] HWC (data/util.py:59-83 and the
    [2, 1, 0] reindex): gray is repeated to three channels, alpha dropped."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 2:
        img = img[:, :, None].repeat(3, 2)
    if img.shape[2] > 3:
        img = img[:, :, :3]
    if img.dtype == np.uint8:
        return np.ascontiguousarray(img[:, :, ::-1]).astype(np.float32) \
            * _INV255
    return (img.astype(np.float32) / 255.0)[:, :, ::-1].copy()


def _list_frames(d: str) -> list[str]:
    frames = sorted(int(f[:-4]) for f in os.listdir(d) if f.endswith(".png"))
    return ["{:03d}.png".format(f) for f in frames]


@dataclass
class WindowEvalDataset:
    """Sliding-window eval dataset covering the Adobe_test / Adobe_test_3 /
    Gopro_test / Vimeo_test_44 modes via parameters."""
    gt_root: str
    lq_root: str
    videos: Sequence[str]
    interval: int = 1
    ref_num: int = 4
    gt_sampled_idx: Sequence[int] = (0, 0, 1, 2, 2)
    time_denom: float = 2.0

    def __post_init__(self):
        self.file_list: list[list[str]] = []
        self.gt_list: list[list[str]] = []
        interval_num = self.ref_num - 1
        step = 1 + self.interval
        k = interval_num // 2
        for video in self.videos:
            frames = _list_frames(osp.join(self.gt_root, video))
            index = 0
            while index + step * interval_num < len(frames):
                inputs = [frames[i] for i in range(index, index + step * interval_num + 1, step)]
                gts = [frames[i] for i in range(index + step * k, index + step * (k + 1) + 1)]
                self.file_list.append([osp.join(video, f) for f in inputs])
                self.gt_list.append([osp.join(video, f) for f in gts])
                index += step

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, index: int) -> dict:
        idx = list(self.gt_sampled_idx)
        gt_paths = np.array([osp.join(self.gt_root, f) for f in self.gt_list[index]])[idx]
        lq_paths = [osp.join(self.lq_root, f) for f in self.file_list[index]]
        lq = np.stack([read_img(p) for p in lq_paths], 0)
        gt = np.stack([read_img(p) for p in gt_paths], 0)
        times = np.asarray([i / self.time_denom for i in idx[1:-1]], np.float32)
        return {"lq": lq, "gt": gt, "times": times,
                "key": self.file_list[index][0]}


@dataclass
class ArbitraryScaleTestDataset:
    """GoPro arbitrary space-time test (Adobe_arbitrary_test.py +
    collate_function_test): interval = time-1, all GT frames, crop 720x1248,
    LQ = MATLAB bicubic 1/d_scale."""
    root: str
    videos: Sequence[str] = field(default_factory=lambda: list(GOPRO_VIDEOS))
    ref_num: int = 4
    time: int = 9
    d_scale: float = 4.0

    def __post_init__(self):
        self.interval = self.time - 1
        self._base = WindowEvalDataset(
            self.root, self.root, self.videos,
            interval=self.interval, ref_num=self.ref_num,
            gt_sampled_idx=[0] + list(range(self.time)) + [self.time - 1],
            time_denom=float(self.time - 1))

    def __len__(self):
        return len(self._base)

    def __getitem__(self, index: int):
        item = self._base[index]
        gt = item["gt"][:, :720, :1248]
        lq_hr = item["lq"][:, :720, :1248]
        lq = np.stack([imresize_matlab_np(v * 255.0, 1.0 / self.d_scale) / 255.0
                       for v in lq_hr], 0).astype(np.float32)
        return {"lq": lq, "gt": gt, "times": item["times"], "key": item["key"]}


@dataclass
class Vimeo7Dataset:
    """The Vimeo-90K septuplet training set (Vimeo7_dataset.py): GT frames
    im1, im1..im7, im7 (the anchors duplicated at the ends) and LQ frames
    im1, im3, im5, im7; in the train phase a random reverse, a random crop
    and flip / transpose augmentation. Items:
    {'lq': (4, s, s, 3), 'gt': (9, GT_size, GT_size, 3), 'times': (7,),
    'key': 'a_b'} with s = GT_size / scale."""
    gt_root: str
    lq_root: str
    keys: Sequence[str] | str = "sep_trainlist.txt"
    gt_size: int = 128
    scale: int = 4
    n_frames: int = 7
    random_reverse: bool = True
    use_flip: bool = True
    use_rot: bool = True
    load_flows: bool = False
    data_type: str = "img"
    phase: str = "train"
    seed: int | None = None

    def __post_init__(self):
        if self.load_flows:
            raise NotImplementedError(
                "Vimeo7Dataset: precomputed flows (Ours_44 training) are not "
                "ported (ROADMAP.md §A.8)")
        if self.data_type == "lmdb":
            raise NotImplementedError(
                "Vimeo7Dataset: LMDB packs are not ported (ROADMAP.md §A.7)")
        if isinstance(self.keys, str):
            if osp.exists(self.keys) or osp.isabs(self.keys):
                path = self.keys
            else:  # a bare file name: next to the GT root
                path = osp.join(osp.dirname(self.gt_root.rstrip("/")),
                                self.keys)
            if path.endswith(".pkl"):
                with open(path, "rb") as f:
                    self.keys = pickle.load(f)
            else:
                with open(path) as f:
                    self.keys = [ln.strip().replace("/", "_")
                                 for ln in f if ln.strip()]
        half = self.n_frames // 2
        self.lr_index_list = [i * 2 for i in range(1 + half)]  # 0, 2, 4, 6
        self._rng = random.Random(self.seed)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index: int) -> dict:
        key = self.keys[index]
        name_a, name_b = key.split("_")
        neighbor = list(range(1, 8))
        if self.random_reverse and self._rng.random() < 0.5:
            neighbor.reverse()
        gt_dir = osp.join(self.gt_root, name_a, name_b)
        lq_dir = osp.join(self.lq_root, name_a, name_b)
        gts = [read_img(osp.join(gt_dir, f"im{v}.png"))
               for v in [1] + neighbor + [7]]
        lqs = [read_img(osp.join(lq_dir, f"im{neighbor[i]}.png"))
               for i in self.lr_index_list]
        times = np.asarray([(v - 1) / 6.0 for v in neighbor], np.float32)

        if self.phase == "train":
            H, W = lqs[0].shape[:2]
            lq_size = self.gt_size // self.scale
            rh = self._rng.randint(0, max(0, H - lq_size))
            rw = self._rng.randint(0, max(0, W - lq_size))
            lqs = [v[rh:rh + lq_size, rw:rw + lq_size] for v in lqs]
            rh4, rw4 = rh * self.scale, rw * self.scale
            gts = [v[rh4:rh4 + self.gt_size, rw4:rw4 + self.gt_size]
                   for v in gts]
            # flip / transpose augmentation (data/util.py:92-128)
            hflip = self.use_flip and self._rng.random() < 0.5
            vflip = self.use_rot and self._rng.random() < 0.5
            rot90 = self.use_rot and self._rng.random() < 0.5

            def aug(img):
                if hflip:
                    img = img[:, ::-1]
                if vflip:
                    img = img[::-1]
                if rot90:
                    img = img.transpose(1, 0, 2)
                return np.ascontiguousarray(img)

            lqs = [aug(v) for v in lqs]
            gts = [aug(v) for v in gts]
        return {"lq": np.stack(lqs, 0), "gt": np.stack(gts, 0),
                "times": times, "key": key}


# window presets of the eval modes
WINDOW_MODES = {
    # Adobe_test.py:168-176 / Gopro_test.py:174-182: [0,0,1..8,8], i/8
    "Adobe_test": dict(interval=7, gt_sampled_idx=[0, 0] + list(range(1, 9)) + [8],
                       time_denom=8.0),
    # Adobe_test_3.py:158-166 (default test.yml): [0,0,1,2,2], i/2
    "Adobe_test_3": dict(interval=1, gt_sampled_idx=[0, 0, 1, 2, 2], time_denom=2.0),
    "Gopro_test": dict(interval=7, gt_sampled_idx=[0, 0] + list(range(1, 9)) + [8],
                       time_denom=8.0),
    # Vimeo_test_44.py:87,165: [0,0,1..6,6], i/6
    "Vimeo_test_44": dict(interval=5, gt_sampled_idx=[0, 0] + list(range(1, 7)) + [6],
                          time_denom=6.0),
}


def create_dataset(opt: dict):
    """Factory keyed by the reference mode strings (data/__init__.py:57-88),
    for the eval modes and `vimeo`."""
    mode = opt["mode"]
    if mode in WINDOW_MODES:
        videos = opt.get("videos")
        if videos is None:
            videos = (VID4_VIDEOS if mode in ("Adobe_test_3", "Vimeo_test_44")
                      else GOPRO_VIDEOS if mode == "Gopro_test"
                      else sorted(os.listdir(opt["dataroot_GT"])))
        return WindowEvalDataset(opt["dataroot_GT"], opt["dataroot_LQ"], videos,
                                 ref_num=opt.get("ref_num", 4),
                                 **WINDOW_MODES[mode])
    if mode == "Gopro_test_a":
        return ArbitraryScaleTestDataset(opt["dataroot_GT"],
                                         videos=opt.get("videos", GOPRO_VIDEOS),
                                         time=opt.get("time", 9),
                                         d_scale=opt.get("d_scale", 4.0))
    if mode == "vimeo":
        # the JAX package's default: no precomputed flows (a 2-anchor model
        # computes its teacher flow live)
        return Vimeo7Dataset(opt["dataroot_GT"], opt["dataroot_LQ"],
                             keys=opt.get("cache_keys") or "sep_trainlist.txt",
                             gt_size=opt.get("GT_size", 128),
                             scale=opt.get("scale", 4),
                             n_frames=opt.get("N_frames", 7),
                             random_reverse=opt.get("random_reverse", True),
                             use_flip=opt.get("use_flip", True),
                             use_rot=opt.get("use_rot", True),
                             load_flows=bool(opt.get("load_flows", False)),
                             data_type=opt.get("data_type", "img"),
                             phase=opt.get("phase", "train"))
    if mode in TRAINING_MODES:
        raise NotImplementedError(
            f"dataset mode [{mode}] is a training mode the port does not "
            "have; it has the eval modes and vimeo (ROADMAP.md §A.7)")
    raise NotImplementedError(f"Dataset mode [{mode}] is not recognized.")
