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

The training modes (vimeo, Adobe, Adobe_4, Adobe_flow, Adobe_a, vimeo_a)
are not ported (ROADMAP.md §A.7) and raise.
"""

from __future__ import annotations

import os
import os.path as osp
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
TRAINING_MODES = ("vimeo", "Adobe", "Adobe_4", "Adobe_flow", "Adobe_a",
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
    for the eval modes."""
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
    if mode in TRAINING_MODES:
        raise NotImplementedError(
            f"dataset mode [{mode}] is a training mode; the port has the "
            "eval modes only (ROADMAP.md §A.7)")
    raise NotImplementedError(f"Dataset mode [{mode}] is not recognized.")
