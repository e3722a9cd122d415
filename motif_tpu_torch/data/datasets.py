"""The datasets, the counterpart of motif_tpu/data/datasets.py: the
reference test modes and the training modes.

Every eval item is channel-last RGB float32 in [0, 1]:
  {'lq': (N_in, H, W, 3), 'gt': (N+2, HH, WW, 3), 'times': (N,), 'key': str}
where gt[0] / gt[-1] are the two anchor frames (the duplicated endpoints of
the reference's gt_sampled_idx).

Frames are decoded by cv2 (imported on first use, as in the JAX package),
and the conversion to float is the JAX package's, bit for bit (`read_img`).

Windows follow Adobe_test* / Gopro_test (Adobe_test_3.py:88-109):
  inputs = frames[i : i + (1+interval)*(ref_num-1) + 1 : 1+interval]
  gts    = frames[i + (1+interval)*k : i + (1+interval)*(k+1) + 1],
  k = (ref_num-1)//2, window stride 1+interval.

The training sets draw from `random.Random(seed)` what the JAX package
draws, in the same order, so that both give the same items:
  * `vimeo` (Vimeo7_dataset.py:112-205): reverse, crop, hflip, vflip,
    rot90; with `load_flows` also the precomputed flows a four-anchor
    model trains on (`hr_gt_flow.npy`, `lr_flow_12.npy`; `python -m
    motif_tpu_torch.precompute_flows` writes them);
  * `Adobe` / `Adobe_4` / `Adobe_flow` (Adobe_dataset.py, _4, _flow):
    septuplet windows, the sampled times, crop, hflip, vflip, rot90; for
    `Adobe_flow` also the window's `_flow` / `_psies` / `_flow_GT` arrays,
    cropped and flipped with the frames (psies without the sign fixes);
  * `Adobe_a` / `vimeo_a` (Adobe_arbitrary.py, Vimeo_dataset_arbitrary.py):
    the sampled times; the raw frames go to the batch collate
    (`pipeline.collate_adobe_arbitrary`), which draws the scale and crop.
The LMDB packs (ROADMAP.md §A.9) are not ported.
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
    # the LQ frames are the GT window's frames at these indices instead of
    # the window's inputs (`SEPTUPLET_LQ` for a four-anchor model)
    lq_index: Sequence[int] | None = None

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
        lq_files = self.file_list[index] if self.lq_index is None else \
            [self.gt_list[index][i] for i in self.lq_index]
        lq_paths = [osp.join(self.lq_root, f) for f in lq_files]
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


def load_keys(path: str) -> list[str]:
    """Vimeo clip keys 'a_b' from a .pkl list or a .txt of 'a/b' lines."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            return pickle.load(f)
    with open(path) as f:
        return [ln.strip().replace("/", "_") for ln in f if ln.strip()]


@dataclass
class Vimeo7Dataset:
    """The Vimeo-90K septuplet training set (Vimeo7_dataset.py): GT frames
    im1, im1..im7, im7 (the anchors duplicated at the ends) and LQ frames
    im1, im3, im5, im7; in the train phase a random reverse, a random crop
    and flip / transpose augmentation. Items:
    {'lq': (4, s, s, 3), 'gt': (9, GT_size, GT_size, 3), 'times': (7,),
    'key': 'a_b'} with s = GT_size / scale; with `load_flows` also
    'flow' (16, s, s, 2), the LR anchor i → anchor j flows in i·4+j order,
    and 'flow_gt' (7, 4, GT_size, GT_size, 2), the GT anchor → time flows,
    read from each clip's `LR/<a>/<b>/lr_flow_12.npy` (16, 2, h, w) and
    `GT/<a>/<b>/hr_gt_flow.npy` (28, 2, H, W), reversed, cropped and
    augmented with the frames. The flips keep the reference's signs: an
    hflip negates channel 1, a vflip channel 0, and the transpose swaps
    the two channels."""
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
        if self.data_type == "lmdb":
            raise NotImplementedError(
                "Vimeo7Dataset: LMDB packs are not ported (ROADMAP.md §A.9)")
        if isinstance(self.keys, str):
            if osp.exists(self.keys) or osp.isabs(self.keys):
                path = self.keys
            else:  # a bare file name: next to the GT root
                path = osp.join(osp.dirname(self.gt_root.rstrip("/")),
                                self.keys)
            self.keys = load_keys(path)
        half = self.n_frames // 2
        self.lr_index_list = [i * 2 for i in range(1 + half)]  # 0, 2, 4, 6
        self._rng = random.Random(self.seed)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index: int) -> dict:
        key = self.keys[index]
        name_a, name_b = key.split("_")
        neighbor = list(range(1, 8))
        # drawn whether or not it is used, as the JAX package draws it
        reverse = self._rng.random() < 0.5 and self.random_reverse
        if reverse:
            neighbor.reverse()
        gt_dir = osp.join(self.gt_root, name_a, name_b)
        lq_dir = osp.join(self.lq_root, name_a, name_b)
        gts = [read_img(osp.join(gt_dir, f"im{v}.png"))
               for v in [1] + neighbor + [7]]
        lqs = [read_img(osp.join(lq_dir, f"im{neighbor[i]}.png"))
               for i in self.lr_index_list]
        times = np.asarray([(v - 1) / 6.0 for v in neighbor], np.float32)
        if self.load_flows:
            # channel-first (K, 2, h, w) as the reference writes them
            gt_flow = np.load(osp.join(gt_dir, "hr_gt_flow.npy")).astype(
                np.float32)
            lr_flow = np.load(osp.join(lq_dir, "lr_flow_12.npy")).astype(
                np.float32)
            if reverse:   # Vimeo7_dataset.py:159-162: times and anchors
                _, _, h, w = gt_flow.shape
                gt_flow = np.flip(np.flip(gt_flow.reshape(7, 4, 2, h, w), 0),
                                  1).reshape(28, 2, h, w)
                lr_flow = np.flip(np.flip(lr_flow.reshape(
                    4, 4, 2, h // 4, w // 4), 0), 1).reshape(
                        16, 2, h // 4, w // 4)

        if self.phase == "train":
            H, W = lqs[0].shape[:2]
            lq_size = self.gt_size // self.scale
            rh = self._rng.randint(0, max(0, H - lq_size))
            rw = self._rng.randint(0, max(0, W - lq_size))
            lqs = [v[rh:rh + lq_size, rw:rw + lq_size] for v in lqs]
            rh4, rw4 = rh * self.scale, rw * self.scale
            gts = [v[rh4:rh4 + self.gt_size, rw4:rw4 + self.gt_size]
                   for v in gts]
            if self.load_flows:
                lr_flow = lr_flow[:, :, rh:rh + lq_size, rw:rw + lq_size]
                gt_flow = gt_flow[:, :, rh4:rh4 + self.gt_size,
                                  rw4:rw4 + self.gt_size]
            flips = _draw_flips(self._rng, self.use_flip, self.use_rot)
            lqs = [_aug_img(v, flips) for v in lqs]
            gts = [_aug_img(v, flips) for v in gts]
            if self.load_flows:
                lr_flow = _aug_flow(lr_flow, flips)
                gt_flow = _aug_flow(gt_flow, flips)
        out = {"lq": np.stack(lqs, 0), "gt": np.stack(gts, 0),
               "times": times, "key": key}
        if self.load_flows:
            out["flow"] = lr_flow.transpose(0, 2, 3, 1)
            g = gt_flow.transpose(0, 2, 3, 1)
            out["flow_gt"] = g.reshape(7, 4, *g.shape[1:3], 2)
        return out


def _draw_flips(rng: random.Random, use_flip: bool, use_rot: bool):
    """(hflip, vflip, rot90) as the reference draws them (data/util.py:
    92-128): a draw each, in that order, whenever its option is on."""
    hflip = use_flip and rng.random() < 0.5
    vflip = use_rot and rng.random() < 0.5
    rot90 = use_rot and rng.random() < 0.5
    return hflip, vflip, rot90


def _aug_img(img: np.ndarray, flips) -> np.ndarray:
    """An (h, w, c) frame flipped and transposed as `flips` say."""
    hflip, vflip, rot90 = flips
    if hflip:
        img = img[:, ::-1]
    if vflip:
        img = img[::-1]
    if rot90:
        img = img.transpose(1, 0, 2)
    return np.ascontiguousarray(img)


def _aug_flow(fl: np.ndarray, flips, signs: bool = True) -> np.ndarray:
    """(K, c, h, w) flow rows, channels (x, y), moved with the frames. With
    `signs` the reference's sign fixes: an hflip negates channel 1, a
    vflip channel 0, and the transpose swaps the two channels; without
    (the psies) only the spatial transforms."""
    hflip, vflip, rot90 = flips
    if hflip:
        fl = fl[:, :, :, ::-1].copy()
        if signs:
            fl[:, 1] *= -1
    if vflip:
        fl = fl[:, :, ::-1, :].copy()
        if signs:
            fl[:, 0] *= -1
    if rot90:
        fl = fl.transpose(0, 1, 3, 2)
        if signs:
            fl = np.flip(fl, 1)
    return np.ascontiguousarray(fl)


def _septuplet_windows(root: str, videos: Sequence[str], interval: int,
                       n_gt: int | None = 9):
    """The Adobe training windows of each video: frames [i, i + interval +
    1] with stride interval + 1; per window the LQ files (its frames 0, 2,
    4, 6) and the GT files (its first `n_gt` frames, None: all)."""
    file_list, gt_list = [], []
    for video in videos:
        frames = _list_frames(osp.join(root, video))
        index = 0
        while index + interval + 1 < len(frames):
            window = frames[index:index + interval + 2]
            file_list.append([osp.join(video, window[i])
                              for i in (0, 2, 4, 6)])
            gt_list.append([osp.join(video, f) for f in window[:n_gt]])
            index += interval + 1
    return file_list, gt_list


def _videos(root: str, video_list_file: str | None) -> list[str]:
    if video_list_file:
        with open(video_list_file) as f:
            return [ln.strip() for ln in f if ln.strip()]
    return sorted(os.listdir(root))


@dataclass
class AdobeSeptupletDataset:
    """Adobe240 fixed-scale training (Adobe_dataset.py / _4 / _flow):
    septuplet windows with stride interval + 1, LQ = the window's frames 0,
    2, 4, 6 from the LQ root, `sample_num` GT times drawn from its 9 frames
    at i / 8, with the anchors (frames 0 and 8) duplicated at the ends. In
    the train phase a random crop of gt_size (the LQ at gt_size / scale)
    and flip / transpose augmentation. Items: {'lq': (4, s, s, 3), 'gt':
    (sample_num + 2, gt_size, gt_size, 3), 'times': (sample_num,), 'key'}.

    `load_flows` (Adobe_flow, Adobe_dataset_flow.py:190-258) adds the
    window's arrays from flow_root/<video>/<n1>_<n2>_{flow,psies,flow_GT}.npy
    (n1, n2: its first two LQ frames): 'flow' (K, s, s, 2), the LR anchor
    flows; 'psies' (K, s, s, 3), their reliability maps; 'flow_gt'
    (sample_num, 2, gt_size, gt_size, 2), the GT flows (2, 9, 2, H, W) at
    the sampled times, anchor-major in the file. All are cropped and
    augmented with the frames, the flows with the sign fixes, the psies
    without."""
    gt_root: str
    lq_root: str
    video_list_file: str | None = None
    interval: int = 7
    sample_num: int = 7
    gt_size: int = 128
    scale: int = 4
    use_flip: bool = True
    use_rot: bool = True
    load_flows: bool = False
    flow_root: str | None = None
    phase: str = "train"
    seed: int | None = None

    def __post_init__(self):
        self.file_list, self.gt_list = _septuplet_windows(
            self.gt_root, _videos(self.gt_root, self.video_list_file),
            self.interval)
        self._rng = random.Random(self.seed)

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, index: int) -> dict:
        lqs = [read_img(osp.join(self.lq_root, p))
               for p in self.file_list[index]]
        gt_paths = [osp.join(self.gt_root, p) for p in self.gt_list[index]]
        m = len(gt_paths)
        picked = sorted(self._rng.sample(range(m), min(self.sample_num, m)))
        gts = [read_img(gt_paths[i]) for i in [0] + picked + [m - 1]]
        times = np.asarray([i / 8.0 for i in picked], np.float32)

        if self.load_flows:
            video = osp.dirname(self.file_list[index][0])
            n1 = osp.basename(self.file_list[index][0])[:-4]
            n2 = osp.basename(self.file_list[index][1])[:-4]
            base = osp.join(self.flow_root or self.lq_root, video,
                            f"{n1}_{n2}")
            flow = np.load(base + "_flow.npy").astype(np.float32)
            psies = np.load(base + "_psies.npy").astype(np.float32)
            flow_gt = np.load(base + "_flow_GT.npy").astype(np.float32)
            h, w = flow_gt.shape[2], flow_gt.shape[3]
            flow_gt = flow_gt.reshape(2, 9, 2, h, w)[:, picked].reshape(
                -1, 2, h, w)

        if self.phase == "train":
            H, W = lqs[0].shape[:2]
            lq_size = self.gt_size // self.scale
            rh = self._rng.randint(0, max(0, H - lq_size))
            rw = self._rng.randint(0, max(0, W - lq_size))
            lqs = [v[rh:rh + lq_size, rw:rw + lq_size] for v in lqs]
            rh4, rw4 = rh * self.scale, rw * self.scale
            gts = [v[rh4:rh4 + self.gt_size, rw4:rw4 + self.gt_size]
                   for v in gts]
            if self.load_flows:
                flow = flow[:, :, rh:rh + lq_size, rw:rw + lq_size]
                psies = psies[:, :, rh:rh + lq_size, rw:rw + lq_size]
                flow_gt = flow_gt[:, :, rh4:rh4 + self.gt_size,
                                  rw4:rw4 + self.gt_size]
            flips = _draw_flips(self._rng, self.use_flip, self.use_rot)
            lqs = [_aug_img(v, flips) for v in lqs]
            gts = [_aug_img(v, flips) for v in gts]
            if self.load_flows:
                flow = _aug_flow(flow, flips)
                psies = _aug_flow(psies, flips, signs=False)
                flow_gt = _aug_flow(flow_gt, flips)

        out = {"lq": np.stack(lqs, 0), "gt": np.stack(gts, 0),
               "times": times, "key": self.file_list[index][0]}
        if self.load_flows:
            out["flow"] = flow.transpose(0, 2, 3, 1)
            out["psies"] = psies.transpose(0, 2, 3, 1)
            g = flow_gt.reshape(2, len(picked), 2, *flow_gt.shape[2:])
            out["flow_gt"] = g.transpose(1, 0, 3, 4, 2)
        return out


@dataclass
class AdobeArbitraryDataset:
    """Adobe240 arbitrary space-time training (Adobe_arbitrary.py): the
    septuplet windows of the GT root, `sample_num` times drawn from a
    window's 9 frames at i / 8. Items hold the raw frames for the batch
    collate (`pipeline.collate_adobe_arbitrary`, which draws the scale,
    crops and makes the LQ): {'lq_raw': 4 frames (the window's 0, 2, 4,
    6), 'gt_raw': sample_num + 2 frames (anchors at the ends), 'times',
    'key'}."""
    root: str
    video_list_file: str | None = None
    n_frames: int = 7
    sample_num: int = 7
    interval: int = 7
    seed: int | None = None

    def __post_init__(self):
        self.file_list, self.gt_list = _septuplet_windows(
            self.root, _videos(self.root, self.video_list_file),
            self.interval, n_gt=None)
        self._rng = random.Random(self.seed)

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, index: int) -> dict:
        lq = [read_img(osp.join(self.root, p)) for p in self.file_list[index]]
        gts_all = [osp.join(self.root, p) for p in self.gt_list[index]]
        n = len(gts_all)
        picked = sorted(self._rng.sample(range(n), min(self.sample_num, n)))
        gt = [read_img(gts_all[i]) for i in [0] + picked + [n - 1]]
        times = np.asarray([i / (n - 1) for i in picked], np.float32)
        return {"lq_raw": lq, "gt_raw": gt, "times": times,
                "key": self.file_list[index][0]}


@dataclass
class VimeoArbitraryDataset:
    """Vimeo arbitrary-scale training (Vimeo_dataset_arbitrary.py): per
    clip the raw frames for the batch collate; the 9 GT slots are [im1] +
    im1..im7 + [im7] (the i / 8 grid), `sample_num` of them drawn,
    the LQ im1, im3, im5, im7. Items as AdobeArbitraryDataset's."""
    gt_root: str
    keys: Sequence[str] | str = "sep_trainlist.txt"
    sample_num: int = 7
    seed: int | None = None

    def __post_init__(self):
        if isinstance(self.keys, str):
            path = self.keys if osp.exists(self.keys) else osp.join(
                osp.dirname(self.gt_root.rstrip("/")), self.keys)
            self.keys = load_keys(path)
        self._rng = random.Random(self.seed)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index: int) -> dict:
        name_a, name_b = self.keys[index].split("_")
        d = osp.join(self.gt_root, name_a, name_b)
        frames = [read_img(osp.join(d, f"im{v}.png")) for v in range(1, 8)]
        picked = sorted(self._rng.sample(range(9), self.sample_num))
        gts_all = [frames[0]] + frames + [frames[6]]
        gt = [gts_all[i] for i in [0] + picked + [8]]
        lq = [frames[i] for i in (0, 2, 4, 6)]
        times = np.asarray([i / 8.0 for i in picked], np.float32)
        return {"lq_raw": lq, "gt_raw": gt, "times": times,
                "key": self.keys[index]}


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
# the LQ of a four-anchor model on a septuplet window (7 GT frames, times
# i/6): its frames 0, 2, 4, 6, the Vimeo septuplet's im1, im3, im5, im7 at
# the anchor positions, as Vimeo7Dataset reads them in training
SEPTUPLET_LQ = (0, 2, 4, 6)


def create_dataset(opt: dict, lq_index: Sequence[int] | None = None):
    """Factory keyed by the reference mode strings (data/__init__.py:57-88),
    for the eval and the training modes. `lq_index` (a window mode only) reads
    the LQ frames at those indices of the GT window instead of the window's
    inputs: test.py passes `SEPTUPLET_LQ` for a four-anchor model on
    `Vimeo_test_44`."""
    mode = opt["mode"]
    if mode in WINDOW_MODES:
        videos = opt.get("videos")
        if videos is None:
            videos = (VID4_VIDEOS if mode in ("Adobe_test_3", "Vimeo_test_44")
                      else GOPRO_VIDEOS if mode == "Gopro_test"
                      else sorted(os.listdir(opt["dataroot_GT"])))
        return WindowEvalDataset(opt["dataroot_GT"], opt["dataroot_LQ"], videos,
                                 ref_num=opt.get("ref_num", 4),
                                 lq_index=lq_index,
                                 **WINDOW_MODES[mode])
    if mode == "Gopro_test_a":
        return ArbitraryScaleTestDataset(opt["dataroot_GT"],
                                         videos=opt.get("videos", GOPRO_VIDEOS),
                                         time=opt.get("time", 9),
                                         d_scale=opt.get("d_scale", 4.0))
    if mode == "vimeo":
        # the JAX package's default: no precomputed flows (a 2-anchor model
        # computes its teacher flow live; train.py turns them on for a
        # four-anchor model)
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
    if mode == "Adobe_a":
        return AdobeArbitraryDataset(opt["dataroot_GT"],
                                     video_list_file=opt.get("video_list"),
                                     sample_num=opt.get("sample_num", 7))
    if mode in ("Adobe", "Adobe_4", "Adobe_flow"):
        return AdobeSeptupletDataset(opt["dataroot_GT"], opt["dataroot_LQ"],
                                     video_list_file=opt.get("video_list"),
                                     sample_num=opt.get("sample_num", 7),
                                     gt_size=opt.get("GT_size", 128),
                                     scale=opt.get("scale", 4),
                                     use_flip=opt.get("use_flip", True),
                                     use_rot=opt.get("use_rot", True),
                                     load_flows=(mode == "Adobe_flow"),
                                     flow_root=opt.get("flow_root"),
                                     phase=opt.get("phase", "train"))
    if mode == "vimeo_a":
        return VimeoArbitraryDataset(
            opt["dataroot_GT"],
            keys=opt.get("cache_keys") or "sep_trainlist.txt",
            sample_num=opt.get("sample_num", 7))
    raise NotImplementedError(f"Dataset mode [{mode}] is not recognized.")
