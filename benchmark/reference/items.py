"""The loader's stage, worked out again from the files: each item of a
batch is found among the items its dataset can make (a time direction,
flips, a transpose, a crop) and made again from the files it names, so a
batch whose frames, times or flows do not follow from the files shows.

Vimeo-90K septuplets (Vimeo7_dataset.py): GT im1, im1..im7, im7 (the
anchors at the ends), LQ im1, im3, im5, im7, times (v - 1) / 6, all in
reverse under a reversed direction (the flows' time and anchor axes with
them), an LQ crop of GT_size / 4 and the GT crop 4 times it, then an
hflip, a vflip and a transpose (the flows' channels negated and swapped
as the reference does: channel 1 under an hflip, channel 0 under a vflip).
Adobe240 windows (Adobe_dataset.py): 9 consecutive frames from the key's,
LQ its frames 0, 2, 4, 6, GT frame 0, the sampled frames and frame 8,
times i / 8, then the crop and flips as above."""

from __future__ import annotations

import itertools
import os

import numpy as np

FLIPS = list(itertools.product((False, True), repeat=3))
TOL = 1e-6


def read(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    return img[..., :3][..., ::-1].astype(np.float32) / np.float32(255.0)


def aug(img, flips):
    h, v, r = flips
    if h:
        img = img[:, ::-1]
    if v:
        img = img[::-1]
    if r:
        img = img.transpose(1, 0, 2)
    return img


def unaug(img, flips):
    h, v, r = flips
    if r:
        img = img.transpose(1, 0, 2)
    if v:
        img = img[::-1]
    if h:
        img = img[:, ::-1]
    return img


def aug_flow(fl, flips, signs=True):
    """(K, 2, h, w) moved with the frames."""
    h, v, r = flips
    fl = fl.copy()
    if h:
        fl = fl[:, :, :, ::-1].copy()
        if signs:
            fl[:, 1] *= -1
    if v:
        fl = fl[:, :, ::-1].copy()
        if signs:
            fl[:, 0] *= -1
    if r:
        fl = fl.transpose(0, 1, 3, 2)
        if signs:
            fl = fl[:, ::-1]
    return fl


def crops(frame: np.ndarray, patch: np.ndarray) -> list:
    """Every (row, column) at which `patch` lies in `frame` (to TOL)."""
    s0, s1 = patch.shape[:2]
    win = np.lib.stride_tricks.sliding_window_view(frame, (s0, s1, 3))
    win = win.reshape(win.shape[0], win.shape[1], s0, s1, 3)
    close = np.abs(win[:, :, 0, 0] - patch[0, 0]).max(-1) <= TOL
    return [(int(r), int(c)) for r, c in zip(*np.nonzero(close))
            if np.abs(win[r, c] - patch).max() <= TOL]


def _gap(item: dict, want: dict) -> float:
    gap = 0.0
    for k, v in want.items():
        got = np.asarray(item[k], np.float32)
        if got.shape != v.shape:
            return float("inf")
        gap = max(gap, float(np.abs(got - v).max()))
    return gap


def vimeo(item: dict, gt_root: str, lq_root: str, scale: int = 4) -> float:
    """The smallest gap between the item and an item made from the files of
    its key (inf where none matches)."""
    a, b = item["key"].split("_")
    gt_dir, lq_dir = os.path.join(gt_root, a, b), os.path.join(lq_root, a, b)
    gts = {v: read(os.path.join(gt_dir, f"im{v}.png")) for v in range(1, 8)}
    lqs = {v: read(os.path.join(lq_dir, f"im{v}.png")) for v in range(1, 8)}
    flows = "flow" in item
    if flows:
        hr = np.load(os.path.join(gt_dir, "hr_gt_flow.npy")).astype(np.float32)
        lr = np.load(os.path.join(lq_dir, "lr_flow_12.npy")).astype(np.float32)
    s = np.asarray(item["lq"]).shape[1]
    g = s * scale
    best = float("inf")
    for reverse, flips in itertools.product((False, True), FLIPS):
        nb = list(range(7, 0, -1)) if reverse else list(range(1, 8))
        raw = unaug(np.asarray(item["lq"][0], np.float32), flips)
        for rh, rw in crops(lqs[nb[0]], raw):
            want = {
                "lq": np.stack([aug(lqs[nb[i]][rh:rh + s, rw:rw + s], flips)
                                for i in (0, 2, 4, 6)]),
                "gt": np.stack([aug(gts[v][rh * scale:rh * scale + g,
                                           rw * scale:rw * scale + g], flips)
                                for v in [1] + nb + [7]]),
                "times": np.asarray([(v - 1) / 6.0 for v in nb], np.float32)}
            if flows:
                H, W = hr.shape[2:]
                h_, l_ = hr, lr
                if reverse:
                    h_ = np.flip(np.flip(hr.reshape(7, 4, 2, H, W), 0), 1
                                 ).reshape(28, 2, H, W)
                    l_ = np.flip(np.flip(lr.reshape(4, 4, 2, H // 4, W // 4),
                                         0), 1).reshape(16, 2, H // 4, W // 4)
                l_ = aug_flow(l_[:, :, rh:rh + s, rw:rw + s], flips)
                h_ = aug_flow(h_[:, :, rh * scale:rh * scale + g,
                                 rw * scale:rw * scale + g], flips)
                want["flow"] = l_.transpose(0, 2, 3, 1)
                hh = h_.transpose(0, 2, 3, 1)
                want["flow_gt"] = hh.reshape(7, 4, *hh.shape[1:3], 2)
            best = min(best, _gap(item, want))
    return best


def adobe(item: dict, gt_root: str, lq_root: str, scale: int = 4,
          interval: int = 7) -> float:
    """As `vimeo`, for an Adobe240 window starting at the key's frame."""
    video, first = os.path.split(item["key"])
    names = sorted(n for n in os.listdir(os.path.join(gt_root, video))
                   if n.endswith(".png"))
    at = names.index(first)
    window = names[at:at + interval + 2]
    lqs = [read(os.path.join(lq_root, video, window[i])) for i in (0, 2, 4, 6)]
    gts = [read(os.path.join(gt_root, video, n)) for n in window[:9]]
    picked = [int(round(float(t) * 8)) for t in np.asarray(item["times"])]
    s = np.asarray(item["lq"]).shape[1]
    g = s * scale
    best = float("inf")
    for flips in FLIPS:
        raw = unaug(np.asarray(item["lq"][0], np.float32), flips)
        for rh, rw in crops(lqs[0], raw):
            want = {
                "lq": np.stack([aug(f[rh:rh + s, rw:rw + s], flips)
                                for f in lqs]),
                "gt": np.stack([aug(gts[i][rh * scale:rh * scale + g,
                                           rw * scale:rw * scale + g], flips)
                                for i in [0] + picked + [8]]),
                "times": np.asarray([i / 8.0 for i in picked], np.float32)}
            best = min(best, _gap(item, want))
    return best
