"""Training trees in the datasets' own layouts, made from the seed under a
directory the run owns:

* `vimeo`: Vimeo-90K septuplets, `GT/<a>/<b>/im1..7.png` at the HR size,
  `LR/<a>/<b>/im1..7.png` at a quarter of it, the key list beside the GT
  root, and with `flows` each clip's precomputed flows as the four-anchor
  recipe reads them: `LR/<a>/<b>/lr_flow_12.npy` (16, 2, h, w), the LR
  anchor i -> anchor j flows, and `GT/<a>/<b>/hr_gt_flow.npy` (28, 2, H,
  W), the GT anchor -> time flows, smooth seeded fields;
* `adobe`: Adobe240 clips, `HR/<clip>/<iii>.png` and `LR/<clip>/<iii>.png`,
  consecutive frames of a source clip panned by a drawn velocity."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark.data import frames as frame_src


def _write(path: str, rgb: np.ndarray) -> None:
    """A PNG at zlib level 1 (fast to write; any level reads the same)."""
    import cv2

    if not cv2.imwrite(path, np.ascontiguousarray(rgb[..., ::-1]),
                       [cv2.IMWRITE_PNG_COMPRESSION, 1]):
        raise OSError(f"could not write {path}")


def _write_all(jobs) -> None:
    """Write (path, frame) pairs on four threads (cv2 releases the GIL)."""
    with ThreadPoolExecutor(4) as pool:
        for f in [pool.submit(_write, p, img) for p, img in jobs]:
            f.result()


def smooth_field(rng: np.random.Generator, n: int, hw, amp: float,
                 cells=(4, 7)) -> np.ndarray:
    """(n, 2, H, W) float32 flow fields: normal values on a coarse grid,
    bicubic up to H x W, times `amp` pixels."""
    import cv2

    H, W = hw
    coarse = rng.standard_normal((n * 2, *cells)).astype(np.float32) * amp
    out = np.stack([cv2.resize(c, (W, H), interpolation=cv2.INTER_CUBIC)
                    for c in coarse], 0)
    return out.reshape(n, 2, H, W)


def vimeo(root: str, seed: int, count: int, hw, flows: bool) -> dict:
    rng = np.random.default_rng([int(seed), 11])
    H, W = hw
    keys, jobs = [], []
    for c, clip in enumerate(frame_src.septuplets(rng, count, hw)):
        a, b = f"{c // 100 + 1:05d}", f"{c % 100 + 1:04d}"
        keys.append(f"{a}/{b}")
        gt_dir = os.path.join(root, "GT", a, b)
        lr_dir = os.path.join(root, "LR", a, b)
        os.makedirs(gt_dir)
        os.makedirs(lr_dir)
        for v, img in enumerate(clip, 1):
            jobs.append((os.path.join(gt_dir, f"im{v}.png"), img))
            jobs.append((os.path.join(lr_dir, f"im{v}.png"),
                         frame_src.downscale(img, 4)))
        if flows:
            np.save(os.path.join(lr_dir, "lr_flow_12.npy"),
                    smooth_field(rng, 16, (H // 4, W // 4), 1.0))
            np.save(os.path.join(gt_dir, "hr_gt_flow.npy"),
                    smooth_field(rng, 28, (H, W), 4.0))
    _write_all(jobs)
    with open(os.path.join(root, "sep_trainlist.txt"), "w") as f:
        f.write("\n".join(keys) + "\n")
    return {"dataroot_GT": os.path.join(root, "GT"),
            "dataroot_LQ": os.path.join(root, "LR"), "keys": keys}


def adobe(root: str, seed: int, clips: int, frames: int, hw) -> dict:
    import cv2

    rng = np.random.default_rng([int(seed), 12])
    H, W = hw
    src = frame_src.sources()
    names, jobs = [], []
    for c in range(clips):
        base = src[int(rng.integers(len(src)))]
        cyc = list(range(len(base))) + list(range(len(base) - 2, 0, -1))
        start = int(rng.integers(len(cyc)))
        dy, dx = int(rng.integers(H)), int(rng.integers(W))
        vy, vx = (int(v) for v in rng.integers(-3, 4, 2))
        name = f"clip{c:03d}"
        names.append(name)
        for res in ("HR", "LR"):
            os.makedirs(os.path.join(root, res, name))
        for k in range(frames):
            img = cv2.resize(base[cyc[(start + k) % len(cyc)]], (W, H),
                             interpolation=cv2.INTER_CUBIC)[..., ::-1]
            img = np.roll(img, (dy + vy * k, dx + vx * k), (0, 1))
            jobs.append((os.path.join(root, "HR", name, f"{k:03d}.png"), img))
            jobs.append((os.path.join(root, "LR", name, f"{k:03d}.png"),
                         frame_src.downscale(img, 4)))
    _write_all(jobs)
    return {"dataroot_GT": os.path.join(root, "HR"),
            "dataroot_LQ": os.path.join(root, "LR"), "clips": names}
