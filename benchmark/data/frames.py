"""Source frames: the repository's sample Vimeo-90K septuplets
(`data/vimeo`, GT 128x128) and Vid4 clips (`data/Vid4`), brought to a
cell's frame size by cv2's bicubic resize, then shifted (rolled) and
flipped by the seed so that every clip of a pool differs."""

from __future__ import annotations

import os

import numpy as np

from benchmark.harness import ROOT


def sources() -> list:
    """Every source clip as a list of uint8 BGR frames: each Vimeo
    septuplet's 7 GT frames, and each Vid4 clip's HR frames."""
    import cv2

    clips = []
    vimeo = os.path.join(ROOT, "data", "vimeo")
    with open(os.path.join(vimeo, "keys.txt")) as f:
        keys = [ln.strip() for ln in f if ln.strip()]
    for key in keys:
        clips.append([cv2.imread(os.path.join(vimeo, "GT", key, f"im{v}.png"))
                      for v in range(1, 8)])
    vid4 = os.path.join(ROOT, "data", "Vid4", "HR")
    for clip in sorted(os.listdir(vid4)):
        names = sorted(n for n in os.listdir(os.path.join(vid4, clip))
                       if n.endswith(".png"))
        clips.append([cv2.imread(os.path.join(vid4, clip, n)) for n in names])
    return clips


def septuplets(rng: np.random.Generator, count: int, hw) -> list:
    """`count` clips of 7 frames at `hw` (uint8 RGB): a source clip drawn
    from `rng` (7 consecutive frames of it, ping-ponged where it is
    shorter), resized, rolled by a drawn shift and flipped."""
    import cv2

    src = sources()
    H, W = hw
    out = []
    for _ in range(count):
        clip = src[int(rng.integers(len(src)))]
        cyc = list(range(len(clip))) + list(range(len(clip) - 2, 0, -1))
        start = int(rng.integers(len(cyc)))
        dy, dx = int(rng.integers(H)), int(rng.integers(W))
        hflip, vflip = bool(rng.integers(2)), bool(rng.integers(2))
        frames = []
        for k in range(7):
            img = cv2.resize(clip[cyc[(start + k) % len(cyc)]], (W, H),
                             interpolation=cv2.INTER_CUBIC)
            img = np.roll(img, (dy, dx), (0, 1))
            if hflip:
                img = img[:, ::-1]
            if vflip:
                img = img[::-1]
            frames.append(np.ascontiguousarray(img[..., ::-1]))
        out.append(frames)
    return out


def downscale(img: np.ndarray, factor: int) -> np.ndarray:
    """An LR frame: the mean of each factor x factor block (uint8 in,
    uint8 out)."""
    H, W = img.shape[0] // factor, img.shape[1] // factor
    blocks = img[:H * factor, :W * factor].reshape(H, factor, W, factor, -1)
    return np.clip(np.round(blocks.astype(np.float32).mean((1, 3))), 0,
                   255).astype(np.uint8)
