"""Optical-flow files, the counterpart of motif_tpu/utils/flow_io.py
(reference models/core/utils/frame_utils.py and flow_viz.py): Middlebury
.flo read and write, PFM read, and the Baker et al. colour-wheel picture of
a flow. numpy only; a .flo this writes is byte-equal to the JAX package's,
and `flow_to_image` is its picture bit for bit."""

from __future__ import annotations

import re

import numpy as np

TAG_CHAR = np.float32(202021.25)


def read_flow(path: str) -> np.ndarray:
    """A Middlebury .flo file as (H, W, 2) float32 (frame_utils.py:12-30);
    a wrong magic number raises ValueError."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic != TAG_CHAR:
            raise ValueError(f"{path}: invalid .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flow(path: str, uv: np.ndarray) -> None:
    """(H, W, 2) flow written as .flo: the magic, the width and height as
    int32, the float32 (u, v) pairs row by row (frame_utils.py:70-96)."""
    assert uv.ndim == 3 and uv.shape[2] == 2
    h, w = uv.shape[:2]
    with open(path, "wb") as f:
        TAG_CHAR.tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        uv.astype(np.float32).tofile(f)


def read_pfm(path: str):
    """A PFM file as (data flipped to top-down rows, scale)
    (frame_utils.py:33-67)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError("Malformed PFM header.")
        w, h = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape)), scale


def flow_to_image(flow: np.ndarray,
                  clip_flow: float | None = None) -> np.ndarray:
    """(H, W, 2) flow as an RGB uint8 picture on the colour wheel: hue from
    the direction, saturation from the length over the largest length
    (flow_viz.py); with `clip_flow`, each component clipped first."""
    u, v = flow[..., 0], flow[..., 1]
    if clip_flow is not None:
        u = np.clip(u, -clip_flow, clip_flow)
        v = np.clip(v, -clip_flow, clip_flow)
    rad = np.sqrt(u ** 2 + v ** 2)
    rad_max = max(rad.max(), 1e-5)
    u, v = u / rad_max, v / rad_max
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi

    wheel = make_color_wheel()
    ncols = wheel.shape[0]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros((*u.shape, 3), np.uint8)
    for i in range(3):
        col0 = wheel[k0, i] / 255.0
        col1 = wheel[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        col = np.where(rad <= 1, 1 - rad * (1 - col), col * 0.75)
        img[..., i] = np.floor(255 * col)
    return img


def make_color_wheel() -> np.ndarray:
    """The 55 colours of the Middlebury wheel, (55, 3) float64 RGB in
    [0, 255]: red-yellow, yellow-green, green-cyan, cyan-blue,
    blue-magenta, magenta-red."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel
