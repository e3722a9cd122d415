"""Video and frame-sequence utilities, the counterpart of
motif_tpu/utils/video.py (reference utils/util.py:198-353 and video.py):
the sliding-window eval plan, frame folders in and out, and ffmpeg for
splitting a video into frames and muxing frames into one.

ffmpeg runs as a subprocess, as in the JAX package; a missing ffmpeg
raises (FileNotFoundError), and nothing here calls it unless asked.
"""

from __future__ import annotations

import os
import os.path as osp
import subprocess

import numpy as np


def read_seq_imgs(img_seq_path: str) -> np.ndarray:
    """A folder of frames (.png / .jpg / .jpeg, in name order) as (T, H, W,
    3) RGB float32 in [0, 1] (utils/util.py:259-269)."""
    from motif_tpu_torch.data.datasets import read_img

    paths = sorted(
        osp.join(img_seq_path, f) for f in os.listdir(img_seq_path)
        if f.lower().endswith((".png", ".jpg", ".jpeg")))
    return np.stack([read_img(p) for p in paths], 0)


def test_index_generation(skip: bool, n_out: int,
                          len_in: int) -> list[list[list[int]]]:
    """The sliding-window eval plan (utils/util.py:272-316): windows of
    [input indices, output indices]. `skip`: the inputs are every other
    frame of the output window; `n_out`: frames a window produces;
    `len_in`: frames in all. A tail window is added when the stride would
    miss the last frame, e.g.

        (skip=False, n_out=3, len_in=5) -> [[0,1],[0,1,2]], [[1,2],[2,3,4]]
        (skip=True,  n_out=3, len_in=5) -> [[0,2],[0,1,2]], [[2,4],[2,3,4]]
    """
    n_in = 1 + n_out // 2
    assert n_in <= len_in, "input too short for the window size"

    plans: list[list[list[int]]] = []
    if skip:
        right = n_out
        while right <= len_in:
            h_list = [right - n_out + x for x in range(n_out)]
            plans.append([h_list[::2], h_list])
            right += n_out - 1
        if right < len_in - 1:                   # the tail window
            h_list = [len_in - n_out + x for x in range(n_out)]
            plans.append([h_list[::2], h_list])
    else:
        right = n_out
        right_in = n_in
        while right_in <= len_in:
            h_list = [right - n_out + x for x in range(n_out)]
            l_list = [right_in - n_in + x for x in range(n_in)]
            plans.append([l_list, h_list])
            right += n_out - 1
            right_in += n_in - 1
        if right_in < len_in - 1:                # the tail window
            right = len_in * 2 - 1
            h_list = [right - n_out + x for x in range(n_out)]
            l_list = [len_in - n_in + x for x in range(n_in)]
            plans.append([l_list, h_list])
    return plans


# not a test, whatever its name says
test_index_generation.__test__ = False


def tensor2img(arr: np.ndarray, min_max=(0.0, 1.0)) -> np.ndarray:
    """A float (H, W, 3) RGB image in `min_max` as uint8 BGR for
    cv2.imwrite: clamped, scaled, rounded (utils/util.py:105-129)."""
    a = np.clip(arr, *min_max)
    a = (a - min_max[0]) / (min_max[1] - min_max[0])
    a = (a * 255.0).round().astype(np.uint8)
    return a[..., ::-1]


def save_img(img_rgb: np.ndarray, path: str) -> None:
    import cv2

    cv2.imwrite(path, tensor2img(img_rgb))


def _ffmpeg(ffmpeg_dir: str) -> str:
    return osp.join(ffmpeg_dir, "ffmpeg") if ffmpeg_dir else "ffmpeg"


def extract_frames(ffmpeg_dir: str, video: str, out_dir: str) -> None:
    """A video split into numbered PNG frames in `out_dir`
    (utils/util.py:323-337)."""
    cmd = [_ffmpeg(ffmpeg_dir), "-i", video, "-vsync", "0", "-qscale:v", "2",
           osp.join(out_dir, "%06d.png")]
    subprocess.run(cmd, check=True)


def create_video(ffmpeg_dir: str, frame_dir: str, output: str, fps: int = 30,
                 pattern: str = "%06d.png") -> None:
    """The frames of `frame_dir` muxed into an H.264 video
    (utils/util.py:340-353, video.py)."""
    cmd = [_ffmpeg(ffmpeg_dir), "-r", str(fps), "-i",
           osp.join(frame_dir, pattern), "-vcodec", "libx264", "-crf", "18",
           "-pix_fmt", "yuv420p", "-y", output]
    subprocess.run(cmd, check=True)


class ProgressBar:
    """The reference's ProgressBar, as a line per update
    (utils/util.py:198-245)."""

    def __init__(self, task_num: int = 0, bar_width: int = 50):
        self.task_num = task_num
        self.completed = 0

    def update(self, msg: str = ""):
        self.completed += 1
        if self.task_num:
            print(f"[{self.completed}/{self.task_num}] {msg}", flush=True)
        else:
            print(f"completed: {self.completed}, {msg}", flush=True)
