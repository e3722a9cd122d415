"""The port's video and flow-file utilities against motif_tpu's
(motif_tpu/utils/video.py, flow_io.py): .flo files byte-equal, flow
pictures and frame folders bit-equal, the eval plan equal, and ffmpeg
called only when asked (and raising when it is missing)."""

import os

import numpy as np
import pytest

from motif_tpu.utils import flow_io as jflow_io
from motif_tpu.utils import video as jvideo
from motif_tpu_torch.utils import flow_io, video


def _flow(seed, h=13, w=17, scale=5.0):
    return (np.random.default_rng(seed).standard_normal((h, w, 2))
            * scale).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_flo_files_are_byte_equal_and_read_back(seed, tmp_path):
    uv = _flow(seed)
    a, b = tmp_path / "a.flo", tmp_path / "b.flo"
    flow_io.write_flow(str(a), uv)
    jflow_io.write_flow(str(b), uv)
    assert a.read_bytes() == b.read_bytes()
    assert len(a.read_bytes()) == 12 + uv.nbytes
    for read in (flow_io.read_flow, jflow_io.read_flow):
        np.testing.assert_array_equal(read(str(a)), uv)
    (tmp_path / "bad.flo").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError):
        flow_io.read_flow(str(tmp_path / "bad.flo"))


@pytest.mark.parametrize("seed,clip", [(0, None), (1, None), (2, 3.0)])
def test_flow_to_image_is_bit_equal(seed, clip):
    uv = _flow(seed, 31, 29)
    uv[0, 0] = 0.0                      # the centre of the wheel
    got = flow_io.flow_to_image(uv, clip)
    assert got.dtype == np.uint8 and got.shape == (31, 29, 3)
    np.testing.assert_array_equal(got, jflow_io.flow_to_image(uv, clip))
    np.testing.assert_array_equal(flow_io.make_color_wheel(),
                                  jflow_io._make_color_wheel())
    zero = flow_io.flow_to_image(np.zeros((4, 5, 2), np.float32))
    np.testing.assert_array_equal(
        zero, jflow_io.flow_to_image(np.zeros((4, 5, 2), np.float32)))


@pytest.mark.parametrize("color", [True, False])
def test_read_pfm_matches_motif_tpu(color, tmp_path):
    shape = (5, 7, 3) if color else (5, 7)
    data = np.random.default_rng(0).random(shape).astype("<f4")
    p = tmp_path / "x.pfm"
    with open(p, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(b"7 5\n-1.0\n")
        f.write(np.flipud(data).tobytes())
    got, scale = flow_io.read_pfm(str(p))
    want, jscale = jflow_io.read_pfm(str(p))
    assert scale == jscale == 1.0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data)
    (tmp_path / "y.pfm").write_bytes(b"P6\n")
    with pytest.raises(ValueError):
        flow_io.read_pfm(str(tmp_path / "y.pfm"))


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("n_out,len_in", [(3, 5), (3, 7), (5, 9), (7, 7),
                                          (3, 12), (5, 20)])
def test_index_generation_matches_motif_tpu(skip, n_out, len_in):
    assert video.test_index_generation(skip, n_out, len_in) == \
        jvideo.test_index_generation(skip, n_out, len_in)


def test_tensor2img_and_frame_folders(tmp_path):
    """tensor2img bit-equal; save_img / read_seq_imgs round trip through
    PNGs as motif_tpu's do, in name order (jpg and upper case too)."""
    rng = np.random.default_rng(5)
    imgs = rng.random((3, 6, 8, 3)).astype(np.float32) * 1.2 - 0.1
    for i, im in enumerate(imgs):
        np.testing.assert_array_equal(video.tensor2img(im),
                                      jvideo.tensor2img(im))
        video.save_img(im, str(tmp_path / f"{i:03d}.png"))
    (tmp_path / "notes.txt").write_text("not a frame")
    got = video.read_seq_imgs(str(tmp_path))
    want = jvideo.read_seq_imgs(str(tmp_path))
    assert got.shape == (3, 6, 8, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.clip(imgs, 0, 1), atol=0.5 / 255 +
                               1e-6)


def test_ffmpeg_runs_only_when_asked(tmp_path, monkeypatch):
    """extract_frames / create_video run ffmpeg with the JAX package's
    arguments; a missing ffmpeg raises."""
    calls = []
    monkeypatch.setattr(video.subprocess, "run",
                        lambda cmd, check: calls.append(cmd))
    video.create_video("", str(tmp_path), "out.mp4", 24)
    video.extract_frames("/opt/ff", "in.mp4", str(tmp_path))
    assert calls[0][:3] == ["ffmpeg", "-r", "24"] and calls[0][-1] == "out.mp4"
    assert calls[1][0] == os.path.join("/opt/ff", "ffmpeg")
    assert calls[1][-1] == os.path.join(str(tmp_path), "%06d.png")
    monkeypatch.undo()
    with pytest.raises(FileNotFoundError):
        video.create_video(str(tmp_path / "no_such_dir"), str(tmp_path),
                           "out.mp4")


def test_progress_bar(capsys):
    bar = video.ProgressBar(2)
    bar.update("a")
    video.ProgressBar().update("b")
    assert capsys.readouterr().out == "[1/2] a\ncompleted: 1, b\n"
