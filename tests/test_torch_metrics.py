"""The port's eval metrics and yml configuration against motif_tpu's, with
no model: Y-PSNR and its split bit for bit, SSIM (separable in the port,
2-D in motif_tpu) within 1e-12 relative, and `parse` equal on every test
config."""

import pathlib

import numpy as np
import pytest

from motif_tpu.utils import config as jconfig
from motif_tpu.utils import metrics as jmetrics
from motif_tpu_torch.utils import config, metrics

ROOT = pathlib.Path(__file__).resolve().parents[1]
TEST_YMLS = [ROOT / "test.yml"] + sorted((ROOT / "configs").glob("test_*.yml"))
SSIM_RTOL = 1e-12


def _frames(n, shape=(20, 28, 3), seed=0):
    rng = np.random.default_rng(seed)
    real = rng.random((n, *shape), dtype=np.float32)
    fake = np.clip(real + rng.normal(0, 0.05, real.shape), 0, 1)
    return real, fake


@pytest.mark.parametrize("n", [2, 3, 5])
def test_y_psnr_and_split_are_bit_equal(n):
    real, fake = _frames(n, seed=n)
    ry, fy = metrics.rgb_to_y(real), metrics.rgb_to_y(fake)
    np.testing.assert_array_equal(ry, jmetrics.rgb_to_y(real))
    np.testing.assert_array_equal(fy, jmetrics.rgb_to_y(fake))
    assert metrics.psnr(ry, fy) == jmetrics.psnr(ry, fy)
    assert metrics.psnr_255(ry * 255, fy * 255) == \
        jmetrics.psnr_255(ry * 255, fy * 255)
    got, want = metrics.eval_psnr_split(ry, fy), jmetrics.eval_psnr_split(ry, fy)
    assert got[:4] == want[:4]
    np.testing.assert_array_equal(got[4], want[4])
    assert metrics.psnr(ry, ry) == float("inf")


@pytest.mark.parametrize("shape", [(40, 52), (40, 52, 1), (40, 52, 3),
                                   (256, 448)],
                         ids=["2d", "one-channel", "three-channel", "256x448"])
def test_ssim_matches_the_2d_window(shape):
    rng = np.random.default_rng(len(shape))
    a = rng.random(shape) * 255
    b = np.clip(a + rng.normal(0, 12, shape), 0, 255)
    got, want = metrics.calculate_ssim(a, b), jmetrics.calculate_ssim(a, b)
    assert abs(got - want) <= SSIM_RTOL * abs(want)
    np.testing.assert_array_equal(metrics._gaussian_window(),
                                  jmetrics._gaussian_window())


def test_ssim_refuses_what_motif_tpu_refuses():
    with pytest.raises(ValueError, match="same dimensions"):
        metrics.calculate_ssim(np.zeros((20, 20)), np.zeros((20, 21)))
    with pytest.raises(ValueError, match="Wrong input"):
        metrics.calculate_ssim(np.zeros((2, 20, 20, 3)), np.zeros((2, 20, 20, 3)))


@pytest.mark.parametrize("is_train", [False, True], ids=["test", "train"])
@pytest.mark.parametrize("path", TEST_YMLS, ids=lambda p: p.name)
def test_parse_matches_motif_tpu(path, is_train):
    got = config.parse(str(path), is_train=is_train)
    want = jconfig.parse(str(path), is_train=is_train)
    assert got == want
    assert isinstance(got["network_G"], config.NoneDict)
    assert got["network_G"]["no_such_key"] is None
