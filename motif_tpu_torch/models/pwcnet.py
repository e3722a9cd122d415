"""PWC-Net optical flow, the counterpart of motif_tpu/models/pwcnet.py
(reference OpticalFlow/PWCNet.py, the QVI implementation of the VideoINR
lineage, and PWCNet_light.py). No model path of either package runs it:
it is kept for component parity, MoTIF uses RAFT.

PWCNet: a 6-level feature pyramid (3 convs a level), per level a decoder
on a 9x9 local cost volume (`ops/corr.py::local_corr`, plain PyTorch as in
the JAX package) against the second pyramid warped by the upsampled flow
with a validity mask, dense feature concatenation, and a dilated context
refiner. PWCNetLight: a learned instance norm of the inputs, 2 convs a
level, non-dense decoders without the upsampled-feature skip, no refiner
(constructed, unused). Both take NHWC frames (B, H, W, 3) and return the
flow at a quarter of the input size, (B, H/4, W/4, 2), in pixels of that
size.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from motif_tpu_torch.models.layers import Conv2d, ConvTranspose2d, LReLU, lrelu
from motif_tpu_torch.ops.corr import local_corr
from motif_tpu_torch.ops.resize import interpolate_bilinear
from motif_tpu_torch.ops.warp import grid_sample

_LEVEL_CHANNELS = [None, None, 81 + 32 + 4, 81 + 64 + 4, 81 + 96 + 4,
                   81 + 128 + 4, 81, None]
_LIGHT_LEVEL_CHANNELS = [None, None, 81 + 32 + 2, 81 + 64 + 2, 81 + 96 + 2,
                         81 + 128 + 2, 81, None]
_BACKWARD_SCALE = [None, None, None, 5.0, 2.5, 1.25, 0.625, None]
_LEVEL_NAMES = ["moduleOne", "moduleTwo", "moduleThr", "moduleFou",
                "moduleFiv", "moduleSix"]
_DENSE = [("moduleOne", 128), ("moduleTwo", 128), ("moduleThr", 96),
          ("moduleFou", 64), ("moduleFiv", 32)]


def _pyramid(chans, convs: int) -> nn.Module:
    """The extractor: per level a stride-2 conv and `convs` - 1 more, each
    followed by lrelu, named `<level>.0`, `.2`, ... as the reference's
    Sequentials."""
    m = nn.Module()
    cin = 3
    for name, c in zip(_LEVEL_NAMES, chans):
        layers = []
        for i in range(convs):
            layers += [Conv2d(cin if i == 0 else c, c, 3, 2 if i == 0 else 1,
                              1), LReLU()]
        setattr(m, name, nn.Sequential(*layers))
        cin = c
    return m


class Extractor(nn.Module):
    """6-level conv pyramid (PWCNet.py:20-88): 16, 32, 64, 96, 128, 196
    channels, 3 convs a level."""

    def __init__(self, chans=(16, 32, 64, 96, 128, 196), convs: int = 3):
        super().__init__()
        pyr = _pyramid(chans, convs)
        for name in _LEVEL_NAMES:
            setattr(self, name, getattr(pyr, name))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        for name in _LEVEL_NAMES:
            x = getattr(self, name)(x)
            feats.append(x)
        return feats


class ExtractorLight(Extractor):
    """2-conv pyramid levels, 192 channels on top (PWCNet_light.py:23-78)."""

    def __init__(self):
        super().__init__((16, 32, 64, 96, 128, 192), 2)


def _masked_backwarp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Decoder.Backward (PWCNet.py:146-178): a grid from linspace(-1, 1)
    (align_corners=True style) sampled with grid_sample's default
    align_corners=False; a warped ones channel thresholded at 0.999 masks
    the samples that left the frame."""
    B, H, W, _ = img.shape
    gx = torch.linspace(-1.0, 1.0, W, dtype=img.dtype,
                        device=img.device)[None, None, :]
    gy = torch.linspace(-1.0, 1.0, H, dtype=img.dtype,
                        device=img.device)[None, :, None]
    u = flow[..., 0] / ((W - 1.0) / 2.0)
    v = flow[..., 1] / ((H - 1.0) / 2.0)
    grid = torch.stack([gx + u, gy + v], dim=-1)
    ones = img.new_ones((B, H, W, 1))
    out = grid_sample(torch.cat([img, ones], -1), grid, mode="bilinear",
                      padding_mode="zeros", align_corners=False)
    mask = (out[..., -1:] > 0.999).to(img.dtype)
    return out[..., :-1] * mask


class Decoder(nn.Module):
    """Per-level flow decoder (PWCNet.py:93-225): the cost volume (at the
    coarsest level alone, else with f1, the upsampled flow and the
    upsampled features), then the dense 128-128-96-64-32 convs, each
    output concatenated in front of its input, and the flow conv."""

    def __init__(self, level: int):
        super().__init__()
        self.level = level
        cin = _LEVEL_CHANNELS[level]
        if level < 6:
            self.moduleUpflow = ConvTranspose2d(2, 2, 4, 2, 1)
            self.moduleUpfeat = ConvTranspose2d(
                _LEVEL_CHANNELS[level + 1] + 448, 2, 4, 2, 1)
        for name, c in _DENSE:
            setattr(self, name, nn.Sequential(Conv2d(cin, c, 3, 1, 1)))
            cin += c
        self.moduleSix = nn.Sequential(Conv2d(cin, 2, 3, 1, 1))

    def forward(self, f1, f2, prev):
        if prev is None:
            feat = lrelu(local_corr(f1, f2, 4))
        else:
            flow_up = self.moduleUpflow(prev["flow"])
            feat_up = self.moduleUpfeat(prev["feat"])
            warped = _masked_backwarp(
                f2, flow_up * _BACKWARD_SCALE[self.level + 1])
            vol = lrelu(local_corr(f1, warped, 4))
            feat = torch.cat([vol, f1, flow_up, feat_up], -1)
        for name, _ in _DENSE:
            feat = torch.cat([lrelu(getattr(self, name)(feat)), feat], -1)
        return {"flow": self.moduleSix(feat), "feat": feat}


class DecoderLight(nn.Module):
    """Non-dense decoder (PWCNet_light.py:80-220): feat = [volume | f1 |
    upsampled flow], then sequential 128-128-96-64-32 convs and the flow
    conv; no upsampled-feature skip."""

    def __init__(self, level: int):
        super().__init__()
        self.level = level
        cin = _LIGHT_LEVEL_CHANNELS[level]
        if level < 6:
            self.moduleUpflow = ConvTranspose2d(2, 2, 4, 2, 1)
        for name, c in _DENSE:
            setattr(self, name, nn.Sequential(Conv2d(cin, c, 3, 1, 1)))
            cin = c
        self.moduleSix = nn.Sequential(Conv2d(cin, 2, 3, 1, 1))

    def forward(self, f1, f2, prev):
        if prev is None:
            feat = lrelu(local_corr(f1, f2, 4))
        else:
            flow_up = self.moduleUpflow(prev["flow"])
            warped = _masked_backwarp(
                f2, flow_up * _BACKWARD_SCALE[self.level + 1])
            vol = lrelu(local_corr(f1, warped, 4))
            feat = torch.cat([vol, f1, flow_up], -1)
        for name, _ in _DENSE:
            feat = lrelu(getattr(self, name)(feat))
        return {"flow": self.moduleSix(feat), "feat": feat}


class Refiner(nn.Module):
    """The dilated context network (PWCNet.py:226-252): convs of 128, 128,
    128, 96, 64, 32 channels at dilations 1, 2, 4, 8, 16, 1 with lrelu,
    then the flow conv (`moduleMain.0` ... `.12`)."""

    def __init__(self, cin: int = 81 + 32 + 4 + 448):
        super().__init__()
        layers = []
        for c, d in [(128, 1), (128, 2), (128, 4), (96, 8), (64, 16),
                     (32, 1)]:
            layers += [Conv2d(cin, c, 3, 1, d, dilation=d), LReLU()]
            cin = c
        self.moduleMain = nn.Sequential(*layers, Conv2d(cin, 2, 3, 1, 1))

    def forward(self, x):
        return self.moduleMain(x)


def _padded(H: int, W: int) -> tuple[int, int]:
    return (int(math.floor(math.ceil(H / 64.0) * 64.0)),
            int(math.floor(math.ceil(W / 64.0) * 64.0)))


def _quarter(flow_q, H, W, ph, pw):
    """The flow at (H/4, W/4), x 20 and rescaled per component from the
    padded grid (PWCNet.py:290-302)."""
    oh, ow = H // 4, W // 4
    flow = 20.0 * interpolate_bilinear(flow_q, (oh, ow))
    return flow * torch.tensor([ow / pw, oh / ph], dtype=flow.dtype,
                               device=flow.device)


class PWCNet(nn.Module):
    """PWCNet.forward (PWCNet.py:266-302): both frames resized to
    multiples of 64, the pyramid decoded coarse to fine, refined, x 20,
    brought to a quarter of the input size."""

    def __init__(self):
        super().__init__()
        self.moduleExtractor = Extractor()
        for level, name in zip(range(6, 1, -1), _LEVEL_NAMES[::-1]):
            setattr(self, name, Decoder(level))
        self.moduleRefiner = Refiner()

    def forward(self, first: torch.Tensor,
                second: torch.Tensor) -> torch.Tensor:
        _, H, W, _ = first.shape
        ph, pw = _padded(H, W)
        flow_q = self.forward_pre(interpolate_bilinear(first, (ph, pw)),
                                  interpolate_bilinear(second, (ph, pw)))
        return _quarter(flow_q, H, W, ph, pw)

    def forward_pre(self, first: torch.Tensor,
                    second: torch.Tensor) -> torch.Tensor:
        """The flow at a quarter of the (padded) input, unscaled."""
        p1 = self.moduleExtractor(first)
        p2 = self.moduleExtractor(second)
        est = None
        for k, name in enumerate(_LEVEL_NAMES[::-1][:5]):
            est = getattr(self, name)(p1[-1 - k], p2[-1 - k], est)
        return est["flow"] + self.moduleRefiner(est["feat"])


class _InstanceNorm2d(nn.Module):
    """nn.InstanceNorm2d(C, affine=True): per sample and channel over (H,
    W), biased variance, learned `weight` and `bias`."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = x.var(dim=(1, 2), unbiased=False, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight \
            + self.bias


class PWCNetLight(nn.Module):
    """PWCNet_light.forward: the inputs instance-normalised (before the
    resize to multiples of 64), the pyramid decoded without refinement,
    x 20, a quarter of the input size. The refiner is built (light
    checkpoints carry it) and never run."""

    def __init__(self):
        super().__init__()
        self.in_normalize = _InstanceNorm2d(3)
        self.moduleExtractor = ExtractorLight()
        for level, name in zip(range(6, 1, -1), _LEVEL_NAMES[::-1]):
            setattr(self, name, DecoderLight(level))
        self.moduleRefiner = Refiner(81 + 32 + 2)

    def forward(self, first: torch.Tensor,
                second: torch.Tensor) -> torch.Tensor:
        _, H, W, _ = first.shape
        first = self.in_normalize(first)
        second = self.in_normalize(second)
        ph, pw = _padded(H, W)
        p1 = self.moduleExtractor(interpolate_bilinear(first, (ph, pw)))
        p2 = self.moduleExtractor(interpolate_bilinear(second, (ph, pw)))
        est = None
        for k, name in enumerate(_LEVEL_NAMES[::-1][:5]):
            est = getattr(self, name)(p1[-1 - k], p2[-1 - k], est)
        return _quarter(est["flow"], H, W, ph, pw)
