"""RAFT-small optical flow — the counterpart of motif_tpu/models/raft.py in
MoTIF's configuration (small=True: hidden 96, context 64, 4 correlation
levels of radius 3, SmallEncoder + SmallUpdateBlock, upflow8).

NHWC throughout; module names follow the reference (`fnet`, `cnet`,
`update_block`, `layer1.0.conv1`, ...). Coordinates accumulate in at least
float32 whatever the image dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Conv2d
from .corr import all_pairs_corr, corr_lookup, corr_pyramid
from .resize import interpolate_bilinear


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """nn.InstanceNorm2d(affine=False) on NHWC, statistics in >= float32."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = xf.var(dim=(1, 2), unbiased=False, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _conv(cin, cout, k, stride=1, pad=0):
    return Conv2d(cin, cout, k, stride, pad, init="kaiming_out")


class BottleneckBlock(nn.Module):
    """1x1 → 3x3 (stride) → 1x1 with a residual, instance norm or none."""

    def __init__(self, cin: int, planes: int, norm_fn: str, stride: int):
        super().__init__()
        self.norm = instance_norm if norm_fn == "instance" else (lambda v: v)
        self.conv1 = _conv(cin, planes // 4, 1)
        self.conv2 = _conv(planes // 4, planes // 4, 3, stride, 1)
        self.conv3 = _conv(planes // 4, planes, 1)
        self.downsample = (nn.Sequential(_conv(cin, planes, 1, stride))
                           if stride != 1 else None)

    def forward(self, x):
        y = torch.relu(self.norm(self.conv1(x)))
        y = torch.relu(self.norm(self.conv2(y)))
        y = torch.relu(self.norm(self.conv3(y)))
        if self.downsample is not None:
            x = self.norm(self.downsample(x))
        return torch.relu(x + y)


class SmallEncoder(nn.Module):
    """The 1/8-resolution feature encoder."""

    def __init__(self, output_dim: int, norm_fn: str):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = _conv(3, 32, 7, 2, 3)
        cin = 32
        for i, (dim, stride) in enumerate([(32, 1), (64, 2), (96, 2)], start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                BottleneckBlock(cin, dim, norm_fn, stride),
                BottleneckBlock(dim, dim, norm_fn, 1)))
            cin = dim
        self.conv2 = _conv(96, output_dim, 1)

    def forward(self, x):
        y = self.conv1(x)
        if self.norm_fn == "instance":
            y = instance_norm(y)
        y = torch.relu(y)
        y = self.layer3(self.layer2(self.layer1(y)))
        return self.conv2(y)


class ConvGRU(nn.Module):
    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        cin = hidden_dim + input_dim
        self.convz = Conv2d(cin, hidden_dim, 3, 1, 1)
        self.convr = Conv2d(cin, hidden_dim, 3, 1, 1)
        self.convq = Conv2d(cin, hidden_dim, 3, 1, 1)

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=-1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=-1)))
        return (1 - z) * h + z * q


class SmallMotionEncoder(nn.Module):
    def __init__(self, cor_planes: int = 4 * 7 ** 2):
        super().__init__()
        self.convc1 = Conv2d(cor_planes, 96, 1, 1, 0)
        self.convf1 = Conv2d(2, 64, 7, 1, 3)
        self.convf2 = Conv2d(64, 32, 3, 1, 1)
        self.conv = Conv2d(128, 80, 3, 1, 1)

    def forward(self, flow, corr):
        cor = torch.relu(self.convc1(corr))
        flo = torch.relu(self.convf1(flow))
        flo = torch.relu(self.convf2(flo))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=-1)))
        return torch.cat([out, flow], dim=-1)


class FlowHead(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int):
        super().__init__()
        self.conv1 = Conv2d(input_dim, hidden_dim, 3, 1, 1)
        self.conv2 = Conv2d(hidden_dim, 2, 3, 1, 1)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x)))


class SmallUpdateBlock(nn.Module):
    def __init__(self, hidden_dim: int = 96, context_dim: int = 64):
        super().__init__()
        self.encoder = SmallMotionEncoder()
        self.gru = ConvGRU(hidden_dim, context_dim + 82)
        self.flow_head = FlowHead(hidden_dim, 128)

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=-1))
        return net, self.flow_head(net)


def coords_grid(B: int, H: int, W: int, device) -> torch.Tensor:
    """(B, H, W, 2) float32 pixel grid, channels (x, y)."""
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([gx, gy], dim=-1)[None].expand(B, H, W, 2)


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """8x bilinear upsample (align_corners=True), values scaled by 8."""
    _, H, W, _ = flow.shape
    return 8.0 * interpolate_bilinear(flow, (8 * H, 8 * W), align_corners=True)


class RAFT(nn.Module):
    """RAFT-small. forward takes images in [0, 255], (B, H, W, 3) each, and
    returns the full-resolution flow (B, H, W, 2) after `iters` updates."""

    hidden_dim = 96
    context_dim = 64
    corr_levels = 4
    corr_radius = 3

    def __init__(self):
        super().__init__()
        self.fnet = SmallEncoder(128, "instance")
        self.cnet = SmallEncoder(self.hidden_dim + self.context_dim, "none")
        self.update_block = SmallUpdateBlock(self.hidden_dim, self.context_dim)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                iters: int = 12) -> torch.Tensor:
        img1 = 2.0 * (image1 / 255.0) - 1.0
        img2 = 2.0 * (image2 / 255.0) - 1.0
        B = img1.shape[0]
        fmaps = self.fnet(torch.cat([img1, img2], dim=0))
        fmap1, fmap2 = fmaps[:B], fmaps[B:]
        pyramid = corr_pyramid(all_pairs_corr(fmap1, fmap2), self.corr_levels)

        c = self.cnet(img1)
        net = torch.tanh(c[..., :self.hidden_dim])
        inp = torch.relu(c[..., self.hidden_dim:])

        H8, W8 = fmap1.shape[1], fmap1.shape[2]
        coords0 = coords_grid(B, H8, W8, img1.device)
        acc = torch.promote_types(torch.float32, img1.dtype)
        coords1 = coords0.to(acc)
        for _ in range(iters):
            corr = corr_lookup(pyramid, coords1, self.corr_radius).to(img1.dtype)
            flow = (coords1 - coords0).to(img1.dtype)
            net, delta = self.update_block(net, inp, corr, flow)
            coords1 = coords1 + delta.to(coords1.dtype)
        return upflow8(coords1 - coords0)
