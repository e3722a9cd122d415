"""The baselines of the reference model zoo — the counterpart of
motif_tpu/models/baselines.py: ZSM (Zooming Slow-Mo), TMNet, EDVR and
Super-SloMo, NHWC, under the reference torch module names (so a reference
`.pth` loads with strict=True and the JAX package's parameters bridge in,
checkpoint.py).

ZSM and TMNet are fixed 4x-spatial models that interpolate time through
the deformable ConvLSTM; TMNet also modulates the PCD offsets with a
continuous time code (TMB). EDVR is a 4x video SR model of the centre
frame. Super-SloMo interpolates frames at any time from two. The DCNs run
the `dcn_im2col` kernel on CUDA tensors (ops/dcn.py); nothing else here
has a kernel.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from motif_tpu_torch.models.encoder import ZSMEncoder
from motif_tpu_torch.models.layers import (Conv2d, LReLU, avg_pool2d_padded,
                                           lrelu, max_pool2d, pixel_shuffle,
                                           res_blocks)
from motif_tpu_torch.models.pcd import DCNSep
from motif_tpu_torch.ops.resize import interpolate_bilinear
from motif_tpu_torch.ops.warp import grid_sample


class _ZSMHead(ZSMEncoder):
    """The ZSM trunk and its pixel-shuffle x4 head (upconv1, upconv2,
    HRconv, conv_last)."""

    def __init__(self, nf, front_rbs, back_rbs, groups, use_time=False):
        super().__init__(nf, front_rbs, back_rbs, groups, use_time)
        self.upconv1 = Conv2d(nf, nf * 4, 3, 1, 1)
        self.upconv2 = Conv2d(nf, 64 * 4, 3, 1, 1)
        self.HRconv = Conv2d(64, 64, 3, 1, 1)
        self.conv_last = Conv2d(64, 3, 3, 1, 1)

    def head(self, out):
        out = lrelu(pixel_shuffle(self.upconv1(out), 2))
        out = lrelu(pixel_shuffle(self.upconv2(out), 2))
        return self.conv_last(lrelu(self.HRconv(out)))


class ZSM(_ZSMHead):
    """Zooming Slow-Mo: x (B, N, H, W, 3) → (B, 2N-1, 4H, 4W, 3)."""

    def __init__(self, nf: int = 64, front_rbs: int = 5, back_rbs: int = 40,
                 groups: int = 8):
        super().__init__(nf, front_rbs, back_rbs, groups)

    def forward(self, x):
        B = x.shape[0]
        feats = self.trunk(self.interleaved(x))
        _, T, H, W, C = feats.shape
        out = self.head(feats.reshape(B * T, H, W, C))
        return out.reshape(B, T, 4 * H, 4 * W, 3)


def _offset_convs(nf):
    return nn.Sequential(Conv2d(2 * nf, nf, 3, 1, 1), LReLU(),
                         Conv2d(nf, nf, 3, 1, 1))


class TMNet(_ZSMHead):
    """TMNet: the time-modulated PCD, a comparison stage of two DCNs over
    each frame's neighbours, the ConvLSTM and the pixel-shuffle head.
    x (B, N, H, W, 3), times (B, Nt) in [0, 1] (the interior times) →
    (B, N + (N-1) Nt, 4H, 4W, 3); without times one frame a pair, as ZSM
    (the reference hardcodes 64 == nf channels in the comparison stage)."""

    def __init__(self, nf: int = 64, front_rbs: int = 5, back_rbs: int = 40,
                 groups: int = 8):
        super().__init__(nf, front_rbs, back_rbs, groups, use_time=True)
        self.layersAtBOffset = _offset_convs(nf)
        self.layersCtBOffset = _offset_convs(nf)
        self.layersAtB = DCNSep(nf, nf, deformable_groups=8)
        self.layersCtB = DCNSep(nf, nf, deformable_groups=8)
        self.layersFusion = nn.Sequential(
            Conv2d(3 * nf, 3 * nf, 1, 1, 0), LReLU(),
            Conv2d(3 * nf, 3 * nf, 1, 1, 0), LReLU(),
            Conv2d(3 * nf, 3 * nf, 1, 1, 0), LReLU(),
            Conv2d(3 * nf, nf, 1, 1, 0))

    def forward(self, x, times=None):
        B = x.shape[0]
        if times is None:
            # a PCD built with TMBs runs them; the JAX package's TMNet
            # without times builds one without
            raise ValueError("TMNet takes the interior times")
        t = ((times / 0.5) - 1.0).reshape(B, -1, 1, 1, 1)
        t_back = (((1.0 - times) / 0.5) - 1.0).reshape(B, -1, 1, 1, 1)
        dnc = self.interleaved(x, t, t_back)
        _, T, H, W, C = dnc.shape

        # the comparison stage over every frame at once: its neighbours
        # clamped at the ends (slices, not a host index: a captured forward
        # may not upload one)
        f0 = torch.cat([dnc[:, :1], dnc[:, :-1]], 1).reshape(B * T, H, W, C)
        f1 = dnc.reshape(B * T, H, W, C)
        f2 = torch.cat([dnc[:, 1:], dnc[:, -1:]], 1).reshape(B * T, H, W, C)
        f0a = lrelu(self.layersAtB(f0, self.layersAtBOffset(
            torch.cat([f0, f1], -1))))
        f2a = lrelu(self.layersCtB(f2, self.layersCtBOffset(
            torch.cat([f2, f1], -1))))
        comp = self.layersFusion(torch.cat([f0a, f1, f2a], -1))
        lstm_feats = dnc + comp.reshape(B, T, H, W, C)

        out = self.trunk(lstm_feats).reshape(B * T, H, W, C)
        out = out + dnc.reshape(B * T, H, W, C)
        return self.head(out).reshape(B, T, 4 * H, 4 * W, 3)


def _up2(v):
    return interpolate_bilinear(v, (v.shape[1] * 2, v.shape[2] * 2))


class EDVRPCDAlignment(nn.Module):
    """EDVR's PCD alignment: one direction, levels L3 → L1 with the
    reference's ModuleDicts keyed l1 / l2 / l3, then a cascading DCN.
    nbr / ref are [L1, L2, L3] pyramids."""

    def __init__(self, nf: int = 64, groups: int = 8):
        super().__init__()
        self.offset_conv1 = nn.ModuleDict()
        self.offset_conv2 = nn.ModuleDict()
        self.offset_conv3 = nn.ModuleDict()
        self.dcn_pack = nn.ModuleDict()
        self.feat_conv = nn.ModuleDict()
        for i in (3, 2, 1):
            lv = f"l{i}"
            self.offset_conv1[lv] = Conv2d(2 * nf, nf, 3, 1, 1)
            if i == 3:
                self.offset_conv2[lv] = Conv2d(nf, nf, 3, 1, 1)
            else:
                self.offset_conv2[lv] = Conv2d(2 * nf, nf, 3, 1, 1)
                self.offset_conv3[lv] = Conv2d(nf, nf, 3, 1, 1)
            self.dcn_pack[lv] = DCNSep(nf, nf, deformable_groups=groups)
            if i < 3:
                self.feat_conv[lv] = Conv2d(2 * nf, nf, 3, 1, 1)
        self.cas_offset_conv1 = Conv2d(2 * nf, nf, 3, 1, 1)
        self.cas_offset_conv2 = Conv2d(nf, nf, 3, 1, 1)
        self.cas_dcnpack = DCNSep(nf, nf, deformable_groups=groups)

    def forward(self, nbr, ref):
        feat = up_off = up_feat = None
        for i in (3, 2, 1):
            lv = f"l{i}"
            off = lrelu(self.offset_conv1[lv](
                torch.cat([nbr[i - 1], ref[i - 1]], -1)))
            if i == 3:
                off = lrelu(self.offset_conv2[lv](off))
            else:
                off = lrelu(self.offset_conv2[lv](torch.cat([off, up_off],
                                                            -1)))
                off = lrelu(self.offset_conv3[lv](off))
            feat = self.dcn_pack[lv](nbr[i - 1], off)
            if i < 3:
                feat = self.feat_conv[lv](torch.cat([feat, up_feat], -1))
            if i > 1:
                feat = lrelu(feat)
                up_off = _up2(off) * 2.0
                up_feat = _up2(feat)
        off = torch.cat([feat, ref[0]], -1)
        off = lrelu(self.cas_offset_conv2(lrelu(self.cas_offset_conv1(off))))
        return lrelu(self.cas_dcnpack(feat, off))


class TSAFusion(nn.Module):
    """EDVR's temporal and spatial attention fusion of T aligned frames."""

    def __init__(self, nf: int = 64, num_frame: int = 7, center: int = 3):
        super().__init__()
        self.center = center
        c1 = lambda cin: Conv2d(cin, nf, 1, 1, 0)      # noqa: E731
        c3 = lambda cin: Conv2d(cin, nf, 3, 1, 1)      # noqa: E731
        self.temporal_attn1 = c3(nf)
        self.temporal_attn2 = c3(nf)
        self.feat_fusion = c1(num_frame * nf)
        self.spatial_attn1 = c1(num_frame * nf)
        self.spatial_attn2 = c1(2 * nf)
        self.spatial_attn3 = c3(nf)
        self.spatial_attn4 = c1(nf)
        self.spatial_attn5 = c3(nf)
        self.spatial_attn_l1 = c1(nf)
        self.spatial_attn_l2 = c3(2 * nf)
        self.spatial_attn_l3 = c3(nf)
        self.spatial_attn_add1 = c1(nf)
        self.spatial_attn_add2 = c1(nf)

    def forward(self, aligned):
        B, T, H, W, C = aligned.shape
        emb_ref = self.temporal_attn1(aligned[:, self.center])
        emb = self.temporal_attn2(aligned.reshape(B * T, H, W, C)).reshape(
            B, T, H, W, -1)
        corr = torch.sigmoid(torch.sum(emb * emb_ref[:, None], -1))
        weighted = (aligned * corr[..., None]).permute(0, 2, 3, 1, 4).reshape(
            B, H, W, T * C)
        feat = lrelu(self.feat_fusion(weighted))

        def pools(v):
            return torch.cat([max_pool2d(v), avg_pool2d_padded(v)], -1)
        attn = lrelu(self.spatial_attn1(weighted))
        attn = lrelu(self.spatial_attn2(pools(attn)))
        attn_lv = lrelu(self.spatial_attn_l1(attn))
        attn_lv = lrelu(self.spatial_attn_l2(pools(attn_lv)))
        attn_lv = lrelu(self.spatial_attn_l3(attn_lv))
        attn_lv = interpolate_bilinear(attn_lv, (attn.shape[1], attn.shape[2]))
        attn = lrelu(self.spatial_attn3(attn)) + attn_lv
        attn = lrelu(self.spatial_attn4(attn))
        attn = interpolate_bilinear(attn, (H, W))
        attn = self.spatial_attn5(attn)
        attn_add = self.spatial_attn_add2(lrelu(self.spatial_attn_add1(attn)))
        attn = torch.sigmoid(attn)
        return feat * attn * 2.0 + attn_add


class EDVR(nn.Module):
    """EDVR video SR of the centre frame: x (B, num_frame, H, W, 3) →
    (B, 4H, 4W, 3). The reference builds it at nf 128, 5 / 40 blocks."""

    def __init__(self, nf: int = 128, num_frame: int = 7, groups: int = 8,
                 extract_blocks: int = 5, recon_blocks: int = 40,
                 with_tsa: bool = True):
        super().__init__()
        self.nf, self.num_frame = nf, num_frame
        self.center = num_frame // 2
        self.conv_first = Conv2d(3, nf, 3, 1, 1)
        self.feature_extraction = res_blocks(nf, extract_blocks)
        self.conv_l2_1 = Conv2d(nf, nf, 3, 2, 1)
        self.conv_l2_2 = Conv2d(nf, nf, 3, 1, 1)
        self.conv_l3_1 = Conv2d(nf, nf, 3, 2, 1)
        self.conv_l3_2 = Conv2d(nf, nf, 3, 1, 1)
        self.pcd_align = EDVRPCDAlignment(nf, groups)
        self.fusion = (TSAFusion(nf, num_frame, self.center) if with_tsa
                       else Conv2d(num_frame * nf, nf, 1, 1, 0))
        self.with_tsa = with_tsa
        self.reconstruction = res_blocks(nf, recon_blocks)
        self.upconv1 = Conv2d(nf, nf * 4, 3, 1, 1)
        self.upconv2 = Conv2d(nf, 64 * 4, 3, 1, 1)
        self.conv_hr = Conv2d(64, 64, 3, 1, 1)
        self.conv_last = Conv2d(64, 3, 3, 1, 1)

    def forward(self, x):
        B, T, H, W, C = x.shape
        if T != self.num_frame:
            raise ValueError(f"EDVR built for {self.num_frame} frames got {T}")
        nf, c = self.nf, self.center
        l1 = lrelu(self.conv_first(x.reshape(B * T, H, W, C)))
        l1 = self.feature_extraction(l1)
        l2 = lrelu(self.conv_l2_2(lrelu(self.conv_l2_1(l1))))
        l3 = lrelu(self.conv_l3_2(lrelu(self.conv_l3_1(l2))))
        pyr = [lv.reshape(B, T, *lv.shape[1:]) for lv in (l1, l2, l3)]
        # every frame aligned to the centre at once: frames ride the batch
        nbr = [lv.reshape(B * T, *lv.shape[2:]) for lv in pyr]
        ref = [lv[:, c:c + 1].expand_as(lv).reshape(B * T, *lv.shape[2:])
               for lv in pyr]
        aligned = self.pcd_align(nbr, ref).reshape(B, T, H, W, nf)
        if self.with_tsa:
            feat = self.fusion(aligned)
        else:
            feat = self.fusion(aligned.permute(0, 2, 3, 1, 4).reshape(
                B, H, W, T * nf))
        out = self.reconstruction(feat)
        out = lrelu(pixel_shuffle(self.upconv1(out), 2))
        out = lrelu(pixel_shuffle(self.upconv2(out), 2))
        out = self.conv_last(lrelu(self.conv_hr(out)))
        return out + interpolate_bilinear(x[:, c], (4 * H, 4 * W))


class _Down(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, k, 1, (k - 1) // 2)
        self.conv2 = Conv2d(cout, cout, k, 1, (k - 1) // 2)

    def forward(self, x):
        x = avg_pool2d_padded(x, 2, 2, 0)
        return lrelu(self.conv2(lrelu(self.conv1(x))))


class _Up(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, 1, 1)
        self.conv2 = Conv2d(2 * cout, cout, 3, 1, 1)

    def forward(self, x, skip):
        x = interpolate_bilinear(x, (x.shape[1] * 2, x.shape[2] * 2))
        x = lrelu(self.conv1(x))
        return lrelu(self.conv2(torch.cat([x, skip], -1)))


class UNet(nn.Module):
    """Super-SloMo's UNet: five average-pooled downs, five bilinear ups."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = Conv2d(cin, 32, 7, 1, 3)
        self.conv2 = Conv2d(32, 32, 7, 1, 3)
        self.down1 = _Down(32, 64, 5)
        self.down2 = _Down(64, 128, 3)
        self.down3 = _Down(128, 256, 3)
        self.down4 = _Down(256, 512, 3)
        self.down5 = _Down(512, 512, 3)
        self.up1 = _Up(512, 512)
        self.up2 = _Up(512, 256)
        self.up3 = _Up(256, 128)
        self.up4 = _Up(128, 64)
        self.up5 = _Up(64, 32)
        self.conv3 = Conv2d(32, cout, 3, 1, 1)

    def forward(self, x):
        x = lrelu(self.conv1(x))
        s1 = lrelu(self.conv2(x))
        s2 = self.down1(s1)
        s3 = self.down2(s2)
        s4 = self.down3(s3)
        s5 = self.down4(s4)
        x = self.down5(s5)
        x = self.up1(x, s5)
        x = self.up2(x, s4)
        x = self.up3(x, s3)
        x = self.up4(x, s2)
        x = self.up5(x, s1)
        return lrelu(self.conv3(x))


@functools.lru_cache(maxsize=None)
def _sslomo_mean(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Super-SloMo's channel mean, made once per dtype and device and kept
    (a forward captured into a CUDA graph may not upload, and reads it
    where it lies). Read only."""
    with torch.inference_mode(False):
        return torch.tensor([0.429, 0.431, 0.397], dtype=dtype, device=device)


def _sslomo_backwarp(img, flow):
    """Super-SloMo's backWarp: x normalised by W (not W - 1), grid_sample's
    defaults (bilinear, zeros, align_corners=False)."""
    _, H, W, _ = img.shape
    gx = torch.arange(W, dtype=torch.float32, device=img.device)[None, None]
    gy = torch.arange(H, dtype=torch.float32, device=img.device)[None, :, None]
    gx = gx + flow[..., 0]
    gy = gy + flow[..., 1]
    grid = torch.stack([2 * (gx / W - 0.5), 2 * (gy / H - 0.5)], -1)
    return grid_sample(img, grid, "bilinear", "zeros", False)


class SuperSloMo(nn.Module):
    """Super-SloMo frame interpolation: a flow UNet and an arbitrary-time
    interpolation UNet with visibility maps. frames (B, 2, h, w, 3),
    `factor` and the output size `out_hw` (h0, w0) → (B, factor + 1, h0,
    w0, 3). The UNets run at the output size rounded down to a multiple of
    32; their parameters do not depend on it."""

    def __init__(self):
        super().__init__()
        self.flow = UNet(6, 4)
        self.interp = UNet(20, 5)

    def forward(self, frames, factor: int, out_hw):
        h0, w0 = out_hw
        h, w = (h0 // 32) * 32, (w0 // 32) * 32
        norm = _sslomo_mean(frames.dtype, frames.device)
        i0 = interpolate_bilinear(frames[:, 0] - norm, (h, w))
        i1 = interpolate_bilinear(frames[:, 1] - norm, (h, w))
        flow_out = self.flow(torch.cat([i0, i1], -1))
        f01, f10 = flow_out[..., :2], flow_out[..., 2:]

        outs = [interpolate_bilinear(i0 + norm, (h0, w0))]
        for i in range(1, factor):
            t = i / factor
            temp = -t * (1 - t)
            ft0 = temp * f01 + (t * t) * f10
            ft1 = ((1 - t) * (1 - t)) * f01 + temp * f10
            g0 = _sslomo_backwarp(i0, ft0)
            g1 = _sslomo_backwarp(i1, ft1)
            io = self.interp(torch.cat([i0, i1, f01, f10, ft1, ft0, g1, g0],
                                       -1))
            ft0f = io[..., :2] + ft0
            ft1f = io[..., 2:4] + ft1
            vt0 = torch.sigmoid(io[..., 4:5])
            vt1 = 1.0 - vt0
            g0f = _sslomo_backwarp(i0, ft0f)
            g1f = _sslomo_backwarp(i1, ft1f)
            ft_p = (((1 - t) * vt0 * g0f + t * vt1 * g1f)
                    / ((1 - t) * vt0 + t * vt1))
            outs.append(interpolate_bilinear(ft_p + norm, (h0, w0)))
        outs.append(interpolate_bilinear(i1 + norm, (h0, w0)))
        return torch.stack(outs, dim=1)
