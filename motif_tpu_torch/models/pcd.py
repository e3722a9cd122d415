"""Pyramid-cascading-deformable alignment — the counterpart of
motif_tpu/models/pcd.py: DCNSep, TMB, PCDAlign (with TMNet's temporal
modulation blocks where asked for; MoTIF does not use them), EasyPCD,
DeformableConvLSTM and BiDeformableConvLSTM. NHWC throughout.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from motif_tpu_torch.models.layers import (Conv2d, ConvLSTMCell, LReLU,
                                           cast_param, lrelu)
from motif_tpu_torch.ops import dcn
from motif_tpu_torch.ops.resize import interpolate_bilinear


class DCNSep(nn.Module):
    """DCN_sep: conv_offset_mask(fea) gives (o1, o2, mask) chunks; the
    offsets cat(o1, o2) are read with layout (g, k, [y, x]); the mask is
    sigmoided; then the modulated deformable conv of `x`."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1,
                 deformable_groups: int = 8):
        super().__init__()
        K, G = kernel_size, deformable_groups
        self.kernel_size, self.stride, self.padding = K, stride, padding
        self.dilation, self.deformable_groups = dilation, G
        self.conv_offset_mask = Conv2d(cin, G * 3 * K * K, K, stride, padding,
                                       init="zeros")
        stdv = 1.0 / math.sqrt(cin * K * K)
        self.weight = nn.Parameter(torch.empty(cout, cin, K, K).uniform_(-stdv,
                                                                         stdv))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, fea):
        K, G = self.kernel_size, self.deformable_groups
        com = self.conv_offset_mask(fea)
        offset = com[..., :2 * G * K * K]
        mask = torch.sigmoid(com[..., 2 * G * K * K:])
        return dcn.dcn_v2(x, offset, mask, cast_param(self, "weight", x.dtype),
                          cast_param(self, "bias", x.dtype),
                          kernel_size=K, stride=self.stride,
                          padding=self.padding, dilation=self.dilation,
                          deformable_groups=G)


def _up2(x):
    return interpolate_bilinear(x, (x.shape[1] * 2, x.shape[2] * 2), False)


class TMB(nn.Module):
    """Temporal modulation block: f_process(x) * t_process(t), x (B, H, W,
    nf), t (B, 1, 1, 1) a time code; the reference hardcodes 64 == nf
    channels."""

    def __init__(self, nf: int = 64):
        super().__init__()
        self.f_process = nn.Sequential(Conv2d(nf, nf, 3, 1, 1), LReLU(),
                                       Conv2d(nf, nf, 3, 1, 1), LReLU())
        self.t_process = nn.Sequential(
            Conv2d(1, nf, 1, 1, 0, bias=False), LReLU(),
            Conv2d(nf, nf, 1, 1, 0, bias=False), LReLU(),
            Conv2d(nf, nf, 1, 1, 0, bias=False), LReLU())

    def forward(self, x, t):
        return self.f_process(x) * self.t_process(t)


class PCDAlign(nn.Module):
    """Bidirectional three-level deformable alignment of two [L1, L2, L3]
    NHWC pyramids; returns cat(y1, y2) on channels. With `use_time`
    (TMNet) each level's offsets are modulated by a TMB of the time code,
    `t` for the first branch and `t_back` for the second (TMB_A_* and
    TMB_B_*)."""

    def __init__(self, nf: int = 64, groups: int = 8, use_time: bool = False):
        super().__init__()
        for s in ("1", "2"):
            for lvl in ("L3", "L2", "L1"):
                setattr(self, f"{lvl}_offset_conv1_{s}",
                        Conv2d(2 * nf, nf, 3, 1, 1))
                setattr(self, f"{lvl}_dcnpack_{s}",
                        DCNSep(nf, nf, 3, 1, 1, deformable_groups=groups))
            setattr(self, f"L3_offset_conv2_{s}", Conv2d(nf, nf, 3, 1, 1))
            for lvl in ("L2", "L1"):
                setattr(self, f"{lvl}_offset_conv2_{s}",
                        Conv2d(2 * nf, nf, 3, 1, 1))
                setattr(self, f"{lvl}_offset_conv3_{s}", Conv2d(nf, nf, 3, 1, 1))
                setattr(self, f"{lvl}_fea_conv_{s}", Conv2d(2 * nf, nf, 3, 1, 1))
        self.use_time = use_time
        if use_time:
            for ab in ("A", "B"):
                for lvl in ("l3", "l2", "l1"):
                    setattr(self, f"TMB_{ab}_{lvl}", TMB(nf))

    def _branch(self, a, b, s, tt):
        m = lambda name: getattr(self, f"{name}_{s}")  # noqa: E731

        def modulated(off_c, off, lvl):
            if tt is None:
                return off_c
            ab = "A" if s == "1" else "B"
            return off_c + getattr(self, f"TMB_{ab}_{lvl}")(off, tt)

        l3_off = lrelu(m("L3_offset_conv1")(torch.cat([a[2], b[2]], -1)))
        l3_off_c = modulated(lrelu(m("L3_offset_conv2")(l3_off)), l3_off, "l3")
        l3_fea = lrelu(m("L3_dcnpack")(a[2], l3_off_c))

        l2_off = lrelu(m("L2_offset_conv1")(torch.cat([a[1], b[1]], -1)))
        l2_off = lrelu(m("L2_offset_conv2")(
            torch.cat([l2_off, _up2(l3_off_c) * 2.0], -1)))
        l2_off_c = modulated(lrelu(m("L2_offset_conv3")(l2_off)), l2_off, "l2")
        l2_fea = m("L2_dcnpack")(a[1], l2_off_c)
        l2_fea = lrelu(m("L2_fea_conv")(torch.cat([l2_fea, _up2(l3_fea)], -1)))

        l1_off = lrelu(m("L1_offset_conv1")(torch.cat([a[0], b[0]], -1)))
        l1_off = lrelu(m("L1_offset_conv2")(
            torch.cat([l1_off, _up2(l2_off_c) * 2.0], -1)))
        l1_off_c = modulated(lrelu(m("L1_offset_conv3")(l1_off)), l1_off, "l1")
        l1_fea = m("L1_dcnpack")(a[0], l1_off_c)
        return m("L1_fea_conv")(torch.cat([l1_fea, _up2(l2_fea)], -1))

    def forward(self, fea1, fea2, t=None, t_back=None):
        """`t` / `t_back` (B, 1, 1, 1): the time codes of a use_time PCD,
        which needs them; None otherwise."""
        if self.use_time != (t is not None and t_back is not None):
            raise ValueError("PCDAlign: time codes go with use_time=True, "
                             "and only there")
        return torch.cat([self._branch(fea1, fea2, "1", t),
                          self._branch(fea2, fea1, "2", t_back)], dim=-1)


class EasyPCD(nn.Module):
    """Three-level pyramids of two features, PCD-aligned, fused 1x1."""

    def __init__(self, nf: int = 64, groups: int = 8):
        super().__init__()
        self.fea_L2_conv1 = Conv2d(nf, nf, 3, 2, 1)
        self.fea_L2_conv2 = Conv2d(nf, nf, 3, 1, 1)
        self.fea_L3_conv1 = Conv2d(nf, nf, 3, 2, 1)
        self.fea_L3_conv2 = Conv2d(nf, nf, 3, 1, 1)
        self.pcd_align = PCDAlign(nf, groups)
        self.fusion = Conv2d(2 * nf, nf, 1, 1, 0)

    def forward(self, f1, f2):
        B = f1.shape[0]
        l1 = torch.cat([f1, f2], dim=0)
        l2 = lrelu(self.fea_L2_conv1(l1))
        l2 = lrelu(self.fea_L2_conv2(l2))
        l3 = lrelu(self.fea_L3_conv1(l2))
        l3 = lrelu(self.fea_L3_conv2(l3))
        aligned = self.pcd_align([l1[:B], l2[:B], l3[:B]],
                                 [l1[B:], l2[B:], l3[B:]])
        return self.fusion(aligned)


class DeformableConvLSTM(nn.Module):
    """One ConvLSTM layer whose hidden and cell states are PCD-aligned to
    the current input (two separate EasyPCD stacks) before each update."""

    def __init__(self, nf: int, groups: int, kernel_size=(3, 3)):
        super().__init__()
        self.nf = nf
        self.pcd_h = EasyPCD(nf, groups)
        self.pcd_c = EasyPCD(nf, groups)
        self.cell_list = nn.ModuleList([ConvLSTMCell(nf, nf, kernel_size)])

    def forward(self, x):
        """x (B, T, H, W, C) → (B, T, H, W, nf)."""
        B, T, H, W, _ = x.shape
        h = x.new_zeros((B, H, W, self.nf))
        c = x.new_zeros((B, H, W, self.nf))
        outs = []
        for t in range(T):
            xt = x[:, t]
            h, c = self.cell_list[0](xt, (self.pcd_h(xt, h), self.pcd_c(xt, c)))
            outs.append(h)
        return torch.stack(outs, dim=1)


class BiDeformableConvLSTM(nn.Module):
    """The same forward_net over the sequence forwards and backwards (both
    directions ride one batch), concatenated and fused 1x1."""

    def __init__(self, nf: int, groups: int):
        super().__init__()
        self.nf = nf
        self.forward_net = DeformableConvLSTM(nf, groups)
        self.conv_1x1 = Conv2d(2 * nf, nf, 1, 1, 0)

    def forward(self, x):
        B = x.shape[0]
        both = self.forward_net(torch.cat([x, x.flip(1)], dim=0))
        both = torch.cat([both[:B], both[B:].flip(1)], dim=-1)
        _, T, H, W, C2 = both.shape
        fused = self.conv_1x1(both.reshape(B * T, H, W, C2))
        return fused.reshape(B, T, H, W, self.nf)
