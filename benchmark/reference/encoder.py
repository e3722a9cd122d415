"""ZSM feature encoder — the counterpart of motif_tpu/models/encoder.py (and
of the ZSM trunk that motif_tpu/models/baselines.py::_zsm_trunk shares with
the baselines): conv_first → front residual blocks → L2/L3 pyramid →
pairwise PCD alignment + fusion → bidirectional deformable ConvLSTM → back
residual blocks."""

from __future__ import annotations

import torch
from torch import nn

from .layers import Conv2d, lrelu, res_blocks
from .pcd import BiDeformableConvLSTM, PCDAlign


class ZSMEncoder(nn.Module):
    """The trunk under the reference's top-level names, which the ZSM
    family (ZSM, TMNet, VideoINR) and MoTIF's encoder share. `groups` is
    the ConvLSTM's deformable groups (the PCD keeps 8); `use_time` gives
    the PCD TMNet's temporal modulation."""

    def __init__(self, channel: int = 64, front_rbs: int = 5,
                 back_rbs: int = 40, groups: int = 8, use_time: bool = False):
        super().__init__()
        nf = self.nf = channel
        self.conv_first = Conv2d(3, nf, 3, 1, 1)
        self.feature_extraction = res_blocks(nf, front_rbs)
        self.fea_L2_conv1 = Conv2d(nf, nf, 3, 2, 1)
        self.fea_L2_conv2 = Conv2d(nf, nf, 3, 1, 1)
        self.fea_L3_conv1 = Conv2d(nf, nf, 3, 2, 1)
        self.fea_L3_conv2 = Conv2d(nf, nf, 3, 1, 1)
        self.pcd_align = PCDAlign(nf, groups=8, use_time=use_time)
        self.fusion = Conv2d(2 * nf, nf, 1, 1, 0)
        self.ConvBLSTM = BiDeformableConvLSTM(nf, groups=groups)
        self.recon_trunk = res_blocks(nf, back_rbs)

    def interleaved(self, x: torch.Tensor, t=None, t_back=None):
        """x (B, N, H, W, 3) → (B, T, H, W, nf): each frame's features with
        its pair's PCD-fused features between them, one per time code of
        `t` / `t_back` (B, Nt, 1, 1, 1) where given (T = N + (N-1) Nt),
        else one (T = 2N - 1)."""
        B, N, H, W, C = x.shape
        if N < 2:
            raise ValueError("ZSMEncoder needs >= 2 input frames")
        nf = self.nf
        l1 = lrelu(self.conv_first(x.reshape(B * N, H, W, C)))
        l1 = self.feature_extraction(l1)
        l2 = lrelu(self.fea_L2_conv1(l1))
        l2 = lrelu(self.fea_L2_conv2(l2))
        l3 = lrelu(self.fea_L3_conv1(l2))
        l3 = lrelu(self.fea_L3_conv2(l3))
        l1 = l1.reshape(B, N, H, W, nf)
        l2 = l2.reshape(B, N, H // 2, W // 2, nf)
        l3 = l3.reshape(B, N, H // 4, W // 4, nf)

        # the N-1 adjacent pairs share weights: fold the pair axis into batch
        def pairs(lv):
            _, _, h, w, c = lv.shape
            return (lv[:, :-1].reshape(B * (N - 1), h, w, c),
                    lv[:, 1:].reshape(B * (N - 1), h, w, c))
        (a1, b1), (a2, b2), (a3, b3) = pairs(l1), pairs(l2), pairs(l3)

        def fused(tt=None, tb=None):
            if tt is not None:      # each pair takes its clip's time code
                tt = tt.repeat_interleave(N - 1, dim=0)
                tb = tb.repeat_interleave(N - 1, dim=0)
            aligned = self.pcd_align([a1, a2, a3], [b1, b2, b3], tt, tb)
            return self.fusion(aligned).reshape(B, N - 1, H, W, nf)
        mids = ([fused()] if t is None else
                [fused(t[:, i], t_back[:, i]) for i in range(t.shape[1])])
        inter = torch.stack([l1[:, :-1], *mids], dim=2)
        return torch.cat([inter.reshape(B, (N - 1) * (1 + len(mids)), H, W,
                                        nf), l1[:, -1:]], dim=1)

    def trunk(self, feats: torch.Tensor) -> torch.Tensor:
        """The ConvLSTM and the back residual blocks over (B, T, H, W, nf)."""
        feats = self.ConvBLSTM(feats)
        B, T, H, W, C = feats.shape
        out = self.recon_trunk(feats.reshape(B * T, H, W, C))
        return out.reshape(B, T, H, W, self.nf)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, N, H, W, 3) → (B, 2N-1, H, W, channel): each frame
        interleaved with its fused pair."""
        return self.trunk(self.interleaved(x))
