"""ZSM feature encoder — the counterpart of motif_tpu/models/encoder.py:
conv_first → front residual blocks → L2/L3 pyramid → pairwise PCD alignment
+ fusion → bidirectional deformable ConvLSTM → back residual blocks."""

from __future__ import annotations

import torch
from torch import nn

from motif_tpu_torch.models.layers import Conv2d, lrelu, res_blocks
from motif_tpu_torch.models.pcd import BiDeformableConvLSTM, PCDAlign


class ZSMEncoder(nn.Module):
    def __init__(self, channel: int = 64, front_rbs: int = 5,
                 back_rbs: int = 40):
        super().__init__()
        nf = self.nf = channel
        self.conv_first = Conv2d(3, nf, 3, 1, 1)
        self.feature_extraction = res_blocks(nf, front_rbs)
        self.fea_L2_conv1 = Conv2d(nf, nf, 3, 2, 1)
        self.fea_L2_conv2 = Conv2d(nf, nf, 3, 1, 1)
        self.fea_L3_conv1 = Conv2d(nf, nf, 3, 2, 1)
        self.fea_L3_conv2 = Conv2d(nf, nf, 3, 1, 1)
        self.pcd_align = PCDAlign(nf, groups=8)
        self.fusion = Conv2d(2 * nf, nf, 1, 1, 0)
        self.ConvBLSTM = BiDeformableConvLSTM(nf, groups=8)
        self.recon_trunk = res_blocks(nf, back_rbs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, N, H, W, 3) → (B, 2N-1, H, W, channel): each frame
        interleaved with its fused pair."""
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
        aligned = self.pcd_align([a1, a2, a3], [b1, b2, b3])
        fused = self.fusion(aligned).reshape(B, N - 1, H, W, nf)
        inter = torch.stack([l1[:, :-1], fused], dim=2)
        feats = torch.cat([inter.reshape(B, 2 * (N - 1), H, W, nf),
                           l1[:, -1:]], dim=1)

        feats = self.ConvBLSTM(feats)
        B2, T, H2, W2, C2 = feats.shape
        out = self.recon_trunk(feats.reshape(B2 * T, H2, W2, C2))
        return out.reshape(B2, T, H2, W2, nf)
