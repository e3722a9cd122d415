"""Ours_flow (models/modules/Ours_flow.py:496-560), the counterpart of
motif_tpu/models/flow_precompute.py: the reference's offline flow / psies
precomputer, kept in the model zoo. Given 4 LR frames it runs RAFT on 12
directed pairs at HR, zeroes the two self-pairs, keeps the 8 middle pairs
(anchors 1 and 2 to all four frames) and returns their flows with the
reliability maps psi_photo / psi_flow / psi_var, which the Adobe_flow
dataset (Adobe_dataset_flow.py:194-196) loads from npy files.

Returns (flow, 0, psies) as the reference forward does: 8 rows per clip,
while `MoTIF(n_anchors=2)` takes n² = 4 rows of LR flow and the
`Adobe_flow` trees of both packages hold 4; the JAX package has the same
mismatch, and the port keeps it (ROADMAP.md §C).
"""

from __future__ import annotations

import torch
from torch import nn

from motif_tpu_torch.models.motif import _gauss_blur_reflect
from motif_tpu_torch.models.raft import RAFT
from motif_tpu_torch.ops.resize import interpolate_bilinear
from motif_tpu_torch.ops.warp import backwarp

# the 12 directed pairs (src, dst), Ours_flow.py:512-515; rows 3 (1 -> 1)
# and 8 (2 -> 2) are the zeroed self-pairs
PAIR_SRC = (0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3)
PAIR_DST = (1, 2, 0, 1, 2, 3, 0, 1, 2, 3, 1, 2)
ZERO_ROWS = (3, 8)
# the reverse pair of each kept row 2..9 (1->0, 1->1, 1->2, 1->3, 2->0,
# 2->1, 2->2, 2->3) in the 12-row table (Ours_flow.py:536-541)
REVERSE_OF_KEPT = (0, 3, 7, 10, 1, 4, 8, 11)


class FlowPrecompute(nn.Module):
    """x (B, 4, H, W, 3) LR frames in [0, 1] -> (flow (8B, H, W, 2), 0,
    psies (8B, H, W, 3)), rows pair-major. The flows are computed at
    scale · (H, W) and brought to LR as MoTIF's live path brings them. The
    reference's fork warps with zeros padding (its BackWarp(clip=False),
    Ours_flow.py:414), not the border padding of MoTIF. No gradient."""

    def __init__(self, scale: int = 4):
        super().__init__()
        self.scale = scale
        self.flow_predictor = RAFT()

    @torch.no_grad()
    def forward(self, x: torch.Tensor, iters: int = 12):
        B, N_in, H, W, _ = x.shape
        if N_in != 4:
            raise ValueError(f"FlowPrecompute takes 4 frames, not {N_in}")
        HH, WW = H * self.scale, W * self.scale
        frames = [x[:, i] for i in range(4)]
        hr = [interpolate_bilinear(f, (HH, WW)) for f in frames]
        src = torch.cat([hr[i] for i in PAIR_SRC], 0)
        dst = torch.cat([hr[j] for j in PAIR_DST], 0)
        flow = self.flow_predictor(src * 255.0, dst * 255.0, iters=iters)
        flow = (interpolate_bilinear(flow, (H, W)) * (H / HH)).reshape(
            12, B, H, W, 2)
        for r in ZERO_ROWS:
            flow[r] = 0.0
        kept = flow[2:-2].reshape(8 * B, H, W, 2)

        # psi_photo (Ours_flow.py:526-532): each pair's dst frame warped
        # back with its flow against its src frame (anchors 1, 2)
        dsts = torch.cat([frames[j] for j in PAIR_DST[2:-2]], 0)
        srcs = torch.cat([frames[1]] * 4 + [frames[2]] * 4, 0)
        warped, _ = backwarp(dsts, kept, clip=False)
        psi_photo = (srcs - warped).abs().mean(-1)
        # psi_flow (Ours_flow.py:536-547): each reverse flow warped back
        rev = torch.cat([flow[r] for r in REVERSE_OF_KEPT], 0)
        warped_f, _ = backwarp(-rev, kept, clip=False)
        psi_flow = (kept - warped_f).abs().mean(-1)
        # psi_var (Ours_flow.py:548-556)
        sq_mean = _gauss_blur_reflect(kept ** 2)
        mean_sq = _gauss_blur_reflect(kept)
        psi_var = torch.sqrt(torch.clamp(sq_mean - mean_sq ** 2, min=1e-9)
                             ).mean(-1)
        psies = torch.stack([psi_photo, psi_flow / 10.0, psi_var], -1)
        return kept, 0, psies
