"""MoTIF continuous space-time video super-resolution — the counterpart of
motif_tpu/models/motif.py::MoTIF for the serving forward this port covers:
setting=5, n_anchors=2 (the reference `Ours`), groups=1, in the reference
float-op order (fused_decode=False, no compute_dtype, raft_resolution=1.0,
decode_chunks=1), inference only.

Pipeline: RAFT-small on the two cross pairs of the two center frames at HR
→ reliability metrics psi_photo / psi_flow / psi_var → ZSM encoder →
flow-context convs → separable LIIF nearest takes → STINF / SINF SIRENs →
softmax splat (CUDA kernel `splat_fused`) → synthesis SIREN → clip.

Tensors are NHWC as in the JAX package: forward takes x (B, N_in, H, W, 3)
and returns frames (N, B, HH, WW, 3).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from motif_tpu_torch import resolve_device
from motif_tpu_torch.models.encoder import ZSMEncoder
from motif_tpu_torch.models.layers import Conv2d, LateralBlock, LReLU
from motif_tpu_torch.models.raft import RAFT
from motif_tpu_torch.models.siren import Siren
from motif_tpu_torch.ops import softsplat
from motif_tpu_torch.ops.resize import interpolate_bilinear
from motif_tpu_torch.ops.warp import backwarp


def make_coord_1d(n: int) -> np.ndarray:
    """Cell-center coordinates in [-1, 1], float64."""
    r = 1.0 / n
    return (-1.0 + r + 2.0 * r * np.arange(n)).astype(np.float64)


def liif_nearest_axis(src: int, dst: int, eps: float = 1e-6):
    """Nearest source cell and scaled relative coordinate for one axis of
    the LIIF query, as grid_sample(nearest, align_corners=False) picks it
    (np.round is half-to-even, as torch's). float64 tables, kept in numpy."""
    hr = make_coord_1d(dst)
    c = np.clip(hr + eps, -1 + 1e-6, 1 - 1e-6)
    pix = ((c + 1.0) * src - 1.0) / 2.0
    idx = np.clip(np.round(pix).astype(np.int64), 0, src - 1)
    rel = (hr - make_coord_1d(src)[idx]) * src
    return idx, rel


def _gauss_blur_reflect(x: torch.Tensor) -> torch.Tensor:
    """3x3 [1,2,1]⊗[1,2,1]/16 blur with reflect padding; x (B, H, W, C)."""
    k0, k1 = 0.25, 0.5
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                                 mode="reflect").permute(0, 2, 3, 1)
    xh = xp[:, :, :-2] * k0 + xp[:, :, 1:-1] * k1 + xp[:, :, 2:] * k0
    return xh[:, :-2] * k0 + xh[:, 1:-1] * k1 + xh[:, 2:] * k0


class MoTIF(nn.Module):
    """The MoTIF model, setting=5 with two anchors. Parameter names are the
    reference torch names, so `load_state_dict(strict=True)` takes the
    bridged JAX parameters (checkpoint.py).

    Each SIREN runs whole through `siren_mlp`: the JAX package's
    fused_siren=True."""

    n_anchors = 2
    positions = (0.0, 8.0)

    def __init__(self, channel: int = 64, front_rbs: int = 5,
                 back_rbs: int = 40):
        super().__init__()
        ch = self.channel = channel
        n = self.n_anchors
        self.flow_predictor = RAFT()
        self.encoder = ZSMEncoder(ch, front_rbs, back_rbs)
        self.flow_process = nn.Sequential(
            Conv2d(n * 7, ch, 3, 1, 1, groups=n),
            Conv2d(ch, ch, 3, 1, 1, groups=2),
            LReLU(),
            *[LateralBlock(ch) for _ in range(5)],
            LReLU(),
            Conv2d(ch, ch, 3, 1, 1, padding_mode="reflect"))
        # checkpointed but unused by this forward (reference Ours.py)
        self.alpha = nn.Parameter(torch.full((1,), -20.0))
        self.norm_gamma = nn.Parameter(torch.ones(1, 3, 1))
        self.norm_beta = nn.Parameter(torch.zeros(1, 3, 1))
        self.shuffle = Conv2d(ch, ch, 1, 1, 0)
        self.flow_imnet = Siren(ch + 3, [64, 64, 256], 2, 3)
        self.imnet = Siren(ch + 2, [64, 64, 256], 2, 64)
        self.synth_net = Siren(64 + 2 + ch + 3 + ch + 1, [64, 64, 64, 256], 3,
                               3)

    def forward(self, x: torch.Tensor, target_t: torch.Tensor, out_hw,
                iters: int = 12):
        """x (B, N_in, H, W, 3) LR frames in [0, 1]; target_t (B, N) times in
        [0, 1]; out_hw (HH, WW). Returns (frames (N, B, HH, WW, 3), flow
        (2BN, HH, WW, 2) / 20 / (HH/H), the all-zero teacher flow likewise)."""
        B, N_in, H, W, _ = x.shape
        HH, WW = out_hw
        N = target_t.shape[1]
        ch = self.channel
        n = self.n_anchors
        n2 = n * n
        rsd_div = self.positions[-1]
        c = N_in // 2
        frames = [x[:, c - 1], x[:, c]]

        # ---- motion + reliability: RAFT on the cross pairs only; the
        # self-pair flows are exact zeros ----
        hr_frames = [interpolate_bilinear(f, (HH, WW)) for f in frames]
        pairs = [(i, j) for i in range(n) for j in range(n) if i != j]
        src = torch.cat([hr_frames[i] for i, _ in pairs], 0)
        dst = torch.cat([hr_frames[j] for _, j in pairs], 0)
        fl = self.flow_predictor(src * 255.0, dst * 255.0, iters=iters)
        fl = interpolate_bilinear(fl, (H, W)) * (H / HH)
        fl = fl.reshape(len(pairs), B, H, W, 2)
        flow = x.new_zeros((n2, B, H, W, 2))
        for k, (i, j) in enumerate(pairs):
            flow[i * n + j] = fl[k]
        flow = flow.reshape(n2 * B, H, W, 2)

        tgt = torch.cat([frames[j] for _ in range(n) for j in range(n)], 0)
        srclr = torch.cat([frames[i] for i in range(n) for _ in range(n)], 0)
        warped, _ = backwarp(tgt, flow, clip=True)
        psi_photo = (srclr - warped).abs().mean(-1)
        f4 = flow.reshape(n2, B, H, W, 2)
        rev = torch.cat([f4[j * n + i] for i in range(n) for j in range(n)], 0)
        warped_f, _ = backwarp(-rev, flow, clip=True)
        psi_flow = (flow - warped_f).abs().mean(-1)
        sq_mean = _gauss_blur_reflect(flow ** 2)
        mean_sq = _gauss_blur_reflect(flow)
        psi_var = torch.sqrt(torch.clamp(sq_mean - mean_sq ** 2, min=1e-9)
                             ).mean(-1)
        psies = torch.stack([psi_photo, psi_flow / 10.0, psi_var], dim=-1)
        flow_gt = x.new_zeros((n * B * N, HH, WW, 2))

        # ---- encoder ----
        feat_t = self.encoder(torch.stack(frames, 1))        # (B, 3, H, W, ch)
        residual_bn = feat_t[:, feat_t.shape[1] // 2][:, None].expand(
            B, N, H, W, ch).reshape(B * N, H, W, ch)
        feat = torch.cat([feat_t[:, 2 * i] for i in range(n)], 0)  # (nB,H,W,ch)

        # ---- flow-context encoder: per source frame i, the targets j of
        # [flow_ij / 20 | psi_ij | rsd row] into a grouped conv ----
        rsd = np.array([[self.positions[i], self.positions[j]]
                        for i in range(n) for j in range(n)], np.float32)
        f22 = (flow / 20.0).reshape(n, n, B, H, W, 2).permute(0, 2, 1, 3, 4, 5)
        p22 = psies.reshape(n, n, B, H, W, 3).permute(0, 2, 1, 3, 4, 5)
        r22 = torch.as_tensor(rsd.reshape(n, 1, n, 1, 1, 2) / rsd_div,
                              device=x.device).to(x.dtype).expand(
                                  n, B, n, H, W, 2)
        ff = torch.cat([f22, p22, r22], dim=-1)              # (n,B,n,H,W,7)
        ff = ff.reshape(n * B, n, H, W, 7).permute(0, 2, 3, 1, 4)
        flow_feat = self.flow_process(ff.reshape(n * B, H, W, n * 7))

        # ---- LIIF query as separable nearest takes (one shift, weight 1) --
        iy, rel_y = liif_nearest_axis(H, HH, 1e-6)
        ix, rel_x = liif_nearest_axis(W, WW, 1e-6)
        iy_t = torch.as_tensor(iy, device=x.device)
        ix_t = torch.as_tensor(ix, device=x.device)

        def up(img):
            return img.index_select(1, iy_t).index_select(2, ix_t)

        ry, rx = np.meshgrid(rel_y, rel_x, indexing="ij")
        rel = torch.as_tensor(np.stack([ry, rx], -1)[None],
                              device=x.device).to(x.dtype)  # (1, HH, WW, 2)
        t_tokens = target_t.reshape(B * N, 1, 1, 1).repeat(n, HH, WW, 1)

        q_feat = up(feat)                                    # (nB,HH,WW,ch)
        q_flow_feat = up(flow_feat)
        q_residual = up(residual_bn)                         # (BN,HH,WW,ch)
        sti = torch.cat([q_flow_feat.repeat_interleave(N, 0), t_tokens,
                         rel.expand(n * B * N, HH, WW, 2)], dim=-1)
        si = torch.cat([q_feat, rel.expand(n * B, HH, WW, 2)], dim=-1)
        q_flow_o = self.flow_imnet(sti.reshape(n * B * N, HH * WW, -1)
                                   ).reshape(n * B * N, HH, WW, 3)
        q_feat_o = self.imnet(si.reshape(n * B, HH * WW, -1)
                              ).reshape(n * B, HH, WW, 64)
        # the single-shift LIIF area weight is area / area == 1 exactly, so
        # the weighted sum of the JAX package is the identity here

        # ---- HR flow / z / features and the splat ----
        feat_hr = torch.cat([q_feat_o.repeat_interleave(N, 0),
                             q_flow_o[..., :2],
                             q_feat.repeat_interleave(N, 0)], dim=-1)
        flow_hr = q_flow_o[..., :2] * 20.0 * (HH / H)
        z = torch.relu(q_flow_o[..., 2:3]) * self.alpha
        # z = relu(.) * alpha <= 0 whenever alpha <= 0: the max splat is then
        # identically 1 and is skipped (one host read of alpha per forward)
        z_nonpos = bool(self.alpha.detach()[0].item() <= 0.0)
        output, warped_z, z_max, count = softsplat.splat_fused(
            feat_hr, flow_hr, z, z_nonpositive=z_nonpos)

        # ---- merge the two directions + extras ----
        Cf = output.shape[-1]
        output = output.reshape(n, B * N, HH, WW, Cf).sum(0)
        warped_z = warped_z.reshape(n, B * N, HH, WW, 1).sum(0)
        warped_z = torch.where(warped_z == 0.0, torch.ones_like(warped_z),
                               warped_z)
        output = output / warped_z
        z_max = z_max.reshape(n, B * N, HH, WW, 1).amax(0)
        count = count.reshape(n, B * N, HH, WW, 1).sum(0)
        count_safe = torch.where(count == 0.0, torch.ones_like(count), count)
        warped_z_masked = torch.where(warped_z == 1.0,
                                      torch.zeros_like(warped_z), warped_z)
        extra = torch.cat([z_max, count / 16.0, warped_z_masked / count_safe],
                          dim=-1)

        # ---- synthesis ----
        tmap = target_t.reshape(B * N, 1, 1, 1) * x.new_ones((1, HH, WW, 1))
        synth_in = torch.cat([output, extra, q_residual, tmap], dim=-1)
        out = self.synth_net(synth_in.reshape(B * N, HH * WW, -1))
        frames_out = torch.clamp(out.reshape(B, N, HH, WW, 3), 0.0, 1.0
                                 ).permute(1, 0, 2, 3, 4)
        flow_norm = flow_hr / 20.0 / (HH / H)
        flow_gt_norm = flow_gt / 20.0 / (HH / H)
        return frames_out, flow_norm, flow_gt_norm


def build_motif(channel: int = 64, front_rbs: int = 5, back_rbs: int = 40,
                device=None, seed: int = 0) -> MoTIF:
    """A float32 MoTIF with random weights from `seed`, in eval mode, on
    `device` (CUDA unless the caller passes another device; raises without
    CUDA).
    On CUDA the conv weights take the channels_last memory format."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = MoTIF(channel, front_rbs, back_rbs)
    model = model.to(dev).eval()
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model
