"""MoTIF continuous space-time video super-resolution — the counterpart of
motif_tpu/models/motif.py::MoTIF at groups=1, for both anchor families:
n_anchors=2 (the reference `Ours`: the two center frames anchor the
flows) and n_anchors=4 (`Ours_44` / `Ours_4`: all four input frames
anchor them, at positions 0, 2, 4, 6 of 6, and the residual is the
encoder output at round(t·6) per target time), at every `setting` of the
reference (1-6: the properties `input_Z`, `predict_Z`, `decoder_Z`,
`warp_to_many`), and the linear-motion fork `Ours_7` (`linear_motion`).
With no knob given it runs the reference float-op order in the input's
dtype; the serving knobs of the JAX package (`fused_decode`,
`compute_dtype`, `splat_dtype`, `raft_resolution`, `decode_chunks`) are
taken under its names. `splat_method` has no counterpart (one splat
kernel), nor has `fused_siren` (every SIREN runs through `siren_mlp`).

Pipeline: RAFT-small on the n(n-1) cross pairs of the anchor frames at HR
(or the precomputed LR flows of `flows=`) → reliability metrics psi_photo
/ psi_flow / psi_var → ZSM encoder → flow-context convs → separable LIIF
nearest takes → STINF / SINF SIRENs → softmax splat (CUDA kernel
`splat_fused`) → synthesis SIREN → clip.

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


def _chunked_tokens(net, toks: torch.Tensor, chunks: int) -> torch.Tensor:
    """A per-token network over the token axis of toks (M, T, C) in
    `chunks` pieces: exact (the SIRENs are pointwise over tokens); it only
    bounds the live activations."""
    T = toks.shape[1]
    if chunks <= 1 or T <= chunks:
        return net(toks)
    c = -(-T // chunks)
    return torch.cat([net(toks[:, i:i + c]) for i in range(0, T, c)], dim=1)


def _gauss_blur_reflect(x: torch.Tensor) -> torch.Tensor:
    """3x3 [1,2,1]⊗[1,2,1]/16 blur with reflect padding; x (B, H, W, C)."""
    k0, k1 = 0.25, 0.5
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                                 mode="reflect").permute(0, 2, 3, 1)
    xh = xp[:, :, :-2] * k0 + xp[:, :, 1:-1] * k1 + xp[:, :, 2:] * k0
    return xh[:, :-2] * k0 + xh[:, 1:-1] * k1 + xh[:, 2:] * k0


# anchor time positions per family (Ours.py [0, 8] / 8; Ours_44.py
# [0, 2, 4, 6] / 6): the last one divides the rsd rows
POSITIONS = {2: (0.0, 8.0), 4: (0.0, 2.0, 4.0, 6.0)}


class MoTIF(nn.Module):
    """The MoTIF model with `n_anchors` 2 or 4 at `setting` 1-6, or the
    linear-motion fork. Parameter names are the reference torch names, so
    `load_state_dict(strict=True)` takes the bridged JAX parameters
    (checkpoint.py); both families have the same parameters (RAFT too,
    though a four-anchor model trained on precomputed flows never runs
    it). The parameters are float32 (or what `.double()` makes them)
    whatever the knobs: one checkpoint loads in every mode. `positions`
    are the anchors' times (POSITIONS).

    The setting (Ours.py:455-459) switches four properties, each on from
    a setting up: `input_Z` (3) feeds the reliability maps to the
    flow-context convs (7 channels per target, else 4: the first conv's
    fan-in); `predict_Z` (4) takes the splat's importance z from the STINF
    output (else z = 0, and the max splat is skipped); `decoder_Z` (5)
    gives the synthesis net the splatted max as a third extra channel;
    `warp_to_many` (6) keeps the n directions apart (each normalised by
    its own weights) and concatenates them, with their extras, into the
    synthesis input. The synthesis net's fan-in follows: 66 + ch + (3 or
    2) + ch + 1, or n · (66 + ch + (3 or 2)) + ch + 1 under warp_to_many.

    `linear_motion` (Ours_7.py:480-704, `define_g` builds it at setting 3):
    the anchors are the first two input frames, the motion to a time t is
    the LR flows f01 · t and f10 · (1 - t) brought to HR (no STINF, no
    reliability maps, no flow-context convs, whose parameters it keeps),
    and the SINF features splat along it with the raw LR features. Of the
    knobs it takes `splat_dtype` and `decode_chunks`, as the JAX fork
    does, and no other.

    Each SIREN runs whole through `siren_mlp`: the JAX package's
    fused_siren=True. The knobs, all off by default (the parity path):

    fused_decode: each SIREN's first linear layer is folded through the
      LIIF nearest takes (and the synthesis net's through the splat, whose
      payload shrinks from 130 to 64 channels), so the wide HR inputs
      never exist; the SIRENs then start from their pre-activation. Exact
      math in another float-op order.
    compute_dtype: "bfloat16" runs RAFT's convs, the encoder, the
      flow-context convs, the LIIF takes and the SIRENs in bfloat16; the
      flow, RAFT's coordinates and norm statistics, the reliability
      metrics, the splat and the frames stay in the input's dtype.
    splat_dtype: "float16" keeps the splat's sums in float16.
    raft_resolution: RAFT runs on the HR grid times this factor (a multiple
      of 8, at least 64), the flow rescaled per component.
    decode_chunks: the SIRENs decode the HR tokens in this many pieces.
    Every knob trains, as the JAX package's autodiff does: under autograd
    the bfloat16 casts of the float32 parameters carry their gradients
    (`cast_param`), and each kernel entry's backward is its plain version
    in the entry's working type.
    """

    def __init__(self, channel: int = 64, front_rbs: int = 5,
                 back_rbs: int = 40, fused_decode: bool = False,
                 compute_dtype: str | None = None,
                 splat_dtype: str | None = None,
                 raft_resolution: float = 1.0, decode_chunks: int = 1,
                 n_anchors: int = 2, setting: int = 5,
                 linear_motion: bool = False):
        super().__init__()
        if n_anchors not in POSITIONS:
            raise ValueError(f"MoTIF: n_anchors={n_anchors}: 2 (Ours) or 4 "
                             "(Ours_44 / Ours_4)")
        if not 1 <= setting <= 6:
            raise ValueError(f"MoTIF: setting={setting}: 1 to 6")
        if linear_motion and (n_anchors != 2 or setting >= 6):
            raise ValueError("MoTIF: linear_motion is the two-anchor Ours_7, "
                             "which merges its directions (setting <= 5)")
        self.n_anchors, self.positions = n_anchors, POSITIONS[n_anchors]
        self.setting, self.linear_motion = setting, linear_motion
        ch = self.channel = channel
        n = self.n_anchors
        k_e = 3 if self.decoder_Z else 2           # the extras' channels
        synth_in = 66 + ch + k_e
        synth_in = (n * synth_in if self.warp_to_many else synth_in) + ch + 1
        self.flow_predictor = RAFT()
        self.encoder = ZSMEncoder(ch, front_rbs, back_rbs)
        self.flow_process = nn.Sequential(
            Conv2d(n * (7 if self.input_Z else 4), ch, 3, 1, 1, groups=n),
            Conv2d(ch, ch, 3, 1, 1, groups=2),
            LReLU(),
            *[LateralBlock(ch) for _ in range(5)],
            LReLU(),
            Conv2d(ch, ch, 3, 1, 1, padding_mode="reflect"))
        # checkpointed; alpha scales z, the norms and shuffle are unused by
        # this forward (reference Ours.py)
        self.alpha = nn.Parameter(torch.full((1,), -20.0))
        self.norm_gamma = nn.Parameter(torch.ones(1, 3, 1))
        self.norm_beta = nn.Parameter(torch.zeros(1, 3, 1))
        self.shuffle = Conv2d(ch, ch, 1, 1, 0)
        # the fork's STINF is checkpointed but unused, at 67 inputs (the
        # reference's 64 + 3) whatever the width, as the JAX package
        # builds it (motif.py:779-780)
        self.flow_imnet = Siren(67 if linear_motion else ch + 3,
                                [64, 64, 256], 2, 3)
        self.imnet = Siren(ch + 2, [64, 64, 256], 2, 64)
        self.synth_net = Siren(synth_in, [64, 64, 64, 256], 3, 3)
        self._tables: dict = {}
        self._alpha_sign = None
        self.configure(fused_decode=fused_decode, compute_dtype=compute_dtype,
                       splat_dtype=splat_dtype,
                       raft_resolution=raft_resolution,
                       decode_chunks=decode_chunks)

    @property
    def warp_to_many(self) -> bool:
        return self.setting >= 6

    @property
    def decoder_Z(self) -> bool:
        return self.setting >= 5

    @property
    def predict_Z(self) -> bool:
        return self.setting >= 4

    @property
    def input_Z(self) -> bool:
        return self.setting >= 3

    @property
    def use_fused(self) -> bool:
        """Whether the forward folds the SIRENs' first layers: the
        fused_decode knob, which warp_to_many turns off (the fold of the
        synthesis net through the splat assumes the merged directions;
        motif.py:423-425) and the linear-motion fork does not run."""
        return self.fused_decode and not self.warp_to_many \
            and not self.linear_motion

    def configure(self, fused_decode: bool = False,
                  compute_dtype: str | None = None,
                  splat_dtype: str | None = None,
                  raft_resolution: float = 1.0, decode_chunks: int = 1):
        """Set every serving knob (one not named goes back to its default);
        the parameters are untouched. Returns self. The linear-motion fork
        raises for a knob it does not run."""
        if self.linear_motion and (fused_decode or compute_dtype
                                   or raft_resolution != 1.0):
            raise ValueError(
                "MoTIF(linear_motion): the Ours_7 fork runs none of "
                "fused_decode, compute_dtype and raft_resolution; it takes "
                "splat_dtype and decode_chunks")
        self.fused_decode = bool(fused_decode)
        self.compute_dtype = _dtype("compute_dtype", compute_dtype,
                                    ("bfloat16",))
        self.splat_dtype = _dtype("splat_dtype", splat_dtype, ("float16",))
        self.raft_resolution = float(raft_resolution)
        self.decode_chunks = int(decode_chunks)
        for net in (self.flow_imnet, self.imnet, self.synth_net):
            net.skip_first_linear = self.use_fused
        return self

    def knobs(self) -> dict:
        """The serving knobs' current values, as `configure` takes them."""
        def name(dtype):
            return None if dtype is None else str(dtype).removeprefix("torch.")
        return dict(fused_decode=self.fused_decode,
                    compute_dtype=name(self.compute_dtype),
                    splat_dtype=name(self.splat_dtype),
                    raft_resolution=self.raft_resolution,
                    decode_chunks=self.decode_chunks)

    def _z_nonpositive(self) -> bool:
        """Whether z <= 0 everywhere, so that the max splat is skipped:
        always when predict_Z is off (z = 0), else when alpha <= 0."""
        return not self.predict_Z or self._alpha_nonpositive()

    def _alpha_nonpositive(self) -> bool:
        """alpha <= 0, read from the device once per loaded state: the
        stamp changes when alpha is written in place (a load, a fill) or
        replaced (a move)."""
        a = self.alpha
        stamp = (a._version, a.data_ptr(), a.device)
        if self._alpha_sign is None or self._alpha_sign[0] != stamp:
            self._alpha_sign = (stamp, bool(a.detach()[0].item() <= 0.0))
        return self._alpha_sign[1]

    @torch.inference_mode(False)
    def _shape_tables(self, H, W, HH, WW, RH, RW, dtype, cdt, device):
        """What depends only on the shapes, built once per (shapes, dtypes,
        device) and kept on the device: the LIIF nearest indices and the
        relative coordinates (in the compute dtype), the anchor-position
        rows of the flow-context input and the flow rescale of a reduced
        RAFT grid. Kept for the model's life (a server sees few shapes): a
        forward captured into a CUDA graph reads them where they lie. Made
        outside inference mode: tables first made by an eval serve a
        training step too (autograd saves them)."""
        key = (H, W, HH, WW, RH, RW, dtype, cdt, device)
        hit = self._tables.get(key)
        if hit is None:
            n = self.n_anchors
            iy, rel_y = liif_nearest_axis(H, HH, 1e-6)
            ix, rel_x = liif_nearest_axis(W, WW, 1e-6)
            ry, rx = np.meshgrid(rel_y, rel_x, indexing="ij")
            rel = torch.as_tensor(np.stack([ry, rx], -1)[None],
                                  device=device).to(dtype)   # (1, HH, WW, 2)
            rsd = np.array([[self.positions[i], self.positions[j]]
                            for i in range(n) for j in range(n)], np.float32)
            r22 = torch.as_tensor(
                rsd.reshape(n, 1, n, 1, 1, 2) / self.positions[-1],
                device=device).to(dtype)
            hit = dict(
                iy=torch.as_tensor(iy, device=device),
                ix=torch.as_tensor(ix, device=device),
                rel=rel if cdt is None else rel.to(cdt), r22=r22,
                flow_scale=torch.tensor([W / RW, H / RH], dtype=dtype,
                                        device=device))
            self._tables[key] = hit
        return hit

    def _motion(self, frames, tab, lr_hw, raft_hw, out_hw, iters, cd, cf,
                lr_flow=None):
        """RAFT on the cross pairs only (the self-pair flows are exact
        zeros) at `raft_hw`, the flows brought to LR, or the precomputed
        `lr_flow` (B, n², H, W, 2) without RAFT; then the reliability
        metrics psi_photo / psi_flow / psi_var: (flow (n²B, H, W, 2),
        psies (n²B, H, W, 3))."""
        n = self.n_anchors
        n2 = n * n
        B = frames[0].shape[0]
        (H, W), (RH, RW), (HH, WW) = lr_hw, raft_hw, out_hw
        if lr_flow is not None:
            flow = lr_flow.transpose(0, 1).reshape(n2 * B, H, W, 2)
        else:
            hr_frames = [interpolate_bilinear(f, (RH, RW)) for f in frames]
            pairs = [(i, j) for i in range(n) for j in range(n) if i != j]
            src = torch.cat([hr_frames[i] for i, _ in pairs], 0)
            dst = torch.cat([hr_frames[j] for _, j in pairs], 0)
            fl = cf(self.flow_predictor(cd(src * 255.0), cd(dst * 255.0),
                                        iters=iters))
            if (RH, RW) == (HH, WW):
                fl = interpolate_bilinear(fl, (H, W)) * (H / HH)
            else:
                fl = interpolate_bilinear(fl, (H, W)) * tab["flow_scale"]
            fl = fl.reshape(len(pairs), B, H, W, 2)
            flow = fl.new_zeros((n2, B, H, W, 2))
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
        return flow, torch.stack([psi_photo, psi_flow / 10.0, psi_var],
                                 dim=-1)

    def _teacher(self, target_frames, N, out_hw, iters, cd, cf):
        """The live RAFT teacher of training: the GT frames resized to 128²,
        RAFT from the GT frame at each anchor position to each target GT
        frame, resized to (HH, WW) and scaled by HH / 128. Returns
        (nBN, HH, WW, 2), anchor-major."""
        if target_frames is None:
            raise ValueError("MoTIF: train=True needs target_frames")
        n = self.n_anchors
        HH, WW = out_hw
        B, T = target_frames.shape[:2]
        small = interpolate_bilinear(
            target_frames.reshape(B * T, HH, WW, 3), (128, 128)
        ).reshape(B, T, 128, 128, 3)
        aidx = [int(round(p / self.positions[-1] * (T - 1)))
                for p in self.positions]
        anchors = torch.cat([
            small[:, k][:, None].expand(B, N, 128, 128, 3).reshape(
                B * N, 128, 128, 3) for k in aidx], 0)
        targets = small[:, 1:-1].reshape(B * N, 128, 128, 3).repeat(
            n, 1, 1, 1)
        flow_gt = cf(self.flow_predictor(cd(anchors * 255.0),
                                         cd(targets * 255.0), iters=iters))
        return interpolate_bilinear(flow_gt, (HH, WW)) * (HH / 128.0)

    def forward(self, x: torch.Tensor, target_t: torch.Tensor, out_hw,
                use_gt: bool = False, iters: int = 12,
                target_frames: torch.Tensor | None = None,
                train: bool = False, flows=None):
        """x (B, N_in, H, W, 3) LR frames in [0, 1] (N_in = 4 for four
        anchors); target_t (B, N) times in [0, 1]; out_hw (HH, WW). Returns
        (frames (N, B, HH, WW, 3), flow (nBN, HH, WW, 2) / 20 / (HH/H), the
        teacher flow likewise), in x's dtype. The teacher flow is
        `flows[1]` when given, else with `train` RAFT's from each anchor GT
        frame to each target GT frame of `target_frames` (B, N+2, HH, WW,
        3) at 128², else zeros; `use_gt` splats with it in place of the
        predicted flow (teacher forcing). `flows` = (lr_flow (B, n², H, W,
        2) in i·n+j order, flow_gt (B, N, n, HH, WW, 2)), either None: the
        dataset's precomputed flows, which replace RAFT's (RAFT does not run
        when both are given, or lr_flow is and `train` is off) and take no
        gradient."""
        B, N_in, H, W, _ = x.shape
        HH, WW = out_hw
        N = target_t.shape[1]
        ch = self.channel
        n = self.n_anchors
        if self.linear_motion:    # the first two (Ours_7.py:481-492)
            return self._linear_forward(x[:, 0], x[:, 1], target_t, out_hw,
                                        use_gt, iters, target_frames, train)
        if n == 2:
            c = N_in // 2
            frames = [x[:, c - 1], x[:, c]]
        elif N_in == 4:
            frames = [x[:, i] for i in range(4)]
        else:
            raise ValueError(f"MoTIF: four anchors take 4 input frames, not "
                             f"{N_in}")
        lr_flow, flow_gt = flows if flows is not None else (None, None)
        # cd casts into the compute dtype, cf back to the input's; both
        # are the identity without a compute dtype
        cdt = self.compute_dtype
        cd = (lambda a: a.to(cdt)) if cdt is not None else (lambda a: a)
        cf = (lambda a: a.to(x.dtype)) if cdt is not None else (lambda a: a)

        if self.raft_resolution != 1.0:
            RH = max(64, int(round(HH * self.raft_resolution / 8.0)) * 8)
            RW = max(64, int(round(WW * self.raft_resolution / 8.0)) * 8)
        else:
            RH, RW = HH, WW
        tab = self._shape_tables(H, W, HH, WW, RH, RW, x.dtype, cdt, x.device)
        # motion, reliability and teacher take no gradient (the JAX
        # package's stop_gradients)
        with torch.no_grad():
            flow, psies = self._motion(frames, tab, (H, W), (RH, RW), (HH, WW),
                                       iters, cd, cf, lr_flow)
            if flow_gt is not None:       # (B, N, n, HH, WW, 2), anchor-major
                flow_gt = flow_gt.permute(2, 0, 1, 3, 4, 5).reshape(
                    n * B * N, HH, WW, 2)
            elif train:
                flow_gt = self._teacher(target_frames, N, (HH, WW), iters,
                                        cd, cf)
            else:
                flow_gt = x.new_zeros((n * B * N, HH, WW, 2))

        # ---- encoder: 2n - 1 fused frames ----
        feat_t = self.encoder(cd(torch.stack(frames, 1)))  # (B, 2n-1, H, W, ch)
        if n == 2:       # the middle fused frame for every time
            residual = feat_t[:, feat_t.shape[1] // 2][:, None].expand(
                B, N, H, W, ch)
        else:            # the fused frame at round(t·6) per time (Ours_44.py)
            idx = torch.round(target_t * 6.0).long().clamp(
                0, feat_t.shape[1] - 1)
            residual = feat_t[torch.arange(B, device=x.device)[:, None], idx]
        residual_bn = residual.reshape(B * N, H, W, ch)
        feat = torch.cat([feat_t[:, 2 * i] for i in range(n)], 0)  # (nB,H,W,ch)

        # ---- flow-context encoder: per source frame i, the targets j of
        # [flow_ij / 20 | psi_ij (input_Z) | rsd row] into a grouped conv --
        f22 = (flow / 20.0).reshape(n, n, B, H, W, 2).permute(0, 2, 1, 3, 4, 5)
        p22 = psies.reshape(n, n, B, H, W, 3).permute(0, 2, 1, 3, 4, 5)
        r22 = tab["r22"].expand(n, B, n, H, W, 2)
        ff = torch.cat([f22, p22, r22] if self.input_Z else [f22, r22],
                       dim=-1)                               # (n,B,n,H,W,7|4)
        k = ff.shape[-1]
        ff = ff.reshape(n * B, n, H, W, k).permute(0, 2, 3, 1, 4)
        flow_feat = self.flow_process(cd(ff.reshape(n * B, H, W, n * k)))

        # ---- LIIF query as separable nearest takes (one shift, weight 1) --
        iy_t, ix_t, rel = tab["iy"], tab["ix"], tab["rel"]   # rel (1,HH,WW,2)

        def up(img):
            return img.index_select(1, iy_t).index_select(2, ix_t)

        def rep_n(a):                    # (nB, HH, WW, c) -> (nBN, HH, WW, c)
            return a.repeat_interleave(N, 0)

        t_tok = cd(target_t.reshape(B * N, 1, 1, 1).repeat(n, 1, 1, 1))
        chunks = self.decode_chunks
        fused = self.use_fused
        if fused:
            # Each SIREN's first layer folded through the takes: a channel
            # product commutes with a spatial take, so the feature products
            # run at LR and sti / si never exist. net.0's rows follow the
            # original concats [flow_feat | t | rel] and [feat | rel]; the
            # terms are added in the JAX package's order.
            wq, bq = self.flow_imnet.first_linear(rel.dtype)
            wq = wq.t()                                      # (ch + 3, 64)
            h0 = rep_n(up(torch.matmul(flow_feat, wq[:ch])))
            h0 = h0 + t_tok * wq[ch] + torch.matmul(rel, wq[ch + 1:]) + bq
            q_flow_o = _chunked_tokens(
                self.flow_imnet, h0.reshape(n * B * N, HH * WW, -1), chunks
            ).reshape(n * B * N, HH, WW, 3)
            wi, bi = self.imnet.first_linear(rel.dtype)
            wi = wi.t()                                      # (ch + 2, 64)
            g0 = up(torch.matmul(feat, wi[:ch]))
            g0 = g0 + torch.matmul(rel, wi[ch:]) + bi
            q_feat_o = _chunked_tokens(
                self.imnet, g0.reshape(n * B, HH * WW, -1), chunks
            ).reshape(n * B, HH, WW, 64)
        else:
            q_feat = up(feat)                                # (nB,HH,WW,ch)
            q_flow_feat = up(flow_feat)
            q_residual = up(residual_bn)                     # (BN,HH,WW,ch)
            sti = torch.cat([rep_n(q_flow_feat),
                             t_tok.expand(n * B * N, HH, WW, 1),
                             rel.expand(n * B * N, HH, WW, 2)], dim=-1)
            si = torch.cat([q_feat, rel.expand(n * B, HH, WW, 2)], dim=-1)
            q_flow_o = _chunked_tokens(
                self.flow_imnet, sti.reshape(n * B * N, HH * WW, -1), chunks
            ).reshape(n * B * N, HH, WW, 3)
            q_feat_o = _chunked_tokens(
                self.imnet, si.reshape(n * B, HH * WW, -1), chunks
            ).reshape(n * B, HH, WW, 64)
            # the single-shift LIIF area weight is area / area == 1 exactly,
            # so the weighted sum of the JAX package is the identity here

        # ---- HR flow / z / features and the splat, in the input's dtype;
        # the payload's flow channels take no gradient (as in the JAX
        # package) ----
        flow_raw = cf(q_flow_o)
        if fused:
            # The synthesis net's first layer folded through the splat,
            # which is linear in its payload: [q_feat_o | flow | q_feat]
            # goes through net.0's matching rows before it is scattered
            # (130 -> 64 channels); the rows of the extras, the residual
            # and the time are added after the merge. The flow's two rows
            # stay in the input's dtype.
            ws_raw, _ = self.synth_net.first_linear(x.dtype)
            ws, bs = self.synth_net.first_linear(rel.dtype)
            ws_raw, ws = ws_raw.t(), ws.t()                  # (198, 64)
            k_e = 3 if self.decoder_Z else 2
            w_a, w_b = ws[:64], ws[66:66 + ch]
            off = 66 + ch
            w_e = ws[off:off + k_e]
            w_r = ws[off + k_e:off + k_e + ch]
            w_t = ws[off + k_e + ch]
            pay = rep_n(torch.matmul(q_feat_o, w_a)
                        + up(torch.matmul(feat, w_b)))
            feat_hr = cf(pay) + torch.matmul(flow_raw[..., :2].detach(),
                                             ws_raw[64:66])  # (nBN,HH,WW,64)
        else:
            feat_hr = torch.cat([rep_n(cf(q_feat_o)),
                                 flow_raw[..., :2].detach(),
                                 rep_n(cf(q_feat))], dim=-1)
        flow_hr = flow_raw[..., :2] * 20.0 * (HH / H)
        z = torch.relu(flow_raw[..., 2:3]) * self.alpha
        if not self.predict_Z:
            z = torch.zeros_like(z)
        output, extra = self._splat_merge(feat_hr, flow_gt if use_gt
                                          else flow_hr, z, n, B * N)

        # ---- synthesis ----
        if fused:
            # net.0's pre-activation: the merged splat output (already
            # through w_a, the flow rows and w_b) + the extras', the
            # residual's and the time's rows + the bias
            h = (cd(output).reshape(B * N, HH, WW, 64)
                 + torch.matmul(cd(extra).reshape(B * N, HH, WW, -1), w_e)
                 + up(torch.matmul(cd(residual_bn), w_r))
                 + cd(target_t).reshape(B * N, 1, 1, 1) * w_t[None, None, None]
                 + bs)
            out = _chunked_tokens(self.synth_net,
                                  h.reshape(B * N, HH * WW, -1), chunks)
        else:
            tmap = cd(target_t.reshape(B * N, 1, 1, 1)
                      * x.new_ones((1, HH, WW, 1)))
            synth_in = torch.cat([cd(output), cd(extra), q_residual, tmap],
                                 dim=-1)
            out = _chunked_tokens(self.synth_net,
                                  synth_in.reshape(B * N, HH * WW, -1), chunks)
        frames_out = torch.clamp(cf(out).reshape(B, N, HH, WW, 3), 0.0, 1.0
                                 ).permute(1, 0, 2, 3, 4)
        flow_norm = flow_hr / 20.0 / (HH / H)
        flow_gt_norm = flow_gt / 20.0 / (HH / H)
        return frames_out, flow_norm, flow_gt_norm

    def _splat_merge(self, feat_hr, splat_flow, z, n, BN):
        """The splat of the payload along `splat_flow` with importance z,
        then the n directions merged (summed, normalised by their summed
        weights, the max and count merged), or under warp_to_many each
        normalised alone and laid side by side; and the extras: [z_max |]
        count / 16 | the masked weights / the safe count. Returns (output,
        extra), BN = B·N rows each."""
        HH, WW = feat_hr.shape[1:3]
        output, warped_z, z_max, count = softsplat.splat_fused(
            feat_hr, splat_flow, z, z_nonpositive=self._z_nonpositive(),
            scatter_dtype=self.splat_dtype)
        Cf = output.shape[-1]
        if not self.warp_to_many:
            output = output.reshape(n, BN, HH, WW, Cf).sum(0)
            warped_z = warped_z.reshape(n, BN, HH, WW, 1).sum(0)
        warped_z = torch.where(warped_z == 0.0, torch.ones_like(warped_z),
                               warped_z)
        output = output / warped_z
        if not self.warp_to_many:
            z_max = z_max.reshape(n, BN, HH, WW, 1).amax(0)
            count = count.reshape(n, BN, HH, WW, 1).sum(0)
        count_safe = torch.where(count == 0.0, torch.ones_like(count), count)
        warped_z_masked = torch.where(warped_z == 1.0,
                                      torch.zeros_like(warped_z), warped_z)
        extra = [count / 16.0, warped_z_masked / count_safe]
        extra = torch.cat([z_max] + extra if self.decoder_Z else extra, -1)
        if self.warp_to_many:
            # the JAX package's NHWC form of the reference's NCHW concat
            # (motif.py:686-691): the (n, HH, WW, c) block of each row read
            # as (HH, WW, n·c) in memory order
            def side_by_side(a):
                return a.reshape(n, BN, HH, WW, -1).transpose(0, 1).reshape(
                    BN, HH, WW, -1)
            output, extra = side_by_side(output), side_by_side(extra)
        return output, extra

    def _linear_forward(self, x0, x1, target_t, out_hw, use_gt, iters,
                        target_frames, train):
        """The Ours_7 fork (Ours_7.py:480-704) on anchors x0, x1 (B, H, W,
        3): RAFT's f01 / f10 at HR brought to LR, scaled by t and 1 - t
        per target time and brought back to HR as the motion; the encoder
        on the two anchors; SINF on the LIIF takes of their features; the
        splat of [SINF | motion | features] along the motion (or the
        teacher's) with z = 0 (its predict_Z is off); the synthesis net.
        In the input's dtype (the fork has no compute dtype). The flows it
        returns are the motion / 20 / (HH / H) and the teacher's likewise
        (the fork's quirk: the motion was never multiplied by 20)."""
        B, H, W, _ = x0.shape
        HH, WW = out_hw
        N = target_t.shape[1]
        ch = self.channel
        tab = self._shape_tables(H, W, HH, WW, HH, WW, x0.dtype, None,
                                 x0.device)
        with torch.no_grad():
            hr0 = interpolate_bilinear(x0, (HH, WW))
            hr1 = interpolate_bilinear(x1, (HH, WW))
            f = self.flow_predictor(torch.cat([hr0, hr1], 0) * 255.0,
                                    torch.cat([hr1, hr0], 0) * 255.0,
                                    iters=iters)
            f = interpolate_bilinear(f, (H, W)) * (H / HH)
            t = target_t.reshape(1, B, N, 1, 1, 1)
            lin = torch.cat([f[None, :B, None] * t,
                             f[None, B:, None] * (1.0 - t)], 0)
            flow = interpolate_bilinear(lin.reshape(2 * B * N, H, W, 2),
                                        (HH, WW)) * (HH / H)
            if train:
                flow_gt = self._teacher(target_frames, N, (HH, WW), iters,
                                        _identity, _identity)
            else:
                flow_gt = x0.new_zeros((2 * B * N, HH, WW, 2))

        feat_t = self.encoder(torch.stack([x0, x1], 1))     # (B, 3, H, W, ch)
        residual_bn = feat_t[:, 1]
        feat = torch.cat([feat_t[:, 0], feat_t[:, 2]], 0)   # (2B, H, W, ch)
        iy_t, ix_t, rel = tab["iy"], tab["ix"], tab["rel"]

        def up(img):
            return img.index_select(1, iy_t).index_select(2, ix_t)
        q_feat = up(feat)
        si = torch.cat([q_feat, rel.expand(2 * B, HH, WW, 2)], dim=-1)
        si_out = _chunked_tokens(self.imnet, si.reshape(2 * B, HH * WW, -1),
                                 self.decode_chunks).reshape(2 * B, HH, WW,
                                                             64)
        feat_hr = torch.cat([si_out.repeat_interleave(N, 0), flow,
                             q_feat.repeat_interleave(N, 0)], dim=-1)
        z = torch.relu(flow[..., -1:]) * self.alpha   # the fork reads z
        if not self.predict_Z:                        # from dy; off at 3
            z = torch.zeros_like(z)
        output, extra = self._splat_merge(feat_hr, flow_gt if use_gt
                                          else flow, z, 2, B * N)
        tmap = target_t.reshape(B * N, 1, 1, 1) * x0.new_ones((1, HH, WW, 1))
        synth_in = torch.cat([output, extra,
                              up(residual_bn).repeat_interleave(N, 0), tmap],
                             dim=-1)
        out = _chunked_tokens(self.synth_net,
                              synth_in.reshape(B * N, HH * WW, -1),
                              self.decode_chunks)
        frames = torch.clamp(out.reshape(B, N, HH, WW, 3), 0.0, 1.0
                             ).permute(1, 0, 2, 3, 4)
        return frames, flow / 20.0 / (HH / H), flow_gt / 20.0 / (HH / H)


def _identity(a):
    return a


def _dtype(knob: str, name, allowed):
    """The torch dtype a knob names (the JAX package takes dtype names), or
    None; raises on a name the port has no entry for."""
    if name is None:
        return None
    if name not in allowed:
        raise ValueError(f"{knob}={name!r}: the port takes None or one of "
                         f"{list(allowed)}")
    return getattr(torch, name)


def build_motif(channel: int = 64, front_rbs: int = 5, back_rbs: int = 40,
                device=None, seed: int = 0, n_anchors: int = 2,
                setting: int = 5, linear_motion: bool = False,
                **knobs) -> MoTIF:
    """A MoTIF with `n_anchors` (2: Ours, 4: Ours_44) at `setting` (or the
    linear-motion Ours_7) and float32 random weights from `seed`, in eval
    mode, on `device` (CUDA unless the caller passes another device;
    raises without CUDA). `knobs` are MoTIF's serving knobs by name
    (`fused_decode`, `compute_dtype`, `splat_dtype`, `raft_resolution`,
    `decode_chunks`); the weights depend on neither (both families draw
    the same weights from a seed; a setting changes the shapes of three
    of them). On CUDA the conv weights take the channels_last memory
    format."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = MoTIF(channel, front_rbs, back_rbs, n_anchors=n_anchors,
                      setting=setting, linear_motion=linear_motion, **knobs)
    model = model.to(dev).eval()
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model
