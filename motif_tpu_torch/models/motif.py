"""MoTIF continuous space-time video super-resolution — the counterpart of
motif_tpu/models/motif.py::MoTIF, for both anchor families:
n_anchors=2 (the reference `Ours`: the two center frames anchor the
flows) and n_anchors=4 (`Ours_44` / `Ours_4`: all four input frames
anchor them, at positions 0, 2, 4, 6 of 6, and the residual is the
encoder output at round(t·6) per target time), at every `setting` of the
reference (1-6: the properties `input_Z`, `predict_Z`, `decoder_Z`,
`warp_to_many`), the linear-motion fork `Ours_7` (`linear_motion`), and
the fields that no reference config turns on, each off by default as in
the JAX package (`groups`, `trans`, `res_liff`, `local_ensemble`,
`siren`).
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
and returns frames (N, B, HH, WW, 3). The forward is two calls: `trunk`
(RAFT, the reliability metrics and the encoder) reads only the frames,
`head` (the rest) reads the times too, so the trunk of one set of frames
serves every chunk of times decoded from them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from motif_tpu_torch import obs, resolve_device
from motif_tpu_torch.models.encoder import ZSMEncoder
from motif_tpu_torch.models.layers import Conv2d, LateralBlock, LReLU
from motif_tpu_torch.models.raft import RAFT
from motif_tpu_torch.models.siren import Siren
from motif_tpu_torch.ops import preact, softsplat
from motif_tpu_torch.ops.resize import interpolate_bilinear
from motif_tpu_torch.ops.warp import backwarp

# the parts of a forward, each `obs.part(<part>)`: the span `motif.<part>`
# and, in a captured graph, its start and end events on the device;
# `MoTIF.trunk` runs the first two, `MoTIF.head` the rest
PARTS = ("motion", "encoder", "decode", "splat", "synth")


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

    The fields (Ours.py:449-453; every reference config keeps them off):

    groups: G > 1 splits the splat into G channel groups: the STINF gives
      (dx, dy, z) per group (3·G wide), each group splats its channel
      slice of the SINF and LR features along its own flow (B·N·G rows,
      the teacher flow repeated per group), and the groups' warped
      channels and extras are laid back side by side for the synthesis
      net (`merge_groups`). Not with fused_decode or warp_to_many (raises
      NotImplementedError, as the JAX package does).
    trans: the flow context of each directed pair [flow / 20 | psi | rsd
      row] through ungrouped convs, and a softmax over the targets j of
      a per-group weight (`weight_generator`) sums each source's pairs.
    res_liff: a fourth SIREN (`res_imnet`) decodes the residual at HR; the
      synthesis net takes it beside the raw residual.
    local_ensemble: the LIIF query at four shifted cells, each decode
      weighted by the area of the diagonally opposite cell.
    siren=False: the synthesis net is a conv stack (3 convs, 5 lateral
      blocks, a reflect-padded conv) in place of the SIREN.
    Each of these (but groups=1, siren=True) turns fused_decode off, as in
    the JAX package.

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
                 linear_motion: bool = False, groups: int = 1,
                 trans: bool = False, res_liff: bool = False,
                 local_ensemble: bool = False, siren: bool = True):
        super().__init__()
        if n_anchors not in POSITIONS:
            raise ValueError(f"MoTIF: n_anchors={n_anchors}: 2 (Ours) or 4 "
                             "(Ours_44 / Ours_4)")
        if not 1 <= setting <= 6:
            raise ValueError(f"MoTIF: setting={setting}: 1 to 6")
        if linear_motion and (n_anchors != 2 or setting >= 6):
            raise ValueError("MoTIF: linear_motion is the two-anchor Ours_7, "
                             "which merges its directions (setting <= 5)")
        fields = (groups != 1 or trans or res_liff or local_ensemble
                  or not siren)
        if linear_motion and fields:
            raise ValueError("MoTIF: the linear-motion Ours_7 takes none of "
                             "groups, trans, res_liff, local_ensemble, "
                             "siren=False")
        if groups < 1 or 64 % groups or channel % groups:
            raise ValueError(f"MoTIF: groups={groups} must divide 64 and the "
                             f"channel {channel}")
        self.n_anchors, self.positions = n_anchors, POSITIONS[n_anchors]
        self.setting, self.linear_motion = setting, linear_motion
        self.groups, self.trans, self.res_liff = groups, trans, res_liff
        self.local_ensemble, self.siren = local_ensemble, siren
        ch = self.channel = channel
        n, G = self.n_anchors, groups
        k_e = 3 if self.decoder_Z else 2           # the extras' channels
        res_w = ch + 64 if res_liff else ch        # the residual's
        synth_in = 64 + 2 * G + ch + G * k_e
        synth_in = (n * synth_in if self.warp_to_many else synth_in) \
            + res_w + 1
        self.flow_predictor = RAFT()
        self.encoder = ZSMEncoder(ch, front_rbs, back_rbs)
        k_in = 7 if self.input_Z else 4        # per target (pair, with trans)
        head = ([Conv2d(k_in, ch // 2, 3, 1, 1), Conv2d(ch // 2, ch, 3, 1, 1)]
                if trans else [Conv2d(n * k_in, ch, 3, 1, 1, groups=n),
                               Conv2d(ch, ch, 3, 1, 1, groups=2)])
        self.flow_process = nn.Sequential(
            *head, LReLU(), *[LateralBlock(ch) for _ in range(5)], LReLU(),
            Conv2d(ch, ch, 3, 1, 1, padding_mode="reflect"))
        if trans:
            self.weight_generator = nn.Sequential(
                LateralBlock(ch), LReLU(),
                Conv2d(ch, G, 3, 1, 1, padding_mode="reflect"))
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
                                [64, 64, 256], 2, 3 * G)
        self.imnet = Siren(ch + 2, [64, 64, 256], 2, 64)
        if res_liff:
            self.res_imnet = Siren(ch + 2, [64, 64, 256], 2, 64)
        if siren:
            self.synth_net = Siren(synth_in, [64, 64, 64, 256], 3, 3)
        else:                  # synth_net.0 ... .10, as the reference's
            self.synth_net = nn.Sequential(
                Conv2d(synth_in, 2 * ch, 3, 1, 1),
                Conv2d(2 * ch, 2 * ch, 3, 1, 1),
                Conv2d(2 * ch, ch, 3, 1, 1),
                LReLU(),
                *[LateralBlock(ch) for _ in range(5)],
                LReLU(),
                Conv2d(ch, 3, 3, 1, 1, padding_mode="reflect"))
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
        motif.py:423-425), as do the fields (groups > 1 raises instead)
        and the linear-motion fork, which does not run it."""
        return (self.fused_decode and not self.warp_to_many
                and not self.linear_motion and self.siren
                and self.groups == 1 and not self.local_ensemble
                and not self.res_liff)

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
            if isinstance(net, Siren):
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

    @torch.inference_mode(False)
    def _shift_tables(self, H, W, HH, WW, dtype, device):
        """The local ensemble's four LIIF queries (shifts (-1, -1), (-1, 1),
        (1, -1), (1, 1) of a cell, eps 1e-6 + v / size): per shift the
        nearest indices and the relative coordinates (1, HH, WW, 2) in
        `dtype`, kept as `_shape_tables` keeps its own."""
        key = ("shifts", H, W, HH, WW, dtype, device)
        hit = self._tables.get(key)
        if hit is None:
            hit = []
            for vy, vx in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
                iy, rel_y = liif_nearest_axis(H, HH, 1e-6 + vy * (1.0 / H))
                ix, rel_x = liif_nearest_axis(W, WW, 1e-6 + vx * (1.0 / W))
                ry, rx = np.meshgrid(rel_y, rel_x, indexing="ij")
                hit.append((torch.as_tensor(iy, device=device),
                            torch.as_tensor(ix, device=device),
                            torch.as_tensor(np.stack([ry, rx], -1)[None],
                                            device=device).to(dtype)))
            self._tables[key] = hit
        return hit

    def _trans_context(self, flow, psies, tab, B, H, W, cd):
        """The `trans` flow context: each directed pair's [flow / 20 | psi
        (input_Z) | rsd row] through `flow_process` (n²B rows), and per
        source frame i the softmax over its targets j of the per-group
        weights of `weight_generator`, summing the pairs' features group
        by group: (nB, H, W, ch).

        The JAX package reshapes the weights to (n², n², B, ...) here
        (motif.py:387-390), which holds n²·n²·B rows where there are n²·B,
        so its `trans` raises at any size; the port reads them as (n, n,
        B, ...), the one shape that gives the (nB, H, W, ch) features the
        rest of the forward takes (ROADMAP.md)."""
        n, G, ch = self.n_anchors, self.groups, self.channel
        n2 = n * n
        rsd = tab["r22"].reshape(n2, 1, 1, 1, 2).expand(n2, B, H, W, 2)
        parts = [flow / 20.0] + ([psies] if self.input_Z else []) \
            + [rsd.reshape(n2 * B, H, W, 2)]
        ffe = self.flow_process(cd(torch.cat(parts, dim=-1)))
        wgt = torch.softmax(self.weight_generator(ffe).reshape(
            n, n, B, H, W, G, 1), dim=1)
        ffg = ffe.reshape(n, n, B, H, W, G, ch // G)
        return (ffg * wgt).sum(1).reshape(n * B, H, W, ch)

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
        gradient. The forward is `head(trunk(x), target_t)`: a caller that
        decodes several sets of times from the same frames runs the trunk
        once."""
        return self.head(self.trunk(x, out_hw, iters, flows), target_t,
                         out_hw, use_gt, target_frames, train, flows)

    def trunk(self, x: torch.Tensor, out_hw, iters: int = 12, flows=None):
        """The part of the forward that reads the frames and never the
        times (the parts "motion" and "encoder"): RAFT on the anchors'
        cross pairs (or `flows[0]`) with the reliability metrics, then the
        ZSM encoder. Returns the state `head` decodes times from, a dict of
        the input `x`, the `iters`, the shape `tab`les and what the trunk
        computed (each tensor a new one): the flow and psies (nothing takes
        their gradient), the encoder's fused frames `feat_t` (B, 2n - 1, H,
        W, ch) and the anchors' features `feat` (nB, H, W, ch). The
        linear-motion fork's holds its LR flows f01 / f10 and features."""
        B, N_in, H, W, _ = x.shape
        HH, WW = out_hw
        n, G = self.n_anchors, self.groups
        if G != 1 and (self.fused_decode or self.warp_to_many):
            raise NotImplementedError(
                "MoTIF groups>1 is only supported with fused_decode=False "
                "and warp_to_many=False (the fused splat-payload fold and "
                "the warp_to_many merge, Ours.py:819-824, assume G=1).")
        if self.linear_motion:    # the first two (Ours_7.py:481-492)
            return self._linear_trunk(x[:, 0], x[:, 1], out_hw, iters)
        if n == 2:
            c = N_in // 2
            frames = [x[:, c - 1], x[:, c]]
        elif N_in == 4:
            frames = [x[:, i] for i in range(4)]
        else:
            raise ValueError(f"MoTIF: four anchors take 4 input frames, not "
                             f"{N_in}")
        lr_flow = flows[0] if flows is not None else None
        cd, cf = self._casts(x)

        if self.raft_resolution != 1.0:
            RH = max(64, int(round(HH * self.raft_resolution / 8.0)) * 8)
            RW = max(64, int(round(WW * self.raft_resolution / 8.0)) * 8)
        else:
            RH, RW = HH, WW
        cdt = self.compute_dtype
        tab = self._shape_tables(H, W, HH, WW, RH, RW, x.dtype, cdt, x.device)
        # motion and reliability take no gradient (the JAX package's
        # stop_gradients)
        with obs.part("motion"), torch.no_grad():
            flow, psies = self._motion(frames, tab, (H, W), (RH, RW), (HH, WW),
                                       iters, cd, cf, lr_flow)

        # ---- encoder: 2n - 1 fused frames ----
        with obs.part("encoder"):
            # (B, 2n-1, H, W, ch)
            feat_t = self.encoder(cd(torch.stack(frames, 1)))
            # (nB, H, W, ch)
            feat = torch.cat([feat_t[:, 2 * i] for i in range(n)], 0)
        return dict(x=x, iters=iters, tab=tab, flow=flow, psies=psies,
                    feat_t=feat_t, feat=feat)

    def _casts(self, x):
        """(cd, cf): cd casts into the compute dtype, cf back to x's; both
        are the identity without a compute dtype."""
        cdt = self.compute_dtype
        if cdt is None:
            return _identity, _identity
        return (lambda a: a.to(cdt)), (lambda a: a.to(x.dtype))

    def head(self, state: dict, target_t: torch.Tensor, out_hw,
             use_gt: bool = False, target_frames: torch.Tensor | None = None,
             train: bool = False, flows=None):
        """The part of the forward that reads the times (the parts
        "decode", "splat" and "synth"), from the `trunk`'s state, which it
        leaves as it is: the teacher flow (`forward` has the arguments), the
        residual (on four anchors the fused frame at round(t·6)), the flow
        context, the LIIF decode, the splat and the synthesis. Returns
        what `forward` returns."""
        if self.linear_motion:
            return self._linear_head(state, target_t, out_hw, use_gt,
                                     target_frames, train)
        x, tab, flow, psies = (state[k] for k in ("x", "tab", "flow",
                                                  "psies"))
        feat_t, feat = state["feat_t"], state["feat"]
        B, _, H, W, _ = x.shape
        HH, WW = out_hw
        N = target_t.shape[1]
        ch = self.channel
        n, G = self.n_anchors, self.groups
        cd, cf = self._casts(x)
        flow_gt = flows[1] if flows is not None else None
        if flow_gt is not None or train:     # the teacher takes no gradient
            with obs.span("motif.motion"), torch.no_grad():
                if flow_gt is not None:  # (B, N, n, HH, WW, 2), anchor-major
                    flow_gt = flow_gt.permute(2, 0, 1, 3, 4, 5).reshape(
                        n * B * N, HH, WW, 2)
                else:
                    flow_gt = self._teacher(target_frames, N, (HH, WW),
                                            state["iters"], cd, cf)

        with obs.part("decode"):
            if flow_gt is None:
                flow_gt = x.new_zeros((n * B * N, HH, WW, 2))
            if n == 2:       # the middle fused frame for every time
                residual = feat_t[:, feat_t.shape[1] // 2][:, None].expand(
                    B, N, H, W, ch)
            else:    # the fused frame at round(t·6) per time (Ours_44.py)
                idx = torch.round(target_t * 6.0).long().clamp(
                    0, feat_t.shape[1] - 1)
                residual = feat_t[torch.arange(B, device=x.device)[:, None],
                                  idx]
            residual_bn = residual.reshape(B * N, H, W, ch)

            # ---- flow-context encoder: per source frame i, the targets j of
            # [flow_ij / 20 | psi_ij (input_Z) | rsd row] into a grouped conv
            # (or, with trans, each pair alone and a softmax over j) --
            if self.trans:
                flow_feat = self._trans_context(flow, psies, tab, B, H, W, cd)
            else:
                f22 = (flow / 20.0).reshape(n, n, B, H, W, 2).permute(
                    0, 2, 1, 3, 4, 5)
                p22 = psies.reshape(n, n, B, H, W, 3).permute(0, 2, 1, 3, 4, 5)
                r22 = tab["r22"].expand(n, B, n, H, W, 2)
                ff = torch.cat([f22, p22, r22] if self.input_Z else [f22, r22],
                               dim=-1)                   # (n,B,n,H,W,7|4)
                k = ff.shape[-1]
                ff = ff.reshape(n * B, n, H, W, k).permute(0, 2, 3, 1, 4)
                flow_feat = self.flow_process(
                    cd(ff.reshape(n * B, H, W, n * k)))

            # ---- LIIF query as separable nearest takes (one shift, weight 1;
            # or the local ensemble's four) --
            # rel (1, HH, WW, 2)
            iy_t, ix_t, rel = tab["iy"], tab["ix"], tab["rel"]

            def up(img, iy_t=iy_t, ix_t=ix_t):
                return preact.take(img, iy_t, ix_t)

            def rep_n(a):            # (nB, HH, WW, c) -> (nBN, HH, WW, c)
                return a.repeat_interleave(N, 0)

            t_tok = cd(target_t.reshape(B * N, 1, 1, 1).repeat(n, 1, 1, 1))
            chunks = self.decode_chunks
            fused = self.use_fused
            if fused:
                # Each SIREN's first layer folded through the takes: a channel
                # product commutes with a spatial take, so the feature products
                # run at LR and sti / si never exist. net.0's columns follow
                # the original concats [flow_feat | t | rel] and [feat | rel];
                # `preact` adds the terms at HR in the JAX package's order.
                wq, bq = self.flow_imnet.first_linear(rel.dtype)  # (64, ch+3)
                h0 = preact.preact(
                    "stinf", torch.matmul(flow_feat, wq.t()[:ch]), iy_t, ix_t,
                    wq, bias=bq, rep=N, hr=rel, col_hr=ch + 1, t=t_tok,
                    col_t=ch)
                q_flow_o = _chunked_tokens(
                    self.flow_imnet, h0.reshape(n * B * N, HH * WW, -1), chunks
                ).reshape(n * B * N, HH, WW, 3)
                wi, bi = self.imnet.first_linear(rel.dtype)       # (64, ch+2)
                g0 = preact.preact(
                    "sinf", torch.matmul(feat, wi.t()[:ch]), iy_t, ix_t, wi,
                    bias=bi, hr=rel, col_hr=ch)
                q_feat_o = _chunked_tokens(
                    self.imnet, g0.reshape(n * B, HH * WW, -1), chunks
                ).reshape(n * B, HH, WW, 64)
            else:
                shifts = (self._shift_tables(H, W, HH, WW, rel.dtype, x.device)
                          if self.local_ensemble else [(iy_t, ix_t, rel)])
                preds, areas = [], []
                for iy_s, ix_s, rel_s in shifts:
                    q_feat = up(feat, iy_s, ix_s)            # (nB,HH,WW,ch)
                    q_flow_feat = up(flow_feat, iy_s, ix_s)
                    q_residual = up(residual_bn, iy_s, ix_s)  # (BN,HH,WW,ch)
                    sti = torch.cat([rep_n(q_flow_feat),
                                     t_tok.expand(n * B * N, HH, WW, 1),
                                     rel_s.expand(n * B * N, HH, WW, 2)],
                                    dim=-1)
                    si = torch.cat([q_feat, rel_s.expand(n * B, HH, WW, 2)],
                                   dim=-1)
                    sti_out = _chunked_tokens(
                        self.flow_imnet, sti.reshape(n * B * N, HH * WW, -1),
                        chunks).reshape(n * B * N, HH, WW, 3 * G)
                    si_out = _chunked_tokens(
                        self.imnet, si.reshape(n * B, HH * WW, -1), chunks
                    ).reshape(n * B, HH, WW, 64)
                    pred = [si_out, q_feat, q_residual, sti_out]
                    if self.res_liff:
                        ri = torch.cat([q_residual,
                                        rel_s.expand(B * N, HH, WW, 2)],
                                       dim=-1)
                        res_out = _chunked_tokens(
                            self.res_imnet, ri.reshape(B * N, HH * WW, -1),
                            chunks).reshape(B * N, HH, WW, 64)
                        pred = [si_out, q_feat, res_out, sti_out, q_residual]
                    preds.append(pred)
                    areas.append((rel_s[..., 0] * rel_s[..., 1]).abs() + 1e-9)
                if len(preds) == 1:
                    # one shift: its area weight is area / area == 1 exactly,
                    # so the JAX package's weighted sum is the identity
                    acc = preds[0]
                else:
                    # each decode weighted by the diagonally opposite cell's
                    # area (Ours.py:758-764), summed in the JAX package's order
                    tot = areas[0] + areas[1] + areas[2] + areas[3]
                    acc = None
                    for pred, area in zip(preds, areas[::-1]):
                        w = (area / tot)[..., None]
                        terms = [p * w.to(p.dtype) for p in pred]
                        acc = terms if acc is None else [
                            a + t for a, t in zip(acc, terms)]
                if self.res_liff:
                    q_feat_o, q_feat, q_res_liif, q_flow_o, q_res_low = acc
                    q_residual = torch.cat([q_res_liif, q_res_low], dim=-1)
                else:
                    q_feat_o, q_feat, q_residual, q_flow_o = acc

            # ---- HR flow / z / features and the splat, in the input's dtype;
            # the payload's flow channels take no gradient (as in the JAX
            # package). With G groups each row splits into G rows, group g
            # taking channel slice g of each part (the reference's NCHW
            # channel split, Ours.py:783-791) ----
            def split_groups(a, k):   # (M, HH, WW, G·k) -> (M·G, ..., k)
                if G == 1:
                    return a
                M = a.shape[0]
                return a.reshape(M, HH, WW, G, k).permute(
                    0, 3, 1, 2, 4).reshape(M * G, HH, WW, k)

            flow_raw = split_groups(cf(q_flow_o), 3)
            if fused:
                # The synthesis net's first layer folded through the splat,
                # which is linear in its payload: [q_feat_o | flow | q_feat]
                # goes through net.0's matching rows before it is scattered
                # (130 -> 64 channels); the rows of the extras, the residual
                # and the time are added after the merge. The flow's two rows
                # stay in the input's dtype.
                ws_raw, _ = self.synth_net.first_linear(x.dtype)
                ws, bs = self.synth_net.first_linear(rel.dtype)   # (64, 198)
                k_e = 3 if self.decoder_Z else 2
                off = 66 + ch          # columns of the extras, then residual
                wst = ws.t()
                # (nBN, HH, WW, 64)
                feat_hr = preact.preact(
                    "payload", torch.matmul(feat, wst[66:66 + ch]), iy_t,
                    ix_t, ws_raw, rep=N,
                    dense=torch.matmul(q_feat_o, wst[:64]),
                    hr=flow_raw[..., :2].detach(), col_hr=64)
            else:
                feat_hr = torch.cat(
                    [split_groups(rep_n(cf(q_feat_o)), 64 // G),
                     flow_raw[..., :2].detach(),
                     split_groups(rep_n(cf(q_feat)), ch // G)], dim=-1)
            flow_hr = flow_raw[..., :2] * 20.0 * (HH / H)
            z = torch.relu(flow_raw[..., 2:3]) * self.alpha
            if not self.predict_Z:
                z = torch.zeros_like(z)
            if G > 1:        # every group splats along the same teacher flow
                flow_gt = flow_gt.repeat_interleave(G, 0)
        with obs.part("splat"):
            output, extra = self._splat_merge(feat_hr, flow_gt if use_gt
                                              else flow_hr, z, n, B * N * G)

        # ---- synthesis ----
        with obs.part("synth"):
            if fused:
                # net.0's pre-activation: the merged splat output (already
                # through the payload's columns) + the extras', the
                # residual's and the time's columns + the bias
                w_r = wst[off + k_e:off + k_e + ch]
                h = preact.preact(
                    "synth", torch.matmul(cd(residual_bn), w_r), iy_t, ix_t,
                    ws, bias=bs,
                    dense=output.reshape(B * N, HH, WW, 64),
                    hr=extra.reshape(B * N, HH, WW, -1), col_hr=off,
                    t=cd(target_t).reshape(B * N, 1, 1, 1),
                    col_t=off + k_e + ch)
                out = _chunked_tokens(self.synth_net,
                                      h.reshape(B * N, HH * WW, -1), chunks)
            else:
                def merge_groups(a):  # (BNG, HH, WW, c) -> (BN, HH, WW, G·c)
                    if G == 1:
                        return a
                    c = a.shape[-1]
                    return a.reshape(B * N, G, HH, WW, c).permute(
                        0, 2, 3, 1, 4).reshape(B * N, HH, WW, G * c)

                tmap = cd(target_t.reshape(B * N, 1, 1, 1)
                          * x.new_ones((1, HH, WW, 1)))
                synth_in = torch.cat([merge_groups(cd(output)),
                                      merge_groups(cd(extra)), q_residual,
                                      tmap], dim=-1)
                if self.siren:
                    out = _chunked_tokens(self.synth_net,
                                          synth_in.reshape(B * N, HH * WW, -1),
                                          chunks)
                else:
                    out = self.synth_net(synth_in)
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

    def _linear_trunk(self, x0, x1, out_hw, iters):
        """The Ours_7 fork's trunk (Ours_7.py:480-704) on anchors x0, x1
        (B, H, W, 3): RAFT's f01 / f10 at HR brought to LR (`f`, (2B, H, W,
        2)), and the encoder on the two anchors (`feat_t`, their features
        `feat`)."""
        B, H, W, _ = x0.shape
        HH, WW = out_hw
        tab = self._shape_tables(H, W, HH, WW, HH, WW, x0.dtype, None,
                                 x0.device)
        with torch.no_grad():
            hr0 = interpolate_bilinear(x0, (HH, WW))
            hr1 = interpolate_bilinear(x1, (HH, WW))
            f = self.flow_predictor(torch.cat([hr0, hr1], 0) * 255.0,
                                    torch.cat([hr1, hr0], 0) * 255.0,
                                    iters=iters)
            f = interpolate_bilinear(f, (H, W)) * (H / HH)
        feat_t = self.encoder(torch.stack([x0, x1], 1))     # (B, 3, H, W, ch)
        feat = torch.cat([feat_t[:, 0], feat_t[:, 2]], 0)   # (2B, H, W, ch)
        return dict(x=x0, iters=iters, tab=tab, f=f, feat_t=feat_t, feat=feat)

    def _linear_head(self, state, target_t, out_hw, use_gt, target_frames,
                     train):
        """The Ours_7 fork's head: f01 · t and f10 · (1 - t) per target time
        brought to HR as the motion; SINF on the LIIF takes of the anchors'
        features; the splat of [SINF | motion | features] along the motion
        (or the teacher's) with z = 0 (its predict_Z is off); the synthesis
        net. In the input's dtype (the fork has no compute dtype). The
        flows it returns are the motion / 20 / (HH / H) and the teacher's
        likewise (the fork's quirk: the motion was never multiplied by
        20)."""
        x0, tab, f = state["x"], state["tab"], state["f"]
        feat_t, feat = state["feat_t"], state["feat"]
        B, H, W, _ = x0.shape
        HH, WW = out_hw
        N = target_t.shape[1]
        with torch.no_grad():
            t = target_t.reshape(1, B, N, 1, 1, 1)
            lin = torch.cat([f[None, :B, None] * t,
                             f[None, B:, None] * (1.0 - t)], 0)
            flow = interpolate_bilinear(lin.reshape(2 * B * N, H, W, 2),
                                        (HH, WW)) * (HH / H)
            if train:
                flow_gt = self._teacher(target_frames, N, (HH, WW),
                                        state["iters"], _identity, _identity)
            else:
                flow_gt = x0.new_zeros((2 * B * N, HH, WW, 2))

        residual_bn = feat_t[:, 1]
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
                fields: dict | None = None, **knobs) -> MoTIF:
    """A MoTIF with `n_anchors` (2: Ours, 4: Ours_44) at `setting` (or the
    linear-motion Ours_7) and float32 random weights from `seed`, in eval
    mode, on `device` (CUDA unless the caller passes another device;
    raises without CUDA). `knobs` are MoTIF's serving knobs by name
    (`fused_decode`, `compute_dtype`, `splat_dtype`, `raft_resolution`,
    `decode_chunks`), `fields` its fields by name (`groups`, `trans`,
    `res_liff`, `local_ensemble`, `siren`); the weights depend on neither
    the knobs (both families draw
    the same weights from a seed; a setting changes the shapes of three
    of them). On CUDA the conv weights take the channels_last memory
    format."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = MoTIF(channel, front_rbs, back_rbs, n_anchors=n_anchors,
                      setting=setting, linear_motion=linear_motion,
                      **(fields or {}), **knobs)
    model = model.to(dev).eval()
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model
