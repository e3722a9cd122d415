"""Evaluation harness, the counterpart of motif_tpu/eval.py: the reference
test.py protocol for the MoTIF families (`Ours` and the four-anchor
Ours_44 / Ours_4) and the baselines (LIIF, ZSM / Zooming, TMNet, EDVR,
Super_SloMo). `infer` zero-pads the LQ to multiples of 4, forwards the
target times (the Ours family in chunks, 3 for Ours and 1 for the
four-anchor pair, the last chunk padded by repeating its last time, then
cropped; every other family all at once, each with its own call), crops to
`out_hw` and, for the Ours family, reports the flow statistics the
reference logs (mean |flow - flow_GT| and mean |flow|). `run` scores every
clip of a loader: L1, Y-channel PSNR split into anchor / inter / center,
MATLAB SSIM, and the per-clip `.npy` files.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from motif_tpu_torch import resolve_device
from motif_tpu_torch.models.factory import BASELINES, FOUR_ANCHOR, unported
from motif_tpu_torch.utils import metrics


@dataclass
class EvalResults:
    psnr: list = field(default_factory=list)
    psnr_anchor: list = field(default_factory=list)
    psnr_inter: list = field(default_factory=list)
    psnr_center: list = field(default_factory=list)
    ssim: list = field(default_factory=list)
    psnrs_all: list = field(default_factory=list)
    ssim_all: list = field(default_factory=list)
    l1: list = field(default_factory=list)
    flows: list = field(default_factory=list)    # mean |flow - flow_GT| (test.py:240)
    flows_0: list = field(default_factory=list)  # mean |flow| (test.py:241)

    def summary(self) -> dict:
        out = {
            "psnr": float(np.mean(self.psnr)),
            "psnr_anchor": float(np.mean(self.psnr_anchor)),
            "psnr_inter": float(np.mean(self.psnr_inter)),
            "psnr_center": float(np.mean(self.psnr_center)),
            "ssim": float(np.mean(self.ssim)),
            "l1": float(np.mean(self.l1)),
            "n_clips": len(self.psnr),
        }
        if self.flows:  # only families that return flows (reference try/except)
            out["flow_err"] = float(np.mean(self.flows))
            out["flow_abs"] = float(np.mean(self.flows_0))
        return out


def resolve_family(family: str, chunk: int) -> tuple[str, int]:
    """The evaluated family and its chunk of times, as the JAX package's
    Evaluator dispatches them (VideoSR_base_model.py:169-200): Ours_44 /
    Ours_4 forward one time at a time, every other Ours_* is Ours, any
    other family is itself (only the Ours family chunks)."""
    if family in ("Ours_44", "Ours_4"):
        return family, 1
    if family.startswith("Ours"):
        return "Ours", chunk
    return family, chunk


class Evaluator:
    """Runs a model over requests and eval clips. `device` is CUDA unless
    the caller names another device (raises without CUDA); the model is
    moved there. The padded LQ and the times take the model's parameter
    dtype. `family` is the yml's `which_model_G` (`resolve_family`) and
    sets how the model is called:

      * Ours family: chunks of times, iters, (frames, flow, flow_gt) back;
      * LIIF (VideoINR): all times, its per-time list stacked;
      * EDVR: its one centre frame repeated over the N times;
      * Super_SloMo: the first and last LQ frames, factor N - 1, the UNets
        at the output size;
      * TMNet: the interior times only;
      * ZSM / Zooming: no times, 2N_in - 1 frames out.

    A family the port has not taken raises NotImplementedError. `knobs`, if
    any, are MoTIF's serving knobs by name (`fused_decode`,
    `compute_dtype`, `splat_dtype`, `raft_resolution`, `decode_chunks`):
    those named are set on the model in place and the others keep the
    model's values (`MoTIF.knobs`, `MoTIF.configure`); with none given the
    model serves as it was built. The baselines take none."""

    def __init__(self, model: torch.nn.Module, scale: int = 4, iters: int = 4,
                 chunk: int = 3, family: str = "Ours", device=None, **knobs):
        self.family, chunk = resolve_family(family, chunk)
        ours = self.family == "Ours" or self.family in FOUR_ANCHOR
        if not ours and self.family not in BASELINES:
            reason = unported(self.family) or f"[{self.family}] is not known"
            raise NotImplementedError(f"eval family {reason}")
        if knobs and not ours:
            raise ValueError(f"eval family [{self.family}]: the serving "
                             f"knobs {sorted(knobs)} are MoTIF's")
        self.device = resolve_device(device)
        if knobs:
            model.configure(**{**model.knobs(), **knobs})
        self.model = model.to(self.device).eval()
        self.dtype = next(model.parameters()).dtype
        self.scale = scale
        self.iters = iters
        self.chunk = chunk
        self.chunked = ours    # only the Ours family chunks over times

    def _forward(self, lq, times, out_hw):
        """One call of the model in its family's way: (frames (N, B, HH,
        WW, 3), (flow_err, flow_abs) or None)."""
        model, f, n = self.model, self.family, times.shape[1]
        if f == "LIIF":
            return torch.stack(model(lq, times, out_hw), 0), None
        if f == "EDVR":
            return model(lq)[None].expand(n, -1, -1, -1, -1), None
        if f == "Super_SloMo":
            out = model(lq[:, [0, -1]], n - 1, out_hw)
        elif f == "TMNet":
            out = model(lq, times[:, 1:-1])
        elif f in ("ZSM", "Zooming"):
            out = model(lq)
        else:
            frames, flow, flow_gt = model(lq, times, out_hw, iters=self.iters)
            return frames, ((flow - flow_gt).abs().mean().item(),
                            flow.abs().mean().item())
        return out.transpose(0, 1), None

    @torch.inference_mode()
    def infer(self, lq: np.ndarray, times: np.ndarray, out_hw):
        """lq (B, N_in, H, W, 3); times (B, N). Returns (frames
        (N, B, out_hw[0], out_hw[1], 3) as numpy, (flow_err, flow_abs) for
        the Ours family, else None)."""
        B, N_in, h, w, _ = lq.shape
        s = self.scale
        h_n = -(-h // 4) * 4
        w_n = -(-w // 4) * 4
        np_dtype = torch.empty((), dtype=self.dtype).numpy().dtype
        lq_p = np.zeros((B, N_in, h_n, w_n, 3), np_dtype)
        lq_p[:, :, :h, :w] = lq
        HH, WW = h_n * s, w_n * s
        lq_t = torch.as_tensor(lq_p, device=self.device)

        n = times.shape[1]
        step = self.chunk if self.chunked else n
        outs, fstats = [], []
        for start in range(0, n, step):
            t = times[:, start:start + step]
            pad = step - t.shape[1] if n > step else 0
            if pad:
                t = np.concatenate([t, np.repeat(t[:, -1:], pad, 1)], 1)
            t_t = torch.as_tensor(np.asarray(t, np_dtype), device=self.device)
            frames, stats = self._forward(lq_t, t_t, (HH, WW))
            if stats is not None:
                fstats.append(stats)
            frames = frames.cpu().numpy()
            if pad:
                frames = frames[: t.shape[1] - pad]
            outs.append(frames)
        out = np.concatenate(outs, 0)
        return (out[:, :, :out_hw[0], :out_hw[1]],
                tuple(np.mean(fstats, 0)) if fstats else None)

    def run(self, loader, save_psnr_dir: str | None = None,
            log_every: int = 1, logger=None, name: str = "") -> EvalResults:
        """Score every batch of `loader` (dicts of `lq` (B, N_in, H, W, 3),
        `gt` (B, N+2, HH, WW, 3) with the two anchors at its ends, `times`
        (B, N)) as the reference test.py does; with `save_psnr_dir`, write
        the per-frame PSNRs and SSIMs of each clip to `<name>.npy` and
        `<name>_ssim.npy` there (object arrays, allow_pickle)."""
        res = EvalResults()
        for it, batch in enumerate(loader):
            lq, gt, times = batch["lq"], batch["gt"], batch["times"]
            B = lq.shape[0]
            H, W = gt.shape[2], gt.shape[3]
            fake, flow_stats = self.infer(lq, times, (H, W))  # (N, B, H, W, 3)
            if flow_stats is not None:
                res.flows.append(flow_stats[0])
                res.flows_0.append(flow_stats[1])
            real = gt[:, 1:-1]                            # (B, N, H, W, 3)
            n = real.shape[1]
            fake_bn = fake.transpose(1, 0, 2, 3, 4).reshape(B * n, H, W, 3)
            real_bn = real.reshape(B * n, H, W, 3)

            res.l1.append(float(np.abs(real_bn - fake_bn).mean()))
            ry = metrics.rgb_to_y(real_bn)
            fy = metrics.rgb_to_y(fake_bn)
            p_a, p_i, p_c, p, per = metrics.eval_psnr_split(ry, fy)
            res.psnr_anchor.append(p_a)
            res.psnr_inter.append(p_i)
            res.psnr_center.append(p_c)
            res.psnr.append(p)
            res.psnrs_all.append(per)
            ssims = [metrics.calculate_ssim(ry[i] * 255.0, fy[i] * 255.0)
                     for i in range(B * n)]
            res.ssim.append(float(np.mean(ssims[:-1])))
            res.ssim_all.append(ssims)
            if logger and (it % log_every == 0):
                s = res.summary()
                logger.info(
                    f"[{it}] psnr {p:.3f} (avg {s['psnr']:.3f}) "
                    f"center {p_c:.3f} (avg {s['psnr_center']:.3f}) "
                    f"ssim avg {s['ssim']:.4f}")
        if save_psnr_dir:
            # named by experiment like the reference ('./psnrs/' +
            # opt['name'] + '.npy', test.py:290-291)
            os.makedirs(save_psnr_dir, exist_ok=True)
            stem = name or "psnrs"
            np.save(os.path.join(save_psnr_dir, f"{stem}.npy"),
                    np.asarray(res.psnrs_all, dtype=object), allow_pickle=True)
            np.save(os.path.join(save_psnr_dir, f"{stem}_ssim.npy"),
                    np.asarray(res.ssim_all, dtype=object), allow_pickle=True)
        return res
