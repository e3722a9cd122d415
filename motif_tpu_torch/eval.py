"""Inference harness — the counterpart of motif_tpu/eval.py::Evaluator.infer
for the `Ours` family: zero-pad the LQ to multiples of 4, forward the
target times in chunks of 3 (the last chunk padded by repeating its last
time, then cropped), crop to `out_hw`, and report the flow statistics the
reference logs (mean |flow - flow_GT| and mean |flow|).

The PSNR `run` loop and the other model families are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from motif_tpu_torch import resolve_device


class Evaluator:
    """Runs a MoTIF over requests. `device` is CUDA unless the caller names
    another device (raises without CUDA); the model is moved there. The
    padded LQ and the times take the model's parameter dtype. `knobs`, if
    any, are MoTIF's serving knobs by name (`fused_decode`,
    `compute_dtype`, `splat_dtype`, `raft_resolution`, `decode_chunks`):
    those named are set on the model in place and the others keep the
    model's values (`MoTIF.knobs`, `MoTIF.configure`); with none given the
    model serves as it was built."""

    def __init__(self, model: torch.nn.Module, scale: int = 4, iters: int = 4,
                 chunk: int = 3, device=None, **knobs):
        self.device = resolve_device(device)
        if knobs:
            model.configure(**{**model.knobs(), **knobs})
        self.model = model.to(self.device).eval()
        self.dtype = next(model.parameters()).dtype
        self.scale = scale
        self.iters = iters
        self.chunk = chunk

    @torch.inference_mode()
    def infer(self, lq: np.ndarray, times: np.ndarray, out_hw):
        """lq (B, N_in, H, W, 3); times (B, N). Returns (frames
        (N, B, out_hw[0], out_hw[1], 3) as numpy, (flow_err, flow_abs))."""
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
        step = self.chunk
        outs, fstats = [], []
        for start in range(0, n, step):
            t = times[:, start:start + step]
            pad = step - t.shape[1] if n > step else 0
            if pad:
                t = np.concatenate([t, np.repeat(t[:, -1:], pad, 1)], 1)
            t_t = torch.as_tensor(np.asarray(t, np_dtype), device=self.device)
            frames, flow, flow_gt = self.model(lq_t, t_t, (HH, WW),
                                               iters=self.iters)
            fstats.append(((flow - flow_gt).abs().mean().item(),
                           flow.abs().mean().item()))
            frames = frames.cpu().numpy()
            if pad:
                frames = frames[: t.shape[1] - pad]
            outs.append(frames)
        out = np.concatenate(outs, 0)
        return out[:, :, :out_hw[0], :out_hw[1]], tuple(np.mean(fstats, 0))
