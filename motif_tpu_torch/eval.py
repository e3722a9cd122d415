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

As the JAX package compiles one forward per shape bucket
(motif_tpu/eval.py:82-125), `infer` keeps one `_Bucket` per key (the
padded LQ shape, the times per chunk and the output size, and what the
forward branches on in host code: the family, the parameter dtype, MoTIF's
knobs and the sign of its alpha). On CUDA a bucket is one CUDA graph of
`_forward`, captured at the bucket's first request after an eager run of
that request's first chunk on a side stream (which builds the kernels and
fills the model's caches), over static device inputs; all buckets of an
Evaluator share one memory pool. A request then copies its inputs in from
pinned host memory, replays the graph once per chunk, keeps the flow
statistics on the device and copies the frames and statistics out into
pinned memory once, with one synchronisation at the end. A capture that
fails raises with the bucket's key: there is no eager fallback. When the
model's weights change (a load, an optimiser step, a move), the buckets
are dropped and captured anew. On the CPU a bucket runs the eager forward
over the same buffers; the rest of `infer` is the same code.
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from motif_tpu_torch import resolve_device
from motif_tpu_torch.models.factory import BASELINES, FOUR_ANCHOR
from motif_tpu_torch.ops import kernels
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

    A family it does not know raises NotImplementedError. `knobs`, if
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
            raise NotImplementedError(f"eval family [{self.family}] is not "
                                      "known")
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
        self._buckets: dict = {}
        self._stamp = None
        self._pool = None

    def _forward(self, lq, times, out_hw):
        """One call of the model in its family's way: (frames (N, B, HH,
        WW, 3), the flow statistics [flow_err, flow_abs] as a (2,) tensor
        on the device for the Ours family, else None)."""
        model, f, n = self.model, self.family, times.shape[1]
        if f == "LIIF":
            return torch.stack(model(lq, times, out_hw), 0), None
        if f == "EDVR":
            return model(lq)[None].expand(n, -1, -1, -1, -1), None
        if f == "Super_SloMo":
            out = model(torch.cat([lq[:, :1], lq[:, -1:]], 1), n - 1, out_hw)
        elif f == "TMNet":
            out = model(lq, times[:, 1:-1])
        elif f in ("ZSM", "Zooming"):
            out = model(lq)
        else:
            frames, flow, flow_gt = model(lq, times, out_hw, iters=self.iters)
            return frames, torch.stack([(flow - flow_gt).abs().mean(),
                                        flow.abs().mean()])
        return out.transpose(0, 1), None

    def _plan(self, lq: np.ndarray, times: np.ndarray):
        """The padded LQ (numpy, the parameters' dtype), the chunks of
        times (each (B, step), the last padded by repeating its last time),
        the number of times asked for and the padded output size."""
        B, N_in, h, w, _ = lq.shape
        h_n = -(-h // 4) * 4
        w_n = -(-w // 4) * 4
        np_dtype = torch.empty((), dtype=self.dtype).numpy().dtype
        lq_p = np.zeros((B, N_in, h_n, w_n, 3), np_dtype)
        lq_p[:, :, :h, :w] = lq
        n = times.shape[1]
        step = self.chunk if self.chunked else n
        chunks = []
        for start in range(0, n, step):
            t = times[:, start:start + step]
            pad = step - t.shape[1] if n > step else 0
            if pad:
                t = np.concatenate([t, np.repeat(t[:, -1:], pad, 1)], 1)
            chunks.append(np.asarray(t, np_dtype))
        return lq_p, chunks, n, (h_n * self.scale, w_n * self.scale)

    def _key(self, lq_shape, t_shape, out_hw):
        """A bucket's key: the shapes, and what `_forward` branches on in
        host code (the family, the dtype, MoTIF's knobs and the sign of
        its alpha, read here, before any capture)."""
        model, ours = self.model, self.chunked
        return (tuple(lq_shape), tuple(t_shape), tuple(out_hw), self.family,
                self.dtype,
                tuple(sorted(model.knobs().items())) if ours else None,
                model._alpha_nonpositive() if ours else None)

    def _bucket(self, lq_shape, t_shape, out_hw):
        stamp = tuple((t.data_ptr(), t._version) for t in itertools.chain(
            self.model.parameters(), self.model.buffers()))
        if stamp != self._stamp:       # the weights changed: every graph
            self._buckets.clear()      # holds the old ones' derived copies
            self._pool = None
            self._stamp = stamp
        key = self._key(lq_shape, t_shape, out_hw)
        if key not in self._buckets:
            if self.device.type == "cuda" and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            self._buckets[key] = _Bucket(key, lq_shape, t_shape, self.dtype,
                                         self.device, self._pool)
        return self._buckets[key]

    @torch.inference_mode()
    def infer(self, lq: np.ndarray, times: np.ndarray, out_hw):
        """lq (B, N_in, H, W, 3); times (B, N). Returns (frames
        (N, B, out_hw[0], out_hw[1], 3) as numpy, (flow_err, flow_abs) for
        the Ours family, else None). Through the request's bucket: on CUDA
        its graph replayed per chunk (captured at the bucket's first
        request)."""
        lq_p, chunks, n, hw = self._plan(lq, times)
        bucket = self._bucket(lq_p.shape, chunks[0].shape, hw)
        frames, stats = bucket.request(
            lambda a, t: self._forward(a, t, hw), lq_p, np.stack(chunks))
        return (frames[:n, :, :out_hw[0], :out_hw[1]],
                tuple(np.mean(stats.astype(np.float64), 0))
                if stats is not None else None)

    @torch.inference_mode()
    def _infer_eager(self, lq: np.ndarray, times: np.ndarray, out_hw):
        """`infer` without buckets: every chunk's `_forward` run eagerly and
        read back chunk by chunk. The reference that the captured path is
        held against (the card's smoke and tests); no serving path takes
        it."""
        lq_p, chunks, n, hw = self._plan(lq, times)
        lq_t = torch.as_tensor(lq_p, device=self.device)
        outs, stats = [], []
        for t in chunks:
            frames, s = self._forward(lq_t, torch.as_tensor(
                t, device=self.device), hw)
            outs.append(frames.cpu().numpy())
            if s is not None:
                stats.append(s.tolist())
        out = np.concatenate(outs, 0)
        return (out[:n, :, :out_hw[0], :out_hw[1]],
                tuple(np.mean(stats, 0)) if stats else None)

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


class _Bucket:
    """One shape bucket of `Evaluator.infer`: static device inputs (the
    padded LQ, one chunk's times) and, on CUDA, the graph of the forward
    captured over them, with its outputs (the frames, the flow statistics)
    static too, and the launches its capture recorded (`kernels.recording`:
    each replay counts them). On the CPU the forward runs eagerly over the
    same buffers."""

    def __init__(self, key, lq_shape, t_shape, dtype, device, pool):
        self.key, self.device, self.pool = key, device, pool
        self.lq = torch.zeros(lq_shape, dtype=dtype, device=device)
        self.t = torch.zeros(t_shape, dtype=dtype, device=device)
        self.graph, self.tape = None, {}
        self.frames = self.stats = None

    def _run(self, forward):
        """The forward over the static inputs: eager on the CPU; on CUDA at
        first an eager run on a side stream (it builds the kernels and
        fills the model's caches, and its outputs are this chunk's), then
        the capture; a replay after that."""
        if self.device.type != "cuda":
            return forward(self.lq, self.t)
        if self.graph is not None:
            self.graph.replay()
            kernels.count_replay(self.tape)
            return self.frames, self.stats
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            warm = forward(self.lq, self.t)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with kernels.recording() as tape, \
                    torch.cuda.graph(graph, pool=self.pool):
                self.frames, self.stats = forward(self.lq, self.t)
        except Exception as e:
            raise RuntimeError(f"Evaluator: the capture of bucket {self.key} "
                               f"failed: {e}") from e
        self.graph, self.tape = graph, tape
        return warm

    def request(self, forward, lq_p: np.ndarray, chunks: np.ndarray):
        """Every chunk of one request (`chunks` (k, B, step)) through the
        bucket: the inputs copied in once (from pinned memory on CUDA), one
        forward per chunk, its frames and statistics gathered on the
        device, then copied out once. Returns numpy (frames (k * step, B,
        HH, WW, 3), statistics (k, 2) or None)."""
        cuda = self.device.type == "cuda"
        lq_h = torch.from_numpy(lq_p)
        t_h = torch.from_numpy(chunks)
        if cuda:
            lq_h, t_h = lq_h.pin_memory(), t_h.pin_memory()
        self.lq.copy_(lq_h, non_blocking=True)
        t_dev = t_h.to(self.device, non_blocking=True)
        frames = stats = None
        for k in range(len(chunks)):
            self.t.copy_(t_dev[k])
            f, s = self._run(forward)
            if frames is None:
                step = f.shape[0]
                frames = f.new_empty((len(chunks) * step, *f.shape[1:]))
                stats = None if s is None else s.new_empty((len(chunks), 2))
            frames[k * step:(k + 1) * step] = f
            if s is not None:
                stats[k] = s
        if not cuda:
            return frames.numpy(), None if stats is None else stats.numpy()
        out = [torch.empty(frames.shape, dtype=frames.dtype, pin_memory=True)]
        out[0].copy_(frames, non_blocking=True)
        if stats is not None:
            out.append(torch.empty(stats.shape, dtype=stats.dtype,
                                   pin_memory=True))
            out[1].copy_(stats, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return out[0].numpy(), out[1].numpy() if stats is not None else None
