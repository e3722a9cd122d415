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
knobs and the sign of its alpha). A bucket runs each of its callables as
a `_Graph`: on CUDA one CUDA graph over static device inputs and outputs,
captured at the bucket's first request after an eager run on a side
stream (which builds the kernels and fills the model's caches) whose
values the static outputs take. A baseline's bucket has one, its head
(`_forward`). For the Ours family, whose trunk (RAFT, the reliability
metrics, the encoder) reads the LQ and never the times, it has two: the
trunk (`MoTIF.trunk`) over the static LQ, and the head (`MoTIF.head`: the
rest of the forward) over the trunk's static outputs and the static times.
All buckets of an Evaluator share one memory pool. A request then copies
its inputs in from pinned host memory, replays the trunk's graph once
(Ours family), replays the head's graph once per chunk, keeps the flow
statistics on the device and copies the frames and statistics out into
pinned memory once, with one synchronisation at the end. A capture that
fails raises with the bucket's key: there is no eager fallback. When the
model's weights change (a load, an optimiser step, a move), the buckets
are dropped and captured anew: `_Weights` tells so on every request
without walking the module tree, which is walked again only after a
change it found. Each bucket
keeps its host staging, page-locked on CUDA: the padded LQ, which a
request's LQ is written into, and its times, grown to the most chunks the
bucket has served; the outputs are copied into new host memory on every
request, so that no array `infer` returns is written by a later one. On
the CPU a bucket runs the same plan eagerly over the same buffers; the
rest of `infer` is the same code.

Under a profiler a request is the span `infer` (attrs: `n` times, `chunks`,
`bucket`, `knobs` (the bucket's knob set, `knobs_label`), `frames`
returned, and after a replayed MoTIF request `parts_ms`
and `forwards`) over its children `infer.plan`, `infer.bucket`,
`infer.copy_in`, for the Ours family `infer.trunk` (the trunk's one
replay), per chunk `infer.replay` and `infer.gather`, `infer.copy_out`,
`infer.wait`, on a replayed MoTIF request `infer.marks` (reading its
marks), and `infer.unpad`; a capture is the span `eval.capture` (attr
`graph="trunk"` for a trunk's). Each graph holds the start and end events
of the parts of MoTIF's forward (`obs.part`) that its capture ran, by
name (`obs.marking`): `parts_ms` are the device milliseconds of each of
those `PARTS` as one of the request's `forwards` holds them, the trunk's
parts its one replay's over `forwards` and the head's those of the last
replay, so that `parts_ms[p] * forwards` is the request's milliseconds of
part p. Counters: `eval.captures` (buckets captured: a head graph's
capture), `eval.trunk_replays` (a trunk graph's replays: one a request of
the Ours family, but for a bucket's first, which captures it),
`eval.replays` (a head graph's: one a chunk, but for the first chunk of a
bucket's first request; on the CPU every eager run of either counts),
`eval.bucket_resets` (every graph dropped for new
weights), `eval.weight_walks` (walks of the model's module tree: at
an Evaluator's first request, then one after each change found) and
`eval.staging_allocs` (a bucket's host staging allocated or grown). Each
graph counts the launches of its own capture at each replay, so a
request's launch counts are those of the kernels it ran.
"""

from __future__ import annotations

import itertools
import operator
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from motif_tpu_torch import obs, resolve_device
from motif_tpu_torch.models.factory import BASELINES, FOUR_ANCHOR
from motif_tpu_torch.models.motif import PARTS
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
        self._weights = None   # `_Weights` of the buckets' weights
        self._pool = None
        self.captures = 0      # buckets captured over the life

    def _forward(self, lq, times, out_hw):
        """One call of the model in its family's way: (frames (N, B, HH,
        WW, 3), the flow statistics [flow_err, flow_abs] as a (2,) tensor
        on the device for the Ours family, else None)."""
        model, f, n = self.model, self.family, times.shape[1]
        if f == "LIIF":
            return torch.stack(model(lq, times, out_hw), 0), None
        if f == "EDVR":
            return model(lq)[None].repeat(n, 1, 1, 1, 1), None
        if f == "Super_SloMo":
            out = model(torch.cat([lq[:, :1], lq[:, -1:]], 1), n - 1, out_hw)
        elif f == "TMNet":
            out = model(lq, times[:, 1:-1])
        elif f in ("ZSM", "Zooming"):
            out = model(lq)
        else:
            return _with_stats(*model(lq, times, out_hw, iters=self.iters))
        return out.transpose(0, 1), None

    def _plan(self, lq: np.ndarray, times: np.ndarray):
        """The padded LQ's shape (the LQ zero-padded to multiples of 4),
        the chunks of times as one (k, B, step) array (the last padded by
        repeating its last time), the number of times asked for and the
        padded output size."""
        B, N_in, h, w, _ = lq.shape
        h_n = -(-h // 4) * 4
        w_n = -(-w // 4) * 4
        n = times.shape[1]
        step = self.chunk if self.chunked else n
        chunks = []
        for start in range(0, n, step):
            t = times[:, start:start + step]
            pad = step - t.shape[1] if n > step else 0
            if pad:
                t = np.concatenate([t, np.repeat(t[:, -1:], pad, 1)], 1)
            chunks.append(t)
        return ((B, N_in, h_n, w_n, 3), np.stack(chunks), n,
                (h_n * self.scale, w_n * self.scale))

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
        if self._weights is None or not self._weights.same(self.model):
            self._buckets.clear()      # the weights changed: every graph
            self._pool = None          # holds the old ones' derived copies
            if self._weights is not None:
                obs.count("eval.bucket_resets")
            self._weights = _Weights(self.model)
            self.dtype = self._weights.dtype
        key = self._key(lq_shape, t_shape, out_hw)
        if key not in self._buckets:
            if self.device.type == "cuda" and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            label = knobs_label(self.dtype, self.model.knobs()
                                if self.chunked else {})
            self._buckets[key] = _Bucket(key, lq_shape, t_shape, self.dtype,
                                         self.device, self._pool, label,
                                         trunk=self.chunked)
        return self._buckets[key]

    @torch.inference_mode()
    def infer(self, lq: np.ndarray, times: np.ndarray, out_hw):
        """lq (B, N_in, H, W, 3); times (B, N). Returns (frames
        (N, B, out_hw[0], out_hw[1], 3) as numpy, (flow_err, flow_abs) for
        the Ours family, else None). Through the request's bucket: on CUDA
        its graph replayed per chunk (captured at the bucket's first
        request); for the Ours family the trunk's graph replayed once
        before them, the head's per chunk."""
        with obs.span("infer", n=times.shape[1]) as sp:
            with obs.span("infer.plan"):
                lq_shape, chunks, n, hw = self._plan(lq, times)
            with obs.span("infer.bucket"):
                bucket = self._bucket(lq_shape, chunks.shape[1:], hw)
            sp.set(chunks=len(chunks), bucket=bucket.serial,
                   knobs=bucket.knobs, frames=n * lq.shape[0])
            captured = bucket.head.graph is not None
            if self.chunked:       # the trunk once, the head per chunk
                model = self.model
                frames, stats = bucket.request(
                    lambda s, t: _with_stats(*model.head(s, t, hw)), lq,
                    chunks, trunk=lambda a: model.trunk(a, hw, self.iters))
            else:
                frames, stats = bucket.request(
                    lambda a, t: self._forward(a, t, hw), lq, chunks)
            self.captures += bucket.head.graph is not None and not captured
            if captured and obs.enabled():
                with obs.span("infer.marks"):
                    parts = bucket.parts_ms(len(chunks))
                    if parts:
                        sp.set(parts_ms=parts, forwards=len(chunks))
            with obs.span("infer.unpad"):
                return (frames[:n, :, :out_hw[0], :out_hw[1]],
                        tuple(np.mean(stats.astype(np.float64), 0))
                        if stats is not None else None)

    @torch.inference_mode()
    def _infer_eager(self, lq: np.ndarray, times: np.ndarray, out_hw):
        """`infer` without buckets: every chunk's `_forward` run eagerly and
        read back chunk by chunk. The reference that the captured path is
        held against (the card's smoke and tests); no serving path takes
        it."""
        lq_shape, chunks, n, hw = self._plan(lq, times)
        lq_p = torch.empty(lq_shape, dtype=self.dtype)
        _pad_into(lq_p.numpy(), lq)
        lq_t = lq_p.to(self.device)
        outs, stats = [], []
        for t in chunks:
            frames, s = self._forward(lq_t, torch.as_tensor(
                t, dtype=self.dtype, device=self.device), hw)
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


_serials = itertools.count()


def knobs_label(dtype: torch.dtype, knobs: dict) -> str:
    """A bucket's knob set as one short string: MoTIF's `knobs` that are
    on, joined by "/" (`bf16` / `f16` for the compute and splat dtypes,
    `fused`, `r<factor>` for the RAFT resolution, `dc<n>` for the decode
    chunks), else the parameters' `dtype` (`fp32`, `fp64`)."""
    short = {"bfloat16": "bf16", "float16": "f16"}
    parts = [short[knobs[k]] for k in ("compute_dtype", "splat_dtype")
             if knobs.get(k)]
    if knobs.get("fused_decode"):
        parts.append("fused")
    if knobs.get("raft_resolution", 1.0) != 1.0:
        parts.append(f"r{knobs['raft_resolution']:g}")
    if knobs.get("decode_chunks", 1) > 1:
        parts.append(f"dc{knobs['decode_chunks']}")
    return "/".join(parts) or "fp" + str(torch.finfo(dtype).bits)


class _Weights:
    """A model's parameters and buffers as `Evaluator._bucket` last saw
    them, taken by one walk of the module tree (`eval.weight_walks`) and
    compared with the model on every request without one (`same`): every
    module's dicts of parameters, buffers and submodules with their
    lengths and the object under each name, and every tensor's
    (data_ptr, _version). So an in-place write (a load, an optimiser
    step, `mul_`, `fill_`), a move or cast (`.to`, whether torch sets
    `.data`, swaps the tensors or puts new ones in the dicts) and a
    parameter, buffer or submodule added, removed or replaced each read
    as a change. Holding the objects keeps their ids from being reused.
    `dtype` is the first parameter's."""

    def __init__(self, model: torch.nn.Module):
        obs.count("eval.weight_walks")
        self.model = model
        mods = list(model.modules())
        self.dicts = [d for m in mods
                      for d in (m._parameters, m._buffers, m._modules)]
        self.lens = [len(d) for d in self.dicts]
        self.where = [d for d in self.dicts for _ in d]
        self.names = [k for d in self.dicts for k in d]
        self.held = [v for d in self.dicts for v in d.values()]
        self.tensors = [v for m in mods for d in (m._parameters, m._buffers)
                        for v in d.values() if v is not None]
        self.dtype = next(p for m in mods for p in m._parameters.values()
                          if p is not None).dtype
        self.stamp = self._stamp()

    def _stamp(self):
        return (list(map(torch.Tensor.data_ptr, self.tensors)),
                list(map(_VERSION, self.tensors)))

    def same(self, model: torch.nn.Module) -> bool:
        """Whether `model` is the recorded one, unchanged."""
        return (model is self.model
                and list(map(len, self.dicts)) == self.lens
                and all(map(operator.is_, map(dict.get, self.where,
                                              self.names), self.held))
                and self._stamp() == self.stamp)


_VERSION = operator.attrgetter("_version")


def _pad_into(out: np.ndarray, lq: np.ndarray) -> None:
    """`lq` (B, N_in, h, w, 3) into the top left of `out` (B, N_in, H, W,
    3), the rest of `out` zeroed."""
    h, w = lq.shape[2:4]
    out[:, :, :h, :w] = lq
    out[:, :, h:] = 0
    out[:, :, :h, w:] = 0


def _host(shape, dtype, pin: bool) -> torch.Tensor:
    """A bucket's host staging (`eval.staging_allocs`): zeros, page-locked
    where `pin`, so that a copy to the card from it is asynchronous."""
    obs.count("eval.staging_allocs")
    return torch.zeros(shape, dtype=dtype, pin_memory=pin)


def _with_stats(frames, flow, flow_gt):
    """MoTIF's outputs as a chunk's: (frames, [flow_err, flow_abs] as a
    (2,) tensor on the device)."""
    return frames, torch.stack([(flow - flow_gt).abs().mean(),
                                flow.abs().mean()])


class _Graph:
    """One callable of a bucket over the bucket's static inputs: eager on
    the CPU; on CUDA at its first call an eager run on a side stream (it
    builds the kernels and fills the model's caches), then the capture of
    a graph over the bucket's pool, whose static outputs (`out`) take the
    eager run's values; a replay after that. It holds the graph, the
    launches its capture recorded (`tape`: each replay counts them) and
    its marks (`obs.marking`). `replays` names the counter of its runs
    after the capture (on the CPU, of every run), `captures` that of its
    capture, if any; `attrs` go on its `eval.capture` span."""

    def __init__(self, bucket, replays: str, captures: str | None = None,
                 **attrs):
        self.bucket, self.replays, self.captures = bucket, replays, captures
        self.attrs = attrs
        self.graph, self.tape, self.marks, self.out = None, {}, None, None

    def run(self, fn, *inputs):
        """`fn(*inputs)`, from the static `inputs`. A capture that fails
        raises with the bucket's key."""
        b, dev = self.bucket, self.bucket.device
        if dev.type != "cuda":
            out = fn(*inputs)
            obs.count(self.replays)
            return out
        if self.graph is not None:
            self.graph.replay()
            obs.count_replay(self.tape)
            obs.count(self.replays)
            return self.out
        with obs.span("eval.capture", bucket=b.serial, **self.attrs):
            side = torch.cuda.Stream(dev)          # the warm run
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                warm = fn(*inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            try:
                with obs.marking(PARTS) as marks, obs.recording() as tape, \
                        torch.cuda.graph(graph, pool=b.pool):
                    self.out = fn(*inputs)
            except Exception as e:
                raise RuntimeError(f"Evaluator: the capture of bucket "
                                   f"{b.key} failed: {e}") from e
        for static, value in zip(_tensors(self.out), _tensors(warm)):
            if static is not value:    # not an input or a shape table
                static.copy_(value)
        if self.captures:
            obs.count(self.captures)
        self.graph, self.tape, self.marks = graph, tape, marks
        return self.out


class _Bucket:
    """One shape bucket of `Evaluator.infer`: static device inputs (the
    padded LQ, one chunk's times), their host staging (`lq_h`, `t_h`:
    allocated at the first request, `t_h` grown to the most chunks a
    request has brought) and its callables as `_Graph`s over one pool: a
    MoTIF bucket's `trunk` over the static LQ, run once a request, whose
    static outputs are the `head`'s input; the `head` over that input (a
    baseline's: the LQ) and the times, run once a chunk."""

    def __init__(self, key, lq_shape, t_shape, dtype, device, pool,
                 knobs: str | None = None, trunk: bool = False):
        self.key, self.device, self.pool = key, device, pool
        self.serial = next(_serials)
        self.knobs = knobs                # `knobs_label`
        self.lq = torch.zeros(lq_shape, dtype=dtype, device=device)
        self.t = torch.zeros(t_shape, dtype=dtype, device=device)
        self.lq_h = self.t_h = None
        self.trunk = (_Graph(self, "eval.trunk_replays", graph="trunk")
                      if trunk else None)
        self.head = _Graph(self, "eval.replays", "eval.captures")
        self.src = self.lq                # the head's input

    def _run(self, forward):
        """One chunk: `forward(src, t)` over the head's static input and
        the static times."""
        return self.head.run(forward, self.src, self.t)

    def parts_ms(self, forwards: int) -> dict:
        """The device ms of each part of MoTIF's forward that the graphs
        recorded, in the last request, as a forward of its `forwards`
        would hold them: the trunk's parts (its one replay) over
        `forwards`, the head's from the last replay; so each part's ms
        times `forwards` is the request's ms of that part."""
        trunk = self.trunk.marks.elapsed() if self.trunk is not None else {}
        return {**{p: ms / forwards for p, ms in trunk.items()},
                **self.head.marks.elapsed()}

    def _stage(self, lq: np.ndarray, chunks: np.ndarray):
        """The request's LQ, zero-padded, and its chunks of times written
        into the bucket's host staging: (the LQ's, the times' (k, B,
        step)). A request reuses them because the one before it waited for
        its copies (`infer.wait`)."""
        pin, k = self.device.type == "cuda", len(chunks)
        if self.lq_h is None:
            self.lq_h = _host(self.lq.shape, self.lq.dtype, pin)
        if self.t_h is None or len(self.t_h) < k:
            self.t_h = _host((k, *self.t.shape), self.t.dtype, pin)
        _pad_into(self.lq_h.numpy(), lq)
        self.t_h.numpy()[:k] = chunks
        return self.lq_h, self.t_h[:k]

    def request(self, forward, lq: np.ndarray, chunks: np.ndarray,
                trunk=None):
        """Every chunk of one request (`lq` (B, N_in, h, w, 3) unpadded,
        `chunks` (k, B, step)) through the bucket: the inputs copied in
        once through the staging (`_stage`); in a MoTIF bucket `trunk(lq)`
        run once (span `infer.trunk`) into the head's input; then
        `forward(src, t)`, the head, once per chunk (`_run`), its frames
        and statistics gathered on the device, then copied out once into
        new host memory. Returns numpy (frames (k * step, B, HH, WW, 3),
        statistics (k, 2) or None)."""
        cuda = self.device.type == "cuda"
        with obs.span("infer.copy_in"):
            lq_h, t_h = self._stage(lq, chunks)
            self.lq.copy_(lq_h, non_blocking=True)
            t_dev = t_h.to(self.device, non_blocking=True)
        if self.trunk is not None:
            with obs.span("infer.trunk"):
                self.src = self.trunk.run(trunk, self.lq)
        frames = stats = None
        for k in range(len(chunks)):
            with obs.span("infer.replay", chunk=k):
                self.t.copy_(t_dev[k])
                f, s = self._run(forward)
            with obs.span("infer.gather", chunk=k):
                if frames is None:
                    step = f.shape[0]
                    frames = f.new_empty((len(chunks) * step, *f.shape[1:]))
                    stats = (None if s is None
                             else s.new_empty((len(chunks), 2)))
                frames[k * step:(k + 1) * step] = f
                if s is not None:
                    stats[k] = s
        with obs.span("infer.copy_out"):
            out = [frames] if stats is None else [frames, stats]
            if cuda:
                out = [torch.empty(a.shape, dtype=a.dtype, pin_memory=True
                                   ).copy_(a, non_blocking=True) for a in out]
                done = torch.cuda.Event()
                done.record()
        with obs.span("infer.wait"):
            if cuda:
                done.synchronize()
        return out[0].numpy(), out[1].numpy() if stats is not None else None


def _tensors(out) -> list:
    """The tensors among a callable's outputs (a dict's values or a
    tuple's items), in their order."""
    values = out.values() if isinstance(out, dict) else out
    return [v for v in values if isinstance(v, torch.Tensor)]
