"""Clip requests to a serving configuration (one whose `network_G` names
MoTIF's serving knobs: bfloat16 compute, float16 splat sums, the fused
decode, RAFT's resolution, decode chunks). The traffic, the set-up, the
window, the traced slice and the checked answers are those of the `clips`
kind: `traffic/clips.py`'s `run` drives the run as it is, with its
`lq_pool`, `schedule`, `sampled` and `_Spans`. Five things differ:

- the check: the answers against the serving reference
  (`reference/serve.py`: the frozen MoTIF with the knobs, its kernel ops
  in their working types), through `clips.compare`'s readings;
- the traced run's pass over the kernel ops bounds each call by its data's
  element size and the tensor cores' rate (`counts/bounds_lowp.py`), kept
  as `ops_lowp` (the float32 bounds' `ops` is left empty);
- the traced run counts the work of the program's plan by dtype
  (`plan_flops_of_n`: the trunk once a request, the head once a chunk of
  the padded chunks, each FLOP of the reference's forward under
  `PlanCounter`, the kernel ops' counted in their working type);
- the program's counters: their change over the traced slice
  (`slice_counters`: the kernels' launches by entry) and over the window
  (`window_counters`, logged: a server that recasts no weight in the
  window reads 0 `layers.cast_copies` there);
- the control (`--control half`): the serving reference with every part
  that the configuration keeps above bfloat16 dropped to bfloat16
  (`serve.Lowered`) in the program's place. TF32 is no control here.

Mix keys: those of `clips`."""

from __future__ import annotations

import contextlib
import types
from unittest import mock

from benchmark import ops_pass, reference, trace, weights
from benchmark.counts import bounds_lowp
from benchmark.reference import infer as ref_infer
from benchmark.reference import lowp, plain, serve
from benchmark.traffic import clips

SPANS = clips.SPANS
KERNELS = ("splat_fused", "dcn_im2col", "siren_mlp")
LAUNCHES = "kernels.launches."
LOW = ("bfloat16", "float16")
_compare = clips.compare


def _splat_bound(img, flow, z, z_nonpositive, *a, **kw):
    B, H, W, C = img.shape
    return bounds_lowp.splat_bound(B, H, W, C, bool(z_nonpositive),
                                   img.element_size())


def _dcn_bound(x, offset, mask, weight, bias, kernel_size=3, stride=1,
               padding=1, dilation=1, deformable_groups=1):
    B, H, W, Cin = x.shape
    Ho, Wo = offset.shape[1], offset.shape[2]
    return bounds_lowp.dcn_bound(B, H, W, Cin, Ho, Wo, weight.shape[0],
                                 deformable_groups, kernel_size,
                                 x.element_size())


def _siren_bound(x, weights, biases, omega0=30.0, sine_last=False,
                 skip_first=False, packed=None):
    dims = [x.shape[-1]] + [w.shape[0] for w in weights]
    return bounds_lowp.siren_bound(x.numel() // x.shape[-1], dims, sine_last,
                                   skip_first, x.element_size())


@contextlib.contextmanager
def wrapped(torch, calls: list, spans):
    """`ops_pass.wrapped` with the dtype-aware bounds."""
    with mock.patch.object(ops_pass, "_splat_bound", _splat_bound), \
            mock.patch.object(ops_pass, "_dcn_bound", _dcn_bound), \
            mock.patch.object(ops_pass, "_siren_bound", _siren_bound), \
            ops_pass.wrapped(torch, calls, spans):
        yield


def counters() -> dict:
    """The program's counters now, or {} for a program without them."""
    try:
        from motif_tpu_torch import obs
    except ImportError:
        return {}
    return obs.counters()


def grown(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def low_share(counts: dict):
    """(launches of the three kernels through a bfloat16 / float16 entry,
    all their launches) in `counts` (`kernels.launches.<kernel>/<entry>`)."""
    low = total = 0
    for name, n in counts.items():
        if not name.startswith(LAUNCHES) or "/" not in name:
            continue
        kernel, entry = name[len(LAUNCHES):].split("/", 1)
        if kernel in KERNELS:
            total += n
            low += n if entry.startswith(LOW) else 0
    return low, total


class PlanCounter:
    """FLOPs of a forward of the reference by part and dtype: each aten op
    that `torch.utils.flop_counter` counts, put down to the trunk until the
    encoder's forward returns and to the head after it (the program's cut,
    `MoTIF.trunk` / `MoTIF.head`), and to "bf16" where its operands are
    16-bit, else "fp32". The kernel ops of `lowp.py` widen their bfloat16
    operands to float32 for exact products: their FLOPs count in the type
    of their inputs, as the program's kernels run them."""

    def __init__(self, torch, model):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        self.counts: dict = {}
        self.phase, self.as_dtype = "trunk", None
        low = (torch.bfloat16, torch.float16)
        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                count = flop_registry.get(func._overloadpacket)
                if count is not None:
                    dt = counter.as_dtype or next(
                        a.dtype for a in args if isinstance(a, torch.Tensor))
                    key = (counter.phase, "bf16" if dt in low else "fp32")
                    counter.counts[key] = counter.counts.get(key, 0) + int(
                        count(*args, **kwargs, out_val=out))
                return out

        self.mode = Mode
        self.hooks = (
            model.register_forward_pre_hook(
                lambda *a: setattr(self, "phase", "trunk")),
            model.encoder.register_forward_hook(
                lambda *a: setattr(self, "phase", "head")))

    def _typed(self, fn):
        def call(x, *a, **kw):
            outer, self.as_dtype = self.as_dtype, x.dtype
            try:
                return fn(x, *a, **kw)
            finally:
                self.as_dtype = outer
        return call

    @contextlib.contextmanager
    def counting(self):
        with mock.patch.object(plain, "dcn_v2", self._typed(lowp.dcn_v2)), \
                mock.patch.object(plain, "siren_mlp",
                                  self._typed(lowp.siren_mlp)), \
                mock.patch.object(plain, "splat_fused", lowp.splat_fused), \
                self.mode():
            yield self.counts

    def close(self):
        for h in self.hooks:
            h.remove()


def plan_flops(cell, args, h, request, out_hw) -> dict:
    """{N: {"bf16": FLOPs, "fp32": FLOPs}} of a request of N times as the
    program plans it: the trunk once, the head once for each chunk, the
    last chunk padded to the chunk's length."""
    torch, dev, cfg = h.torch, h.device, cell.config
    chunk, iters = int(cfg["eval_chunk"]), int(cfg["eval_iters"])
    lq, _ = request(0)
    per_k: dict = {}
    with reference.precise(torch):
        model = serve.build(cfg, dev)
        pc = PlanCounter(torch, model)
        out = {}
        for n in sorted(set(cell.traffic["n_times"])):
            ks = [min(chunk, n)] * -(-n // chunk)
            for k in set(ks) - set(per_k):
                with pc.counting() as c:
                    c.clear()
                    ref_infer.infer(model, lq, clips.times_of(k, lq.shape[0]),
                                    out_hw, int(cfg["scale"]), k, iters, dev)
                    per_k[k] = dict(c)
            trunk = per_k[ks[0]]
            out[n] = {dt: trunk.get(("trunk", dt), 0) + sum(
                per_k[k].get(("head", dt), 0) for k in ks)
                for dt in ("bf16", "fp32")}
        pc.close()
        del model
    h.log(f"the plan's FLOPs by N and dtype: {out}")
    return out


def compare(cell, args, h, kept: dict, request, out_hw, ns, due: int):
    """`clips.compare`'s readings of the kept answers against the serving
    reference; with a trace, the plan's FLOPs by dtype (`plan_flops`)."""
    quiet = types.SimpleNamespace(**dict(vars(args), trace=0))
    with mock.patch.object(ref_infer, "build", serve.build), \
            mock.patch.object(ref_infer, "infer", serve.infer):
        checks, _ = _compare(cell, quiet, h, kept, request, out_hw, ns, due)
    return checks, (plan_flops(cell, args, h, request, out_hw)
                    if args.trace else {})


def run(cell, args, h) -> dict:
    """One run of a serving clip cell: `clips.run` with this kind's check,
    bounds, counts and counters (see the module's note)."""
    at: dict = {}
    slices: list = []
    mark_setup, read_memory = h.mark_setup, h.read_memory

    def setup_done():
        mark_setup()
        at["setup"] = counters()

    def window_done():
        at["window"] = counters()
        read_memory()

    class CountingSlice(trace.Slice):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.counters = None
            slices.append(self)

        def before(self, i):
            if self.on and i == self.start:
                self._at = counters()
            super().before(i)

        def close(self):
            if self._cm is not None:
                super().close()
                self.counters = grown(self._at, counters())

    h.mark_setup, h.read_memory = setup_done, window_done
    try:
        with mock.patch.object(clips, "compare", compare), \
                mock.patch.object(clips, "wrapped", wrapped), \
                mock.patch.object(trace, "Slice", CountingSlice):
            rec = clips.run(cell, args, h)
    finally:
        del h.mark_setup, h.read_memory
    rec["ops_lowp"], rec["ops"] = rec.get("ops"), None
    rec["plan_flops_of_n"] = rec.pop("flops_of_n", None)
    rec["peak_bf16"] = float(cell.config["peak_bf16_flop_per_s"])
    rec["slice_counters"] = slices[0].counters if slices else None
    win = rec["window_counters"] = grown(at.get("setup", {}),
                                         at.get("window", {}))
    if "layers.cast_copies" in at.get("window", {}):
        h.log(f"window: layers.cast_copies +{win.get('layers.cast_copies', 0)}"
              f", layers.cast_bytes +{win.get('layers.cast_bytes', 0)}")
    else:
        h.log("window: the program counts no cast copies")
    if rec["slice_counters"] is not None:
        low, total = low_share(rec["slice_counters"])
        h.log(f"traced slice: {low} of {total} kernel launches through a "
              f"16-bit entry")
    return rec


def control(cell, args, h) -> dict:
    """The control of `correct` (`--control half`): the answers of the
    same sampled requests made by the serving reference with every part
    the configuration keeps above bfloat16 dropped to bfloat16
    (`serve.Lowered`), in the program's place, then compared as a run
    compares the program's."""
    if args.control != "half":
        raise SystemExit(
            f"--control {args.control}: a serving cell's control is "
            f"`half`. TF32 keeps 10 mantissa bits where this configuration "
            f"computes in bfloat16 (7): the reference with TF32 on is more "
            f"precise than the program, not the nearest precision below it.")
    torch, dev, cfg, mix = h.torch, h.device, cell.config, cell.traffic
    scale = int(cfg["scale"])
    pool = clips.lq_pool(args.seed, mix, scale)
    h_lq, w_lq = mix["lq_hw"]
    out_hw = (h_lq * scale, w_lq * scale)
    ns = clips.schedule(args.seed, mix, int(mix["max_requests"]))
    B = int(mix["batch"])

    def request(i):
        return pool[i % len(pool)], clips.times_of(ns[i], B)

    h.mark_setup()
    kept = {}
    due = clips.sampled(args.seed, cell.limits, ns)
    with reference.precise(torch):
        model = serve.build(cfg, dev)
        weights.load(model, args.seed, cfg["init"])
        lowered = serve.Lowered(model)
        for i in due:
            lq, t = request(i)
            frames, stats = serve.infer(lowered, lq, t, out_hw, scale,
                                        int(cfg["eval_chunk"]),
                                        int(cfg["eval_iters"]), dev)
            kept[i] = (frames.cpu().numpy(), stats)
        del model, lowered
    h.read_memory()
    h.free()
    checks, _ = compare(cell, types.SimpleNamespace(**dict(vars(args),
                                                           trace=0)),
                        h, kept, request, out_hw, ns, len(due))
    return {"setup_s": h.setup_s, "attempted": len(kept), "failed": 0,
            "checks": checks, "e2e": {}, "window_s": 0.0}
