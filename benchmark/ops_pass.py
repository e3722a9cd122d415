"""The traced run's pass over the program's three kernel ops: each call of
the module entries the models look up at call time (`softsplat.
splat_fused`, `dcn.dcn_v2`, `siren_kernel.siren_mlp`) runs between two
device synchronisations inside a span of its own (`op.<op>`), under the
profiler. Its bound is counted from the call's shapes, and its device time
is the sum of the device operations in the profile that fall inside its
span: with the device idle at both ends, every kernel there is the call's,
whatever kernels implement it, and the host's preamble and the gaps
between its launches are not counted. (The profiler's launch correlation
misses kernels launched through ctypes, so none is used.)"""

from __future__ import annotations

import contextlib
from unittest import mock

from benchmark.counts import bounds

OPS = ("splat", "dcn", "siren")


def _splat_bound(img, flow, z, z_nonpositive, *a, **kw):
    B, H, W, C = img.shape
    return bounds.splat_bound(B, H, W, C, bool(z_nonpositive))


def _dcn_bound(x, offset, mask, weight, bias, kernel_size=3, stride=1,
               padding=1, dilation=1, deformable_groups=1):
    B, H, W, Cin = x.shape
    Ho, Wo = offset.shape[1], offset.shape[2]
    return bounds.dcn_bound(B, H, W, Cin, Ho, Wo, weight.shape[0],
                            deformable_groups, kernel_size)


def _siren_bound(x, weights, biases, omega0=30.0, sine_last=False,
                 skip_first=False, packed=None):
    dims = [x.shape[-1]] + [w.shape[0] for w in weights]
    return bounds.siren_bound(x.numel() // x.shape[-1], dims, sine_last,
                              skip_first)


def span(op: str) -> str:
    return "op." + op


@contextlib.contextmanager
def wrapped(torch, calls: list, spans):
    """Patch the three entries; each call appends (op, bound ms) to `calls`
    and runs inside the span `op.<op>`, which opens once the device is idle
    and closes once it is idle again."""
    from motif_tpu_torch.ops import dcn, siren_kernel, softsplat

    cuda = torch.cuda.is_available()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def wrap(op, fn, bound_of):
        def call(*a, **kw):
            sync()
            with spans(span(op)):
                out = fn(*a, **kw)
                sync()
            calls.append((op, bound_of(*a, **kw)))
            return out
        return call

    splat = wrap("splat", softsplat.splat_fused, _splat_bound)
    with mock.patch.object(softsplat, "splat_fused", splat), \
            mock.patch.object(dcn, "dcn_v2",
                              wrap("dcn", dcn.dcn_v2, _dcn_bound)), \
            mock.patch.object(siren_kernel, "siren_mlp",
                              wrap("siren", siren_kernel.siren_mlp,
                                   _siren_bound)):
        yield


def op_times(calls: list, tr) -> dict:
    """{op: (summed bound ms, summed device ms, calls)}: the i-th span of an
    op in the trace `tr` is its i-th call. Without device operations (on the
    CPU) the device ms are 0."""
    from benchmark import trace

    out, seen = {}, {}
    spans = {op: sorted((s for s in tr.spans if s[0] == span(op)),
                        key=lambda s: s[1]) for op in OPS}
    for op, bound_ms in calls:
        i = seen[op] = seen.get(op, -1) + 1
        ms = 0.0
        if i < len(spans[op]):
            _, lo, hi = spans[op][i]
            ms = trace.device_us_within(tr, lo, hi) / 1e3
        b, d, n = out.get(op, (0.0, 0.0, 0))
        out[op] = (b + bound_ms, d + ms, n + 1)
    return out
