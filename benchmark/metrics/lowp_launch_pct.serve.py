"""Kernels of a serving cell: the share of the launches of `splat_fused`,
`dcn_im2col` and `siren_mlp` over the traced slice that went through a
bfloat16 or float16 entry, from the program's counters
`kernels.launches.<kernel>/<entry>` (each graph's tape counted per
replay), in percent. A serving path that falls back to a float32 entry
lowers it."""


def read(rec):
    from benchmark.traffic.clips_serve import low_share

    low, total = low_share(rec.get("slice_counters") or {})
    return 100.0 * low / total if total else None
