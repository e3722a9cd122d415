"""The parts MoTIF.head hands each site of `ops/preact.py`, at random
values of their dtypes, for the CPU tests and the card's."""

import numpy as np
import torch

from motif_tpu_torch.models.motif import liif_nearest_axis

BF, F32 = torch.bfloat16, torch.float32


def preact_inputs(site, n, N, lr_hw, hr_hw, ch, seed=0, device="cpu",
                  dtype=BF):
    """`preact`'s keyword arguments for `site` with n anchors, N times, one
    clip, `ch` features: the LR product `lr`, the take tables, the
    first-layer weight (64, fan_in) and bias, the HR channels (`rel`, the
    flow's first two of three, or the extras: count / 16, weights, max),
    the times and the dense HR term, made on the CPU from `seed`, in the
    types of bfloat16 compute, or with `dtype` float32 all float32 (the
    same values)."""
    (H, W), (HH, WW) = lr_hw, hr_hw
    g = torch.Generator().manual_seed(seed)

    def rnd(*s, scale=1.0, dtype=BF):
        return (torch.randn(s, generator=g) * scale).to(dtype)
    iy, rel_y = liif_nearest_axis(H, HH, 1e-6)
    ix, rel_x = liif_nearest_axis(W, WW, 1e-6)
    ry, rx = np.meshgrid(rel_y, rel_x, indexing="ij")
    rel = torch.as_tensor(np.stack([ry, rx], -1)[None]).to(BF)
    t = torch.rand((1, N), generator=g)
    a = dict(iy=torch.as_tensor(iy), ix=torch.as_tensor(ix))
    fan_in = 66 + ch + 3 + ch + 1
    if site == "stinf":
        a.update(lr=rnd(n, H, W, 64), w=rnd(64, ch + 3),
                 bias=rnd(64, scale=0.1), rep=N, hr=rel, col_hr=ch + 1,
                 t=t.reshape(N, 1, 1, 1).repeat(n, 1, 1, 1).to(BF), col_t=ch)
    elif site == "sinf":
        a.update(lr=rnd(n, H, W, 64), w=rnd(64, ch + 2),
                 bias=rnd(64, scale=0.1), hr=rel, col_hr=ch)
    elif site == "payload":
        flow_raw = torch.randn((n * N, HH, WW, 3), generator=g) * 0.3
        a.update(lr=rnd(n, H, W, 64), w=rnd(64, fan_in, scale=0.2, dtype=F32),
                 rep=N, dense=rnd(n, HH, WW, 64), hr=flow_raw[..., :2],
                 col_hr=64)
    else:
        extra = torch.cat([torch.rand((N, HH, WW, 1), generator=g),
                           torch.rand((N, HH, WW, 2), generator=g) * 2], -1)
        a.update(lr=rnd(N, H, W, 64), w=rnd(64, fan_in),
                 bias=rnd(64, scale=0.1),
                 dense=torch.randn((N, HH, WW, 64), generator=g), hr=extra,
                 col_hr=66 + ch, t=t.to(BF).reshape(N, 1, 1, 1),
                 col_t=66 + ch + 3 + ch)

    def put(v):
        if dtype == F32 and v.is_floating_point():
            v = v.to(F32)
        return v.to(device)
    a = {k: put(v) if torch.is_tensor(v) else v for k, v in a.items()}
    if site == "payload":     # a view of three channels, as MoTIF's
        a["hr"] = put(flow_raw)[..., :2]
    return a
