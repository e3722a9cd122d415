"""The reference of a serving configuration: the frozen MoTIF of `motif.py`
built with the configuration's serving knobs (`fused_decode`,
`compute_dtype`, `splat_dtype`, `raft_resolution`, `decode_chunks`), its
three kernel ops run in their working types by `lowp.py`, and a request
worked out by `infer.py`'s plan. Nothing of `motif.py` or `plain.py` is
copied or edited: the frozen modules call `plain.dcn_v2`,
`plain.siren_mlp` and `plain.splat_fused` by name at each call, and
`ops()` puts `lowp.py`'s ops in their place for the block (each runs the
plain op on float32 tensors). TF32 stays off for the float32 parts, as
`reference.precise` sets it.

`Lowered` is the control of `correct` for such a configuration: the
same reference with every part that the configuration keeps above
bfloat16 dropped to bfloat16: the frames go in as bfloat16 with no
compute dtype, so the flow, the reliability metrics, the splat's inputs
and the decode run in bfloat16, the splat's sums are bfloat16, and RAFT's
coordinates are bfloat16 (`_raft_forward_lowered`, a copy of
`raft.RAFT.forward` with its coordinates in the images' type). RAFT's
norm statistics and correlation volume stay float32 (the frozen modules
widen them whatever the input).
"""

from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np
import torch
from torch import nn

from . import lowp, plain
from .motif import MoTIF
from .raft import RAFT, coords_grid, upflow8
from .corr import corr_lookup, corr_pyramid, all_pairs_corr
# the request's plan, bound here: a caller may put `infer` in its place
from .infer import infer as _plan

KNOBS = ("fused_decode", "compute_dtype", "splat_dtype", "raft_resolution",
         "decode_chunks")


def knobs(config: dict) -> dict:
    """The serving knobs that the configuration's `network_G` names."""
    net = config["network_G"]
    return {k: net[k] for k in KNOBS if k in net}


def build(config: dict, device) -> MoTIF:
    """The reference MoTIF of the configuration with its serving knobs, in
    eval mode on `device`; float32 parameters (the program's weights load
    into it as into `infer.build`'s). On a card its convolution weights
    take the channels_last memory format, as the program's do, so that
    cuDNN picks the program's algorithm for each bfloat16 convolution: the
    same arithmetic, and none of another summation order's roundings in
    the comparison."""
    net = config["network_G"]
    model = MoTIF(channel=int(net["nf"]), front_rbs=int(net["front_RBs"]),
                  back_rbs=int(net["back_RBs"]),
                  n_anchors=int(config["n_anchors"]),
                  setting=int(net.get("setting", 5)), **knobs(config))
    model = model.to(device).eval()
    if torch.device(device).type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


@contextlib.contextmanager
def ops():
    """`lowp.py`'s three ops in `plain`'s place for the block."""
    with mock.patch.object(plain, "dcn_v2", lowp.dcn_v2), \
            mock.patch.object(plain, "siren_mlp", lowp.siren_mlp), \
            mock.patch.object(plain, "splat_fused", lowp.splat_fused):
        yield


@torch.no_grad()
def infer(model: nn.Module, lq: np.ndarray, times: np.ndarray, out_hw,
          scale: int, chunk: int, iters: int, device):
    """`infer.infer` with the low-precision ops: (frames (N, B, out_hw[0],
    out_hw[1], 3) float32 on the device, (flow_err, flow_abs) float64)."""
    with ops():
        return _plan(model, lq, times, out_hw, scale, chunk, iters, device)


def _raft_forward_lowered(self, image1, image2, iters: int = 12):
    """`raft.RAFT.forward` with its coordinates in the images' type (the
    frozen forward keeps them in at least float32)."""
    img1 = 2.0 * (image1 / 255.0) - 1.0
    img2 = 2.0 * (image2 / 255.0) - 1.0
    B = img1.shape[0]
    fmaps = self.fnet(torch.cat([img1, img2], dim=0))
    fmap1, fmap2 = fmaps[:B], fmaps[B:]
    pyramid = corr_pyramid(all_pairs_corr(fmap1, fmap2), self.corr_levels)
    c = self.cnet(img1)
    net = torch.tanh(c[..., :self.hidden_dim])
    inp = torch.relu(c[..., self.hidden_dim:])
    H8, W8 = fmap1.shape[1], fmap1.shape[2]
    coords0 = coords_grid(B, H8, W8, img1.device).to(img1.dtype)
    coords1 = coords0
    for _ in range(iters):
        corr = corr_lookup(pyramid, coords1, self.corr_radius).to(img1.dtype)
        flow = coords1 - coords0
        net, delta = self.update_block(net, inp, corr, flow)
        coords1 = coords1 + delta.to(img1.dtype)
    return upflow8(coords1 - coords0)


class Lowered(nn.Module):
    """The control's model: `model` (the configuration's reference, its
    weights loaded) with no compute dtype and the frames in bfloat16 (see
    the module's note), run through `infer`, whose splat then sums in
    bfloat16; its outputs widened to float32."""

    def __init__(self, model: MoTIF):
        super().__init__()
        kn = model.knobs()
        kn.update(compute_dtype=None, splat_dtype=None)
        self.model = model.configure(**kn)

    def forward(self, x, target_t, out_hw, iters: int = 12):
        with mock.patch.object(RAFT, "forward", _raft_forward_lowered):
            out = self.model(x.to(lowp.BF16), target_t.to(lowp.BF16), out_hw,
                             iters=iters)
        return tuple(o.float() for o in out)
