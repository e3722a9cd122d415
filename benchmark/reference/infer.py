"""A request as the eval protocol defines it, worked out by the reference:
the LQ zero-padded to multiples of 4, the target times in chunks (the last
padded by repeating its last time), one forward a chunk, the frames
cropped to the times asked for and the output size, and per chunk the
flow statistics mean |flow - flow_GT| and mean |flow|, averaged over the
chunks."""

from __future__ import annotations

import numpy as np
import torch

from .motif import MoTIF


def build(config: dict, device) -> MoTIF:
    net = config["network_G"]
    model = MoTIF(channel=int(net["nf"]), front_rbs=int(net["front_RBs"]),
                  back_rbs=int(net["back_RBs"]),
                  n_anchors=int(config["n_anchors"]),
                  setting=int(net.get("setting", 5)))
    return model.to(device).eval()


def chunks(times: np.ndarray, chunk: int) -> list:
    n = times.shape[1]
    out = []
    for start in range(0, n, chunk):
        t = times[:, start:start + chunk]
        if n > chunk and t.shape[1] < chunk:
            t = np.concatenate([t, np.repeat(t[:, -1:], chunk - t.shape[1],
                                             1)], 1)
        out.append(t)
    return out


@torch.no_grad()
def infer(model: MoTIF, lq: np.ndarray, times: np.ndarray, out_hw, scale: int,
          chunk: int, iters: int, device):
    """(frames (N, B, out_hw[0], out_hw[1], 3) on the device, (flow_err,
    flow_abs) as float64)."""
    B, N_in, h, w, _ = lq.shape
    h_n, w_n = -(-h // 4) * 4, -(-w // 4) * 4
    x = torch.zeros((B, N_in, h_n, w_n, 3), dtype=torch.float32,
                    device=device)
    x[:, :, :h, :w] = torch.as_tensor(lq, device=device)
    hw = (h_n * scale, w_n * scale)
    outs, stats = [], []
    for t in chunks(times, chunk):
        frames, flow, flow_gt = model(
            x, torch.as_tensor(np.asarray(t, np.float32), device=device), hw,
            iters=iters)
        outs.append(frames)
        stats.append([float((flow - flow_gt).abs().mean()),
                      float(flow.abs().mean())])
    frames = torch.cat(outs, 0)[:times.shape[1], :, :out_hw[0], :out_hw[1]]
    return frames, tuple(np.mean(np.asarray(stats, np.float64), 0))
