"""Precompute the Vimeo-90K flow files a four-anchor MoTIF trains on
(`hr_gt_flow.npy` / `lr_flow_12.npy`, read by Vimeo7_dataset.py:143,152),
the counterpart of tools/precompute_flows.py: the same files, layout and
formulas, with the port's RAFT-small:

    python -m motif_tpu_torch.precompute_flows --gt_root data/vimeo/GT \\
        --lq_root data/vimeo/LR --keys data/vimeo/keys.txt \\
        [--checkpoint best.pth|orbax_dir] [--iters 12] [--overwrite] [--device cpu]

Written per clip `<a>/<b>` of `--keys` (a .txt of a/b lines or a .pkl of
a_b keys), channel-first float32:
  LR_root/<a>/<b>/lr_flow_12.npy : (16, 2, h, w)  flow anchor_i -> anchor_j
      over the LR frames im1, im3, im5, im7 in i*4+j order: the frames
      resized bilinearly to the GT size, RAFT on all 16 pairs there, the
      flow resized back to LR and scaled by h/H, the self-pairs zeroed
      (the model's own live procedure, Ours.py:540-554);
  GT_root/<a>/<b>/hr_gt_flow.npy : (28, 2, H, W)  flow anchor_a -> frame_t
      over the GT frames im1..im7, t-major (row t*4+a; the loader reshapes
      it to (7, 4, 2, H, W)).

RAFT's weights come from a reference-format `.pth` (a whole model's
`flow_predictor.*` keys or a bare RAFT's keys) or from the JAX package's
orbax directory of a RAFT params tree, as its tool takes one
(`checkpoint.load_checkpoint`); without `--checkpoint` it
is a RAFT with random weights from seed 0, good for smoke runs only, with
the JAX tool's warning. A clip whose two files exist is skipped unless
`--overwrite`. RAFT runs on CUDA unless `--device` names another device.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np
import torch

ANCHORS = (1, 3, 5, 7)           # the septuplet's im1, im3, im5, im7


def raft_state_dict(path: str) -> dict:
    """RAFT's weights from a reference-format `.pth`
    (`checkpoint.reference_state_dict`), a whole model's `flow_predictor.`
    prefix stripped and its other keys left out."""
    from motif_tpu_torch.checkpoint import reference_state_dict

    sd = reference_state_dict(path)
    prefix = "flow_predictor."
    if any(k.startswith(prefix) for k in sd):
        sd = {k[len(prefix):]: v for k, v in sd.items()
              if k.startswith(prefix)}
    return sd


def build_raft(checkpoint: str | None, device) -> torch.nn.Module:
    """The port's RAFT-small in eval mode on `device`: strictly loaded from
    `checkpoint`, else random weights from seed 0 (with a warning)."""
    from motif_tpu_torch.checkpoint import load_checkpoint
    from motif_tpu_torch.models.raft import RAFT

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        raft = RAFT()
    if checkpoint and os.path.isdir(checkpoint):
        # motif_tpu's orbax directory of RAFT's params tree, as its
        # tools/precompute_flows.py takes one
        load_checkpoint(raft, checkpoint)
    elif checkpoint:
        raft.load_state_dict(raft_state_dict(checkpoint), strict=True)
    else:
        print("WARNING: no --checkpoint given; using a randomly "
              "initialized RAFT (smoke-test flows only)")
    return raft.to(device).eval()


@torch.inference_mode()
def clip_flows(raft, lqs: np.ndarray, gts: np.ndarray, iters: int = 12,
               device=None) -> tuple[np.ndarray, np.ndarray]:
    """lqs (4, h, w, 3): the LR anchors; gts (7, H, W, 3): the GT frames,
    in [0, 1], in RAFT's dtype. Returns (lr_flow (16, 2, h, w), hr_flow
    (28, 2, H, W)), channel-first as the files hold them, in that dtype."""
    from motif_tpu_torch.ops.resize import interpolate_bilinear

    dev = device or next(raft.parameters()).device
    lq = torch.as_tensor(lqs, device=dev)
    gt = torch.as_tensor(gts, device=dev)
    h, w = lq.shape[1:3]
    HH, WW = gt.shape[1:3]

    lq_hr = interpolate_bilinear(lq, (HH, WW))
    src = lq_hr.repeat_interleave(4, 0)           # row i*4+j: anchor i
    dst = lq_hr.repeat(4, 1, 1, 1)                # ... -> anchor j
    lr = raft(src * 255.0, dst * 255.0, iters=iters)
    lr = interpolate_bilinear(lr, (h, w)) * (h / HH)
    lr[torch.arange(4, device=dev) * 5] = 0.0      # the self-pairs i*4+i

    anchors = gt[[a - 1 for a in ANCHORS]]
    src = anchors.repeat(7, 1, 1, 1)              # row t*4+a: anchor a
    dst = gt.repeat_interleave(4, 0)              # ... -> frame t
    hr = raft(src * 255.0, dst * 255.0, iters=iters)
    return (lr.permute(0, 3, 1, 2).cpu().numpy(),
            hr.permute(0, 3, 1, 2).cpu().numpy())


def main(argv: list[str] | None = None) -> int:
    """The CLI; returns the number of clips written."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--gt_root", required=True)
    p.add_argument("--lq_root", required=True)
    p.add_argument("--keys", required=True,
                   help=".txt (a/b per line) or Vimeo7_train_keys.pkl")
    p.add_argument("--checkpoint", default=None,
                   help="reference-format .pth holding RAFT's weights")
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: CUDA)")
    args = p.parse_args(argv)

    from motif_tpu_torch import resolve_device
    from motif_tpu_torch.data.datasets import load_keys, read_img

    dev = resolve_device(args.device)
    raft = build_raft(args.checkpoint, dev)
    written = 0
    for key in load_keys(args.keys):
        a, b = key.split("_")
        gt_dir = osp.join(args.gt_root, a, b)
        lq_dir = osp.join(args.lq_root, a, b)
        lr_out = osp.join(lq_dir, "lr_flow_12.npy")
        hr_out = osp.join(gt_dir, "hr_gt_flow.npy")
        if not args.overwrite and osp.exists(lr_out) and osp.exists(hr_out):
            continue
        lqs = np.stack([read_img(osp.join(lq_dir, f"im{i}.png"))
                        for i in ANCHORS], 0)
        gts = np.stack([read_img(osp.join(gt_dir, f"im{i}.png"))
                        for i in range(1, 8)], 0)
        lr_flow, hr_flow = clip_flows(raft, lqs, gts, args.iters, dev)
        np.save(lr_out, lr_flow.astype(np.float32))
        np.save(hr_out, hr_flow.astype(np.float32))
        written += 1
        print(f"{key}: wrote {lr_out} {lr_flow.shape} and {hr_out} "
              f"{hr_flow.shape}")
    return written


if __name__ == "__main__":
    main()
