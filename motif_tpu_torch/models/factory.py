"""Model factory, the counterpart of motif_tpu/models/factory.py: the
reference networks.define_G dispatch from a yml's `network_G` section.

The port builds the `Ours` family (two anchors), the four-anchor
`Ours_44` / `Ours_4` at `setting: 5`, and the baselines: `LIIF`
(VideoINR), `ZSM` / `Zooming`, `TMNet`, `EDVR` and `Super_SloMo`. The
other MoTIF variants (other settings, Ours_7, Ours_flow) wait for
ROADMAP.md §A.8 and raise NotImplementedError.
"""

from __future__ import annotations

import torch

from motif_tpu_torch import resolve_device
from motif_tpu_torch.models.motif import build_motif

VARIANTS = ("Ours_7", "Ours_flow")
FOUR_ANCHOR = ("Ours_44", "Ours_4")
BASELINES = ("LIIF", "ZSM", "Zooming", "TMNet", "EDVR", "Super_SloMo")

# chunking behaviour per model family at eval time
# (VideoSR_base_model.py:172-197)
EVAL_CHUNK = {"Ours_44": 1, "Ours": 3}


def unported(which: str) -> str | None:
    """Why the port cannot build or evaluate family `which` yet, or None."""
    if which in VARIANTS:
        return f"[{which}] is a MoTIF variant not ported yet (ROADMAP.md §A.8)"
    return None


def build_baseline(opt: dict, device=None, seed: int = 0) -> torch.nn.Module:
    """The baseline of a `network_G` section, as the JAX package's
    define_g builds it (nf, groups, front_RBs, back_RBs; EDVR at nf 128
    unless set, `nframes` frames, TSA unless `with_tsa` is false; VideoINR
    for two LQ frames), with float32 random weights from `seed`, in eval
    mode, on `device` (CUDA unless the caller names another device)."""
    from motif_tpu_torch.models import baselines
    from motif_tpu_torch.models.videoinr import VideoINR

    which = opt["which_model_G"]
    nf = int(opt.get("nf") or 64)
    groups = int(opt.get("groups") or 8)
    front = int(opt.get("front_RBs") or 5)
    back = int(opt.get("back_RBs") or 40)
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if which == "LIIF":
            model = VideoINR(nf, front, back, groups)
        elif which in ("ZSM", "Zooming"):
            model = baselines.ZSM(nf, front, back, groups)
        elif which == "TMNet":
            model = baselines.TMNet(nf, front, back, groups)
        elif which == "EDVR":
            model = baselines.EDVR(
                int(opt.get("nf") or 128), int(opt.get("nframes") or 7),
                groups, front, back, bool(opt.get("with_tsa", True)))
        elif which == "Super_SloMo":
            model = baselines.SuperSloMo()
        else:
            raise NotImplementedError(f"Generator model [{which}] is not a "
                                      "baseline")
    return model.to(dev).eval()


def define_g(opt: dict, device=None) -> torch.nn.Module:
    """The model of a `network_G` section with random weights from seed 0,
    on `device` (CUDA unless the caller names another device): a MoTIF for
    Ours_* (four anchors for Ours_44 / Ours_4, two for every other), a
    baseline (`build_baseline`) for the baseline families.

    As in the JAX package, MoTIF's trunk has 5 front / 40 back residual
    blocks and the splat one channel group whatever `front_RBs`, `back_RBs`
    and `groups` say; `nf` sets the width. The serving knobs are read as the
    JAX package reads them (`fused_decode`, `compute_dtype`, `splat_dtype`,
    `raft_resolution`, `decode_chunks`). `splat_method` is ignored: the port
    has one splat kernel."""
    which = opt.get("which_model_G") or "Ours"
    nf = int(opt.get("nf") or 64)
    setting = int(opt.get("setting") or 5)
    reason = unported(which)
    if reason:
        raise NotImplementedError(f"Generator model {reason}")
    if which in BASELINES:
        return build_baseline(opt, device)
    if not which.startswith("Ours"):
        raise NotImplementedError(f"Generator model [{which}] not recognized")
    if setting != 5:
        raise NotImplementedError(f"MoTIF setting {setting}: the port has "
                                  "setting 5 only (ROADMAP.md §A.8)")
    return build_motif(
        channel=nf, device=device, seed=0,
        n_anchors=4 if which in FOUR_ANCHOR else 2,
        fused_decode=bool(opt.get("fused_decode") or False),
        compute_dtype=opt.get("compute_dtype") or None,
        splat_dtype=opt.get("splat_dtype") or None,
        raft_resolution=float(opt.get("raft_resolution") or 1.0),
        decode_chunks=int(opt.get("decode_chunks") or 1))
