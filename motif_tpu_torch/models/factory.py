"""Model factory, the counterpart of motif_tpu/models/factory.py: the
reference networks.define_G dispatch from a yml's `network_G` section.

The port builds the `Ours` family (two anchors) and the four-anchor
`Ours_44` / `Ours_4` at `setting: 5`. The other MoTIF variants (other
settings, Ours_7, Ours_flow) wait for ROADMAP.md §A.8 and the baselines
(LIIF, ZSM, Zooming, TMNet, EDVR, Super_SloMo) for §A.9; each raises
NotImplementedError.
"""

from __future__ import annotations

from motif_tpu_torch.models.motif import MoTIF, build_motif

VARIANTS = ("Ours_7", "Ours_flow")
FOUR_ANCHOR = ("Ours_44", "Ours_4")
BASELINES = ("LIIF", "ZSM", "Zooming", "TMNet", "EDVR", "Super_SloMo")

# chunking behaviour per model family at eval time
# (VideoSR_base_model.py:172-197)
EVAL_CHUNK = {"Ours_44": 1, "Ours": 3}


def unported(which: str) -> str | None:
    """Why the port cannot build or evaluate family `which` yet, or None."""
    if which in BASELINES:
        return f"[{which}] is a baseline, not ported yet (ROADMAP.md §A.9)"
    if which in VARIANTS:
        return f"[{which}] is a MoTIF variant not ported yet (ROADMAP.md §A.8)"
    return None


def define_g(opt: dict, device=None) -> MoTIF:
    """The MoTIF of a `network_G` section (four anchors for Ours_44 /
    Ours_4, two for every other Ours_*), with random weights from seed 0
    (`build_motif`), on `device` (CUDA unless the caller names another
    device).

    As in the JAX package, the trunk has 5 front / 40 back residual blocks
    and the splat one channel group whatever `front_RBs`, `back_RBs` and
    `groups` say; `nf` sets the width. The serving knobs are read as the JAX
    package reads them (`fused_decode`, `compute_dtype`, `splat_dtype`,
    `raft_resolution`, `decode_chunks`). `splat_method` is ignored: the port
    has one splat kernel."""
    which = opt.get("which_model_G") or "Ours"
    nf = int(opt.get("nf") or 64)
    setting = int(opt.get("setting") or 5)
    reason = unported(which)
    if reason:
        raise NotImplementedError(f"Generator model {reason}")
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
