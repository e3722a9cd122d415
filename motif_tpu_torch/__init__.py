"""motif_tpu_torch — MoTIF (the two-anchor Ours and the four-anchor
Ours_44 / Ours_4) in PyTorch, served, evaluated and trained, and the
baselines it is compared against (VideoINR, ZSM, TMNet, EDVR, Super-SloMo)
served and evaluated, with hand-written CUDA kernels for Hopper (sm_90a).

It mirrors `motif_tpu`'s module layout (`models/`, `ops/`, `data/`,
`checkpoint.py`, `eval.py`, `trainer.py`) and is held against that package
by the tests. It imports neither JAX nor `motif_tpu`. Public functions
keep `motif_tpu`'s NHWC layout; convolutions run NCHW views of the same
memory (channels_last).

Entry points (`models.motif.build_motif`, `eval.Evaluator`, the CLIs
`test`, `train` and `precompute_flows`) run on CUDA unless the caller
passes ``device="cpu"``; without CUDA they raise. On CPU
tensors each kernel wrapper runs its plain PyTorch version; on CUDA tensors
it launches its kernel or raises.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The entry-point device rule: CUDA unless the caller names another
    device. Asking for (or defaulting to) CUDA without a usable card raises
    instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "motif_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev
