"""The kernels' launch counters as the tests read them: `obs.counters()`
under `obs.LAUNCHES`, by kernel and by `<kernel>/<entry>`."""

from motif_tpu_torch import obs
from motif_tpu_torch.ops.kernels import KERNELS


def by_kernel() -> dict:
    """The launches of each of `KERNELS` (0 until launched)."""
    counters = obs.counters()
    return {k: counters.get(obs.LAUNCHES + k, 0) for k in KERNELS}


def by_entry() -> dict:
    """The launches of each `<kernel>/<entry>` launched."""
    n = len(obs.LAUNCHES)
    return {k[n:]: v for k, v in obs.counters().items()
            if k.startswith(obs.LAUNCHES) and "/" in k}
