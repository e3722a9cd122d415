"""Tensor ops of the port: resize, warp, RAFT and PWC-Net correlation, the
DCN sampler, the forward splat and the fused SIREN (the last three with
CUDA kernels, see `kernels`). The names below are those that
motif_tpu/ops/__init__.py exports; all are NHWC, a flow's last axis is
(u, v) in pixels."""

from motif_tpu_torch.ops.warp import (  # noqa: F401
    grid_sample,
    backwarp,
    bilinear_sampler,
    flow_warp,
)
from motif_tpu_torch.ops.resize import (  # noqa: F401
    interpolate_bilinear,
    resize_matrix_linear,
    imresize_matlab,
    avg_pool2d,
)
from motif_tpu_torch.ops.softsplat import (  # noqa: F401
    splat_sum,
    splat_max,
    splat_count,
    softmax_splat,
)
from motif_tpu_torch.ops.dcn import dcn_v2  # noqa: F401
from motif_tpu_torch.ops.corr import (  # noqa: F401
    all_pairs_corr,
    corr_pyramid,
    corr_lookup,
    local_corr,
)
