"""Tensor ops of the port: resize, warp, RAFT correlation, the DCN sampler,
the forward splat and the fused SIREN (the last three with CUDA kernels,
see `kernels`)."""
