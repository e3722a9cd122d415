"""The least time the card could take for one call of each kernel op,
from the call's shapes: the larger of its bytes over the memory rate and
its operations over the peak (H100 SXM, NVIDIA's data sheet: 3.35 TB/s,
67 TFLOP/s in float32 outside the tensor cores). Each input byte is read
once and each output byte written once, whatever the kernel reads again.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound(nbytes: float, flops: float, peak: float = FP32_FLOP_PER_S,
          rate: float = HBM_BYTES_PER_S) -> float:
    """Milliseconds: max(bytes / rate, operations / peak)."""
    return max(nbytes / rate, flops / peak) * 1e3


def splat_bound(B, H, W, C, nonpos, elem: int = 4) -> float:
    """The softmax splat of B images H x W with C payload channels: img,
    flow and e^z read once, the sums (C + 2 channels: payload, weights,
    count) written once, and z_max when the max runs; per pixel C + 1
    payload values times 4 corners' multiply-adds and 4 weights."""
    n = B * H * W
    nbytes = elem * n * (C + 3 + C + 2 + (0 if nonpos else 1))
    flops = n * ((C + 1) * (1 + 4 * 2) + 4) + (0 if nonpos else n * 8)
    return bound(nbytes, flops)


def dcn_bound(B, H, W, Cin, Ho, Wo, Cout, G, K, elem: int = 4) -> float:
    """The whole modulated deformable convolution: x, the offsets, the mask
    and the weights read once, the output written once; per output pixel,
    group and tap a bilinear sample of cg channels (4 multiply-adds each)
    times the mask, and the contraction's 2 * K*K*Cin*Cout."""
    q = B * Ho * Wo
    nbytes = elem * (B * H * W * Cin + q * G * K * K * 3 + Cout * Cin * K * K
                     + Cout + q * Cout)
    flops = q * K * K * Cin * (4 * 2 + 1) + 2 * q * K * K * Cin * Cout
    return bound(nbytes, flops)


def siren_bound(n_tok, dims, sine_last, skip_first, elem: int = 4) -> float:
    """An MLP of widths `dims` over `n_tok` tokens: x read once, the result
    written once, the weights and biases read once; 2 flops a multiply-add
    and a sine."""
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    sines = (sum(dims[1:-1]) + (dims[-1] if sine_last else 0)
             + (dims[0] if skip_first else 0))
    nbytes = elem * (n_tok * (dims[0] + dims[-1]) + sum(
        (a + 1) * b for a, b in zip(dims[:-1], dims[1:])))
    return bound(nbytes, n_tok * (2 * macs + 2 * sines))


def dcn_im2col_bound(B, H, W, G, cg, Ho, Wo, K, elem: int = 4) -> float:
    """The im2col half of the deformable convolution alone: x, the offsets
    and the mask read once, the columns written once."""
    Q = Ho * Wo * K * K
    nbytes = elem * (B * H * W * G * cg + B * Ho * Wo * G * K * K * 3
                     + B * Ho * Wo * G * K * K * cg)
    return bound(nbytes, B * G * Q * (cg * 9 + 20))
