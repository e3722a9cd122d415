"""The least time the card could take for one call of each kernel op when
its data are 16-bit: the largest of three times (H100 SXM, NVIDIA's data
sheet): the bytes, each tensor at its own element size, over 3.35 TB/s;
the tensor cores' products (2 operations a multiply-add of bfloat16
operands) over 989 TFLOP/s dense; and the rest of the work (the sines,
the bilinear taps, the splat's products and sums), counted as `bounds.py`
counts it, over 67 TFLOP/s in float32 outside the tensor cores. With
4-byte data nothing runs on the tensor cores, and each bound is
`bounds.py`'s.

Where this departs from `chip_smoke.py`'s arithmetic (the kernel table's
bounds): the smoke adds a bfloat16 SIREN's sines to its products at the
tensor cores' rate; here they are work of their own at the float32 rate,
and the larger time bounds the call (STINF's bfloat16 bound 0.0355 ms
against the smoke's 0.0361).
"""

from __future__ import annotations

from benchmark.counts import bounds

TC_FLOP_PER_S = 989e12     # dense bfloat16 on the tensor cores


def bound(nbytes: float, tc_flops: float, other_flops: float) -> float:
    """Milliseconds: max(bytes / rate, tensor-core operations / their
    peak, other operations / the float32 peak)."""
    return max(nbytes / bounds.HBM_BYTES_PER_S, tc_flops / TC_FLOP_PER_S,
               other_flops / bounds.FP32_FLOP_PER_S) * 1e3


def splat_bound(B, H, W, C, nonpos, elem: int = 4) -> float:
    """The softmax splat with inputs and results of `elem` bytes: its sums
    (float32 or float16) live in the kernel's shared memory and are not
    read or written through memory, and nothing runs on the tensor cores,
    so it is `bounds.splat_bound`."""
    return bounds.splat_bound(B, H, W, C, nonpos, elem)


def dcn_bound(B, H, W, Cin, Ho, Wo, Cout, G, K, elem: int = 4) -> float:
    """The whole modulated deformable convolution with x, the offsets, the
    mask, the weights, the bias and the output of `elem` bytes: each read
    or written once; the taps (4 multiply-adds and the mask a channel) in
    float32; the contraction's 2 * K*K*Cin*Cout a pixel on the tensor cores
    when the data are 2-byte."""
    q = B * Ho * Wo
    nbytes = elem * (B * H * W * Cin + q * G * K * K * 3 + Cout * Cin * K * K
                     + Cout + q * Cout)
    taps = q * K * K * Cin * (4 * 2 + 1)
    contraction = 2 * q * K * K * Cin * Cout
    if elem == 2:
        return bound(nbytes, contraction, taps)
    return bound(nbytes, 0, taps + contraction)


def siren_bound(n_tok, dims, sine_last, skip_first, elem: int = 4) -> float:
    """An MLP of widths `dims` over `n_tok` tokens with `elem`-byte tokens,
    weights and result: each read or written once; its products on the
    tensor cores when the data are 2-byte; 2 operations a sine."""
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    sines = (sum(dims[1:-1]) + (dims[-1] if sine_last else 0)
             + (dims[0] if skip_first else 0))
    nbytes = elem * (n_tok * (dims[0] + dims[-1]) + sum(
        (a + 1) * b for a, b in zip(dims[:-1], dims[1:])))
    if elem == 2:
        return bound(nbytes, n_tok * 2 * macs, n_tok * 2 * sines)
    return bound(nbytes, 0, n_tok * (2 * macs + 2 * sines))
