"""The bound arithmetic copied into the benchmark reproduces the bounds
the repository's kernel table was measured against, and FlopCounterMode
counts a convolution and a linear layer as a hand count does."""

import pytest
import torch

from benchmark.counts import bounds
from benchmark.counts.flops import counting


def test_splat_bound_request_a():
    # 6 x 256 x 448 x 130, the max skipped: 0.2177 ms (bytes)
    assert bounds.splat_bound(6, 256, 448, 130, True) == pytest.approx(
        0.2177, abs=5e-5)


def test_dcn_im2col_bound_level_1():
    # L1: 2 x 64 x 112, G 8, cg 8, K 3: 0.0147 ms (bytes)
    assert bounds.dcn_im2col_bound(2, 64, 112, 8, 8, 64, 112, 3) == \
        pytest.approx(0.0147, abs=5e-5)


def test_siren_bound_stinf():
    # STINF over 688,128 tokens, 67 -> 64 -> 64 -> 256 -> 3: 0.5324 ms
    assert bounds.siren_bound(688128, [67, 64, 64, 256, 3], False,
                              False) == pytest.approx(0.5324, abs=5e-5)


def test_dcn_bound_counts_the_whole_op():
    # the contraction alone is 2 * Q * K*K*Cin * Cout operations
    q, kkc, cout = 2 * 64 * 112, 9 * 64, 64
    ops = 2 * q * kkc * cout + q * kkc * 9
    assert bounds.dcn_bound(2, 64, 112, 64, 64, 112, 64, 8, 3) >= \
        ops / bounds.FP32_FLOP_PER_S * 1e3 - 1e-12


def test_flop_counter_conv_and_linear():
    conv = torch.nn.Conv2d(8, 16, 3, padding=1)
    lin = torch.nn.Linear(32, 24)
    x, y = torch.randn(2, 8, 10, 12), torch.randn(5, 32)
    with counting() as c:
        conv(x)
    assert c["flops"] == 2 * (2 * 10 * 12) * (8 * 9) * 16
    with counting() as c:
        lin(y)
    assert c["flops"] == 2 * 5 * 32 * 24
