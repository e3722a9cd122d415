"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and `nvcc` (marked `cuda`; skipped
where torch.cuda.is_available() is false). The file imports neither JAX nor
motif_tpu, so it runs on a GPU machine without them (`--noconftest`: the
suite's conftest.py sets up JAX):

    python -m pytest -q -m cuda --noconftest tests/test_torch_kernels.py

TF32 is off for the plain versions' matrix products and convolutions.
Every entry of a kernel is covered: float32 and bfloat16 for the DCN im2col
and the SIREN, the SIREN whole and from its first layer's pre-activation,
the splat with float32 and float16 sums at its compiled widths (130, 64)
and a generic one; each also replayed from a CUDA graph. The eval harness
(Evaluator.run on a data/Vid4 clip) is held against its plain versions on
the card and against the CPU; Evaluator.infer's captured graphs against
the eager forward, and a replayed request under the sync debug mode.
"""

import contextlib
import copy
import pathlib
from unittest import mock

import numpy as np
import pytest
import torch

from motif_tpu_torch.models.siren import hidden_bound
from motif_tpu_torch.ops import dcn, kernels, siren_kernel, softsplat

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def ulp_at(scale: float, bits: int) -> float:
    """One unit in the last place at magnitude `scale` of a type with
    `bits` stored mantissa bits (bfloat16 7, float16 10)."""
    return 2.0 ** (np.floor(np.log2(scale)) - bits)


def _replayed(fn, static, updates):
    """fn() captured in a CUDA graph after a warm-up, then replayed after
    each of `updates` (lists of tensors copied into `static` in place);
    yields the captured outputs after each replay."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn()
    for new in updates:
        for s_, t in zip(static, new):
            s_.copy_(t)
        graph.replay()
        torch.cuda.synchronize()
        yield outs


def _launches(name, fn):
    before = kernels.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.LAUNCHES[name] - before


def _splat_inputs(dev, case):
    """img, flow, z for one splat case."""
    B, H, W, C = {"c130": (3, 40, 56, 130), "c5-ragged": (2, 37, 45, 5),
                  "c1000": (2, 12, 21, 1000), "c64": (3, 40, 56, 64),
                  "c64-ragged": (2, 37, 45, 64),
                  "c64-tile16": (2, 24, 40, 64),
                  "c64-converging": (2, 21, 35, 64)}.get(case,
                                                         (2, 21, 35, 130))
    g = torch.Generator(device=dev).manual_seed(0)
    img = torch.randn((B, H, W, C), device=dev, generator=g)
    z = torch.randn((B, H, W, 1), device=dev, generator=g) * 0.5
    flow = torch.randn((B, H, W, 2), device=dev, generator=g) * 3.0
    flow[0, 0, :, 1] = -30.0                     # a row thrown off the top
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    pos = torch.stack([xs, ys], -1).float()
    if case == "zero":
        flow = torch.zeros_like(flow)
    elif case == "integer":                      # zero-weight corners
        flow = torch.randint(-17, 18, flow.shape, device=dev,
                             generator=g).float()
    elif case.endswith("converging"):            # most pixels into one tile
        target = torch.tensor([20.0, 9.0], device=dev)
        spread = torch.rand(flow.shape, device=dev, generator=g)
        flow = target - pos + spread * torch.tensor([14.0, 6.0], device=dev)
        flow[1, :3] = torch.randn((3, W, 2), device=dev, generator=g)
    elif case == "off-image":
        flow = flow + torch.tensor([0.0, 1e3], device=dev)
    elif case == "non-finite":
        bad = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e6,
                            -1e6, 3e38], device=dev)
        pick = torch.randint(0, 12, flow.shape, device=dev, generator=g)
        flow = torch.where(pick < 6, bad[pick.clamp(max=5)], flow)
    return img, flow, z


SPLAT_CASES = ["c130", "c5-ragged", "c1000", "zero", "integer",
               "converging", "off-image", "non-finite", "c64", "c64-ragged",
               "c64-tile16", "c64-converging"]


@pytest.mark.parametrize("z_nonpositive", [True, False])
@pytest.mark.parametrize("case", SPLAT_CASES)
def test_splat_fused(dev, case, z_nonpositive):
    """The binned kernel against the plain version: C = 130 and C = 64
    (specialised) and C = 5 (generic) at H, W that are not tile multiples
    (C = 64 also at multiples of 8 but not of 16), C = 1000 (a
    smaller tile, warps that take several channel groups), B > 1
    throughout; zero and integer flows (corners of
    weight 0 on tile borders still count), converging flows, everything
    thrown off the image, and NaN / inf / huge entries, which are dropped.
    z <= 0 with the max skipped, and z of both signs with the max. One
    launch per call either way. Shared atomics sum in a varying order:
    atol 1e-4 on out / norm; z_max and the count exact."""
    img, flow, z = _splat_inputs(dev, case)
    if z_nonpositive:
        z = -z.abs()
    got, n = _launches("splat_fused", lambda: softsplat.splat_fused(
        img, flow, z, z_nonpositive=z_nonpositive))
    assert n == 1
    want = softsplat.splat_fused_plain(img, flow, z, z_nonpositive)
    for a, b in zip(got, want):
        assert a.shape == b.shape
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=0)
    if case == "off-image":
        assert not got[3].any() and (got[2] == 1.0).all()
    elif case.endswith("converging"):
        assert got[3].max() >= 20          # ~28 corner hits per target


@pytest.mark.parametrize("z_nonpositive", [True, False])
@pytest.mark.parametrize("case", SPLAT_CASES)
def test_splat_fused_float16_sums(dev, case, z_nonpositive):
    """The float16-sum entry against the plain version with float16 sums,
    on the float32 entry's cases. The kernel sums a tile's list in an order
    that varies from run to run and the plain version sums each corner
    kind on its own, so out / norm agree to 4 float16 ulps of the largest
    value (16 for the converging flow's ~28-term sums); the count (small
    integers, exact in float16) and the float32 max are exact. The results
    are float32."""
    img, flow, z = _splat_inputs(dev, case)
    if z_nonpositive:
        z = -z.abs()
    got, n = _launches("splat_fused", lambda: softsplat.splat_fused(
        img, flow, z, z_nonpositive, scatter_dtype=torch.float16))
    assert n == 1
    want = softsplat.splat_fused_plain(img, flow, z, z_nonpositive,
                                       scatter_dtype=torch.float16)
    ulps = 16 if case.endswith("converging") else 4
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == torch.float32 and a.shape == b.shape
        tol = ulps * ulp_at(max(float(b.abs().max()), 1e-3), 10)
        torch.testing.assert_close(a, b, rtol=0, atol=tol)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=0)
    if case in ("c130", "c64"):
        full = softsplat.splat_fused(img, flow, z, z_nonpositive)
        assert not torch.equal(got[0], full[0])   # really float16 sums
        torch.testing.assert_close(got[0], full[0], rtol=0, atol=5e-2)


def test_splat_fused_float16_replays_from_a_cuda_graph(dev):
    """The float16-sum entry replayed from a CUDA graph on new inputs:
    count and z_max exact, out / norm to 4 float16 ulps of the largest
    value (the summation order varies between runs)."""
    img, flow, z = _splat_inputs(dev, "c64")
    static = [t.clone() for t in (img, flow, z)]
    runs = _replayed(lambda: softsplat.splat_fused(
        *static, z_nonpositive=False, scatter_dtype=torch.float16), static,
        [(img, flow * sc, z) for sc in (1.0, 2.5)])
    for sc, outs in zip((1.0, 2.5), runs):
        want = softsplat.splat_fused(img, flow * sc, z, z_nonpositive=False,
                                     scatter_dtype=torch.float16)
        for a, b in zip(outs[:2], want[:2]):
            tol = 4 * ulp_at(float(b.abs().max()), 10)
            torch.testing.assert_close(a, b, rtol=0, atol=tol)
        for a, b in zip(outs[2:], want[2:]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("sdt", [None, torch.float16])
@pytest.mark.parametrize("z_nonpositive", [True, False])
def test_splat_fused_c64_integer_flow_is_bit_equal(dev, sdt, z_nonpositive):
    """A flow that permutes each image's pixels (integer offsets, some
    long): every target is corner (0, 0) of exactly one source, weight 1,
    and gets weight-0 corners of others, so each sum has one nonzero term
    and no order can change it. The C = 64 entries are then bit-equal to
    the plain version, with float32 and float16 sums, max or not."""
    img, _, z = _splat_inputs(dev, "c64-ragged")
    B, H, W, _ = img.shape
    if z_nonpositive:
        z = -z.abs()
    g = torch.Generator(device=dev).manual_seed(3)
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    pos = torch.stack([xs, ys], -1).reshape(H * W, 2).float()
    flow = torch.stack([pos[torch.randperm(H * W, device=dev, generator=g)]
                        - pos for _ in range(B)]).reshape(B, H, W, 2)
    got, n = _launches("splat_fused", lambda: softsplat.splat_fused(
        img, flow, z, z_nonpositive, scatter_dtype=sdt))
    assert n == 1
    want = softsplat.splat_fused_plain(img, flow, z, z_nonpositive,
                                       scatter_dtype=sdt)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (got[3] >= 1).all() and got[3].max() <= 4


def test_splat_fused_c64_float32_replays_from_a_cuda_graph(dev):
    """The float32-sum entry at C = 64 replayed from a CUDA graph on new
    inputs: count and z_max exact, out / norm to 1e-4 (summation order)."""
    img, flow, z = _splat_inputs(dev, "c64-ragged")
    static = [t.clone() for t in (img, flow, z)]
    runs = _replayed(lambda: softsplat.splat_fused(
        *static, z_nonpositive=False), static,
        [(img, flow * sc, z) for sc in (1.0, 2.5)])
    for sc, outs in zip((1.0, 2.5), runs):
        want = softsplat.splat_fused(img, flow * sc, z, z_nonpositive=False)
        for a, b in zip(outs[:2], want[:2]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
        for a, b in zip(outs[2:], want[2:]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_splat_fused_replays_from_a_cuda_graph(dev):
    """The whole splat (memset and four kernels) captured in a CUDA graph
    and replayed on new inputs written in place: no host synchronisation,
    no host read of list sizes. Against the eager call: count and z_max
    exact, out / norm to 1e-4 (summation order)."""
    img, flow, z = _splat_inputs(dev, "c130")
    static = [t.clone() for t in (img, flow, z)]
    softsplat.splat_fused(*static, z_nonpositive=False)   # build, warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = softsplat.splat_fused(*static, z_nonpositive=False)
    for scale in (1.0, 2.5):
        for s, t in zip(static, (img, flow * scale, z)):
            s.copy_(t)
        graph.replay()
        torch.cuda.synchronize()
        want = softsplat.splat_fused(img, flow * scale, z,
                                     z_nonpositive=False)
        for a, b in zip(outs[:2], want[:2]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
        for a, b in zip(outs[2:], want[2:]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def _dcn_inputs(dev, B, H, W, G, cg, K, stride, pad, dil, strided):
    """x, offsets to ±10 px with some at ±1e6 px (zeros out), the sigmoided
    mask; `strided`: offsets and mask sliced from one conv-like output, as
    DCNSep takes them."""
    g = torch.Generator(device=dev).manual_seed(1)
    Ho = (H + 2 * pad - (dil * (K - 1) + 1)) // stride + 1
    Wo = (W + 2 * pad - (dil * (K - 1) + 1)) // stride + 1
    n_off, n_mask = G * K * K * 2, G * K * K
    x = torch.randn((B, H, W, G * cg), device=dev, generator=g)
    com = torch.rand((B, Ho, Wo, n_off + n_mask), device=dev, generator=g)
    com[..., :n_off] = com[..., :n_off] * 20.0 - 10.0
    far = torch.rand((B, Ho, Wo, n_off), device=dev, generator=g) < 0.01
    com[..., :n_off] = torch.where(far, torch.sign(com[..., :n_off]) * 1e6,
                                   com[..., :n_off])
    com[..., n_off:] = torch.sigmoid(com[..., n_off:] * 4.0 - 2.0)
    off, mask = com[..., :n_off], com[..., n_off:]
    if not strided:
        off, mask = off.contiguous(), mask.contiguous()
    return x, off, mask


@pytest.mark.parametrize("H,W,G,cg,K,stride,pad,dil,strided", [
    (64, 112, 8, 8, 3, 1, 1, 1, False), (64, 112, 8, 8, 3, 1, 1, 1, True),
    (30, 28, 8, 8, 3, 1, 1, 1, True), (30, 28, 8, 8, 3, 2, 1, 1, False),
    (30, 28, 4, 8, 3, 1, 2, 2, True), (30, 28, 8, 2, 3, 1, 1, 1, False),
    (30, 28, 2, 12, 5, 1, 2, 1, True), (17, 9, 1, 4, 1, 1, 0, 1, False)])
def test_dcn_im2col(dev, H, W, G, cg, K, stride, pad, dil, strided):
    """Against the plain version at the L1 shape and an H % 8 != 0 one,
    stride 2 / dilation 2, strided offset / mask views, a cg that takes
    the scalar path, and K = 5 / K = 1 with cg = 12 / 4 (the kernel's
    general geometry). atol 1e-5."""
    x, off, mask = _dcn_inputs(dev, 2, H, W, G, cg, K, stride, pad, dil,
                               strided)
    got, n = _launches("dcn_im2col", lambda: dcn.dcn_im2col(
        x, off, mask, K, stride, pad, dil, G))
    assert n == 1
    want = dcn.dcn_im2col_plain(x, off, mask, K, stride, pad, dil, G)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


DCN_SHAPES = [
    (64, 112, 8, 8, 3, 1, 1, 1, False), (64, 112, 8, 8, 3, 1, 1, 1, True),
    (30, 28, 8, 8, 3, 1, 1, 1, True), (30, 28, 8, 8, 3, 2, 1, 1, False),
    (30, 28, 4, 8, 3, 1, 2, 2, True), (30, 28, 8, 2, 3, 1, 1, 1, False),
    (30, 28, 2, 12, 5, 1, 2, 1, True), (17, 9, 1, 4, 1, 1, 0, 1, False),
    (30, 28, 4, 16, 3, 1, 1, 1, True)]


@pytest.mark.parametrize("H,W,G,cg,K,stride,pad,dil,strided", DCN_SHAPES)
def test_dcn_im2col_bfloat16(dev, H, W, G, cg, K, stride, pad, dil, strided):
    """The bfloat16 entry on the float32 entry's shapes (cg = 8 and 16 take
    16-byte loads of 8 bfloat16s, the others the scalar path; strided
    bfloat16 views are read in place at half the byte offsets). Kernel and
    plain version do the same float32 arithmetic on the same bfloat16
    inputs and round once: 1 bfloat16 ulp of the largest column."""
    x, off, mask = (t.bfloat16() for t in _dcn_inputs(
        dev, 2, H, W, G, cg, K, stride, pad, dil, False))
    if strided:
        com = torch.cat([off, mask], -1)
        off, mask = com[..., :off.shape[-1]], com[..., off.shape[-1]:]
    got, n = _launches("dcn_im2col", lambda: dcn.dcn_im2col(
        x, off, mask, K, stride, pad, dil, G))
    assert n == 1 and got.dtype == torch.bfloat16
    want = dcn.dcn_im2col_plain(x, off, mask, K, stride, pad, dil, G)
    assert got.shape == want.shape
    tol = ulp_at(float(want.abs().max()), 7)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    assert (got == want).float().mean() > 0.999


@pytest.mark.parametrize("with_bias", [True, False])
def test_dcn_v2_bfloat16_through_the_kernel(dev, with_bias):
    """dcn_v2 in bfloat16 (kernel + one bfloat16 addmm) against
    dcn_v2_plain, the same contraction of the plain im2col: 2 bfloat16
    ulps of the largest output (a column off by an ulp moves a float32
    sum)."""
    G, cg, K = 8, 8, 3
    x, off, mask = (t.bfloat16() for t in _dcn_inputs(
        dev, 2, 30, 28, G, cg, K, 1, 1, 1, False))
    g = torch.Generator(device=dev).manual_seed(3)
    w = (torch.randn((64, G * cg, K, K), device=dev, generator=g) * 0.05
         ).bfloat16()
    b = torch.randn((64,), device=dev, generator=g).bfloat16()
    args = (x, off, mask, w, b if with_bias else None, K, 1, 1, 1, G)
    got, n = _launches("dcn_im2col", lambda: dcn.dcn_v2(*args))
    assert n == 1 and got.dtype == torch.bfloat16
    want = dcn.dcn_v2_plain(*args)
    assert want.shape == got.shape
    tol = 2 * ulp_at(float(want.abs().max()), 7)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dcn_im2col_replays_from_a_cuda_graph(dev, dtype):
    """Both entries captured in a CUDA graph and replayed on new inputs
    written in place: bit-equal to the eager call (no atomics)."""
    x, off, mask = (t.to(dtype) for t in _dcn_inputs(
        dev, 2, 30, 28, 8, 8, 3, 1, 1, 1, False))
    static = [t.clone() for t in (x, off, mask)]
    runs = _replayed(lambda: dcn.dcn_im2col(*static, 3, 1, 1, 1, 8), static,
                     [(x, off * sc, mask) for sc in (1.0, 0.5)])
    for sc, out in zip((1.0, 0.5), runs):
        want = dcn.dcn_im2col(x, off * sc, mask, 3, 1, 1, 1, 8)
        assert torch.equal(out, want)


def test_dcn_v2_through_the_kernel(dev):
    """dcn_v2 (kernel + addmm) against the same contraction of the plain
    im2col, TF32 off. atol 1e-5."""
    G, cg, K = 8, 8, 3
    x, off, mask = _dcn_inputs(dev, 2, 30, 28, G, cg, K, 1, 1, 1, True)
    g = torch.Generator(device=dev).manual_seed(3)
    w = torch.randn((64, G * cg, K, K), device=dev, generator=g) * 0.05
    b = torch.randn((64,), device=dev, generator=g)
    got, n = _launches("dcn_im2col", lambda: dcn.dcn_v2(
        x, off, mask, w, b, K, 1, 1, 1, G))
    assert n == 1
    cols = dcn.dcn_im2col_plain(x, off, mask, K, 1, 1, 1, G)
    wm = w.reshape(64, G, cg, K * K).transpose(2, 3).reshape(64, -1)
    want = (cols @ wm.t() + b).reshape(got.shape)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _siren(dev, dims):
    g = torch.Generator(device=dev).manual_seed(2)
    ws = [(torch.rand((o, i), device=dev, generator=g) * 2 - 1)
          * hidden_bound(i, 30.0) for i, o in zip(dims[:-1], dims[1:])]
    bs = [torch.rand((o,), device=dev, generator=g) * 0.2 - 0.1
          for o in dims[1:]]
    return ws, bs, g


MOTIF_MLPS = [[67, 64, 64, 256, 3], [66, 64, 64, 256, 64],
              [198, 64, 64, 64, 256, 3]]


@pytest.mark.parametrize("dims", MOTIF_MLPS + [[5, 7]])
@pytest.mark.parametrize("sine_last", [False, True])
def test_siren_mlp(dev, dims, sine_last):
    """The three MoTIF MLPs (and a one-layer odd-width one) over a token
    count that is not a tile multiple. atol 1e-5: fp32 FMA and sinf, as the
    plain version with TF32 off (TF32 products or a fast __sinf would miss
    it)."""
    ws, bs, g = _siren(dev, dims)
    x = torch.rand((5001, dims[0]), device=dev, generator=g) * 2 - 1
    got, n = _launches("siren_mlp", lambda: siren_kernel.siren_mlp(
        x, ws, bs, 30.0, sine_last))
    assert n == 1
    torch.testing.assert_close(
        got, siren_kernel.siren_mlp_plain(x, ws, bs, 30.0, sine_last),
        rtol=0, atol=1e-5)


SKIP_MLPS = [d[1:] for d in MOTIF_MLPS] + [[20, 7], [64, 100, 12]]


@pytest.mark.parametrize("dims", SKIP_MLPS, ids=lambda d: "-".join(map(str, d)))
@pytest.mark.parametrize("sine_last", [False, True])
def test_siren_mlp_entries(dev, dims, sine_last):
    """The float32 entry from the first layer's pre-activation (the three
    MoTIF MLPs without their layer 0, a narrow pre-activation of 20 and a
    stored layer of 100). 5001 tokens: not a tile multiple. atol 1e-5."""
    ws, bs, g = _siren(dev, dims)
    x = (torch.rand((5001, dims[0]), device=dev, generator=g) * 2 - 1) * 0.6
    got, n = _launches("siren_mlp", lambda: siren_kernel.siren_mlp(
        x, ws, bs, 30.0, sine_last, True))
    assert n == 1 and got.dtype == torch.float32
    want = siren_kernel.siren_mlp_plain(x, ws, bs, 30.0, sine_last, True)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _bf16_case(dev, dims, n_tok, skip_first):
    ws, bs, g = _siren(dev, dims)
    ws, bs = [w.bfloat16() for w in ws], [b.bfloat16() for b in bs]
    x = ((torch.rand((n_tok, dims[0]), device=dev, generator=g) * 2 - 1)
         * (0.6 if skip_first else 1.0)).bfloat16()
    return x, ws, bs


def _hold_bf16(x, ws, bs, sine_last, skip_first, got=None):
    """The bfloat16 entries' gate (siren_kernel.layer_gate / mlp_gate): one
    layer 99% bit-equal to the plain version and nowhere further off than
    one flipped rounding puts it; a whole MLP as accurate against the
    float64 evaluation as the plain version is."""
    if got is None:
        got = siren_kernel.siren_mlp(x, ws, bs, 30.0, sine_last, skip_first)
    want = siren_kernel.siren_mlp_plain(x, ws, bs, 30.0, sine_last,
                                        skip_first)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    if len(ws) == 1 and not skip_first:
        pre = torch.nn.functional.linear(x.double(), ws[0].double())
        pre_max = float(torch.maximum(pre.abs(), (pre + bs[0].double()).abs()
                                      ).max())
        held = siren_kernel.layer_gate(got, want, pre_max, 30.0, sine_last)
    else:
        held = siren_kernel.mlp_gate(got, want, siren_kernel.
                                     siren_mlp_reference64(
                                         x, ws, bs, 30.0, sine_last,
                                         skip_first))
    assert held["ok"], held
    return got


BF16_ENTRIES = ([(True, d) for d in SKIP_MLPS]
                + [(False, d) for d in MOTIF_MLPS + [[5, 7]]]
                + [(False, [64] * 9), (True, [64] * 9), (False, [16, 100]),
                   (False, [100, 72, 3]), (False, [32, 64, 64, 80, 3])])


@pytest.mark.parametrize("skip_first,dims", BF16_ENTRIES, ids=lambda v: (
    "-".join(map(str, v)) if isinstance(v, list) else
    "skip_first" if v else "whole"))
@pytest.mark.parametrize("sine_last", [False, True])
def test_siren_mlp_bfloat16(dev, skip_first, dims, sine_last):
    """The tensor-core entries, whole and from the pre-activation: the
    three MoTIF MLPs (fan-ins 67 / 66 / 198: odd, wider than a chunk), a
    narrow pre-activation of 20, a wide layer of 100 that feeds 12, 8
    layers, a wide last layer, and a ragged wide chunk (80). 5001 tokens:
    not a tile multiple. Held by accuracy, not equality."""
    x, ws, bs = _bf16_case(dev, dims, 5001, skip_first)
    got, n = _launches("siren_mlp", lambda: siren_kernel.siren_mlp(
        x, ws, bs, 30.0, sine_last, skip_first))
    assert n == 1
    _hold_bf16(x, ws, bs, sine_last, skip_first, got)


@pytest.mark.parametrize("K", [64, 67, 198, 256])
@pytest.mark.parametrize("N", [64, 256, 3])
@pytest.mark.parametrize("sine_last", [False, True])
def test_siren_mlp_bfloat16_one_layer(dev, K, N, sine_last):
    """Gate 1: one layer K -> N at the MoTIF MLPs' widths, both ways of
    the last sine: at least 99% bit-equal to the plain layer and within
    one flipped rounding of it everywhere. 256 -> 256 does not fit a block
    and raises."""
    x, ws, bs = _bf16_case(dev, [K, N], 20001, False)
    if (K, N) == (256, 256):
        with pytest.raises(ValueError, match="shared memory"):
            siren_kernel.siren_mlp(x, ws, bs, 30.0, sine_last)
        return
    _hold_bf16(x, ws, bs, sine_last, False)


@pytest.mark.parametrize("skip_first", [False, True])
@pytest.mark.parametrize("n_tok", [1, 15, 17, 127, 129])
def test_siren_mlp_bfloat16_ragged_tokens(dev, n_tok, skip_first):
    """A token's result does not depend on its tile or on how many tokens
    the launch has: the first n rows of a large launch, bit for bit."""
    dims = MOTIF_MLPS[1][1 if skip_first else 0:]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    big = n_sm * siren_kernel.BF16_WARPS * siren_kernel.BF16_TILE * 2 + 7
    x, ws, bs = _bf16_case(dev, dims, big, skip_first)
    whole = _hold_bf16(x, ws, bs, False, skip_first)
    got = siren_kernel.siren_mlp(x[:n_tok], ws, bs, 30.0, False, skip_first)
    assert torch.equal(got, whole[:n_tok])
    # the same rows off a 16-byte boundary take the 2-byte staging
    odd = torch.empty(n_tok * dims[0] + 1, dtype=x.dtype,
                      device=dev)[1:].view(n_tok, dims[0])
    odd.copy_(x[:n_tok])
    assert odd.data_ptr() % 16 != 0
    got = siren_kernel.siren_mlp(odd, ws, bs, 30.0, False, skip_first)
    assert torch.equal(got, whole[:n_tok])


def test_siren_mlp_bfloat16_wide_arguments(dev):
    """Pre-activations up to 1e4 make omega0 * x exceed the branch-free
    sine's range, so whole groups of sines take sinf's slow path (kept out
    of line in the kernel): still the plain version's values but for the
    few sums that the order flips."""
    x, ws, bs = _bf16_case(dev, [64, 64, 3], 5001, True)
    x = (x.float() * 1e4).bfloat16()
    got = siren_kernel.siren_mlp(x, ws, bs, 30.0, False, True)
    want = siren_kernel.siren_mlp_plain(x, ws, bs, 30.0, False, True)
    assert torch.isfinite(got.float()).all()
    assert (got == want).float().mean() > 0.99


def test_siren_mlp_bfloat16_refuses_what_it_does_not_take(dev):
    """A wide layer that feeds a wide layer, and an MLP with a layer whose
    weights and slabs exceed a block's shared memory alone, raise before
    any launch."""
    before = kernels.LAUNCHES["siren_mlp"]
    x, ws, bs = _bf16_case(dev, [64, 256, 256, 3], 10, False)
    with pytest.raises(ValueError, match="must be last or feed"):
        siren_kernel.siren_mlp(x, ws, bs)
    x, ws, bs = _bf16_case(dev, [64, 64, 1024, 64], 10, False)
    with pytest.raises(ValueError, match="shared memory"):
        siren_kernel.siren_mlp(x, ws, bs)
    assert kernels.LAUNCHES["siren_mlp"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_siren_packs_once_and_follows_a_load(dev, dtype):
    """Siren keeps the kernel's parameter buffer per dtype; a
    load_state_dict is followed by a new one and new results."""
    from motif_tpu_torch.models.siren import Siren

    torch.manual_seed(0)
    net = Siren(67, [64, 64, 256], 2, 3, skip_first_linear=True).to(dev)
    other = Siren(67, [64, 64, 256], 2, 3, skip_first_linear=True).to(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    toks = (torch.rand((1000, 64), device=dev, generator=g) - 0.5).to(dtype)
    with torch.no_grad():
        first = net(toks)
        buf = net.packed(dtype)
        assert net.packed(dtype) is buf and torch.equal(net(toks), first)
        net.load_state_dict(other.state_dict())
        assert net.packed(dtype) is not buf
        assert torch.equal(net(toks), other(toks))
        assert not torch.equal(net(toks), first)


@pytest.mark.parametrize("dtype,skip_first", [
    (torch.float32, False), (torch.float32, True), (torch.bfloat16, False),
    (torch.bfloat16, True)])
def test_siren_mlp_replays_from_a_cuda_graph(dev, dtype, skip_first):
    """Each entry captured in a CUDA graph and replayed on new tokens
    written in place: bit-equal to the eager call."""
    dims = MOTIF_MLPS[1][1 if skip_first else 0:]
    ws, bs, g = _siren(dev, dims)
    ws, bs = [w.to(dtype) for w in ws], [b.to(dtype) for b in bs]
    x = (torch.rand((3001, dims[0]), device=dev, generator=g) - 0.5).to(dtype)
    static = [x.clone()]
    runs = _replayed(lambda: siren_kernel.siren_mlp(
        static[0], ws, bs, 30.0, False, skip_first), static,
        [(x * sc,) for sc in (1.0, 0.5)])
    for sc, out in zip((1.0, 0.5), runs):
        want = siren_kernel.siren_mlp(x * sc, ws, bs, 30.0, False, skip_first)
        assert torch.equal(out, want)


def test_siren_skip_first_equals_the_whole_mlp_float32(dev):
    """Layer 0's linear map by F.linear, then the skip-first entry, is bit
    for bit the whole-MLP entry in float32 (both are F.linear + sin)."""
    dims = MOTIF_MLPS[0]
    ws, bs, g = _siren(dev, dims)
    x = torch.rand((4097, dims[0]), device=dev, generator=g) * 2 - 1
    whole = siren_kernel.siren_mlp(x, ws, bs)
    pre = torch.nn.functional.linear(x, ws[0], bs[0])
    assert torch.equal(siren_kernel.siren_mlp(pre, ws[1:], bs[1:],
                                              skip_first=True), whole)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_chunks_are_bit_equal(dev, dtype):
    """A skip-first Siren over the token axis in 3 pieces (a batch of 2, so
    the pieces are strided views) is bit for bit the one-piece call: the
    kernel is pointwise over tokens."""
    from motif_tpu_torch.models.motif import _chunked_tokens
    from motif_tpu_torch.models.siren import Siren

    torch.manual_seed(0)
    net = Siren(67, [64, 64, 256], 2, 3, skip_first_linear=True).to(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    toks = (torch.rand((2, 1000, 64), device=dev, generator=g) - 0.5).to(dtype)
    with torch.no_grad():
        whole, n1 = _launches("siren_mlp", lambda: net(toks))
        pieces, n3 = _launches("siren_mlp",
                               lambda: _chunked_tokens(net, toks, 3))
    assert (n1, n3) == (1, 3)
    assert torch.equal(whole, pieces)


def test_siren_skip_first_refuses_a_wide_pre_activation(dev):
    ws, bs, g = _siren(dev, [100, 64, 3])
    before = kernels.LAUNCHES["siren_mlp"]
    with pytest.raises(ValueError, match="pre-activation"):
        siren_kernel.siren_mlp(torch.zeros((10, 100), device=dev), ws, bs,
                               skip_first=True)
    assert kernels.LAUNCHES["siren_mlp"] == before


@pytest.mark.parametrize("dims", MOTIF_MLPS)
@pytest.mark.parametrize("tokens", ["one", "tile-1", "grid*tile*3+7"])
def test_siren_mlp_ragged_tiles(dev, dims, tokens):
    """The persistent loop's edges: 1 token, a tile less one, and three
    rounds of the grid (one block per SM at these MLPs' shared memory)
    plus a ragged tile of 7. atol 1e-5."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n = {"one": 1, "tile-1": siren_kernel.TILE - 1,
         "grid*tile*3+7": n_sm * siren_kernel.TILE * 3 + 7}[tokens]
    ws, bs, g = _siren(dev, dims)
    x = torch.rand((n, dims[0]), device=dev, generator=g) * 2 - 1
    got, launches = _launches("siren_mlp", lambda: siren_kernel.siren_mlp(
        x, ws, bs))
    assert launches == 1
    torch.testing.assert_close(got, siren_kernel.siren_mlp_plain(x, ws, bs),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("dims", [[48, 128, 96, 8], [32, 64, 64, 80, 3],
                                  [100, 72, 3], [5, 20, 3], [16, 70],
                                  [16, 100]])
@pytest.mark.parametrize("sine_last", [False, True])
def test_siren_mlp_other_widths(dev, dims, sine_last):
    """Widths that take the kernel's other paths: a stored activation wider
    than 64; a fused pair with a ragged second chunk; a first layer wider
    than 64 both in and out (x restaged per chunk); a stored layer of 20
    (partly idle tiles); last layers of 70 and 100 (two chunks, scalar and
    float4 stores). atol 1e-5."""
    ws, bs, g = _siren(dev, dims)
    x = torch.rand((3001, dims[0]), device=dev, generator=g) * 2 - 1
    fused, rows, smem = siren_kernel.plan(dims)
    if smem > siren_kernel.SMEM_LIMIT:
        pytest.fail(f"{dims} must fit: {smem} B")
    got = siren_kernel.siren_mlp(x, ws, bs, 30.0, sine_last)
    torch.testing.assert_close(
        got, siren_kernel.siren_mlp_plain(x, ws, bs, 30.0, sine_last),
        rtol=0, atol=1e-5)


def test_siren_mlp_too_wide_raises(dev):
    """A layer whose input is too wide for even 8 columns of weights in a
    block cannot be cut into launches: it raises before any launch (an MLP
    merely too large for one block runs in several, below)."""
    ws, bs, g = _siren(dev, [6000, 8])
    x = torch.zeros((10, 6000), device=dev)
    before = kernels.LAUNCHES["siren_mlp"]
    with pytest.raises(ValueError, match="shared memory"):
        siren_kernel.siren_mlp(x, ws, bs)
    assert kernels.LAUNCHES["siren_mlp"] == before


def test_wrappers_reject_float64(dev):
    x = torch.zeros((2, 4, 4, 8), device=dev, dtype=torch.float64)
    off = torch.zeros((2, 4, 4, 36), device=dev, dtype=torch.float64)
    mask = torch.zeros((2, 4, 4, 18), device=dev, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        dcn.dcn_im2col(x, off, mask, 3, 1, 1, 1, 2)


def test_wrappers_reject_mixed_dtypes_and_devices(dev):
    """Nothing is converted: bfloat16 features with float32 offsets, a
    bfloat16 splat input (its entries take float32 tensors), float16
    tokens, and a tensor left on the CPU all raise before any launch."""
    x = torch.zeros((2, 4, 4, 8), device=dev)
    off = torch.zeros((2, 4, 4, 36), device=dev)
    mask = torch.zeros((2, 4, 4, 18), device=dev)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(TypeError, match="share"):
        dcn.dcn_im2col(x.bfloat16(), off, mask, 3, 1, 1, 1, 2)
    with pytest.raises(ValueError, match="one CUDA device"):
        dcn.dcn_im2col(x, off.cpu(), mask, 3, 1, 1, 1, 2)
    img = torch.zeros((1, 4, 4, 3), device=dev)
    flow = torch.zeros((1, 4, 4, 2), device=dev)
    z = torch.zeros((1, 4, 4, 1), device=dev)
    with pytest.raises(TypeError, match="float32"):
        softsplat.splat_fused(img.bfloat16(), flow.bfloat16(), z.bfloat16(),
                              True)
    with pytest.raises(ValueError, match="float16"):
        softsplat.splat_fused(img, flow, z, True, scatter_dtype=torch.bfloat16)
    w, b = torch.zeros((4, 3), device=dev), torch.zeros((4,), device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        siren_kernel.siren_mlp(torch.zeros((5, 3), device=dev).half(),
                               [w.half()], [b.half()])
    assert kernels.LAUNCHES == before


def test_entry_counters_name_the_entry(dev):
    """Each wrapper counts its launch under its kernel and its entry."""
    kernels.reset_launches()
    ws, bs, g = _siren(dev, [64, 64, 3])
    x = torch.zeros((10, 64), device=dev)
    siren_kernel.siren_mlp(x.bfloat16(), [w.bfloat16() for w in ws],
                           [b.bfloat16() for b in bs], skip_first=True)
    siren_kernel.siren_mlp(x, ws, bs)
    img, flow, z = _splat_inputs(dev, "c64")
    softsplat.splat_fused(img, flow, z, False, scatter_dtype=torch.float16)
    softsplat.splat_fused(img[..., :5].contiguous(), flow, z, False)
    xd, off, mask = _dcn_inputs(dev, 1, 9, 9, 2, 8, 3, 1, 1, 1, False)
    dcn.dcn_im2col(xd.bfloat16(), off.bfloat16(), mask.bfloat16(), 3, 1, 1, 1,
                   2)
    torch.cuda.synchronize()
    assert kernels.ENTRY_LAUNCHES == {
        "siren_mlp/bfloat16/skip_first": 1, "siren_mlp/float32/whole": 1,
        "splat_fused/float16/C=64": 1, "splat_fused/float32/generic": 1,
        "dcn_im2col/bfloat16": 1}
    assert kernels.LAUNCHES == {"siren_mlp": 2, "splat_fused": 2,
                                "dcn_im2col": 1}


def test_kernels_build_from_the_sources(dev):
    kernels.build()
    for name in kernels.SOURCES:
        assert kernels._library_path(name).exists()
    assert np.isfinite(kernels.build())  # all built: nothing to do


@contextlib.contextmanager
def _plain_versions():
    """Route the model's kernel calls to the plain versions."""
    def siren_plain(*a, packed=None, **kw):
        return siren_kernel.siren_mlp_plain(*a, **kw)
    with mock.patch.object(softsplat, "splat_fused",
                           softsplat.splat_fused_plain), \
            mock.patch.object(dcn, "dcn_im2col", dcn.dcn_im2col_plain), \
            mock.patch.object(siren_kernel, "siren_mlp", siren_plain):
        yield


# Evaluator.run's summary on the card against its plain versions (the
# frames agree to ~1e-7, which moves a PSNR by ~1e-5 dB) and against the
# CPU (other convolution algorithms; a splatted pixel can cross a floor())
RUN_GATES = {"plain": dict(psnr=1e-3, ssim=1e-4, l1=1e-5, flow_rel=1e-5),
             "cpu": dict(psnr=1e-2, ssim=1e-3, l1=1e-4, flow_rel=1e-4)}


def _hold_summary(got, want, gate):
    for k in ("psnr", "psnr_anchor", "psnr_inter", "psnr_center"):
        assert abs(got[k] - want[k]) <= gate["psnr"], (k, got[k], want[k])
    assert abs(got["ssim"] - want["ssim"]) <= gate["ssim"]
    assert abs(got["l1"] - want["l1"]) <= gate["l1"]
    for k in ("flow_err", "flow_abs"):
        assert abs(got[k] - want[k]) <= gate["flow_rel"] * abs(want[k]), k


def test_evaluator_run_on_a_vid4_clip(dev):
    """Evaluator.run over the first data/Vid4 clip (16x24 → 64x96, 3
    times) at channel 16, front 1 / back 2 blocks, DCN offsets perturbed:
    every kernel launches, and the summary holds against the plain
    versions on the card and against the same model on the CPU."""
    from motif_tpu_torch.data import BatchLoader, create_dataset
    from motif_tpu_torch.eval import Evaluator
    from motif_tpu_torch.models.motif import build_motif
    from motif_tpu_torch.models.pcd import DCNSep

    vid4 = pathlib.Path(__file__).resolve().parents[1] / "data" / "Vid4"
    clip = [next(BatchLoader(create_dataset(
        {"mode": "Adobe_test_3", "dataroot_GT": str(vid4 / "HR"),
         "dataroot_LQ": str(vid4 / "LR")})).epoch(0))]
    model = build_motif(16, 1, 2, device="cpu", seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, DCNSep):
                w, b = mod.conv_offset_mask.weight, mod.conv_offset_mask.bias
                w.copy_(torch.randn(w.shape, generator=g) * 0.01)
                b.copy_(torch.randn(b.shape, generator=g))
    cpu = Evaluator(copy.deepcopy(model), device="cpu").run(clip).summary()
    ev = Evaluator(model, device=dev)
    before = dict(kernels.LAUNCHES)
    card = ev.run(clip).summary()
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
    assert launched == {"splat_fused": 1, "dcn_im2col": 42, "siren_mlp": 3}
    with _plain_versions():         # a new Evaluator: its graph captures
        plain = Evaluator(model, device=dev).run(clip).summary()  # these
    assert kernels.LAUNCHES == {k: before[k] + v for k, v in launched.items()}
    assert card["n_clips"] == 1 and all(np.isfinite(v) for v in card.values())
    _hold_summary(card, plain, RUN_GATES["plain"])
    _hold_summary(card, cpu, RUN_GATES["cpu"])


# ---------------------------------------------------------------------------
# Training: each kernel's autograd Function (the kernel forward, a plain
# backward) against autograd through its plain version, at the widths of
# the training path; the float32 forwards differ from the plain versions by
# a summation order at most, the backwards use the same inputs: 1e-5 of
# each gradient's largest value.
# ---------------------------------------------------------------------------

GRAD_TOL = 1e-5


def _grad_close(got, want, what):
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    assert scale > 0 and err <= GRAD_TOL * scale, (what, err, scale)


def _grads(fn, inputs, cotangents):
    ts = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * c).sum() for o, c in zip(outs, cotangents))
    return torch.autograd.grad(loss, ts)


@pytest.mark.parametrize("z_nonpositive", [True, False])
def test_splat_fused_backward(dev, z_nonpositive):
    """C = 130 (the training splat) on 4 images of 128²."""
    g = torch.Generator(device=dev).manual_seed(3)
    B, H, W, C = 4, 128, 128, 130
    img = torch.randn((B, H, W, C), device=dev, generator=g)
    flow = torch.randn((B, H, W, 2), device=dev, generator=g) * 3.0
    z = torch.randn((B, H, W, 1), device=dev, generator=g)
    z = -z.abs() if z_nonpositive else z.abs()
    cot = (torch.randn((B, H, W, C), device=dev, generator=g),
           torch.randn((B, H, W, 1), device=dev, generator=g))
    got, n = _launches("splat_fused", lambda: _grads(
        lambda *a: softsplat.splat_fused(*a, z_nonpositive)[:2],
        (img, flow, z), cot))
    assert n == 1
    want = _grads(lambda *a: softsplat.splat_fused_plain(*a, z_nonpositive)[:2],
                  (img, flow, z), cot)
    for what, a, b in zip(("img", "flow", "z"), got, want):
        _grad_close(a, b, what)


@pytest.mark.parametrize("offsets", [0.0, 2.0])
def test_dcn_v2_backward(dev, offsets):
    """The PCD's L1 at training size (8 frames of 32², G 8, cg 8), the
    offsets and the mask strided views of one conv output."""
    g = torch.Generator(device=dev).manual_seed(4)
    B, H, W, G, cg, K = 8, 32, 32, 8, 8, 3
    x = torch.randn((B, H, W, G * cg), device=dev, generator=g)
    com = torch.randn((B, H, W, G * K * K * 3), device=dev, generator=g) * offsets
    w = torch.randn((64, G * cg, K, K), device=dev, generator=g) * 0.05
    b = torch.randn((64,), device=dev, generator=g)
    cot = (torch.randn((B, H, W, 64), device=dev, generator=g),)
    n2 = G * K * K * 2

    def run(op):
        def f(xx, cc, ww, bb):
            return op(xx, cc[..., :n2], torch.sigmoid(cc[..., n2:]), ww, bb,
                      K, 1, 1, 1, G)
        return f
    got, n = _launches("dcn_im2col", lambda: _grads(run(dcn.dcn_v2),
                                                    (x, com, w, b), cot))
    assert n == 1
    want = _grads(run(dcn.dcn_v2_plain), (x, com, w, b), cot)
    for what, a, c in zip(("x", "offset|mask", "weight", "bias"), got, want):
        _grad_close(a, c, what)


@pytest.mark.parametrize("skip_first", [False, True])
@pytest.mark.parametrize("dims", [(67, 64, 64, 256, 3), (66, 64, 64, 256, 64),
                                  (198, 64, 64, 64, 256, 3)],
                         ids=["stinf", "sinf", "synth"])
def test_siren_mlp_backward(dev, dims, skip_first):
    g = torch.Generator(device=dev).manual_seed(5)
    dims = dims[1:] if skip_first else dims
    ws = [(torch.rand((o, i), device=dev, generator=g) * 2 - 1)
          * hidden_bound(i, 30.0) for i, o in zip(dims[:-1], dims[1:])]
    bs = [torch.rand((o,), device=dev, generator=g) * 0.2 - 0.1
          for o in dims[1:]]
    x = torch.randn((3, 20000, dims[0]), device=dev, generator=g) * 0.3
    cot = (torch.randn((3, 20000, dims[-1]), device=dev, generator=g),)
    n = len(ws)

    def run(op):
        return lambda xx, *p: op(xx, list(p[:n]), list(p[n:]), 30.0, False,
                                 skip_first)
    got, launched = _launches("siren_mlp", lambda: _grads(
        run(siren_kernel.siren_mlp), (x, *ws, *bs), cot))
    assert launched == 1
    want = _grads(run(siren_kernel.siren_mlp_plain), (x, *ws, *bs), cot)
    for k, (a, c) in enumerate(zip(got, want)):
        _grad_close(a, c, k)


def _lowprec_close(got, want, bits, what):
    """Within 2 units in the last place of the working type (`bits`
    stored mantissa bits) at the gradient's largest magnitude: a backward
    fed the kernel's forward against one fed the plain forward."""
    scale = float(want.double().abs().max())
    err = float((got.double() - want.double()).abs().max())
    assert scale > 0 and err <= 2 * ulp_at(scale, bits), (what, err, scale)


@pytest.mark.parametrize("C", [64, 130])
def test_splat_fused_float16_sums_backward(dev, C):
    """The float16-sum entry under grad (the knobs' training splat: C = 64
    under fused_decode, 130 without) on 4 images of 128²: one launch, and
    the gradients of img, flow and z against autograd through the plain
    float16 splat, within 2 float16 ulps of the largest."""
    g = torch.Generator(device=dev).manual_seed(3)
    B, H, W = 4, 128, 128
    img = torch.randn((B, H, W, C), device=dev, generator=g)
    flow = torch.randn((B, H, W, 2), device=dev, generator=g) * 3.0
    z = torch.randn((B, H, W, 1), device=dev, generator=g).abs()
    cot = (torch.randn((B, H, W, C), device=dev, generator=g),
           torch.randn((B, H, W, 1), device=dev, generator=g))
    h = torch.float16
    got, n = _launches("splat_fused", lambda: _grads(
        lambda *a: softsplat.splat_fused(*a, False, scatter_dtype=h)[:2],
        (img, flow, z), cot))
    assert n == 1
    want = _grads(lambda *a: softsplat.splat_fused_plain(
        *a, False, scatter_dtype=h)[:2], (img, flow, z), cot)
    for what, a, b in zip(("img", "flow", "z"), got, want):
        _lowprec_close(a, b, 10, what)


def test_dcn_v2_bfloat16_backward(dev):
    """The bfloat16 entry under grad at the PCD's L1 training size (8
    frames of 32², G 8, cg 8): one launch, every gradient against autograd
    through the plain bfloat16 dcn_v2 within 2 bfloat16 ulps."""
    g = torch.Generator(device=dev).manual_seed(4)
    B, H, W, G, cg, K = 8, 32, 32, 8, 8, 3
    bf = torch.bfloat16
    x = torch.randn((B, H, W, G * cg), device=dev, generator=g).to(bf)
    com = (torch.randn((B, H, W, G * K * K * 3), device=dev, generator=g)
           * 2.0).to(bf)
    w = (torch.randn((64, G * cg, K, K), device=dev, generator=g)
         * 0.05).to(bf)
    b = torch.randn((64,), device=dev, generator=g).to(bf)
    cot = (torch.randn((B, H, W, 64), device=dev, generator=g).to(bf),)
    n2 = G * K * K * 2

    def run(op):
        def f(xx, cc, ww, bb):
            return op(xx, cc[..., :n2], torch.sigmoid(cc[..., n2:]), ww, bb,
                      K, 1, 1, 1, G)
        return f
    got, n = _launches("dcn_im2col", lambda: _grads(run(dcn.dcn_v2),
                                                    (x, com, w, b), cot))
    assert n == 1
    want = _grads(run(dcn.dcn_v2_plain), (x, com, w, b), cot)
    for what, a, c in zip(("x", "offset|mask", "weight", "bias"), got, want):
        assert a.dtype == bf, what
        _lowprec_close(a, c, 7, what)


@pytest.mark.parametrize("dims,skip_first,launches", [
    ((67, 64, 64, 256, 3), False, 1), ((64, 64, 256, 64), True, 1),
    ((331, 64, 64, 64, 256, 3), False, 2)],
    ids=["whole", "skip_first", "cut"])
def test_siren_mlp_bfloat16_backward(dev, dims, skip_first, launches):
    """The bfloat16 entries under grad: whole (STINF), skip-first (SINF)
    and setting 6's synthesis net cut into two launches
    (`segments_bf16`): the kernel's launches, and every gradient equal to
    autograd through the plain bfloat16 version (the backward recomputes
    from the inputs, so the kernel's forward cannot reach it)."""
    g = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16
    ws = [((torch.rand((o, i), device=dev, generator=g) * 2 - 1)
           * hidden_bound(i, 30.0)).to(bf) for i, o in zip(dims[:-1],
                                                           dims[1:])]
    bs = [(torch.rand((o,), device=dev, generator=g) * 0.2 - 0.1).to(bf)
          for o in dims[1:]]
    x = (torch.randn((3, 20000, dims[0]), device=dev, generator=g)
         * 0.3).to(bf)
    cot = (torch.randn((3, 20000, dims[-1]), device=dev, generator=g
                       ).to(bf),)
    n = len(ws)

    def run(op):
        return lambda xx, *p: op(xx, list(p[:n]), list(p[n:]), 30.0, False,
                                 skip_first)
    got, launched = _launches("siren_mlp", lambda: _grads(
        run(siren_kernel.siren_mlp), (x, *ws, *bs), cot))
    assert launched == launches
    want = _grads(run(siren_kernel.siren_mlp_plain), (x, *ws, *bs), cot)
    for k, (a, c) in enumerate(zip(got, want)):
        assert a.dtype == bf and torch.equal(a, c), k


def test_lower_precision_entries_raise_under_grad(dev):
    """The lower-precision entries no longer raise under grad: MoTIF under
    every knob (bfloat16 compute, float16 splat sums, fused decode) runs a
    forward and a backward on the card, launching the bfloat16 DCN, the
    bfloat16 skip-first SIREN and the float16-sum splat, and its float32
    parameters take finite gradients."""
    from motif_tpu_torch.models.motif import build_motif
    m = build_motif(16, 1, 2, device=dev, fused_decode=True,
                    compute_dtype="bfloat16", splat_dtype="float16")
    before = dict(kernels.ENTRY_LAUNCHES)
    frames, _, _ = m(torch.rand(1, 4, 16, 16, 3, device=dev),
                     torch.rand(1, 2, device=dev), (64, 64), iters=1)
    frames.square().sum().backward()
    torch.cuda.synchronize()
    launched = {k for k, v in kernels.ENTRY_LAUNCHES.items()
                if v != before.get(k, 0)}
    assert launched == {"dcn_im2col/bfloat16", "siren_mlp/bfloat16/skip_first",
                        "splat_fused/float16/C=64"}
    for name, p in m.named_parameters():
        assert p.grad is None or (p.grad.dtype == torch.float32
                                  and torch.isfinite(p.grad).all()), name


def _perturbed_motif(dev, **kw):
    from motif_tpu_torch.models.motif import build_motif
    from motif_tpu_torch.models.pcd import DCNSep

    model = build_motif(16, 1, 2, device=dev, seed=0, **kw)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        model.alpha.fill_(0.5)
        for mod in model.modules():
            if isinstance(mod, DCNSep):
                w, b = mod.conv_offset_mask.weight, mod.conv_offset_mask.bias
                w.copy_(torch.randn(w.shape, generator=g) * 0.01)
                b.copy_(torch.randn(b.shape, generator=g))
    return model


def _motif_grads(model, fused):
    model.configure(fused_decode=fused)
    model.zero_grad(set_to_none=True)
    rng = np.random.default_rng(1)
    dev = next(model.parameters()).device
    x = torch.tensor(rng.random((1, 4, 16, 16, 3), np.float32), device=dev)
    tt = torch.tensor([[0.2, 0.8]], device=dev)
    gt = torch.tensor(rng.random((1, 2, 64, 64, 3), np.float32), device=dev)
    frames, _, _ = model(x, tt, (64, 64), iters=2)
    ((frames.transpose(0, 1) - gt) ** 2).sum().backward()
    return {k: (p.grad.clone() if p.grad is not None else
                torch.zeros_like(p)) for k, p in model.named_parameters()}


STEP_GRAD_TOL = 1e-3   # chip_smoke.py's TRAIN_GATES["grad_rel"]


def test_fused_decode_gradient_on_the_card(dev):
    """The gradient through fused_decode (the skip-first float32 SIREN
    entry) on the card: against the reference order's, per module within
    5e-3 of its largest (tests/test_bf16.py:82-112), and against the same
    fused forward and backward with the plain versions, each gradient
    within STEP_GRAD_TOL of its largest: a whole model's gradient, as the
    smoke's training gates hold one (alpha > 0, so the max splat and z
    enter; the splat's float32 sums run in another order than the plain
    version's, which moves the flow-context convs' gradient by 1.4e-5 on
    an H100)."""
    model = _perturbed_motif(dev)
    ref = _motif_grads(model, False)
    before = dict(kernels.ENTRY_LAUNCHES)
    got = _motif_grads(model, True)
    assert kernels.ENTRY_LAUNCHES["siren_mlp/float32/skip_first"] - \
        before.get("siren_mlp/float32/skip_first", 0) == 3
    for key in ("synth_net", "imnet", "flow_imnet", "encoder"):
        a = torch.cat([g.reshape(-1) for k, g in ref.items()
                       if k.startswith(key + ".")])
        b = torch.cat([g.reshape(-1) for k, g in got.items()
                       if k.startswith(key + ".")])
        assert float((a - b).abs().max()) <= 5e-3 * float(a.abs().max()), key
    with _plain_versions():
        plain = _motif_grads(model, True)
    for k, g in got.items():
        scale = float(plain[k].abs().max())
        if scale > 0:
            err = float((g - plain[k]).abs().max())
            assert err <= STEP_GRAD_TOL * scale, (k, err, scale)


def test_bfloat16_trainer_step_matches_the_plain_versions(dev):
    """Trainer.step under every knob (bfloat16 compute, float16 splat
    sums, fused decode) at channel 16 on the card, use_gt False: every
    parameter's gradient within 0.5 of the same step's with the plain
    versions in L2 relative to its norm (bfloat16's own spread reaches
    0.19 at the PCD's offset convs against float64,
    tests/test_torch_train_bf16.py), the loss within 1e-2, and the
    parameters each reaches the same."""
    from motif_tpu_torch.trainer import Trainer, TrainerConfig

    model = _perturbed_motif(dev, fused_decode=True, compute_dtype="bfloat16",
                             splat_dtype="float16")
    rng = np.random.default_rng(0)
    batch = {"lq": rng.random((2, 4, 16, 16, 3), np.float32),
             "gt": rng.random((2, 5, 64, 64, 3), np.float32),
             "times": np.float32([[0.25, 0.5, 0.75]] * 2)}
    tr = Trainer(model, TrainerConfig(teacher_forcing_steps=1), iters=2)
    aux = tr.compute_grads(batch, False)
    grads = [p.grad.clone() for p in tr.params]
    with _plain_versions():
        plain = tr.compute_grads(batch, False)
    assert abs(float(aux["loss"]) / float(plain["loss"]) - 1) <= 1e-2
    for (name, p), a in zip(model.named_parameters(), grads):
        n = float(p.grad.norm())
        assert (n > 0) == (float(a.norm()) > 0), name
        if n > 0:
            assert float((a - p.grad).norm()) <= 0.5 * n, name


def test_liif_trainer_step_matches_the_plain_versions(dev):
    """A LIIF (VideoINR at nf 16, 1 / 1 blocks, 4 LQ frames) Trainer step
    on the card, LR 16² -> 64², 3 times: the DCN and the float32 SIREN
    (the 1049-wide encode_imnet cut into launches) launch, and the loss
    and every gradient hold against the plain versions (1e-5)."""
    from motif_tpu_torch.models.factory import build_baseline
    from motif_tpu_torch.trainer import Trainer, TrainerConfig

    model = build_baseline({"which_model_G": "LIIF", "nf": 16,
                            "front_RBs": 1, "back_RBs": 1}, dev, n_frames=4)
    model.train()
    rng = np.random.default_rng(0)
    batch = {"lq": rng.random((2, 4, 16, 16, 3), np.float32),
             "gt": rng.random((2, 5, 64, 64, 3), np.float32),
             "times": np.float32([[0.25, 0.5, 0.75]] * 2)}
    tr = Trainer(model, TrainerConfig(), out_hw=(64, 64), family="LIIF")
    before = dict(kernels.LAUNCHES)
    aux = tr.compute_grads(batch, tr.draw_use_gt())
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                if v != before[k]}
    assert set(launched) == {"dcn_im2col", "siren_mlp"}
    grads = [p.grad.clone() for p in tr.params]
    with _plain_versions():
        plain = tr.compute_grads(batch, False)
    assert abs(float(aux["loss"]) - float(plain["loss"])) <= \
        1e-5 * abs(float(plain["loss"]))
    for (name, p), a in zip(model.named_parameters(), grads):
        if float(p.grad.abs().max()) > 0:
            _grad_close(a, p.grad, name)
        else:
            assert float(a.abs().max()) == 0.0, name


def test_siren_packed_follows_an_optimiser_step_on_the_card(dev):
    """Adam's step on the card (foreach) moves the parameters' version
    counters: the kernel's buffer is rebuilt and the next forward uses the
    new weights."""
    from motif_tpu_torch.models.siren import Siren

    torch.manual_seed(0)
    net = Siren(67, [64, 64, 256], 2, 3).to(dev)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    x = torch.rand((4000, 67), device=dev)
    net(x).square().sum().backward()
    buf = net.packed(torch.float32)
    opt.step()
    assert net.packed(torch.float32) is not buf
    with torch.no_grad():
        got = net(x)
        lins = net._kernel_linears()
        want = siren_kernel.siren_mlp_plain(x, [m.weight for m in lins],
                                            [m.bias for m in lins])
    assert torch.equal(got, want)


def test_trainer_step_matches_the_plain_versions(dev):
    """Trainer.step at channel 16 (front 1 / back 2 blocks, LR 16² → HR
    64², N 3, iters 2, DCN offsets perturbed), use_gt True and False, on
    the card: the loss and every parameter's gradient against the same
    step with the plain versions; every kernel launches."""
    from motif_tpu_torch.models.motif import build_motif
    from motif_tpu_torch.models.pcd import DCNSep
    from motif_tpu_torch.trainer import Trainer, TrainerConfig

    model = build_motif(16, 1, 2, device=dev, seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, DCNSep):
                w, b = mod.conv_offset_mask.weight, mod.conv_offset_mask.bias
                w.copy_(torch.randn(w.shape, generator=g) * 0.01)
                b.copy_(torch.randn(b.shape, generator=g))
    rng = np.random.default_rng(0)
    batch = {"lq": rng.random((2, 4, 16, 16, 3), np.float32),
             "gt": rng.random((2, 5, 64, 64, 3), np.float32),
             "times": np.float32([[0.25, 0.5, 0.75]] * 2)}
    tr = Trainer(model, TrainerConfig(teacher_forcing_steps=1), iters=2)
    for use_gt in (True, False):
        before = dict(kernels.LAUNCHES)
        aux = tr.compute_grads(batch, use_gt)
        grads = [p.grad.clone() for p in tr.params]
        launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
        assert launched == {"splat_fused": 1, "dcn_im2col": 42,
                            "siren_mlp": 3}
        with _plain_versions():
            plain = tr.compute_grads(batch, use_gt)
        assert abs(float(aux["loss"]) - float(plain["loss"])) <= \
            1e-5 * abs(float(plain["loss"]))
        for (name, p), a in zip(model.named_parameters(), grads):
            if float(p.grad.abs().max()) > 0:
                _grad_close(a, p.grad, name)
            else:
                assert float(a.abs().max()) == 0.0, name


# ---------------------------------------------------------------------------
# The four-anchor MoTIF (Ours_44): a request and a training step on
# precomputed flows against the plain versions, at channel 16 (front 1 /
# back 2 blocks); the splat and the SIREN at the recipe's training shapes
# for four anchors (4 anchors x batch 8 x 7 times = 224 images of 128²).
# ---------------------------------------------------------------------------


def _four_anchor_model(dev, n_anchors=4):
    from motif_tpu_torch.models.motif import build_motif
    from motif_tpu_torch.models.pcd import DCNSep

    model = build_motif(16, 1, 2, device=dev, seed=0, n_anchors=n_anchors)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, DCNSep):
                w, b = mod.conv_offset_mask.weight, mod.conv_offset_mask.bias
                w.copy_(torch.randn(w.shape, generator=g) * 0.01)
                b.copy_(torch.randn(b.shape, generator=g))
    return model


def test_ours44_request_matches_the_plain_versions(dev):
    """Evaluator.infer with family Ours_44 (one time a forward, RAFT on the
    12 cross pairs) on LR 16² → 64², 3 times: each forward launches one
    splat, three SIRENs and the DCNs of a four-frame encoder; the frames
    and the flow statistics hold against the plain versions to 1e-5."""
    from motif_tpu_torch.eval import Evaluator

    ev = Evaluator(_four_anchor_model(dev), iters=2, family="Ours_44",
                   device=dev)
    rng = np.random.default_rng(0)
    lq = rng.random((1, 4, 16, 16, 3), np.float32)
    times = np.float32([[0.1, 0.5, 0.75]])
    before = dict(kernels.ENTRY_LAUNCHES)
    got, stats = ev.infer(lq, times, (64, 64))
    launched = {k: v - before.get(k, 0)
                for k, v in kernels.ENTRY_LAUNCHES.items()
                if v != before.get(k, 0)}
    # channel 16: the splat's payload is 64 + 2 + 16 = 82 wide (generic)
    assert launched == {"dcn_im2col/float32": 3 * 90,
                        "siren_mlp/float32/whole": 9,
                        "splat_fused/float32/generic": 3}
    with _plain_versions():        # eagerly: a replay runs the kernels
        want, want_stats = ev._infer_eager(lq, times, (64, 64))
    assert got.shape == (3, 1, 64, 64, 3) and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-5
    for a, b in zip(stats, want_stats):
        assert abs(a - b) <= 1e-5 * abs(b)


def test_ours44_trainer_step_matches_the_plain_versions(dev):
    """Trainer.step of Ours_44 on a batch with precomputed flows (LR 16² →
    HR 64², N 3, batch 2), use_gt True and False: RAFT never runs, and the
    loss and every parameter's gradient hold against the same step with
    the plain versions."""
    from motif_tpu_torch.trainer import Trainer, TrainerConfig

    model = _four_anchor_model(dev)
    calls = []
    model.flow_predictor.register_forward_hook(lambda *a: calls.append(1))
    rng = np.random.default_rng(0)
    batch = {"lq": rng.random((2, 4, 16, 16, 3), np.float32),
             "gt": rng.random((2, 5, 64, 64, 3), np.float32),
             "times": np.float32([[0.25, 0.5, 0.75]] * 2),
             "flow": rng.standard_normal((2, 16, 16, 16, 2), np.float32),
             "flow_gt": rng.standard_normal((2, 3, 4, 64, 64, 2),
                                            np.float32) * 3}
    tr = Trainer(model, TrainerConfig(teacher_forcing_steps=1), iters=2,
                 family="Ours_44")
    for use_gt in (True, False):
        before = dict(kernels.LAUNCHES)
        aux = tr.compute_grads(batch, use_gt)
        grads = [p.grad.clone() for p in tr.params]
        launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
        assert launched == {"splat_fused": 1, "dcn_im2col": 90,
                            "siren_mlp": 3}
        with _plain_versions():
            plain = tr.compute_grads(batch, use_gt)
        assert abs(float(aux["loss"]) - float(plain["loss"])) <= \
            1e-5 * abs(float(plain["loss"]))
        for (name, p), a in zip(model.named_parameters(), grads):
            if float(p.grad.abs().max()) > 0:
                _grad_close(a, p.grad, name)
            else:
                assert float(a.abs().max()) == 0.0, name
    assert calls == []


def test_splat_fused_at_the_ours44_training_step(dev):
    """C = 130 over 224 images of 128² (4.8e8 payload elements): the
    forward against the plain version and the backward against autograd
    through it."""
    g = torch.Generator(device=dev).manual_seed(8)
    B, H, W, C = 224, 128, 128, 130
    img = torch.randn((B, H, W, C), device=dev, generator=g)
    flow = torch.randn((B, H, W, 2), device=dev, generator=g) * 3.0
    z = -(torch.randn((B, H, W, 1), device=dev, generator=g)).abs()
    with torch.no_grad():
        got = softsplat.splat_fused(img, flow, z, True)
        want = softsplat.splat_fused_plain(img, flow, z, True)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4
    del got, want
    cot = (torch.randn((B, H, W, C), device=dev, generator=g),
           torch.randn((B, H, W, 1), device=dev, generator=g))
    got = _grads(lambda *a: softsplat.splat_fused(*a, True)[:2],
                 (img, flow, z), cot)
    want = _grads(lambda *a: softsplat.splat_fused_plain(*a, True)[:2],
                  (img, flow, z), cot)
    for what, a, b in zip(("img", "flow", "z"), got, want):
        _grad_close(a, b, what)


def test_siren_mlp_at_the_ours44_training_step(dev):
    """The STINF (67 → 64 → 64 → 256 → 3) over the Ours_44 step's 3.67M
    tokens: the forward against the plain version (1e-5, as at the
    serving shapes), the backward against autograd through it."""
    g = torch.Generator(device=dev).manual_seed(9)
    dims = (67, 64, 64, 256, 3)
    ws = [(torch.rand((o, i), device=dev, generator=g) * 2 - 1)
          * hidden_bound(i, 30.0) for i, o in zip(dims[:-1], dims[1:])]
    bs = [torch.rand((o,), device=dev, generator=g) * 0.2 - 0.1
          for o in dims[1:]]
    x = torch.rand((224 * 128 * 128, 67), device=dev, generator=g) * 2 - 1
    with torch.no_grad():
        assert float((siren_kernel.siren_mlp(x, ws, bs)
                      - siren_kernel.siren_mlp_plain(x, ws, bs)).abs().max()
                     ) <= 1e-5
    cot = (torch.randn((x.shape[0], 3), device=dev, generator=g),)
    n = len(ws)

    def run(op):
        return lambda xx, *p: op(xx, list(p[:n]), list(p[n:]))
    got = _grads(run(siren_kernel.siren_mlp), (x, *ws, *bs), cot)
    want = _grads(run(siren_kernel.siren_mlp_plain), (x, *ws, *bs), cot)
    for k, (a, c) in enumerate(zip(got, want)):
        _grad_close(a, c, k)


# ---------------------------------------------------------------------------
# The baselines: the float32 SIREN cut into launches at VideoINR's widths,
# the DCN at EDVR's 16 channels a group, one forward of each family.
# ---------------------------------------------------------------------------

VIDEOINR_MLPS = [[201, 64, 64, 256, 64], [263, 64, 64, 256, 4],
                 [525, 64, 64, 256, 256, 3]]


@pytest.mark.parametrize("dims", VIDEOINR_MLPS,
                         ids=lambda d: "-".join(map(str, d)))
@pytest.mark.parametrize("sine_last", [False, True])
def test_siren_mlp_videoinr_widths(dev, dims, sine_last):
    """VideoINR's SIRENs, two of them larger than one block's shared
    memory, over a token count that is not a tile multiple: one launch per
    entry of `segments`, each counted; the result within 1e-5 of the
    plain version (the cut keeps every output's k order)."""
    ws, bs, g = _siren(dev, dims)
    x = torch.rand((5001, dims[0]), device=dev, generator=g) * 2 - 1
    got, n = _launches("siren_mlp", lambda: siren_kernel.siren_mlp(
        x, ws, bs, 30.0, sine_last))
    assert n == len(siren_kernel.segments(dims))
    want = siren_kernel.siren_mlp_plain(x, ws, bs, 30.0, sine_last)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_siren_mlp_cut_replays_from_a_cuda_graph(dev):
    """encode_imnet's five launches captured and replayed on new tokens."""
    dims = VIDEOINR_MLPS[2]
    ws, bs, g = _siren(dev, dims)
    x = torch.rand((3000, dims[0]), device=dev, generator=g) * 2 - 1
    packed = siren_kernel.pack(ws, bs)
    new = [torch.rand(x.shape, device=dev, generator=g) * 2 - 1
           for _ in range(2)]
    for out, x_new in zip(_replayed(lambda: siren_kernel.siren_mlp(
            x, ws, bs, packed=packed), [x], [[t] for t in new]), new):
        torch.testing.assert_close(
            out, siren_kernel.siren_mlp_plain(x_new, ws, bs), rtol=0,
            atol=1e-5)


@pytest.mark.parametrize("H,W", [(64, 112), (32, 56), (16, 28)],
                         ids=["L1", "L2", "L3"])
def test_dcn_im2col_edvr_groups(dev, H, W):
    """EDVR's DCNs: nf 128 in 8 groups of 16 channels (the kernel's generic
    4-wide path), at the PCD's three levels of a 64x112 request's two
    frames. atol 1e-5."""
    x, off, mask = _dcn_inputs(dev, 2, H, W, 8, 16, 3, 1, 1, 1, True)
    got, n = _launches("dcn_im2col", lambda: dcn.dcn_im2col(
        x, off, mask, 3, 1, 1, 1, 8))
    assert n == 1
    torch.testing.assert_close(
        got, dcn.dcn_im2col_plain(x, off, mask, 3, 1, 1, 1, 8), rtol=0,
        atol=1e-5)


BASELINE_LAUNCHES = {  # one forward on 2 frames of 16x24, 3 times
    "LIIF": {"dcn_im2col": 42, "siren_mlp": 3 * 8},
    "ZSM": {"dcn_im2col": 42}, "TMNet": {"dcn_im2col": 44},
    "EDVR": {"dcn_im2col": 4}, "Super_SloMo": {}}


@pytest.mark.parametrize("family", list(BASELINE_LAUNCHES))
def test_baseline_forward_matches_the_plain_versions(dev, family):
    """Each baseline at its yml's width (configs/test_vid4_*.yml; 1 / 1
    residual blocks), DCN offsets perturbed, through Evaluator.infer on 2
    LQ frames of 16x24 → 3 times at 64x96: its kernels launch as counted,
    and the frames hold against the plain versions to 1e-5."""
    from motif_tpu_torch.eval import Evaluator
    from motif_tpu_torch.models.factory import build_baseline
    from motif_tpu_torch.models.pcd import DCNSep
    from motif_tpu_torch.utils import config

    name = {"LIIF": "liif", "ZSM": "zsm", "TMNet": "tmnet", "EDVR": "edvr",
            "Super_SloMo": "superslomo"}[family]
    yml = (pathlib.Path(__file__).resolve().parents[1] / "configs"
           / f"test_vid4_{name}.yml")
    net = config.parse(str(yml), is_train=False)["network_G"]
    model = build_baseline(net | {"front_RBs": 1, "back_RBs": 1}, dev)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, DCNSep):
                w, b = mod.conv_offset_mask.weight, mod.conv_offset_mask.bias
                w.copy_(torch.randn(w.shape, generator=g) * 0.01)
                b.copy_(torch.randn(b.shape, generator=g))
    ev = Evaluator(model, family=family, device=dev)
    rng = np.random.default_rng(0)
    lq = rng.random((1, 2, 16, 24, 3), np.float32)
    times = np.float32([[0.0, 0.5, 1.0]])
    before = dict(kernels.LAUNCHES)
    got, stats = ev.infer(lq, times, (64, 96))
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                if v != before[k]}
    assert launched == BASELINE_LAUNCHES[family] and stats is None
    with _plain_versions():        # eagerly: a replay runs the kernels
        want, _ = ev._infer_eager(lq, times, (64, 96))
    assert got.shape == (3, 1, 64, 96, 3) and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-5


# ---------------------------------------------------------------------------
# Evaluator.infer's captured graph per shape bucket, and the deterministic
# plain DCN backward the training gates' state is reached with
# ---------------------------------------------------------------------------

def test_captured_infer_matches_eager_in_two_buckets(dev):
    """MoTIF at channel 16 (1 / 2 blocks, DCN offsets perturbed) through
    Evaluator.infer on two LQ shapes, two buckets: each request, captured
    and then replayed, against `_forward` run eagerly (`_infer_eager`),
    frames within 1e-5 and the flow statistics within 1e-5 relative (the
    splat sums in a varying order); a replay launches one forward's
    kernels, counted from the capture's tape."""
    from motif_tpu_torch.eval import Evaluator

    ev = Evaluator(_four_anchor_model(dev, 2), iters=2, device=dev)
    rng = np.random.default_rng(0)
    times = np.float32([[0.0, 0.4, 1.0]])
    for h, w in ((16, 24), (20, 28)):
        lq = rng.random((1, 4, h, w, 3), np.float32)
        first, _ = ev.infer(lq, times, (4 * h, 4 * w))
        before = dict(kernels.ENTRY_LAUNCHES)
        got, stats = ev.infer(lq, times, (4 * h, 4 * w))
        launched = {k: v - before.get(k, 0)
                    for k, v in kernels.ENTRY_LAUNCHES.items()
                    if v != before.get(k, 0)}
        assert launched == {"dcn_im2col/float32": 42,
                            "siren_mlp/float32/whole": 3,
                            "splat_fused/float32/generic": 1}
        want, want_stats = ev._infer_eager(lq, times, (4 * h, 4 * w))
        assert got.shape == (3, 1, 4 * h, 4 * w, 3) and np.isfinite(got).all()
        for frames in (first, got):
            assert float(np.abs(frames - want).max()) <= 1e-5
        for a, b in zip(stats, want_stats):
            assert abs(a - b) <= 1e-5 * abs(b)
    assert len(ev._buckets) == 2


def test_a_replayed_request_does_not_synchronise(dev):
    """A request replayed from its bucket under
    torch.cuda.set_sync_debug_mode("error"): nothing on the way reads the
    device (no .item(), no pageable copy); only the final event's wait,
    which the mode lets through, blocks."""
    from motif_tpu_torch.eval import Evaluator

    ev = Evaluator(_four_anchor_model(dev, 2), iters=2, device=dev)
    lq = np.random.default_rng(0).random((1, 4, 16, 24, 3), np.float32)
    times = np.float32([[0.0, 0.5, 1.0, 0.25]])      # two chunks
    want, want_stats = ev.infer(lq, times, (64, 96))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, stats = ev.infer(lq, times, (64, 96))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got.shape == (4, 1, 64, 96, 3)
    assert float(np.abs(got - want).max()) <= 1e-5
    for a, b in zip(stats, want_stats):
        assert abs(a - b) <= 1e-5 * abs(b)


def test_deterministic_plain_dcn_backward_is_bit_equal(dev):
    """The plain DCN backward at the PCD's L1 (2 x 64 x 112, 8 groups of
    8), under torch.use_deterministic_algorithms: two runs bit-equal (its
    scatter_add_ sums in a fixed order there)."""
    x, off, mask = _dcn_inputs(dev, 2, 64, 112, 8, 8, 3, 1, 1, 1, True)
    g = torch.Generator(device=dev).manual_seed(2)
    g_cols = torch.randn((2 * 64 * 112, 8 * 9 * 8), device=dev, generator=g)
    torch.use_deterministic_algorithms(True)
    try:
        runs = [dcn.dcn_im2col_backward_plain(x, off, mask, g_cols, 3, 1, 1,
                                              1, 8) for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The Adobe and arbitrary-scale recipes (MoTIF settings 1-6, Ours_7): the
# splat at the `_a` output sizes that are no multiple of 16, with z at zero
# (predict_Z off) and with float16 sums at C = 130 (setting 6 serving); the
# DCN at the PCD levels of an `_a` batch of 24 (LQ 32²); the SIREN whose
# synthesis net is too wide for one block (setting 6: 331 inputs); one
# forward of settings 2 and 6 and of Ours_7 against the plain versions.
# ---------------------------------------------------------------------------

def _a_splat_inputs(dev, side, C=130, B=12):
    g = torch.Generator(device=dev).manual_seed(side)
    img = torch.randn((B, side, side, C), device=dev, generator=g)
    flow = torch.randn((B, side, side, 2), device=dev, generator=g) * 3.0
    return img, flow, torch.zeros((B, side, side, 1), device=dev)


@pytest.mark.parametrize("side", [72, 120])
def test_splat_fused_at_arbitrary_sizes_with_z_at_zero(dev, side):
    """C = 130, z = 0 (settings <= 3 and Ours_7 splat with the max
    skipped) at 72² and 120² (`_a` outputs, not multiples of 16): the
    forward against the plain version (out / norm 1e-4, max and count
    exact), the backward against autograd through it."""
    img, flow, z = _a_splat_inputs(dev, side)
    with torch.no_grad():
        got, n = _launches("splat_fused", lambda: softsplat.splat_fused(
            img, flow, z, True))
        want = softsplat.splat_fused_plain(img, flow, z, True)
    assert n == 1 and (got[2] == 1.0).all()
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    for a, b in zip(got[2:], want[2:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    g = torch.Generator(device=dev).manual_seed(side + 1)
    cot = (torch.randn(img.shape, device=dev, generator=g),
           torch.randn(z.shape, device=dev, generator=g))
    got = _grads(lambda *a: softsplat.splat_fused(*a, True)[:2],
                 (img, flow, z), cot)
    want = _grads(lambda *a: softsplat.splat_fused_plain(*a, True)[:2],
                  (img, flow, z), cot)
    for what, a, b in zip(("img", "flow", "z"), got, want):
        _grad_close(a, b, what)


@pytest.mark.parametrize("side", [72, 120])
@pytest.mark.parametrize("z_nonpositive", [True, False])
def test_splat_fused_float16_sums_at_c130(dev, side, z_nonpositive):
    """The float16-sum entry at MoTIF's C = 130 (setting 6 serves with
    float16 sums and no fused decode): 4 float16 ulps of the largest value
    on out / norm, the max and the count exact; counted as its own entry."""
    img, flow, z = _a_splat_inputs(dev, side, B=4)
    z = -torch.rand(z.shape, device=dev) if z_nonpositive else \
        torch.rand(z.shape, device=dev)
    before = dict(kernels.ENTRY_LAUNCHES)
    got = softsplat.splat_fused(img, flow, z, z_nonpositive,
                                scatter_dtype=torch.float16)
    key = "splat_fused/float16/C=130"
    assert kernels.ENTRY_LAUNCHES[key] - before.get(key, 0) == 1
    want = softsplat.splat_fused_plain(img, flow, z, z_nonpositive,
                                       scatter_dtype=torch.float16)
    for a, b in zip(got[:2], want[:2]):
        tol = 4 * ulp_at(max(float(b.abs().max()), 1e-3), 10)
        torch.testing.assert_close(a, b, rtol=0, atol=tol)
    for a, b in zip(got[2:], want[2:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("side", [32, 16, 8], ids=["L1", "L2", "L3"])
def test_dcn_v2_at_the_arbitrary_scale_pcd_levels(dev, side):
    """The PCD of an `_a` batch of 24 at LQ 32² (48 frames, G 8, cg 8):
    the forward against the plain version (1e-5) and the backward against
    autograd through it."""
    g = torch.Generator(device=dev).manual_seed(side)
    B, G, cg, K = 48, 8, 8, 3
    x = torch.randn((B, side, side, G * cg), device=dev, generator=g)
    com = torch.randn((B, side, side, G * K * K * 3), device=dev,
                      generator=g) * 2.0
    w = torch.randn((64, G * cg, K, K), device=dev, generator=g) * 0.05
    b = torch.randn((64,), device=dev, generator=g)
    n2 = G * K * K * 2

    def run(op):
        def f(xx, cc, ww, bb):
            return op(xx, cc[..., :n2], torch.sigmoid(cc[..., n2:]), ww, bb,
                      K, 1, 1, 1, G)
        return f
    with torch.no_grad():
        got, n = _launches("dcn_im2col", lambda: run(dcn.dcn_v2)(x, com, w,
                                                                 b))
        want = run(dcn.dcn_v2_plain)(x, com, w, b)
    assert n == 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    cot = (torch.randn(want.shape, device=dev, generator=g),)
    got = _grads(run(dcn.dcn_v2), (x, com, w, b), cot)
    want = _grads(run(dcn.dcn_v2_plain), (x, com, w, b), cot)
    for what, a, c in zip(("x", "offset|mask", "weight", "bias"), got, want):
        _grad_close(a, c, what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_siren_mlp_warp_to_many_synthesis_is_cut(dev, dtype):
    """The synthesis net of setting 6 (331 -> 64 -> 64 -> 64 -> 256 -> 3)
    fits no block whole in either type: two launches, float32 bit-equal
    to the plain version, bfloat16 held by accuracy (mlp_gate); replayed
    from a CUDA graph."""
    dims = [331, 64, 64, 64, 256, 3]
    if dtype == torch.bfloat16:
        x, ws, bs = _bf16_case(dev, dims, 5001, False)
    else:
        ws, bs, g = _siren(dev, dims)
        x = torch.rand((5001, 331), device=dev, generator=g) * 2 - 1
    got, n = _launches("siren_mlp", lambda: siren_kernel.siren_mlp(x, ws,
                                                                   bs))
    assert n == 2
    if dtype == torch.bfloat16:
        _hold_bf16(x, ws, bs, False, False, got)
    else:
        assert torch.equal(got, siren_kernel.siren_mlp_plain(x, ws, bs))
    (replayed,) = list(_replayed(lambda: siren_kernel.siren_mlp(x, ws, bs),
                                 [x], [[x]]))
    assert torch.equal(replayed, got) or dtype == torch.bfloat16


SETTING_LAUNCHES = {  # one forward of 3 times: (setting, linear_motion)
    (2, False): {"dcn_im2col/float32": 42, "siren_mlp/float32/whole": 3,
                 "splat_fused/float32/generic": 1},
    (6, False): {"dcn_im2col/float32": 42, "siren_mlp/float32/whole": 3,
                 "splat_fused/float32/generic": 1},
    (3, True): {"dcn_im2col/float32": 42, "siren_mlp/float32/whole": 2,
                "splat_fused/float32/generic": 1}}


@pytest.mark.parametrize("setting,linear", list(SETTING_LAUNCHES),
                         ids=["s2", "s6", "ours7"])
def test_settings_forward_matches_the_plain_versions(dev, setting, linear):
    """MoTIF at setting 2 or 6, or Ours_7, at channel 16 (1 / 2 blocks,
    DCN offsets perturbed, alpha > 0) through Evaluator.infer on LR 16² ->
    64², 3 times: its kernels launch as counted (channel 16: a generic
    splat payload of 82), the frames and flow statistics hold against the
    plain versions to 1e-5, captured and replayed."""
    from motif_tpu_torch.eval import Evaluator
    from motif_tpu_torch.models.motif import build_motif
    from motif_tpu_torch.models.pcd import DCNSep

    model = build_motif(16, 1, 2, device=dev, seed=0, setting=setting,
                        linear_motion=linear)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        model.alpha.fill_(0.5)
        for mod in model.modules():
            if isinstance(mod, DCNSep):
                w, b = mod.conv_offset_mask.weight, mod.conv_offset_mask.bias
                w.copy_(torch.randn(w.shape, generator=g) * 0.01)
                b.copy_(torch.randn(b.shape, generator=g))
    ev = Evaluator(model, iters=2, family="Ours_7" if linear else "Ours",
                   device=dev)
    rng = np.random.default_rng(0)
    lq = rng.random((1, 4, 16, 16, 3), np.float32)
    times = np.float32([[0.1, 0.5, 0.75]])
    before = dict(kernels.ENTRY_LAUNCHES)
    got, stats = ev.infer(lq, times, (64, 64))
    launched = {k: v - before.get(k, 0)
                for k, v in kernels.ENTRY_LAUNCHES.items()
                if v != before.get(k, 0)}
    assert launched == SETTING_LAUNCHES[(setting, linear)]
    with _plain_versions():
        want, want_stats = ev._infer_eager(lq, times, (64, 64))
    assert got.shape == (3, 1, 64, 64, 3) and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-5
    for a, b in zip(stats, want_stats):
        assert abs(a - b) <= 1e-5 * max(abs(b), 1e-12)

