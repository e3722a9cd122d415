"""Package rules of motif_tpu_torch: it imports neither JAX nor motif_tpu
(nor does chip_smoke.py), its entry points default to CUDA and raise
without it unless device="cpu" is passed, and its kernel wrappers take
their plain versions only for CPU tensors."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import motif_tpu_torch
from motif_tpu_torch.eval import Evaluator
from motif_tpu_torch.models.motif import build_motif
from motif_tpu_torch.ops import dcn, kernels, siren_kernel, softsplat

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "motif_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "motif_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_or_motif_tpu_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_kernel_has_a_source():
    for name in kernels.SOURCES:
        assert (kernels.CSRC / f"{name}.cu").is_file()
    assert all(any(src.startswith(name) for src in kernels.SOURCES)
               for name in kernels.KERNELS)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_cuda_and_raises(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        motif_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError):
        motif_tpu_torch.resolve_device("cuda")
    assert motif_tpu_torch.resolve_device("cpu").type == "cpu"


def test_build_motif_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        build_motif(16, 1, 2)


SERVING = dict(fused_decode=True, compute_dtype="bfloat16",
               splat_dtype="float16", raft_resolution=0.5, decode_chunks=3)


def test_entry_points_raise_without_cuda_with_the_knobs_too(no_cuda):
    """The serving knobs change nothing about where the entry points run."""
    with pytest.raises(RuntimeError, match="CUDA"):
        build_motif(16, 1, 2, **SERVING)
    m = build_motif(16, 1, 2, device="cpu", **SERVING)
    assert m.fused_decode and m.compute_dtype == torch.bfloat16
    assert m.splat_dtype == torch.float16 and m.decode_chunks == 3
    with pytest.raises(RuntimeError, match="CUDA"):
        Evaluator(m, **SERVING)
    plain = build_motif(16, 1, 2, device="cpu")
    ev = Evaluator(plain, device="cpu", **SERVING)
    assert ev.model.fused_decode and ev.model.raft_resolution == 0.5
    assert all(net.skip_first_linear for net in
               (plain.flow_imnet, plain.imnet, plain.synth_net))
    plain.configure()                      # every knob back to its default
    assert not plain.fused_decode and plain.compute_dtype is None
    assert not plain.synth_net.skip_first_linear


def test_evaluator_changes_only_the_knobs_it_is_given():
    """Evaluator(model, **knobs) sets the named knobs and keeps the model's
    others: a model built for serving keeps its fused decode and float16
    splat when a caller asks for decode chunks."""
    m = build_motif(16, 1, 2, device="cpu", fused_decode=True,
                    splat_dtype="float16")
    ev = Evaluator(m, device="cpu", decode_chunks=3)
    assert ev.model is m and m.decode_chunks == 3
    assert m.fused_decode and m.synth_net.skip_first_linear
    assert m.splat_dtype == torch.float16
    assert m.compute_dtype is None and m.raft_resolution == 1.0
    assert m.knobs() == dict(fused_decode=True, compute_dtype=None,
                             splat_dtype="float16", raft_resolution=1.0,
                             decode_chunks=3)


def test_evaluator_raises_without_cuda(no_cuda):
    m = build_motif(16, 1, 2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Evaluator(m)
    assert Evaluator(m, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("call", [
    lambda t: softsplat.splat_fused(t((1, 4, 4, 3)), t((1, 4, 4, 2)),
                                    t((1, 4, 4, 1)), False),
    lambda t: dcn.dcn_im2col(t((1, 4, 4, 8)), t((1, 4, 4, 36)),
                             t((1, 4, 4, 18)), 3, 1, 1, 1, 2),
    lambda t: siren_kernel.siren_mlp(t((5, 3)), [t((4, 3))], [t((4,))]),
], ids=["splat_fused", "dcn_im2col", "siren_mlp"])
def test_wrappers_take_plain_versions_on_cpu_without_counting(call):
    before = dict(kernels.LAUNCHES)
    rng = np.random.default_rng(0)
    out = call(lambda shape: torch.from_numpy(rng.random(shape)))
    assert kernels.LAUNCHES == before
    assert all(torch.isfinite(o).all() for o in
               (out if isinstance(out, tuple) else (out,)))


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """No toolkit: building raises (the CPU tests never build)."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels.shutil, "which", lambda _: None)
    monkeypatch.setattr(kernels.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build(["siren_mlp"])


def test_library_path_follows_every_header(monkeypatch, tmp_path):
    """A changed csrc/*.cuh gives a new library name, so no stale build of
    a source that includes it is loaded."""
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("#define A 1\n")
    first = kernels._library_path("k")
    assert kernels._library_path("k") == first
    (tmp_path / "common.cuh").write_text("#define A 2\n")
    second = kernels._library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// changed\n')
    assert kernels._library_path("k") not in (first, second)


@pytest.mark.parametrize("dims,fused,rows,smem", [
    ([67, 64, 64, 256, 3], [0, 0, 1, 0], 64, 174_368),
    ([66, 64, 64, 256, 64], [0, 0, 1, 0], 64, 231_680),
    ([198, 64, 64, 64, 256, 3], [0, 0, 0, 1, 0], 64, 224_544),
    ([48, 128, 96, 8], [0, 1, 0], 128, 208_800),
    ([64, 256, 256, 3], [0, 1, 0], 256, 600_096),
], ids=["stinf", "sinf", "synth", "wide-stored", "too-wide"])
def test_siren_plan(dims, fused, rows, smem):
    """The fused SIREN's plan: which wide layers feed the next chunk by
    chunk, the activation buffers' height and the shared memory a block
    needs (the three MoTIF MLPs fit in 232,448 B, a 256-256 pair does not)."""
    assert siren_kernel.plan(dims) == (fused, rows, smem)
    assert (smem <= siren_kernel.SMEM_LIMIT) == (dims != [64, 256, 256, 3])


@pytest.mark.parametrize("C,tile", [(130, (8, 8)), (5, (8, 8)),
                                    (1000, (4, 8)), (50_000, (1, 1))],
                         ids=["motif", "narrow", "wide", "widest"])
def test_splat_plan(C, tile):
    """The splat's target tile: 8x8 while a [64, C + 3] float tile and the
    staged records fit in a block's shared memory, then halved, rows first
    (MoTIF's C = 130 takes 38,144 B)."""
    assert softsplat.plan(C) == tile
    th, tw = tile
    assert th * tw * (C + 3) * 4 + softsplat.STAGE_BYTES <= softsplat.SMEM_LIMIT


@pytest.mark.parametrize("key", sorted(softsplat.TILE),
                         ids=lambda k: f"C{k[0]}-{k[1]}B")
def test_splat_plan_takes_each_compiled_widths_tile(key):
    """Each compiled (C, bytes per sum) gets the tile the card's sweep
    chose for it, and that tile with its staged records fits in a block's
    shared memory; C = 130 and any other width still start from 8x8."""
    C, elem = key
    th, tw = softsplat.plan(C, elem)
    assert (th, tw) == softsplat.TILE[key]
    assert (th * tw * ((C + 2) * elem + 4) + softsplat.STAGE_BYTES
            <= softsplat.SMEM_LIMIT)
    assert softsplat.plan(130, elem) == (8, 8)


def test_splat_plan_halves_a_compiled_tile_that_does_not_fit(monkeypatch):
    """A compiled width's tile is halved, rows first, as any other tile:
    64x64 float32 sums at C = 64 take 1.1 MB, 8x64 fit."""
    monkeypatch.setattr(softsplat, "TILE", {(64, 4): (64, 64)})
    assert softsplat.plan(64, 4) == (8, 64)
    assert softsplat.plan(64, 2) == (8, 8)


def test_splat_plan_raises_when_one_pixel_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        softsplat.plan(60_000)
