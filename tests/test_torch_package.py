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
    for name in kernels.KERNELS:
        assert (kernels.CSRC / f"{name}.cu").is_file()


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


def test_evaluator_raises_without_cuda(no_cuda):
    m = build_motif(16, 1, 2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Evaluator(m)
    assert Evaluator(m, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("call", [
    lambda t: softsplat.splat_fused(t((1, 4, 4, 3)), t((1, 4, 4, 2)),
                                    t((1, 4, 4, 1)), False),
    lambda t: dcn.dcn_sample(t((1, 4, 4, 8)), t((1, 2, 5)), t((1, 2, 5))),
    lambda t: siren_kernel.siren_mlp(t((5, 3)), [t((4, 3))], [t((4,))]),
], ids=["splat_fused", "dcn_sample", "siren_mlp"])
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
