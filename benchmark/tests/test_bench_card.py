"""On the card only: the control of `correct` at a size a test run holds
(the tiny cells of tiny.py, with the kernels): the reference with TF32 on,
put in the program's place, must come out not correct; the program itself
must come out correct. Run on the card with
`python -m pytest -q -m cuda benchmark/tests/test_bench_card.py`."""

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.run import Host

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return Host(torch, torch.device("cuda", 0))


def _failed(rec):
    return [c["name"] for c in rec["checks"] if not c["ok"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ours-clips", "ours44-clips"])
def test_clips_program_and_control(name):
    host = _card()
    cell = tiny.cell(name)
    kind = harness.load_module("traffic", "clips")
    assert not _failed(kind.run(cell, tiny.args(seconds=600.0), host))
    assert _failed(kind.control(cell, tiny.args(control="tf32"), host))


@pytest.mark.cuda
def test_train_program_and_control(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    host = _card()
    cell = tiny.cell("ours44-train")
    kind = harness.load_module("traffic", "train")
    assert not _failed(kind.run(cell, tiny.args(seconds=1.0), host))
    assert _failed(kind.control(cell, tiny.args(control="tf32"), host))
