"""A run with the timed path broken underneath sees `correct` come out
false, once for each fault a cell can have (the card's look skipped: the
CPU rehearsal of tiny.py drives the rest of the run):

* clips: an answer altered where it is produced (`Evaluator.infer`): a
  whole frame, one channel, a tile region; and a sampled answer that
  never came;
* training: a step that returns its state unchanged (the optimiser's
  update skipped), and half of each batch left out with the mean taken
  over the rest (the recipe's summed loss doubled).

No cell spans chips, so no exchange between chips can be left out."""

from unittest import mock

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _checks(name, cell=None, **kw):
    cell = cell or tiny.cell(name)
    kind = harness.load_module("traffic", cell.traffic["kind"])
    rec = kind.run(cell, tiny.args(**kw), tiny.cpu_host())
    return {c["name"]: c for c in rec["checks"]}


def _failed(checks):
    return [n for n, c in checks.items() if not c["ok"]]


def _altered(change):
    """`Evaluator.infer` with `change(frames)` applied to its answer."""
    from motif_tpu_torch.eval import Evaluator

    infer = Evaluator.infer

    def altered(self, lq, times, out_hw):
        frames, stats = infer(self, lq, times, out_hw)
        frames = frames.copy()
        change(frames)
        return frames, stats

    return mock.patch.object(Evaluator, "infer", altered)


def _shift_frame(frames):
    frames[-1] += 0.01


def _shift_channel(frames):
    # one of the three channels: a third of each frame's values
    frames[..., 1] += 0.01


def _shift_tile(frames):
    # an 8 x 12 tile at the frames' corner: 1.6% of each frame's values
    frames[..., -8:, -12:, :] += 0.01


@pytest.mark.parametrize("change,caught", [
    (_shift_frame, "frame_median_abs_max"),
    (_shift_channel, "frame_p999_abs_max"),
    (_shift_tile, "frame_p999_abs_max")], ids=["frame", "channel", "tile"])
def test_clips_answer_altered(change, caught):
    with _altered(change):
        checks = _checks("ours-clips", seconds=600.0)
    assert caught in _failed(checks)


def test_clips_answer_never_came():
    """Sampled requests that the window never reached fail the run."""
    cell = tiny.cell("ours-clips")
    cell.traffic["max_requests"] = 4
    cell.limits.update(sample_from=8, sample=6)
    checks = _checks("ours-clips", cell=cell, seconds=30.0)
    assert _failed(checks) == ["answers_missing"]
    assert checks["answers_missing"]["value"] >= 2


def test_train_state_unchanged(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    with mock.patch.object(torch.optim.Adam, "step", lambda self: None):
        checks = _checks("ours44-train", seconds=0.2)
    assert {"grad_norm_gap", "change_norm_gap_median"} <= set(
        _failed(checks))
    assert checks["change_norm_gap_median"]["value"] > 0.9


def test_train_half_batch(tmp_path, monkeypatch):
    from motif_tpu_torch.trainer import Trainer

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    loss = Trainer.loss

    def half(self, batch, use_gt):
        rows = {k: (v[:v.shape[0] // 2] if hasattr(v, "shape") else v)
                for k, v in batch.items()}
        total, aux = loss(self, rows, use_gt)
        return total * 2.0, aux

    with mock.patch.object(Trainer, "loss", half):
        checks = _checks("ours44-train", seconds=0.2)
    assert {"loss_rel_first", "grad_norm_gap"} <= set(_failed(checks))
