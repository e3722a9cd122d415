"""What `Evaluator.infer` keeps from one request to the next, on the CPU:
the record of the model's weights (`_Weights`), read on every request
without a walk of the module tree, and each bucket's host staging of the
padded LQ and the times, written in place by every request and grown to
the most chunks a bucket has served. After the first request of each
bucket, requests mixing N = 2, 4 and 8 and two LQ sizes that pad alike
walk no tree (`eval.weight_walks`, and no call of `Module.parameters` /
`modules` / `buffers` / `named_modules`), allocate no staging
(`eval.staging_allocs`) and give the eager path's frames bit for bit; the
arrays a request returned are not written by the next one. The card's
counterpart is in `tests/test_torch_kernels.py`."""

import numpy as np
import pytest
import torch

from motif_tpu_torch import obs
from motif_tpu_torch.eval import Evaluator
from motif_tpu_torch.models.motif import build_motif

# (LQ h, w): both pad to 16 x 24, one bucket per number of times a chunk
SIZES = ((16, 24), (14, 22))
ORDER = (8, 2, 4, 4, 8, 2, 2, 8, 4, 2)      # the window's N, every bucket


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ev():
    return Evaluator(build_motif(16, 1, 1, device="cpu"), iters=2,
                     device="cpu")


def _request(rng, i, n):
    h, w = SIZES[i % 2]
    lq = rng.random((1, 4, h, w, 3), np.float32)
    times = np.float32(np.arange(n) / n + rng.random() / (2 * n))[None]
    return lq, times, (4 * h, 4 * w)


def _grew(before, name):
    return obs.counters().get(name, 0) - before.get(name, 0)


def test_requests_walk_no_tree_and_allocate_no_staging(ev, monkeypatch):
    """The set-up's requests (N = 2, 4, 8, as the benchmark warms up):
    one walk, and the staging of two buckets (an LQ and times each) with
    the times' grown once, from N = 4's two chunks to N = 8's three. Then
    ten requests: +0 walks and +0 staging, no module-tree iterator called,
    each request's frames and flow statistics those of `_infer_eager`."""
    rng = np.random.default_rng(0)
    before = obs.counters()
    for n in (2, 4, 8):
        ev.infer(*_request(rng, 0, n))
    assert _grew(before, "eval.weight_walks") == 1
    assert _grew(before, "eval.staging_allocs") == 2 + 2 + 1
    assert len(ev._buckets) == 2
    calls = []
    for name in ("parameters", "modules", "buffers", "named_modules"):
        def counted(self, *a, _fn=getattr(torch.nn.Module, name), _n=name,
                    **kw):
            calls.append(_n)
            return _fn(self, *a, **kw)
        monkeypatch.setattr(torch.nn.Module, name, counted)
    before = obs.counters()
    asked, got = [], []
    for i, n in enumerate(ORDER):
        req = _request(rng, i, n)
        asked.append(req)
        got.append(ev.infer(*req))
    assert calls == []
    assert _grew(before, "eval.weight_walks") == 0
    assert _grew(before, "eval.staging_allocs") == 0
    assert _grew(before, "eval.bucket_resets") == 0
    monkeypatch.undo()
    for (lq, times, hw), (frames, stats) in zip(asked, got):
        want, want_stats = ev._infer_eager(lq, times, hw)
        assert frames.shape == (times.shape[1], 1, *hw, 3)
        np.testing.assert_array_equal(frames, want)
        assert stats == want_stats


def test_returned_arrays_alias_no_later_request(ev):
    """Request k's frames and flow statistics, kept, are unchanged by
    request k + 1 on the same bucket with other inputs (and share no
    memory with the bucket's staging)."""
    rng = np.random.default_rng(1)
    first = _request(rng, 0, 4)
    frames, stats = ev.infer(*first)
    kept = frames.copy()
    bucket = next(b for b in ev._buckets.values() if b.t.shape[1] == 3)
    for buf in (bucket.lq_h, bucket.t_h):
        assert not np.shares_memory(frames, buf.numpy())
    later, _ = ev.infer(*_request(rng, 1, 4))
    assert not np.array_equal(later[:, :, :56, :88], kept[:, :, :56, :88])
    np.testing.assert_array_equal(frames, kept)
    want, want_stats = ev._infer_eager(*first)
    np.testing.assert_array_equal(frames, want)
    assert stats == want_stats
