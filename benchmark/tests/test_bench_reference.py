"""The frozen plain reference against the program's CPU path at a tiny
width, on the same weights from the seed: MoTIF's forward for two and four
anchors, and a training step's loss and gradients. (The test imports both;
the reference itself imports nothing of the program.)"""

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import infer as ref_infer
from benchmark.reference import train as ref_train
from benchmark.tests import tiny

SEED = 2_718_281_828


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _pair(cell_name):
    from motif_tpu_torch.models.factory import define_g

    cfg = tiny.cell(cell_name).config
    prog = define_g(dict(cfg["network_G"]), device="cpu", n_frames=4)
    ref = ref_infer.build(cfg, "cpu")
    weights.load(prog, SEED, cfg["init"])
    weights.load(ref, SEED, cfg["init"])
    return cfg, prog, ref


@pytest.mark.parametrize("cell", ["ours-clips", "ours44-clips"])
def test_forward_matches_the_program(cell):
    cfg, prog, ref = _pair(cell)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.random((1, 4, 16, 24, 3), dtype=np.float32))
    t = torch.tensor([[0.0, 0.4, 0.75]])
    with torch.no_grad():
        got = prog(x, t, (64, 96), iters=2)
        want = ref(x, t, (64, 96), iters=2)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, atol=1e-5, rtol=0), float(
            (a - b).abs().max())


def test_weights_follow_the_seed_and_the_rules():
    cfg, prog, _ = _pair("ours-clips")
    p = dict(prog.named_parameters())
    assert float(p["alpha"].detach()) == -20.0
    w = p["imnet.net.0.linear.weight"]
    assert float(w.abs().max()) <= 1.0 / w.shape[1]
    again = weights.make(SEED, {"alpha": (1,), "imnet.net.0.linear.weight":
                                tuple(w.shape)}, cfg["init"], "cpu")
    other = weights.make(SEED + 1, {"x.weight": (4, 4)}, cfg["init"], "cpu")
    assert other["x.weight"].abs().max() <= 0.5
    assert again["alpha"].item() == -20.0


def test_training_loss_and_gradients_match_the_program():
    from motif_tpu_torch.trainer import Trainer, TrainerConfig

    cfg, prog, ref = _pair("ours-clips")
    prog.train()
    ref.train()
    rng = np.random.default_rng(1)
    batch = {"lq": rng.random((2, 4, 16, 16, 3), dtype=np.float32),
             "gt": rng.random((2, 5, 64, 64, 3), dtype=np.float32),
             "times": np.tile(np.float32([0.25, 0.5, 0.75]), (2, 1))}
    tr = Trainer(prog, TrainerConfig(lr=1e-4), (64, 64), iters=2, seed=3)
    total, _ = tr.loss(batch, use_gt=True)
    total.backward()
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    want = ref_train.loss(ref, b, True, 0, 2, 150000)
    want.backward()
    assert float(total) == pytest.approx(float(want), rel=1e-6)
    for (n, p), q in zip(prog.named_parameters(), ref.parameters()):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        h = q.grad if q.grad is not None else torch.zeros_like(q)
        scale = max(float(h.abs().max()), 1e-30)
        assert float((g - h).abs().max()) <= 1e-4 * scale, n
