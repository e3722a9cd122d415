"""A training step as the recipes define it, worked out by the reference
(the reference VideoSR_base_model.py and base_model.py, as MoTIF trains):

* teacher forcing: use_gt ~ Bernoulli(max(0, 1 - step / T)), T =
  `teacher_forcing_steps`, drawn on the host from `random.Random(seed)`;
* the pixel loss: Charbonnier, sum(sqrt(d^2 + 1e-6)), summed per target
  time against GT[:, 1:-1], times (4 / scale)^2, scale = output width /
  LQ width; plus 0.1 * Charbonnier(flow, teacher flow) * max(0, 1 -
  (step % T) / T);
* Adam (betas 0.9 / 0.99, eps 1e-8) over every parameter, at the cosine
  restart schedule's lr of the step before the update:
  eta_min + (lr - eta_min) * (1 + cos(pi * step / T_period)) / 2 in the
  first period."""

from __future__ import annotations

import math
import random

import torch


def charbonnier(x, y, eps: float = 1e-6):
    d = x - y
    return torch.sum(torch.sqrt(d * d + eps))


def use_gt_draws(seed: int, steps: int, T: int) -> list:
    rng = random.Random(seed)
    return [rng.random() < max(0.0, 1.0 - s / T) for s in range(steps)]


def lr_at(step: int, base: float, period: float, eta_min: float) -> float:
    return eta_min + (base - eta_min) * (1 + math.cos(math.pi * step
                                                      / period)) / 2


def loss(model, batch: dict, use_gt: bool, step: int, iters: int,
         T: int, flow_weight: float = 0.1):
    lq, gt, times = batch["lq"], batch["gt"], batch["times"]
    out_hw = (gt.shape[2], gt.shape[3])
    flows = None
    if "flow" in batch or "flow_gt" in batch:
        flows = (batch.get("flow"), batch.get("flow_gt"))
    frames, flow, flow_gt = model(lq, times, out_hw, use_gt=use_gt,
                                  iters=iters, target_frames=gt, train=True,
                                  flows=flows)
    target = gt[:, 1:-1]
    l_pix = sum(charbonnier(frames[i], target[:, i])
                for i in range(frames.shape[0]))
    l_pix = l_pix * (4.0 / (out_hw[1] / lq.shape[3])) ** 2
    ratio = max(0.0, 1.0 - (step % T) / T)
    return l_pix + flow_weight * charbonnier(flow, flow_gt) * ratio


class Adam:
    """torch.optim.Adam's update, written out: m, v, the bias corrections,
    p -= lr * m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, params, betas=(0.9, 0.99), eps: float = 1e-8):
        self.params = list(params)
        self.b1, self.b2 = betas
        self.eps = eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(lr * (m / c1) / ((v / c2).sqrt() + self.eps))
