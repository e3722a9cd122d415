"""Training, the counterpart of motif_tpu/trainer.py (reference
models/VideoSR_base_model.py + base_model.py): one optimiser step of a
MoTIF model (the `Ours` family, or the four-anchor Ours_44 / Ours_4 on the
dataset's precomputed flows) per batch.

The step keeps the reference's training semantics as the JAX package does
(VideoSR_base_model.py:127-158):
 * teacher forcing: use_gt ~ Bernoulli(max(0, 1 - step / teacher_forcing_steps)),
   drawn on the host per step from `random.Random(seed)`;
 * pixel loss: the criterion summed per target time against GT[:, 1:-1],
   scaled by (4 / scale)^2, scale = output width / LQ width;
 * flow distillation: + 0.1 * cb(flow, flow_GT)
   * max(0, 1 - (step % teacher_forcing_steps) / teacher_forcing_steps);
 * Adam (AdamW with a weight decay) over every parameter, the lr from the
   schedule at the step count before the update, as optax reads it.

optax updates every parameter at every step, a zero gradient included (RAFT
sits behind the stop-gradient; norm_gamma, norm_beta and shuffle are
checkpointed but unused). torch's optimisers skip a parameter whose `.grad`
is None, and from then on its moments and weight decay would differ from
the JAX package's; so every parameter autograd did not reach is given a
zero gradient before the update.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from motif_tpu_torch import losses, schedules

f32 = np.float32


@dataclass
class TrainerConfig:
    lr: float = 4e-4
    beta1: float = 0.9
    beta2: float = 0.99
    weight_decay: float = 0.0
    pixel_criterion: str = "cb"
    pixel_weight: float = 1.0
    lr_scheme: str = "CosineAnnealingLR_Restart"
    t_period: tuple = (150000, 150000, 150000, 150000)
    restarts: tuple = (150000, 300000, 450000)
    restart_weights: tuple = (1, 1, 1)
    eta_min: float = 1e-7
    lr_steps: tuple = ()
    lr_gamma: float = 0.5
    teacher_forcing_steps: int = 150000
    flow_loss_weight: float = 0.1
    warmup_iter: int = -1


def make_schedule(cfg: TrainerConfig) -> Callable:
    """step -> float32 lr: the cosine or multistep restart schedule, with
    the linear warmup of base_model.py:51-63 over its first `warmup_iter`
    steps."""
    if cfg.lr_scheme == "CosineAnnealingLR_Restart":
        base = schedules.cosine_annealing_restart(
            cfg.lr, cfg.t_period, list(cfg.restarts),
            list(cfg.restart_weights), cfg.eta_min)
    else:
        base = schedules.multistep_restart(
            cfg.lr, list(cfg.lr_steps), cfg.lr_gamma, list(cfg.restarts),
            list(cfg.restart_weights))
    if cfg.warmup_iter > 0:
        def sched(step):
            warm = f32(cfg.lr) * np.minimum(f32(step) / f32(cfg.warmup_iter),
                                            f32(1))
            return warm if step < cfg.warmup_iter else base(step)
        return sched
    return base


def make_optimizer(cfg: TrainerConfig, params):
    """(optimizer, schedule): Adam(betas, eps 1e-8), or AdamW with the
    weight decay when there is one (optax.adamw's decoupled decay times
    the lr). The lr is set from the schedule before each step."""
    params = list(params)
    sched = make_schedule(cfg)
    lr = float(sched(0))
    betas = (cfg.beta1, cfg.beta2)
    if cfg.weight_decay:
        opt = torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8,
                                weight_decay=cfg.weight_decay)
    else:
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
    return opt, sched


class Trainer:
    """Trains a MoTIF (the `Ours` family, Ours_44 / Ours_4) in place.

    batch: {'lq': (B, N_in, H, W, 3), 'gt': (B, N+2, HH, WW, 3),
    'times': (B, N)} and, when the dataset has them (a four-anchor model),
    the precomputed flows 'flow' (B, n², H, W, 2) and 'flow_gt' (B, N, n,
    HH, WW, 2), which the model takes in place of RAFT's (its `flows=`);
    numpy arrays or tensors, moved to the model's device and dtype. GT
    holds the two anchor frames at [0] and [-1] (the live teacher's), the
    loss is on gt[:, 1:-1].
    `step_count` is the number of optimiser steps taken (the JAX package's
    state.step)."""

    def __init__(self, model, cfg: TrainerConfig, out_hw=None,
                 iters: int = 12, flow_loss: bool = True, seed: int = 0,
                 family: str = "Ours"):
        if not family.startswith("Ours") or family in ("Ours_7",
                                                       "Ours_flow"):
            raise NotImplementedError(
                f"Trainer: family [{family}] is not ported (LIIF: ROADMAP.md "
                "§A.9; the linear-motion variant and the flow precomputer: "
                "§A.8)")
        self.model = model
        self.cfg = cfg
        # None: the output size is read from each batch's GT
        self.out_hw = tuple(out_hw) if out_hw is not None else None
        self.iters = iters
        self.flow_loss = flow_loss
        self.criterion = losses.PIXEL_CRITERIA[cfg.pixel_criterion]
        self.params = list(model.parameters())
        self.optimizer, self.schedule = make_optimizer(cfg, self.params)
        self._rng = random.Random(seed)
        self.step_count = 0

    def draw_use_gt(self) -> bool:
        """The host-side teacher-forcing draw for the current step
        (VideoSR_base_model.py:128-129); advances the generator."""
        ratio = max(0.0, 1.0 - self.step_count / self.cfg.teacher_forcing_steps)
        return self._rng.random() < ratio

    def _tensors(self, batch) -> dict:
        p = self.params[0]
        return {k: torch.as_tensor(batch[k]).to(p.device, p.dtype)
                for k in ("lq", "gt", "times", "flow", "flow_gt")
                if k in batch}

    def _out_hw(self, gt) -> tuple[int, int]:
        return self.out_hw or (int(gt.shape[2]), int(gt.shape[3]))

    def loss(self, batch, use_gt: bool):
        """(total loss, aux) of the current weights on `batch`, under
        autograd."""
        cfg = self.cfg
        b = self._tensors(batch)
        out_hw = self._out_hw(b["gt"])
        flows = None
        if "flow" in b or "flow_gt" in b:     # precomputed (Ours_44 / Vimeo)
            flows = (b.get("flow"), b.get("flow_gt"))
        frames, flow, flow_gt = self.model(
            b["lq"], b["times"], out_hw, use_gt=use_gt, iters=self.iters,
            target_frames=b["gt"], train=True, flows=flows)
        gt = b["gt"][:, 1:-1]
        l_pix = 0.0
        for idx in range(frames.shape[0]):              # per-time sum loss
            l_pix = l_pix + cfg.pixel_weight * self.criterion(frames[idx],
                                                              gt[:, idx])
        scale = out_hw[1] / b["lq"].shape[3]
        l_pix = l_pix * (4.0 / scale) ** 2
        total = l_pix
        aux = {"l_pix": l_pix.detach()}
        if self.flow_loss:
            fl = losses.charbonnier(flow, flow_gt)
            T = f32(cfg.teacher_forcing_steps)
            ratio = np.maximum(f32(0), f32(1) - f32(self.step_count) % T / T)
            total = total + cfg.flow_loss_weight * fl * float(ratio)
            aux["flow_l"] = fl.detach()
        return total, aux

    def compute_grads(self, batch, use_gt: bool, clock=None) -> dict:
        """Forward and backward on `batch`, no update: every parameter's
        `.grad` holds this batch's gradient (zeros where autograd did not
        reach). Returns aux with `loss`."""
        clock = clock or _Clock(False, None)
        self.optimizer.zero_grad(set_to_none=False)
        total, aux = self.loss(batch, use_gt)
        clock.mark("forward")
        total.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clock.mark("backward")
        aux["loss"] = total.detach()
        return aux

    def step(self, batch, sync_times: bool = False) -> dict:
        """One optimiser step. Returns aux: loss, l_pix, flow_l (tensors),
        lr (the step's float32 lr) and use_gt; with `sync_times` also `ms`,
        the milliseconds of the forward (with the loss), the backward and
        the optimiser, each ended by a device synchronisation."""
        use_gt = self.draw_use_gt()
        lr = self.schedule(self.step_count)
        clock = _Clock(sync_times, self.params[0].device)
        aux = self.compute_grads(batch, use_gt, clock)
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)
        self.optimizer.step()
        clock.mark("optimizer")
        self.step_count += 1
        aux.update(lr=float(lr), use_gt=use_gt)
        if sync_times:
            aux["ms"] = clock.ms
        return aux

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step_count}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step_count = int(state["step"])


class _Clock:
    """Milliseconds between marks by the host clock, each mark after a
    device synchronisation; does nothing unless on."""

    def __init__(self, on: bool, device: torch.device):
        self.on = on
        self.cuda = on and device.type == "cuda"
        self.ms: dict[str, float] = {}
        if on:
            self._sync()
            self._t = time.perf_counter()

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def mark(self, name: str) -> None:
        if self.on:
            self._sync()
            t = time.perf_counter()
            self.ms[name] = (t - self._t) * 1e3
            self._t = t
