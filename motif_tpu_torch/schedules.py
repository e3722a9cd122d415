"""Learning-rate schedules, the counterpart of motif_tpu/schedules.py
(reference models/lr_scheduler.py): step -> lr functions.

The JAX package evaluates them in float32 (the step cast to float32, every
constant rounded to float32), and its optimiser applies that float32 lr.
These functions do the same arithmetic in numpy float32, in the same order,
and return an np.float32: the same lr bit for bit, so that the Adam steps
of the two packages do not drift apart by an ulp of the lr. The cosine is
the C library's `cosf`, which is what XLA's CPU backend calls (numpy's own
float32 cos differs from it by an ulp at about one argument in six).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np

f32 = np.float32


@functools.cache
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    lib.cosf.restype = ctypes.c_float
    lib.cosf.argtypes = [ctypes.c_float]
    return lib


def cosf(x: np.float32) -> np.float32:
    """The C library's float32 cosine."""
    return f32(_libm().cosf(float(x)))


def cosine_annealing_restart(base_lr: float, t_period, restarts=None,
                             restart_weights=None, eta_min: float = 1e-7):
    """CosineAnnealingLR_Restart (lr_scheduler.py:35-66) in closed form:
    lr(t) = eta_min + (base * w_seg - eta_min) * (1 + cos(pi (t - t0) / T)) / 2
    with segment boundaries at `restarts` and per-segment periods and
    weights."""
    restarts = list(restarts or [])
    restart_weights = list(restart_weights or [1] * len(restarts))
    assert len(restarts) == len(restart_weights)
    bounds = np.array([0] + restarts, dtype=np.float64).astype(f32)
    weights = np.array([1.0] + restart_weights, dtype=np.float64).astype(f32)
    periods = np.array(list(t_period), dtype=np.float64)
    assert len(periods) >= len(bounds), "need a T_period per segment"
    periods = periods[:len(bounds)].astype(f32)

    def schedule(step) -> np.float32:
        t = f32(step)
        seg = int(np.sum(t >= bounds[1:]))
        cosv = cosf(f32(np.pi) * (t - bounds[seg]) / periods[seg])
        return f32(eta_min) + (f32(base_lr) * weights[seg] - f32(eta_min)) \
            * (f32(1) + cosv) / f32(2)

    return schedule


def multistep_restart(base_lr: float, milestones, gamma: float = 0.1,
                      restarts=None, restart_weights=None):
    """MultiStepLR_Restart (lr_scheduler.py:8-32): base * w * gamma^n, w the
    weight of the last restart at or before t, n the milestones passed
    since it."""
    restarts = list(restarts or [0])
    restart_weights = list(restart_weights or [1])
    milestones = sorted(milestones)

    def schedule(step) -> np.float32:
        t = f32(step)
        w = f32(1)
        for r, rw in zip(restarts, restart_weights):
            if t >= r:
                w = f32(rw)
        last_r = f32(0)
        for r in restarts:
            if t >= r:
                last_r = f32(r)
        n = f32(0)
        for m in milestones:
            n = n + (f32(1) if (t >= m) and (m > last_r) else f32(0))
        return f32(base_lr) * w * f32(gamma) ** n

    return schedule
