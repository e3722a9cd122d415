"""Weights from the seed, made on the device in two large calls (one
uniform draw, one normal draw) and cut into the model's leaves by the
configuration's `init` rules. The program and the reference get the same
values: each calls `make` with the same seed and the same leaves."""

from __future__ import annotations

import math
import re

import torch


def _rule(name: str, rules: list) -> dict:
    for rule in rules:
        if re.search(rule["match"], name):
            return rule
    raise KeyError(f"no init rule matches the leaf {name}")


def _fan_in(name: str, shapes: dict) -> int:
    """The fan-in of a weight, or of the weight beside a bias."""
    w = shapes.get(name[:-len("bias")] + "weight", shapes[name]) \
        if name.endswith("bias") else shapes[name]
    return max(1, math.prod(w[1:])) if len(w) > 1 else 1


def make(seed: int, shapes: dict, rules: list, device) -> dict:
    """{leaf name: tensor} for `shapes` ({name: shape}, in a fixed order).
    Each rule: `match` (a regex on the name, first match wins) and `init`:
    "uniform_fan_in" (U(-1/sqrt(fan_in), +)), "uniform_first" (U(-1/fan_in,
    +), SIREN's first layer), "uniform_siren" (U(-sqrt(6/fan_in)/30, +)),
    "normal" (N(0, std)) or "const" (value)."""
    names = list(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    total = sum(sizes)
    uni = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    nor = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, size in zip(names, sizes):
        rule = _rule(name, rules)
        kind = rule["init"]
        if kind == "const":
            t = torch.full((size,), float(rule["value"]), device=device)
        elif kind == "normal":
            t = nor[at:at + size] * float(rule["std"])
        else:
            fan = _fan_in(name, shapes)
            bound = {"uniform_fan_in": 1.0 / math.sqrt(fan),
                     "uniform_first": 1.0 / fan,
                     "uniform_siren": math.sqrt(6.0 / fan) / 30.0}[kind]
            t = uni[at:at + size] * bound
        out[name] = t.reshape(shapes[name])
        at += size
    return out


def load(model: torch.nn.Module, seed: int, rules: list) -> int:
    """Write `make`'s values into every parameter of `model` in place;
    returns the number of values written."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    vals = make(seed, {n: tuple(p.shape) for n, p in params.items()}, rules,
                dev)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(vals[n])
    return sum(p.numel() for p in params.values())
