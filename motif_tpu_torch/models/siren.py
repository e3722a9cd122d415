"""SIREN coordinate MLPs — the counterpart of motif_tpu/models/siren.py.

Init (reference SIREN.py): first-layer weights U(-1/in, 1/in); hidden and
outermost-linear weights U(±sqrt(6/in)/omega0); biases keep torch's
nn.Linear default. Module names follow the torch tree: `net.k` is the k-th
layer, SineLayers keep their inner `linear`.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from motif_tpu_torch.models.layers import Linear, cached, cast_param
from motif_tpu_torch.ops import siren_kernel


def first_bound(fan_in: int) -> float:
    return 1.0 / fan_in


def hidden_bound(fan_in: int, omega0: float) -> float:
    return math.sqrt(6.0 / fan_in) / omega0


def _pack_detached(lins, dtype):
    with torch.no_grad():
        return siren_kernel.pack([cast_param(m, "weight", dtype) for m in lins],
                                 [cast_param(m, "bias", dtype) for m in lins])


class SineLayer(nn.Module):
    """sin(omega0 * linear(x)): holds `linear` under the reference name;
    `Siren` evaluates it inside `siren_mlp`."""

    def __init__(self, cin: int, cout: int, is_first: bool = False,
                 omega_0: float = 30.0):
        super().__init__()
        bound = first_bound(cin) if is_first else hidden_bound(cin, omega_0)
        self.linear = Linear(cin, cout, bound)


class Siren(nn.Module):
    """layers = [first] + hidden_layers x [sine] + [out], widths
    in_features → hidden_features[0..hidden_layers] → out_features, one
    omega0 for every layer (as every MoTIF SIREN has). The whole MLP runs in
    `siren_mlp` (the CUDA kernel on CUDA tensors), in the input's dtype: the
    float32 parameters are cast at use (`cast_param`) and packed for the
    kernel once (`packed`), not per forward.

    With `skip_first_linear` the forward takes net.0's pre-activation
    (width hidden_features[0]) in x's place: the caller has applied net.0's
    linear map, whose parameters stay here under their reference names
    (`first_linear` reads them), and the MLP starts with sin(omega0 * x).
    The parameters are the same either way."""

    def __init__(self, in_features: int, hidden_features: Sequence[int],
                 hidden_layers: int, out_features: int,
                 outermost_linear: bool = True, omega_0: float = 30.0,
                 skip_first_linear: bool = False):
        super().__init__()
        self.omega0 = omega_0
        self.skip_first_linear = skip_first_linear
        self.outermost_linear = outermost_linear
        layers = [SineLayer(in_features, hidden_features[0], is_first=True,
                            omega_0=omega_0)]
        for i in range(hidden_layers):
            layers.append(SineLayer(hidden_features[i], hidden_features[i + 1],
                                    omega_0=omega_0))
        last_in = hidden_features[hidden_layers]
        if outermost_linear:
            layers.append(Linear(last_in, out_features,
                                 hidden_bound(last_in, omega_0)))
        else:
            layers.append(SineLayer(last_in, out_features, omega_0=omega_0))
        self.net = nn.Sequential(*layers)

    def _linears(self):
        return [m.linear if isinstance(m, SineLayer) else m for m in self.net]

    def first_linear(self, dtype: torch.dtype):
        """net.0's (weight (out, in), bias) in `dtype`, for a caller that
        applies the first linear map itself."""
        lin = self._linears()[0]
        return cast_param(lin, "weight", dtype), cast_param(lin, "bias", dtype)

    def _kernel_linears(self):
        return self._linears()[1 if self.skip_first_linear else 0:]

    def packed(self, dtype: torch.dtype) -> torch.Tensor:
        """The kernel's parameter buffer (`siren_kernel.pack`) in `dtype`,
        kept on the module as `cast_param` keeps its copies: stamped with
        every parameter's version counter, address and device, and made
        anew when any of them changed (a `load_state_dict`, a move, an
        optimiser's in-place step). It carries no autograd history: the
        kernel reads it, the gradients go to the parameters themselves."""
        lins = self._kernel_linears()
        return cached(
            self, ("packed", dtype),
            [p for m in lins for p in (m.weight, m.bias)],
            lambda: _pack_detached(lins, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lins = self._kernel_linears()
        return siren_kernel.siren_mlp(
            x, [cast_param(m, "weight", x.dtype) for m in lins],
            [cast_param(m, "bias", x.dtype) for m in lins], self.omega0,
            sine_last=not self.outermost_linear,
            skip_first=self.skip_first_linear,
            packed=self.packed(x.dtype) if x.is_cuda else None)
