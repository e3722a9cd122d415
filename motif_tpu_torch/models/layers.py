"""Shared building blocks — the counterpart of motif_tpu/models/layers.py.

Every module takes and returns NHWC tensors. A convolution views its NHWC
input as NCHW (a permute, which is the channels_last memory format, not a
copy), runs `F.conv2d` and permutes back. Parameter names follow the
reference torch modules, so the port's `state_dict` keys are the reference
checkpoint's keys (see checkpoint.py).

Mixed precision: parameters stay float32 whatever the compute dtype, so one
checkpoint loads in both modes; a module casts its weights to its input's
dtype at use, as the JAX package does, through `cast_param`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def lrelu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    """nn.LeakyReLU(0.1), written as the JAX package writes it."""
    return torch.where(x >= 0, x, x * negative_slope)


class LReLU(nn.Module):
    """lrelu as a Sequential member (the reference's nn.LeakyReLU(0.1))."""

    def forward(self, x):
        return lrelu(x)


def cast_param(module: nn.Module, name: str, dtype: torch.dtype):
    """`module.<name>` in `dtype`: the parameter itself when it has that
    dtype (or is None), else a cast copy. Under autograd (the parameter
    requires grad and grad mode is on) the copy is `p.to(dtype)`, made
    anew by every forward, so that the gradient flows back to the float32
    parameter as optax's does through a cast. Otherwise the copy is kept
    on the module, so that a forward does not cast every weight again: it
    is stamped with the parameter's version counter, address and device,
    and made anew when any of them changed (`load_state_dict` copies into
    the parameter in place, which raises its version, and a move to
    another device replaces its storage). The kept copy carries no
    gradient."""
    p = getattr(module, name)
    if p is None or p.dtype == dtype:
        return p
    if torch.is_grad_enabled() and p.requires_grad:
        return p.to(dtype)
    cache = module.__dict__.setdefault("_cast_cache", {})
    stamp = (p._version, p.data_ptr(), p.device)
    hit = cache.get((name, dtype))
    if hit is None or hit[0] != stamp:
        hit = (stamp, p.detach().to(dtype))
        cache[(name, dtype)] = hit
    return hit[1]


def cached(module: nn.Module, key, params, make):
    """`make()`, a tensor derived from `params` (parameters of `module`),
    kept on the module under `key` the way `cast_param` keeps its copies:
    stamped with every parameter's version counter, address and device and
    made anew when any of them changed."""
    stamp = tuple((p._version, p.data_ptr(), p.device) for p in params)
    cache = module.__dict__.setdefault("_derived_cache", {})
    hit = cache.get(key)
    if hit is None or hit[0] != stamp:
        with torch.inference_mode(False):   # an eval's copy serves training
            hit = (stamp, make())
        cache[key] = hit
    return hit[1]


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _reflect_index(n: int, p: int, device) -> torch.Tensor:
    i = torch.arange(-p, n + p, device=device).abs()
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def reflect_pad(y: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """F.pad(y, (pw, pw, ph, ph), mode="reflect") of an NCHW tensor, the
    same values, as two `index_select`s: their backward (an `index_add`)
    has a deterministic CUDA path under
    `torch.use_deterministic_algorithms`, the reflection pad's has none."""
    H, W = y.shape[2], y.shape[3]
    if ph:
        y = y.index_select(2, _reflect_index(H, ph, y.device))
    if pw:
        y = y.index_select(3, _reflect_index(W, pw, y.device))
    return y


class Conv2d(nn.Module):
    """torch nn.Conv2d on NHWC tensors, with zero or reflect padding and
    groups. Parameters `weight` (O, I/groups, kh, kw) and `bias` (O,).

    init: "default" (torch's U(±1/sqrt(fan_in)) for weight and bias),
    "kaiming_in" (kaiming normal fan_in times `scale`, zero bias — the
    reference ResidualBlock_noBN), "kaiming_out" (kaiming normal fan_out,
    RAFT's encoders), "zeros" (DCN_sep's conv_offset_mask).
    """

    def __init__(self, cin: int, cout: int, kernel_size=3, stride=1,
                 padding=0, dilation: int = 1, groups: int = 1,
                 bias: bool = True, padding_mode: str = "zeros",
                 init: str = "default", scale: float = 1.0):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.dilation = dilation
        self.groups = groups
        self.padding_mode = padding_mode
        kh, kw = self.kernel_size
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kh, kw))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self._init, self._scale = init, scale
        self.reset_parameters()

    def reset_parameters(self):
        fan_in = self.weight[0].numel()
        fan_out = self.weight.shape[0] * self.weight[0, 0].numel()
        with torch.no_grad():
            if self._init == "default":
                bound = 1.0 / math.sqrt(fan_in)
                self.weight.uniform_(-bound, bound)
            elif self._init == "kaiming_in":
                self.weight.normal_(0.0, math.sqrt(2.0 / fan_in) * self._scale)
            elif self._init == "kaiming_out":
                self.weight.normal_(0.0, math.sqrt(2.0 / fan_out))
            elif self._init == "zeros":
                self.weight.zero_()
            else:
                raise ValueError(f"unknown init {self._init!r}")
            if self.bias is not None:
                if self._init in ("default", "kaiming_out"):
                    bound = 1.0 / math.sqrt(fan_in)
                    self.bias.uniform_(-bound, bound)
                else:
                    self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.permute(0, 3, 1, 2)
        ph, pw = self.padding
        pad = self.padding
        if self.padding_mode == "reflect" and (ph or pw):
            y = reflect_pad(y, ph, pw)
            pad = (0, 0)
        y = F.conv2d(y, cast_param(self, "weight", x.dtype),
                     cast_param(self, "bias", x.dtype), self.stride, pad,
                     self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


class ResidualBlockNoBN(nn.Module):
    """ResidualBlock_noBN: x + conv2(relu(conv1(x))), kaiming fan_in x 0.1
    init with zero bias."""

    def __init__(self, nf: int = 64):
        super().__init__()
        self.conv1 = Conv2d(nf, nf, 3, 1, 1, init="kaiming_in", scale=0.1)
        self.conv2 = Conv2d(nf, nf, 3, 1, 1, init="kaiming_in", scale=0.1)

    def forward(self, x):
        return x + self.conv2(torch.relu(self.conv1(x)))


def res_blocks(nf: int, n_blocks: int) -> nn.Sequential:
    """The reference make_layer stack of n ResidualBlockNoBN, unrolled (the
    JAX package scans it with the weights stacked; checkpoint.py bridges
    the two layouts)."""
    return nn.Sequential(*[ResidualBlockNoBN(nf) for _ in range(n_blocks)])


class LateralBlock(nn.Module):
    """x + conv(lrelu(conv(x))) with the reference's Sequential `layers`."""

    def __init__(self, dim: int):
        super().__init__()
        self.layers = nn.Sequential(Conv2d(dim, dim, 3, 1, 1), LReLU(),
                                    Conv2d(dim, dim, 3, 1, 1))

    def forward(self, x):
        return x + self.layers(x)


class ConvLSTMCell(nn.Module):
    """One conv producing the i, f, o, g gates, in that order."""

    def __init__(self, input_dim: int, hidden_dim: int, kernel_size=(3, 3),
                 bias: bool = True):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.conv = Conv2d(input_dim + hidden_dim, 4 * hidden_dim, (kh, kw), 1,
                           (kh // 2, kw // 2), bias=bias)

    def forward(self, x, state):
        h, c = state
        gates = self.conv(torch.cat([x, h], dim=-1))
        cc_i, cc_f, cc_o, cc_g = torch.chunk(gates, 4, dim=-1)
        i = torch.sigmoid(cc_i)
        f = torch.sigmoid(cc_f)
        o = torch.sigmoid(cc_o)
        g = torch.tanh(cc_g)
        c_next = f * c + i * g
        h_next = o * torch.tanh(c_next)
        return h_next, c_next


class Linear(nn.Linear):
    """torch nn.Linear with the SIREN weight init: the weight is
    U(-bound, bound); the bias keeps torch's default."""

    def __init__(self, cin: int, cout: int, bound: float):
        self._bound = bound
        super().__init__(cin, cout)

    def reset_parameters(self):
        super().reset_parameters()
        with torch.no_grad():
            self.weight.uniform_(-self._bound, self._bound)


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """nn.PixelShuffle on NHWC: input channel (c, ry, rx), fastest last,
    goes to out[b, h * r + ry, w * r + rx, c]."""
    B, H, W, C = x.shape
    c = C // (r * r)
    x = x.reshape(B, H, W, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H * r, W * r, c)


def max_pool2d(x: torch.Tensor, window: int = 3, stride: int = 2,
               padding: int = 1) -> torch.Tensor:
    """nn.MaxPool2d on NHWC (the padding never wins)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding)
    return y.permute(0, 2, 3, 1)


def avg_pool2d_padded(x: torch.Tensor, window: int = 3, stride: int = 2,
                      padding: int = 1) -> torch.Tensor:
    """nn.AvgPool2d on NHWC with count_include_pad=True (its default): the
    zero padding counts in the denominator."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride, padding,
                     count_include_pad=True)
    return y.permute(0, 2, 3, 1)
