"""Shared network torsos: Nature-DQN conv stack, IMPALA ResNet, action
embedding, MLP.

Counterparts of the JAX package's `models/torso.py`. Observations enter
NHWC, as there; the convolutions run NCHW inside and the feature maps are
put back to NHWC before they are flattened, so the first layer after a
flatten sees the JAX package's feature order. Kernels start Glorot-uniform
and biases at zero, drawn from an explicit `torch.Generator`.

`dtype` is the compute type, as the flax modules' `dtype`: parameters stay
float32, and each layer casts its input, kernel and bias to `dtype`
(bfloat16 compute with float32 parameters). At float32 every cast is a
no-op.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def glorot_uniform_(t: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator | None) -> None:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def init_glorot_(module: nn.Module, generator: torch.Generator | None) -> None:
    """Glorot-uniform weights and zero biases for every conv and dense layer
    under `module`, the initialisers the JAX package's layers use."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            k = m.kernel_size[0] * m.kernel_size[1]
            glorot_uniform_(m.weight, m.in_channels * k, m.out_channels * k, generator)
        elif isinstance(m, nn.Linear):
            glorot_uniform_(m.weight, m.in_features, m.out_features, generator)
        else:
            continue
        with torch.no_grad():
            m.bias.zero_()


def _nhwc_flatten(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _scaled(weight: torch.Tensor, input_scale: float | None) -> torch.Tensor:
    """conv(x * s) == conv_{k*s}(x): the frame normalisation folded into
    the first kernel (in the kernel's type, as the JAX torso scales its
    cast kernel), so integer frames can enter raw."""
    if input_scale is None:
        return weight
    return weight * torch.tensor(input_scale, dtype=weight.dtype)


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`layer(x)` computed in `dtype` (flax `Dense(dtype=...)`)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype,
         input_scale: float | None = None) -> torch.Tensor:
    """`layer(x)` on NCHW `x` computed in `dtype`, the kernel scaled by
    `input_scale` after its cast."""
    return F.conv2d(x, _scaled(layer.weight.to(dtype), input_scale), layer.bias.to(dtype),
                    stride=layer.stride, padding=layer.padding)


class NatureConv(nn.Module):
    """Nature-DQN conv torso: 8x8/4 x32, 4x4/2 x64, 3x3/1 x64, flatten."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0 = nn.Conv2d(in_channels, 32, 8, stride=4)
        self.conv1 = nn.Conv2d(32, 64, 4, stride=2)
        self.conv2 = nn.Conv2d(64, 64, 3, stride=1)

    @staticmethod
    def output_size(height: int, width: int) -> int:
        for k, s in ((8, 4), (4, 2), (3, 1)):
            height, width = (height - k) // s + 1, (width - k) // s + 1
        return height * width * 64

    def forward(self, x: torch.Tensor, input_scale: float | None = None) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        x = F.relu(conv(self.conv0, x, dt, input_scale))
        x = F.relu(conv(self.conv1, x, dt))
        x = F.relu(conv(self.conv2, x, dt))
        return _nhwc_flatten(x)


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max pool with XLA's SAME padding (low = total // 2),
    padded with -inf."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad order: last dim first
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), 3, stride=2)


class ResNetTorso(nn.Module):
    """IMPALA deep torso (Espeholt et al. 2018, fig. 3): three sections of
    conv3x3 -> maxpool3x3/2 -> 2 residual blocks, then relu, flatten and
    Dense 256. `width` multiplies the paper's (16, 32, 32) channels."""

    def __init__(self, in_channels: int, height: int, width_px: int, width: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        chans = [base * width for base in (16, 32, 32)]
        self.conv0 = nn.Conv2d(in_channels, chans[0], 3, padding=1)
        for s in (1, 2):
            setattr(self, f"section{s}_conv", nn.Conv2d(chans[s - 1], chans[s], 3, padding=1))
        for s, ch in enumerate(chans):
            for r in range(2):
                for k in range(2):
                    setattr(self, f"section{s}_res{r}_conv{k}", nn.Conv2d(ch, ch, 3, padding=1))
        for _ in range(3):
            height, width_px = -(-height // 2), -(-width_px // 2)
        self.trunk_out = nn.Linear(height * width_px * chans[2], 256)

    def forward(self, x: torch.Tensor, input_scale: float | None = None) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        for s in range(3):
            if s == 0:
                x = conv(self.conv0, x, dt, input_scale)
            else:
                x = conv(getattr(self, f"section{s}_conv"), x, dt)
            x = _max_pool_same(x)
            for r in range(2):
                y = conv(getattr(self, f"section{s}_res{r}_conv0"), F.relu(x), dt)
                y = conv(getattr(self, f"section{s}_res{r}_conv1"), F.relu(y), dt)
                x = x + y
        x = _nhwc_flatten(F.relu(x))
        return F.relu(linear(self.trunk_out, x, dt))


class ActionEmbedding(nn.Module):
    """One-hot previous action -> Dense 256 relu -> Dense 256 relu."""

    def __init__(self, num_actions: int, width: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_actions = num_actions
        self.dtype = dtype
        self.layers = nn.ModuleList([nn.Linear(num_actions, width), nn.Linear(width, width)])

    def forward(self, action: torch.Tensor) -> torch.Tensor:
        x = F.one_hot(action.long(), self.num_actions).to(self.dtype)
        for layer in self.layers:
            x = F.relu(linear(layer, x, self.dtype))
        return x


class MLP(nn.Module):
    """relu MLP over `hidden_sizes` with a linear `output_size` head."""

    def __init__(self, input_size: int, hidden_sizes: Sequence[int], output_size: int,
                 final_activation: Callable[[torch.Tensor], torch.Tensor] | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        sizes = [input_size, *hidden_sizes, output_size]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        self.final_activation = final_activation
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = F.relu(linear(layer, x, self.dtype))
        x = linear(self.layers[-1], x, self.dtype)
        if self.final_activation is not None:
            x = self.final_activation(x)
        return x
