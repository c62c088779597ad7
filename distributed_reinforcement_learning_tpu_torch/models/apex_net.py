"""Ape-X Q-networks.

Counterpart of the JAX package's `models/apex_net.py`:

- `DuelingQNetwork` keeps the reference's nonstandard dueling head,
  q = value(num_actions) - mean(1), from two separate 256-256 MLP
  towers over `[NatureConv(obs), ActionEmbedding(prev_action)]`. Frames
  enter NHWC and NatureConv flattens its features NHWC, the JAX order,
  so both towers see the same 3136 features as there. With
  `fold_normalize`, integer frames enter raw and the /255 is folded into
  conv0's kernel.
- `SimpleQNetwork` (vector observations): state MLP 256-256, concat
  with the action embedding, Dense 256, then the value / mean head.

Parameter names follow the flax modules' (`torso`, `action_embed`,
`value`, `mean`; SimpleQNetwork's automatic `Dense_{i}` as `layers.{i}`),
so `models/convert.py` maps them by rule. Kernels start Glorot-uniform
and biases at zero, drawn from an explicit `torch.Generator`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distributed_reinforcement_learning_tpu_torch.models.torso import (
    MLP, ActionEmbedding, NatureConv, init_glorot_)


class DuelingQNetwork(nn.Module):
    """Conv torso + previous-action embedding -> value(A) - mean(1)."""

    def __init__(self, num_actions: int, obs_shape: tuple[int, ...],
                 hidden_sizes: Sequence[int] = (256, 256), fold_normalize: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fold_normalize = fold_normalize
        self.torso = NatureConv(obs_shape[2])
        feat = NatureConv.output_size(obs_shape[0], obs_shape[1]) + 256
        self.action_embed = ActionEmbedding(num_actions)
        self.value = MLP(feat, hidden_sizes, num_actions)
        self.mean = MLP(feat, hidden_sizes, 1)
        init_glorot_(self, generator)

    def forward(self, obs: torch.Tensor, prev_action: torch.Tensor) -> torch.Tensor:
        """`[N, H, W, C]` frames (raw integers under `fold_normalize`, else
        floats) and `[N]` previous actions -> Q-values `[N, A]`."""
        scale = 1.0 / 255.0 if self.fold_normalize and not obs.dtype.is_floating_point else None
        z = torch.cat([self.torso(obs, scale), self.action_embed(prev_action)], dim=-1)
        return self.value(z) - self.mean(z)


class SimpleQNetwork(nn.Module):
    """MLP variant for vector observations (CartPole-class envs)."""

    def __init__(self, num_actions: int, obs_size: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        # `layers.{i}` is flax's `Dense_{i}`: state 0-1, joint 2, value 3, mean 4.
        self.layers = nn.ModuleList([
            nn.Linear(obs_size, 256), nn.Linear(256, 256), nn.Linear(512, 256),
            nn.Linear(256, num_actions), nn.Linear(256, 1)])
        self.action_embed = ActionEmbedding(num_actions)
        init_glorot_(self, generator)

    def forward(self, obs: torch.Tensor, prev_action: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.layers[0](obs.to(torch.float32)))
        x = F.relu(self.layers[1](x))
        z = F.relu(self.layers[2](torch.cat([x, self.action_embed(prev_action)], dim=-1)))
        return self.layers[3](z) - self.layers[4](z)
