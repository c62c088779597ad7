"""R2D2 recurrent Q-network with a fused sequence unroll.

Counterpart of the JAX package's `models/r2d2_net.py`: torso and action
embedding -> LSTM -> dueling head (value - mean). One step (`step`, the
act path) returns `(q [N, A], h, c)`; `unroll` runs `[B, T]` sequences
from the sequence-start stored state with done-masked resets (the carry
is zeroed AFTER a step whose done is set). Only the recursion is
sequential: torso, embedding and head run over all `[B*T]` positions at
once around `LSTMCell.unroll`.

`torso`: "mlp" is the reference's CartPole network; "nature" and
"resnet" are the conv torsos of the pixel sections. Parameter names
follow the flax module's (`state_fc1`, `torso`, `action_embed`, `cell`,
`head_fc`, `value`, `mean`), so `models/convert.py` maps them by rule.
`dtype` is the compute type of every layer but the LSTM (float32, see
`models/recurrent.py`); Q-values come out float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributed_reinforcement_learning_tpu_torch.models.recurrent import LSTMCell
from distributed_reinforcement_learning_tpu_torch.models.torso import (
    ActionEmbedding, NatureConv, ResNetTorso, init_glorot_, linear)


class R2D2Net(nn.Module):
    def __init__(self, num_actions: int, obs_shape: tuple[int, ...], lstm_size: int = 512,
                 torso: str = "mlp", torso_width: int = 1, fold_normalize: bool = False,
                 generator: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.torso_kind = torso
        self.fold_normalize = fold_normalize
        self.dtype = dtype
        if torso == "mlp":
            self.state_fc1 = nn.Linear(obs_shape[-1], 256)
            self.state_fc2 = nn.Linear(256, 256)
            feat = 256
        elif torso == "resnet":
            self.torso = ResNetTorso(obs_shape[2], obs_shape[0], obs_shape[1], torso_width,
                                     dtype=dtype)
            feat = 256
        elif torso == "nature":
            self.torso = NatureConv(obs_shape[2], dtype=dtype)
            feat = NatureConv.output_size(obs_shape[0], obs_shape[1])
        else:
            raise ValueError(f"unknown torso {torso!r}")
        self.action_embed = ActionEmbedding(num_actions, dtype=dtype)
        self.cell = LSTMCell(feat + 256, lstm_size)
        self.head_fc = nn.Linear(lstm_size, 128)
        self.value = nn.Linear(128, num_actions)
        self.mean = nn.Linear(128, 1)
        init_glorot_(self, generator)
        self.cell.reset_parameters(generator)

    def _features(self, obs: torch.Tensor) -> torch.Tensor:
        """`[N, ...obs]` -> `[N, F]`."""
        if self.torso_kind == "mlp":
            x = F.relu(linear(self.state_fc1, obs, self.dtype))
            return F.relu(linear(self.state_fc2, x, self.dtype))
        integer = not obs.dtype.is_floating_point
        if self.fold_normalize and not integer:
            raise ValueError("fold_normalize expects raw integer frames; got "
                             f"{obs.dtype}: feed uint8 or disable fold_normalize")
        return self.torso(obs, 1.0 / 255.0 if self.fold_normalize else None)

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        q = F.relu(linear(self.head_fc, h, dt))
        return (linear(self.value, q, dt) - linear(self.mean, q, dt)).to(torch.float32)

    def step(self, obs: torch.Tensor, prev_action: torch.Tensor, h: torch.Tensor,
             c: torch.Tensor):
        """One step on an `[N]` batch -> (q `[N, A]`, h', c')."""
        z = torch.cat([self._features(obs), self.action_embed(prev_action)], dim=-1)
        new_h, new_c = self.cell(z, h, c)
        return self._head(new_h), new_h, new_c

    def unroll(self, obs_seq: torch.Tensor, prev_action_seq: torch.Tensor,
               done_seq: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
        """Q-values `[B, T, A]` over `[B, T, ...]` sequences from the
        stored start state (h0, c0)."""
        B, T = obs_seq.shape[:2]
        x = self._features(obs_seq.reshape((B * T,) + tuple(obs_seq.shape[2:])))
        z = torch.cat([x.reshape(B, T, -1), self.action_embed(prev_action_seq)], dim=-1)
        h_all, _ = self.cell.unroll(z, done_seq, h0, c0)
        return self._head(h_all)

    def forward(self, obs, prev_action, h, c, done=None):
        """`step(obs, prev_action, h, c)`; with `done` (`[B, T]`),
        `unroll(obs, prev_action, done, h, c)`. One entry point, so that
        `models.functional.functional_call` reaches both under explicit params."""
        if done is None:
            return self.step(obs, prev_action, h, c)
        return self.unroll(obs, prev_action, done, h, c)
