"""IMPALA conv-LSTM actor-critic network.

Counterpart of the JAX package's `models/impala_net.py`. Training seeds
every timestep from the actor-recorded (h, c) (stored-state semantics), so
the learner flattens `[B, T, ...]` to `[B*T, ...]`, runs the network once
and reshapes back (`apply_stored_state`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from distributed_reinforcement_learning_tpu_torch.models.functional import functional_call
from distributed_reinforcement_learning_tpu_torch.models.recurrent import LSTMCell
from distributed_reinforcement_learning_tpu_torch.models.torso import (
    MLP, ActionEmbedding, NatureConv, ResNetTorso, init_glorot_)


class ImpalaOutput(NamedTuple):
    policy: torch.Tensor  # [N, num_actions] softmax probabilities
    value: torch.Tensor  # [N]
    h: torch.Tensor  # [N, lstm]
    c: torch.Tensor  # [N, lstm]


class ImpalaActorCritic(nn.Module):
    """Single-step conv-LSTM actor-critic: obs + prev_action + (h, c) ->
    policy/value. Conv (or, for vector observations, MLP) torso and action
    embedding -> one LSTM step -> separate 256-256 policy and value heads.

    `fold_normalize` folds the /255 frame normalisation into the first
    conv kernel for integer frames. `torso` is "nature" (reference parity)
    or "resnet" (the IMPALA paper's deep torso, `torso_width` channels).
    `dtype` is the compute type of the torso, embedding and heads (the
    LSTM stays float32, see `models/recurrent.py`); policy and value come
    out float32.
    """

    def __init__(self, num_actions: int, obs_shape: tuple[int, ...], lstm_size: int = 256,
                 fold_normalize: bool = False, torso: str = "nature", torso_width: int = 1,
                 generator: torch.Generator | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fold_normalize = fold_normalize
        self.dtype = dtype
        if len(obs_shape) == 1:
            self.torso = MLP(obs_shape[0], [256], 256, final_activation=F.relu, dtype=dtype)
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
        self.lstm = LSTMCell(feat + 256, lstm_size)
        self.policy_head = MLP(lstm_size, [256, 256], num_actions, dtype=dtype)
        self.value_head = MLP(lstm_size, [256, 256], 1, dtype=dtype)
        init_glorot_(self, generator)
        self.lstm.reset_parameters(generator)

    def forward(self, obs: torch.Tensor, prev_action: torch.Tensor,
                h: torch.Tensor, c: torch.Tensor) -> ImpalaOutput:
        if obs.dim() == 2:  # vector observations (CartPole-class envs)
            img = self.torso(obs.to(self.dtype))
        else:
            integer = not (obs.dtype.is_floating_point or obs.dtype.is_complex)
            scale = 1.0 / 255.0 if self.fold_normalize and integer else None
            img = self.torso(obs, scale)
        z = torch.cat([img, self.action_embed(prev_action)], dim=-1)
        new_h, new_c = self.lstm(z, h, c)
        policy = torch.softmax(self.policy_head(new_h).to(torch.float32), dim=-1)
        value = self.value_head(new_h)[..., 0].to(torch.float32)
        return ImpalaOutput(policy, value, new_h, new_c)


def apply_stored_state(
    model: ImpalaActorCritic,
    params: dict[str, torch.Tensor],
    obs_seq: torch.Tensor,  # [B, T, ...obs]
    prev_action_seq: torch.Tensor,  # [B, T]
    h_seq: torch.Tensor,  # [B, T, lstm] actor-recorded per-step h
    c_seq: torch.Tensor,  # [B, T, lstm]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Policy `[B, T, A]` and value `[B, T]` for all (b, t) in one `[B*T]`
    forward of `model` under `params`."""
    B, T = obs_seq.shape[:2]
    flat = lambda x: x.reshape((B * T,) + tuple(x.shape[2:]))
    out = functional_call(model, params, (flat(obs_seq), flat(prev_action_seq),
                                          flat(h_seq), flat(c_seq)))
    return out.policy.reshape(B, T, -1), out.value.reshape(B, T)
