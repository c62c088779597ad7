"""Transformer network: causal pre-LN attention over the sequence, in place
of the LSTM.

Counterpart of the JAX package's `models/transformer_net.py`, dense
single-device body: MLP torso 256-256 on the observation and the
previous-action embedding -> Dense to d_model -> `num_layers` pre-LN
blocks (causal attention confined within episodes by segment ids from
`done`, RoPE on q and k) -> LayerNorm -> Dense 128 relu -> head.

Two heads over one trunk: `actor_critic` returns `(policy [B, T, A]
softmax, value [B, T])` (Transformer-IMPALA), `dueling_q` returns the
reference's `value - learned_mean` Q-values `[B, T, A]`
(Transformer-R2D2). Not ported: sequence-parallel `attention_fn` and
`sequence_perm`, mixture-of-experts MLPs, stacked and pipelined layers,
remat.

Module names are this package's; `models/convert.py` maps flax's
automatic names (`Dense_0`, `SelfAttentionBlock_0/LayerNorm_0`, ...)
onto them.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from distributed_reinforcement_learning_tpu_torch.models.torso import (
    ActionEmbedding, init_glorot_)
from distributed_reinforcement_learning_tpu_torch.ops.attention import causal_attention

# flax.linen.LayerNorm's default; torch's is 1e-5.
_LN_EPS = 1e-6


def episode_segments(done_seq: torch.Tensor) -> torch.Tensor:
    """[B, T] episode ids from done flags: step t still belongs to the
    episode that `done[t]` ends, t + 1 starts the next (where the
    recurrent nets zero their carries)."""
    d = done_seq.to(torch.int32)
    return torch.cat([torch.zeros_like(d[:, :1]), torch.cumsum(d, dim=1)[:, :-1]],
                     dim=1).to(torch.int32)


@functools.lru_cache(maxsize=64)
def _rope_tables(t: int, d2: int, base: float, device: torch.device,
                 dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin `[1, T, 1, D/2]`, computed once in float32 on the CPU
    (the same numbers on every device), cast to `dtype`. Made outside
    inference mode, so that the cached tables also serve autograd."""
    with torch.inference_mode(False):
        freqs = base ** (-torch.arange(d2, dtype=torch.float32) / d2)
        angles = torch.arange(t, dtype=torch.float32)[:, None] * freqs[None, :]
        return (torch.cos(angles)[None, :, None, :].to(device, dtype),
                torch.sin(angles)[None, :, None, :].to(device, dtype))


def rope(x: torch.Tensor, base: float = 10_000.0) -> torch.Tensor:
    """Rotary position embedding over the time axis of `[B, T, H, D]`,
    with the half-split rotation (`x1 = x[..., :D/2]`)."""
    d2 = x.shape[-1] // 2
    cos, sin = _rope_tables(x.shape[1], d2, base, x.device, x.dtype)
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class SelfAttentionBlock(nn.Module):
    """Pre-LN attention + dense MLP block (the flax module's dense path)."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by num_heads {num_heads}")
        self.d_model, self.num_heads = d_model, num_heads
        self.ln1 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.proj = nn.Linear(d_model, d_model)
        self.ln2 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.mlp1 = nn.Linear(d_model, 4 * d_model)
        self.mlp2 = nn.Linear(4 * d_model, d_model)

    def forward(self, x: torch.Tensor, segs: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        head_dim = self.d_model // self.num_heads
        q, k, v = torch.split(self.qkv(self.ln1(x)), self.d_model, dim=-1)

        def split(z):
            return z.reshape(b, t, self.num_heads, head_dim)

        out = causal_attention(rope(split(q)), rope(split(k)), split(v), q_seg=segs, k_seg=segs)
        x = x + self.proj(out.reshape(b, t, self.d_model))
        return x + self.mlp2(F.relu(self.mlp1(self.ln2(x))))


class TransformerQNet(nn.Module):
    """MLP torso + action embedding -> causal transformer -> output head.

    `forward(obs_seq [B, T, ...], prev_action_seq [B, T], done_seq [B, T])`.
    Acting runs the same forward over a window of steps; training over
    the stored sequence."""

    def __init__(self, num_actions: int, obs_shape: tuple[int, ...], d_model: int = 256,
                 num_heads: int = 4, num_layers: int = 2, max_len: int = 512,
                 head: str = "dueling_q", generator: torch.Generator | None = None):
        super().__init__()
        if head not in ("dueling_q", "actor_critic"):
            raise ValueError(f"unknown head {head!r}")
        self.head, self.max_len = head, max_len
        obs_size = 1
        for n in obs_shape:
            obs_size *= n
        self.obs_fc1 = nn.Linear(obs_size, 256)
        self.obs_fc2 = nn.Linear(256, 256)
        self.action_embed = ActionEmbedding(num_actions)
        self.embed = nn.Linear(512, d_model)
        self.blocks = nn.ModuleList(SelfAttentionBlock(d_model, num_heads)
                                    for _ in range(num_layers))
        self.final_ln = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.head_fc = nn.Linear(d_model, 128)
        if head == "actor_critic":
            self.logits = nn.Linear(128, num_actions)
            self.value = nn.Linear(128, 1)
        else:
            self.q = nn.Linear(128, num_actions)
            self.mean = nn.Linear(128, 1)
        init_glorot_(self, generator)

    def forward(self, obs_seq: torch.Tensor, prev_action_seq: torch.Tensor,
                done_seq: torch.Tensor):
        b, t = prev_action_seq.shape
        if t > self.max_len:
            raise ValueError(f"sequence length {t} exceeds max_len {self.max_len}")
        x = obs_seq.to(torch.float32).reshape(b, t, -1)
        x = F.relu(self.obs_fc2(F.relu(self.obs_fc1(x))))
        z = self.embed(torch.cat([x, self.action_embed(prev_action_seq)], dim=-1))
        segs = episode_segments(done_seq)
        for block in self.blocks:
            z = block(z, segs)
        h = F.relu(self.head_fc(self.final_ln(z)))
        if self.head == "actor_critic":
            policy = torch.softmax(self.logits(h).to(torch.float32), dim=-1)
            return policy, self.value(h).to(torch.float32)[..., 0]
        return (self.q(h) - self.mean(h)).to(torch.float32)
