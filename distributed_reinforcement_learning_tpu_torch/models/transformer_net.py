"""Transformer network: causal pre-LN attention over the sequence, in place
of the LSTM.

Counterpart of the JAX package's `models/transformer_net.py` on one
device: MLP torso 256-256 on the observation and the previous-action
embedding -> Dense to d_model -> `num_layers` pre-LN blocks (causal
attention confined within episodes by segment ids from `done`, RoPE on q
and k) -> LayerNorm -> Dense 128 relu -> head.

Two heads over one trunk: `actor_critic` returns `(policy [B, T, A]
softmax, value [B, T])` (Transformer-IMPALA), `dueling_q` returns the
reference's `value - learned_mean` Q-values `[B, T, A]`
(Transformer-R2D2). The body features that need no mesh:

- `num_experts > 0`: every block's MLP is a routed mixture of experts
  (`ops/moe.py`), its parameters one `moe` group per block. The routers'
  load-balancing terms come back explicitly, one per layer, from
  `forward(..., return_aux=True)`; nothing is kept on the module, which
  runs under `functional_call` and may be shared.
- `stack_layers`: the blocks' parameters are one `blocks_stacked` group
  of `[num_layers, ...]` tensors (the JAX layout, kernels `[in, out]`),
  applied layer by layer by `stacked_block_apply`. Dense attention only.
- `remat`: each block is recomputed in the backward pass
  (`torch.utils.checkpoint`, non-reentrant). The recompute runs after
  `functional_call` has put the module's own tensors back, so the
  checkpointed function takes the block's parameters as explicit inputs
  and applies the block to them itself. It runs only where autograd
  records; the parameter names do not change.

Not ported: sequence-parallel `attention_fn` and `sequence_perm`, the
pipeline, expert parallelism (ROADMAP item 13c).

Module names are this package's; `models/convert.py` maps flax's
automatic names (`Dense_0`, `SelfAttentionBlock_0/LayerNorm_0`, ...)
onto them.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_reinforcement_learning_tpu_torch.models.functional import functional_call
from distributed_reinforcement_learning_tpu_torch.models.torso import (
    ActionEmbedding, glorot_uniform_, init_glorot_)
from distributed_reinforcement_learning_tpu_torch.ops.attention import causal_attention
from distributed_reinforcement_learning_tpu_torch.ops.moe import init_moe_params, moe_mlp

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


def _split_heads(z: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = z.shape
    return z.reshape(b, t, num_heads, d // num_heads)


def _attend(q, k, v, segs, num_heads: int) -> torch.Tensor:
    """RoPE on q and k, causal same-segment attention -> `[B, T, d]`."""
    b, t, d = q.shape
    out = causal_attention(rope(_split_heads(q, num_heads)), rope(_split_heads(k, num_heads)),
                           _split_heads(v, num_heads), q_seg=segs, k_seg=segs)
    return out.reshape(b, t, d)


class MoEParams(nn.Module):
    """One block's `moe` parameter group (`ops/moe.py`): router `[d, E]`,
    expert MLPs `[E, d, 4d]` and `[E, 4d, d]` with their biases."""

    def __init__(self, d_model: int, num_experts: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        for name, value in init_moe_params(d_model, 4 * d_model, num_experts,
                                           generator).items():
            setattr(self, name, nn.Parameter(value))


class SelfAttentionBlock(nn.Module):
    """Pre-LN attention + MLP block; `num_experts > 0` swaps the dense MLP
    for a routed mixture of experts. `forward` -> (x, aux), aux the
    router's load-balancing term or None."""

    def __init__(self, d_model: int, num_heads: int, num_experts: int = 0,
                 moe_top_k: int = 2, moe_capacity_factor: float = 2.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by num_heads {num_heads}")
        self.d_model, self.num_heads = d_model, num_heads
        self.moe_top_k, self.moe_capacity_factor = moe_top_k, moe_capacity_factor
        self.ln1 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.proj = nn.Linear(d_model, d_model)
        self.ln2 = nn.LayerNorm(d_model, eps=_LN_EPS)
        if num_experts:
            self.moe = MoEParams(d_model, num_experts, generator)
        else:
            self.mlp1 = nn.Linear(d_model, 4 * d_model)
            self.mlp2 = nn.Linear(4 * d_model, d_model)

    def forward(self, x: torch.Tensor, segs: torch.Tensor):
        q, k, v = torch.split(self.qkv(self.ln1(x)), self.d_model, dim=-1)
        x = x + self.proj(_attend(q, k, v, segs, self.num_heads))
        y = self.ln2(x)
        if hasattr(self, "moe"):
            y, aux = moe_mlp(y, dict(self.moe.named_parameters()), top_k=self.moe_top_k,
                             capacity_factor=self.moe_capacity_factor)
            return x + y, aux
        return x + self.mlp2(F.relu(self.mlp1(y))), None


class StackedBlocks(nn.Module):
    """The `blocks_stacked` parameter group: every block's parameters as
    one `[num_layers, ...]` tensor each, kernels `[in, out]` as in the JAX
    package. Glorot-uniform kernels (drawn layer by layer), zero biases,
    unit LayerNorm scales."""

    def __init__(self, num_layers: int, d_model: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        d, h = d_model, 4 * d_model
        shapes = {"ln1_scale": (d,), "ln1_bias": (d,), "qkv_kernel": (d, 3 * d),
                  "qkv_bias": (3 * d,), "proj_kernel": (d, d), "proj_bias": (d,),
                  "ln2_scale": (d,), "ln2_bias": (d,), "mlp1_kernel": (d, h),
                  "mlp1_bias": (h,), "mlp2_kernel": (h, d), "mlp2_bias": (d,)}
        for name, shape in shapes.items():
            fill = 1.0 if name.endswith("_scale") else 0.0
            setattr(self, name, nn.Parameter(torch.full((num_layers, *shape), fill)))
        for layer in range(num_layers):
            for name in ("qkv_kernel", "proj_kernel", "mlp1_kernel", "mlp2_kernel"):
                kernel = getattr(self, name)[layer]
                glorot_uniform_(kernel, *kernel.shape, generator)


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis: biased variance, eps 1e-6."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-6) * scale + bias


def stacked_block_apply(p: dict[str, torch.Tensor], x: torch.Tensor, segs: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """One pre-LN block as a pure function of one layer's parameters (the
    JAX package's `_stacked_block_apply`): the dense block's math with
    explicit parameters."""
    d = x.shape[-1]
    y = _layer_norm(x, p["ln1_scale"], p["ln1_bias"])
    q, k, v = torch.split(y @ p["qkv_kernel"] + p["qkv_bias"], d, dim=-1)
    x = x + _attend(q, k, v, segs, num_heads) @ p["proj_kernel"] + p["proj_bias"]
    y = _layer_norm(x, p["ln2_scale"], p["ln2_bias"])
    y = F.relu(y @ p["mlp1_kernel"] + p["mlp1_bias"])
    return x + y @ p["mlp2_kernel"] + p["mlp2_bias"]


class TransformerQNet(nn.Module):
    """MLP torso + action embedding -> causal transformer -> output head.

    `forward(obs_seq [B, T, ...], prev_action_seq [B, T], done_seq [B, T],
    return_aux=False)`; with `return_aux` -> (output, [aux of each layer]),
    the routers' load-balancing terms (an empty list without experts).
    Acting runs the same forward over a window of steps; training over
    the stored sequence."""

    def __init__(self, num_actions: int, obs_shape: tuple[int, ...], d_model: int = 256,
                 num_heads: int = 4, num_layers: int = 2, max_len: int = 512,
                 head: str = "dueling_q", num_experts: int = 0, moe_top_k: int = 2,
                 moe_capacity_factor: float = 2.0, stack_layers: bool = False,
                 remat: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        if head not in ("dueling_q", "actor_critic"):
            raise ValueError(f"unknown head {head!r}")
        if stack_layers and num_experts:
            raise ValueError("stack_layers uses the dense-attention pure-function block; "
                             "mixture-of-experts layers need the module body")
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by num_heads {num_heads}")
        self.head, self.max_len = head, max_len
        self.num_heads, self.num_layers, self.remat = num_heads, num_layers, remat
        obs_size = 1
        for n in obs_shape:
            obs_size *= n
        self.obs_fc1 = nn.Linear(obs_size, 256)
        self.obs_fc2 = nn.Linear(256, 256)
        self.action_embed = ActionEmbedding(num_actions)
        self.embed = nn.Linear(512, d_model)
        if stack_layers:
            self.blocks_stacked = StackedBlocks(num_layers, d_model, generator)
        else:
            self.blocks = nn.ModuleList(
                SelfAttentionBlock(d_model, num_heads, num_experts, moe_top_k,
                                   moe_capacity_factor, generator)
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

    def _layer(self, i: int, z: torch.Tensor, segs: torch.Tensor):
        """Block i -> (z, aux or None). With remat (where autograd records)
        the block runs under a non-reentrant checkpoint whose function gets
        the block's parameters as inputs: its recompute in the backward
        pass finds them there, not on the module."""
        remat = self.remat and torch.is_grad_enabled()
        if hasattr(self, "blocks_stacked"):
            names, stacked = zip(*self.blocks_stacked.named_parameters())
            params = [p[i] for p in stacked]

            def run(z, segs, *params):
                return stacked_block_apply(dict(zip(names, params)), z, segs,
                                           self.num_heads), None
        else:
            block = self.blocks[i]
            if not remat:
                return block(z, segs)
            names, params = zip(*block.named_parameters())

            def run(z, segs, *params):
                return functional_call(block, dict(zip(names, params)), (z, segs))
        if remat:
            return checkpoint(run, z, segs, *params, use_reentrant=False)
        return run(z, segs, *params)

    def forward(self, obs_seq: torch.Tensor, prev_action_seq: torch.Tensor,
                done_seq: torch.Tensor, return_aux: bool = False):
        b, t = prev_action_seq.shape
        if t > self.max_len:
            raise ValueError(f"sequence length {t} exceeds max_len {self.max_len}")
        x = obs_seq.to(torch.float32).reshape(b, t, -1)
        x = F.relu(self.obs_fc2(F.relu(self.obs_fc1(x))))
        z = self.embed(torch.cat([x, self.action_embed(prev_action_seq)], dim=-1))
        segs = episode_segments(done_seq)
        aux = []
        for i in range(self.num_layers):
            z, a = self._layer(i, z, segs)
            if a is not None:
                aux.append(a)
        h = F.relu(self.head_fc(self.final_ln(z)))
        if self.head == "actor_critic":
            policy = torch.softmax(self.logits(h).to(torch.float32), dim=-1)
            out = (policy, self.value(h).to(torch.float32)[..., 0])
        else:
            out = (self.q(h) - self.mean(h)).to(torch.float32)
        return (out, aux) if return_aux else out
