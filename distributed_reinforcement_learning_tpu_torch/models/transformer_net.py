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
(Transformer-R2D2). The body features:

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

- `attention_fn` with `seq_mesh`: sequence parallelism. The stream is
  sharded over the mesh's `seq` axis from the input on: each rank runs
  the torso, the blocks and the head on its `T / seq` steps (its
  contiguous chunk, or with `sequence_perm` its chunks of the zigzag
  layout, the one reorder JAX makes once), RoPE and the episode masks
  take the steps' true positions, and the attention is `attention_fn`,
  a per-rank body of `parallel/sequence.py` (`ring_shard`,
  `ring_shard_zigzag`, `ulysses_shard`) bound to the mesh. The head's
  outputs are all-gathered over `seq` and put back in time order. Every
  parameter's gradient is then a part over the rank's steps, summed over
  `seq` by the learner (`parallel/learner.py`).
- `moe_mesh`: the routers route the union batch of the mesh (its `data`
  rows and, when sequence-sharded, its `seq` steps), and over an
  `expert` axis each rank runs its own experts (`ops/moe.py`).
- `pipeline_mesh` (with `stack_layers`): the blocks run as GPipe stages
  over the mesh's `pipe` axis (`parallel/pipeline.py`), each rank
  holding and scanning its contiguous `num_layers / pipe` layers
  (virtual stages) on the microbatches.

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
from distributed_reinforcement_learning_tpu_torch.parallel import mesh as mesh_lib

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
def _rope_tables(t: int, d2: int, base: float, device: torch.device, dtype: torch.dtype,
                 positions: tuple[int, ...] | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin `[1, T, 1, D/2]` at `positions` (default `range(t)`),
    computed once in float32 on the CPU (the same numbers on every device),
    cast to `dtype`. Made outside inference mode, so that the cached
    tables also serve autograd."""
    with torch.inference_mode(False):
        freqs = base ** (-torch.arange(d2, dtype=torch.float32) / d2)
        pos = (torch.arange(t, dtype=torch.float32) if positions is None
               else torch.tensor(positions, dtype=torch.float32))
        angles = pos[:, None] * freqs[None, :]
        return (torch.cos(angles)[None, :, None, :].to(device, dtype),
                torch.sin(angles)[None, :, None, :].to(device, dtype))


def rope(x: torch.Tensor, positions: tuple[int, ...] | None = None,
         base: float = 10_000.0) -> torch.Tensor:
    """Rotary position embedding over the time axis of `[B, T, H, D]`,
    with the half-split rotation (`x1 = x[..., :D/2]`). `positions` (the
    steps' true positions, one a step of x) overrides `range(T)` for a
    sharded or permuted stream."""
    d2 = x.shape[-1] // 2
    cos, sin = _rope_tables(x.shape[1], d2, base, x.device, x.dtype, positions)
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _split_heads(z: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = z.shape
    return z.reshape(b, t, num_heads, d // num_heads)


def _attend(q, k, v, segs, num_heads: int, attention_fn=None, positions=None) -> torch.Tensor:
    """RoPE on q and k, causal same-segment attention -> `[B, T, d]`:
    `attention_fn(q, k, v, segs)` on a sequence-sharded stream, else
    `causal_attention`."""
    b, t, d = q.shape
    q = rope(_split_heads(q, num_heads), positions)
    k = rope(_split_heads(k, num_heads), positions)
    v = _split_heads(v, num_heads)
    if attention_fn is not None:
        out = attention_fn(q, k, v, segs)
    else:
        out = causal_attention(q, k, v, q_seg=segs, k_seg=segs)
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
                 generator: torch.Generator | None = None, attention_fn=None,
                 moe_mesh=None, seq_sharded: bool = False):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by num_heads {num_heads}")
        self.d_model, self.num_heads = d_model, num_heads
        self.attention_fn, self.moe_mesh, self.seq_sharded = attention_fn, moe_mesh, seq_sharded
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

    def forward(self, x: torch.Tensor, segs: torch.Tensor, positions=None):
        q, k, v = torch.split(self.qkv(self.ln1(x)), self.d_model, dim=-1)
        x = x + self.proj(_attend(q, k, v, segs, self.num_heads, self.attention_fn, positions))
        y = self.ln2(x)
        if hasattr(self, "moe"):
            y, aux = moe_mlp(y, dict(self.moe.named_parameters()), top_k=self.moe_top_k,
                             capacity_factor=self.moe_capacity_factor, mesh=self.moe_mesh,
                             seq_sharded=self.seq_sharded)
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
    the stored sequence. The mesh arguments (`attention_fn` with
    `seq_mesh` and `sequence_perm`, `moe_mesh`, `pipeline_mesh`) are the
    module docstring's; outputs are always the whole `[B, T, ...]` of the
    rank's rows, in time order."""

    def __init__(self, num_actions: int, obs_shape: tuple[int, ...], d_model: int = 256,
                 num_heads: int = 4, num_layers: int = 2, max_len: int = 512,
                 head: str = "dueling_q", num_experts: int = 0, moe_top_k: int = 2,
                 moe_capacity_factor: float = 2.0, stack_layers: bool = False,
                 remat: bool = False, generator: torch.Generator | None = None,
                 attention_fn=None, seq_mesh=None, sequence_perm: tuple | None = None,
                 moe_mesh=None, pipeline_mesh=None, pipeline_microbatches: int = 2):
        super().__init__()
        if head not in ("dueling_q", "actor_critic"):
            raise ValueError(f"unknown head {head!r}")
        if stack_layers and (attention_fn is not None or num_experts):
            raise ValueError("stack_layers uses the dense-attention pure-function block; "
                             "sequence-parallel attention and mixture-of-experts layers need "
                             "the module body (nesting their collectives inside a pipeline "
                             "stage is unsupported)")
        if (attention_fn is None) != (seq_mesh is None):
            raise ValueError("attention_fn (a per-rank body) and seq_mesh go together")
        if sequence_perm is not None and attention_fn is None:
            raise ValueError("sequence_perm without a layout-aware attention_fn would "
                             "causally mask in the wrong order")
        if pipeline_mesh is not None and not stack_layers:
            raise ValueError("pipeline_mesh runs the stacked layout (stack_layers=True)")
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by num_heads {num_heads}")
        self.head, self.max_len = head, max_len
        self.num_heads, self.num_layers, self.remat = num_heads, num_layers, remat
        self.seq_mesh, self.sequence_perm = seq_mesh, sequence_perm
        self.pipeline_mesh, self.pipeline_microbatches = pipeline_mesh, pipeline_microbatches
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
                                   moe_capacity_factor, generator, attention_fn=attention_fn,
                                   moe_mesh=moe_mesh, seq_sharded=seq_mesh is not None)
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

    def _stacked_block(self):
        """One layer of the stacked layout as a function of its parameters:
        (params, z, segs) -> z, recomputed in the backward pass with remat
        (where autograd records)."""
        names = [n for n, _ in self.blocks_stacked.named_parameters()]

        def run(z, segs, *params):
            return stacked_block_apply(dict(zip(names, params)), z, segs, self.num_heads)

        if not (self.remat and torch.is_grad_enabled()):
            return lambda p, z, segs: run(z, segs, *(p[k] for k in names))
        return lambda p, z, segs: checkpoint(run, z, segs, *(p[k] for k in names),
                                             use_reentrant=False)

    def _layer(self, i: int, z: torch.Tensor, segs: torch.Tensor, positions=None):
        """Block i -> (z, aux or None). With remat (where autograd records)
        the block runs under a non-reentrant checkpoint whose function gets
        the block's parameters as inputs: its recompute in the backward
        pass finds them there, not on the module."""
        if hasattr(self, "blocks_stacked"):
            stacked = dict(self.blocks_stacked.named_parameters())
            return self._stacked_block()({k: v[i] for k, v in stacked.items()}, z, segs), None
        block = self.blocks[i]
        if not (self.remat and torch.is_grad_enabled()):
            return block(z, segs, positions)
        names, params = zip(*block.named_parameters())

        def run(z, segs, *params):
            return functional_call(block, dict(zip(names, params)), (z, segs, positions))

        return checkpoint(run, z, segs, *params, use_reentrant=False)

    def _pipeline(self, z: torch.Tensor, segs: torch.Tensor) -> torch.Tensor:
        """The blocks as GPipe stages over `pipeline_mesh`'s `pipe` axis:
        this rank's `[num_layers / pipe, ...]` layers scanned in each tick,
        segment ids riding with their microbatch."""
        from distributed_reinforcement_learning_tpu_torch.parallel import pipeline as pp
        from distributed_reinforcement_learning_tpu_torch.parallel.mesh import PIPE_AXIS

        mesh = self.pipeline_mesh
        stages = mesh.size(PIPE_AXIS)
        if stages < 2 or self.num_layers % stages != 0:
            raise ValueError(f"pipeline mesh pipe axis {stages} must be >= 2 and divide "
                             f"num_layers {self.num_layers}")
        per_stage = self.num_layers // stages
        local = dict(self.blocks_stacked.named_parameters())
        if {v.shape[0] for v in local.values()} != {per_stage}:
            raise ValueError(f"a pipe rank holds {per_stage} layers of the stack, got "
                             f"{ {v.shape[0] for v in local.values()} }")
        block = self._stacked_block()

        def stage(p, act):
            zz, ss = act
            for layer in range(per_stage):
                zz = block({k: v[layer] for k, v in p.items()}, zz, ss)
            return zz, ss

        staged = {k: v[None] for k, v in local.items()}
        return pp.pipeline_apply(mesh, stage, staged, (z, segs),
                                 num_microbatches=self.pipeline_microbatches)[0]

    def forward(self, obs_seq: torch.Tensor, prev_action_seq: torch.Tensor,
                done_seq: torch.Tensor, return_aux: bool = False):
        b, t = prev_action_seq.shape
        if t > self.max_len:
            raise ValueError(f"sequence length {t} exceeds max_len {self.max_len}")
        segs = episode_segments(done_seq)  # chronological, before any reorder
        positions = None
        if self.seq_mesh is not None:
            obs_seq, prev_action_seq, segs, positions = self._own_steps(
                t, obs_seq, prev_action_seq, segs)
        x = obs_seq.to(torch.float32).reshape(b, prev_action_seq.shape[1], -1)
        x = F.relu(self.obs_fc2(F.relu(self.obs_fc1(x))))
        z = self.embed(torch.cat([x, self.action_embed(prev_action_seq)], dim=-1))
        aux = []
        if self.pipeline_mesh is not None:
            z = self._pipeline(z, segs)
        else:
            for i in range(self.num_layers):
                z, a = self._layer(i, z, segs, positions)
                if a is not None:
                    aux.append(a)
        h = F.relu(self.head_fc(self.final_ln(z)))
        if self.head == "actor_critic" and self.seq_mesh is None:
            policy = torch.softmax(self.logits(h).to(torch.float32), dim=-1)
            out = (policy, self.value(h).to(torch.float32)[..., 0])
        elif self.head == "actor_critic":
            # One gather of the logits and the value; the softmax after it,
            # as JAX takes it after the un-permute.
            out = torch.cat([self.logits(h), self.value(h)], dim=-1).to(torch.float32)
            out = self._whole_sequence(out)
            out = (torch.softmax(out[..., :-1], dim=-1), out[..., -1])
        else:
            out = self._whole_sequence((self.q(h) - self.mean(h)).to(torch.float32))
        return (out, aux) if return_aux else out

    def _own_steps(self, t: int, obs_seq, prev_action_seq, segs):
        """This seq rank's steps of the inputs: its contiguous chunk of the
        time axis, or of the zigzag layout under `sequence_perm` -> the
        inputs at those steps and the steps' true positions."""
        from distributed_reinforcement_learning_tpu_torch.parallel.mesh import SEQ_AXIS

        n, i = self.seq_mesh.size(SEQ_AXIS), self.seq_mesh.coords[SEQ_AXIS]
        if t % n:
            raise ValueError(f"sequence length {t} not divisible by seq axis {n}")
        layout = tuple(range(t))
        if self.sequence_perm is not None:
            layout = tuple(self.sequence_perm[0])
            if len(layout) != t:
                raise ValueError(f"sequence_perm is for T={len(layout)}, got T={t}")
        positions = layout[i * (t // n):(i + 1) * (t // n)]
        idx = torch.tensor(positions, device=segs.device)
        return (obs_seq.index_select(1, idx.to(obs_seq.device)),
                prev_action_seq.index_select(1, idx.to(prev_action_seq.device)),
                segs.index_select(1, idx), positions)

    def _whole_sequence(self, out: torch.Tensor) -> torch.Tensor:
        """A sequence-sharded output `[B, T/n, ...]` -> the whole `[B, T,
        ...]` in time order, the same on every seq rank (the loss reads it
        there)."""
        if self.seq_mesh is None:
            return out
        from distributed_reinforcement_learning_tpu_torch.parallel.mesh import SEQ_AXIS

        out = mesh_lib.gather_invariant(self.seq_mesh, out, SEQ_AXIS, 1)
        if self.sequence_perm is not None:
            out = out.index_select(1, torch.tensor(self.sequence_perm[1], device=out.device))
        return out
