"""Mixture-of-experts MLP: top-k routing over a fixed per-expert capacity.

Counterpart of the JAX package's `ops/moe.py` on one device: the dense
dispatch/combine formulation of GShard and Switch, top-k routing
expressed as 0/1 dispatch and weighted combine tensors `[N, E, C]`
contracted with the tokens and the expert-stacked weights. The expert
products are plain einsums, as the JAX package computes them outside any
Pallas kernel. Expert parallelism (`mesh` with an `expert` axis) needs a
mesh and raises (ROADMAP item 13c).

Routing, as there:
- `top_k` experts per token, gate weights renormalised over the chosen k;
  ties between router probabilities go to the lower expert index
  (`jax.lax.top_k`'s order, pinned here by a stable sort).
- `ceil(top_k * N * capacity_factor / E)` slots per expert, filled in
  (choice rank, token order) priority; a token past an expert's capacity
  is dropped from that expert (its combine weight is zero).
- Aux load-balancing loss (Switch Transformer eq. 4): `E * sum_e f_e p_e`
  with `f_e` the fraction of tokens whose first choice is `e` and `p_e`
  the mean router probability; 1.0 at perfect balance. Its gradient
  flows through `p_e` only.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from distributed_reinforcement_learning_tpu_torch.models.torso import glorot_uniform_


def init_moe_params(d_model: int, d_hidden: int, num_experts: int,
                    generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
    """Router and expert-stacked MLP weights: Glorot-uniform over the
    matmul dims (the leading expert dim is a batch axis for the fans),
    zero biases."""
    e = num_experts
    gate = torch.empty(d_model, e)
    w1 = torch.empty(e, d_model, d_hidden)
    w2 = torch.empty(e, d_hidden, d_model)
    glorot_uniform_(gate, d_model, e, generator)
    glorot_uniform_(w1, d_model, d_hidden, generator)
    glorot_uniform_(w2, d_hidden, d_model, generator)
    return {"moe_gate": gate, "moe_w1": w1, "moe_b1": torch.zeros(e, d_hidden),
            "moe_w2": w2, "moe_b2": torch.zeros(e, d_model)}


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    return max(1, math.ceil(top_k * num_tokens * capacity_factor / num_experts))


def top_k_lower_index(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row, largest
    first, ties to the lower index (`jax.lax.top_k`'s order; `torch.topk`
    promises none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_combine(probs: torch.Tensor, top_k: int, capacity: int):
    """[N, E] router probabilities -> ([N, E, C] 0/1 dispatch, [N, E, C]
    combine, aux). All first choices claim capacity before any second
    choice, so a token's strongest expert is the last to overflow."""
    n, e = probs.shape
    vals, idx = top_k_lower_index(probs, top_k)  # [N, k]
    gate = vals / (torch.sum(vals, dim=-1, keepdim=True) + 1e-9)
    onehot = F.one_hot(idx, e).to(probs.dtype)  # [N, k, E]

    # Rank each (choice, token) within its expert, choice-major. The
    # cumsum stays integer: float32 ranks go inexact past 2^24 routed
    # slots an expert and would double-book capacity.
    flat = onehot.transpose(0, 1).reshape(top_k * n, e).to(torch.int32)
    pos_flat = torch.sum((torch.cumsum(flat, dim=0, dtype=torch.int32) - 1) * flat, dim=-1)
    pos = pos_flat.reshape(top_k, n).T  # [N, k]
    # Positions >= capacity match no slot: the overflow drop.
    slot = (pos[..., None] == torch.arange(capacity, device=probs.device)).to(probs.dtype)

    dispatch = torch.einsum("nke,nkc->nec", onehot, slot)
    combine = torch.einsum("nk,nke,nkc->nec", gate, onehot, slot)

    frac = torch.mean(onehot[:, 0, :], dim=0)
    mean_prob = torch.mean(probs, dim=0)
    aux = e * torch.sum(frac * mean_prob)
    return dispatch, combine, aux


def moe_mlp(x: torch.Tensor, params: dict[str, torch.Tensor], *, top_k: int = 2,
            capacity_factor: float = 2.0, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward over `[..., d_model]` tokens -> (y, aux loss)."""
    if mesh is not None:
        raise ValueError("expert parallelism (a mesh with an expert axis) is not ported "
                         "(ROADMAP item 13c)")
    e = params["moe_gate"].shape[-1]
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, d)
    n = xf.shape[0]

    probs = torch.softmax(xf.to(torch.float32) @ params["moe_gate"].to(torch.float32), dim=-1)
    dispatch, combine, aux = _dispatch_combine(
        probs, top_k, expert_capacity(n, e, top_k, capacity_factor))

    expert_in = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), xf)
    h = F.relu(torch.einsum("ecd,edh->ech", expert_in, params["moe_w1"].to(x.dtype))
               + params["moe_b1"][:, None].to(x.dtype))
    expert_out = (torch.einsum("ech,ehd->ecd", h, params["moe_w2"].to(x.dtype))
                  + params["moe_b2"][:, None].to(x.dtype))
    y = torch.einsum("nec,ecd->nd", combine.to(x.dtype), expert_out)
    return y.reshape(*lead, d), aux
