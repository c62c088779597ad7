"""Mixture-of-experts MLP: top-k routing over a fixed per-expert capacity.

Counterpart of the JAX package's `ops/moe.py`: the dense
dispatch/combine formulation of GShard and Switch, top-k routing
expressed as 0/1 dispatch and weighted combine tensors `[N, E, C]`
contracted with the tokens and the expert-stacked weights. The expert
products are plain einsums, as the JAX package computes them outside any
Pallas kernel.

Over a mesh of ranks (`mesh=`) the routing is the union batch's, as
under GSPMD in JAX: each rank's `[N_local, E]` router probabilities are
all-gathered over `data` (and over `seq` when the tokens are
sequence-sharded), the capacity counts the global N, slots go in the
global (choice, token) order and the load-balancing term takes the
global means; then each rank keeps its own tokens' rows. With an
`expert` axis of n each rank holds `E / n` experts (the `moe_w*` /
`moe_b*` leaves' leading dim), runs them on its tokens' slots and the
partial combines are summed over the axis.

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
from distributed_reinforcement_learning_tpu_torch.parallel import mesh as mesh_lib
from distributed_reinforcement_learning_tpu_torch.parallel.mesh import (
    DATA_AXIS, EXPERT_AXIS, SEQ_AXIS)


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
    combine). All first choices claim capacity before any second choice,
    so a token's strongest expert is the last to overflow."""
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
    return dispatch, combine


def _aux_loss(probs: torch.Tensor) -> torch.Tensor:
    """Switch's load-balancing term of `[N, E]` router probabilities:
    `E * sum_e f_e p_e`, `f_e` the fraction of first choices (ties to the
    lower expert, as the dispatch's), `p_e` the mean probability."""
    e = probs.shape[-1]
    first = top_k_lower_index(probs, 1)[1][:, 0]
    frac = torch.mean(F.one_hot(first, e).to(probs.dtype), dim=0)
    return e * torch.sum(frac * torch.mean(probs, dim=0))


def _global_probs(probs, lead, mesh, seq_sharded: bool):
    """This rank's `[N_local, E]` router probabilities -> (the union's `[N,
    E]` in JAX's token order, this rank's rows in it or None). `lead` is
    the tokens' leading shape, `[B_local]` or `[B_local, T_local]`: dim 0
    split over `data`, dim 1 over `seq` when `seq_sharded`."""
    d = mesh.size(DATA_AXIS)
    s = mesh.size(SEQ_AXIS) if seq_sharded else 1
    if d == 1 and s == 1:
        return probs, None
    b_local = lead[0]
    t_local = math.prod(lead[1:])
    if s > 1 and len(lead) != 2:
        raise ValueError(f"sequence-sharded tokens are [B, T, d], got lead {tuple(lead)}")
    p = probs.reshape(b_local, t_local, probs.shape[-1])
    if s > 1:
        # Out of the sequence-sharded region: the loss reads the union's
        # routing the same on every seq rank.
        p = mesh_lib.gather_invariant(mesh, p, SEQ_AXIS, 1)
    p = mesh_lib.gather_varying(mesh, p, DATA_AXIS, 0)
    b = mesh.coords[DATA_AXIS] * b_local + torch.arange(b_local, device=probs.device)
    t = (mesh.coords[SEQ_AXIS] if s > 1 else 0) * t_local + torch.arange(
        t_local, device=probs.device)
    rows = (b[:, None] * (t_local * s) + t[None, :]).reshape(-1)
    return p.reshape(-1, probs.shape[-1]), rows


def moe_mlp(x: torch.Tensor, params: dict[str, torch.Tensor], *, top_k: int = 2,
            capacity_factor: float = 2.0, mesh=None,
            seq_sharded: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward over `[..., d_model]` tokens -> (y, aux loss).

    With `mesh` (a `parallel/mesh.RankMesh`) the routing is the union
    batch's (x's dim 0 is this rank's rows over `data`; with
    `seq_sharded` its dim 1 is this rank's steps over `seq`), and over an
    `expert` axis > 1 `params` hold this rank's experts."""
    e = params["moe_gate"].shape[-1]
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, d)

    probs = torch.softmax(xf.to(torch.float32) @ params["moe_gate"].to(torch.float32), dim=-1)
    rows = None
    if mesh is not None:
        probs, rows = _global_probs(probs, lead, mesh, seq_sharded)
    cap = expert_capacity(probs.shape[0], e, top_k, capacity_factor)
    # The load-balancing term reads the probabilities outside any expert
    # split: its cotangent is the same on every expert rank.
    aux = _aux_loss(probs)
    ep = 1 if mesh is None else mesh.size(EXPERT_AXIS)
    if ep > 1:
        # This rank's experts: the tokens and the router probabilities enter
        # the expert-sharded work (their cotangents sum over the axis; the
        # `[N, E]` probabilities rather than the `[N, E, C]` combine
        # weights they make).
        e_local = params["moe_w1"].shape[0]
        if e_local * ep != e:
            raise ValueError(f"{e} experts over an expert axis of {ep}: a rank holds "
                             f"{e_local}")
        probs = mesh_lib.enter(mesh, probs, EXPERT_AXIS)
        xf = mesh_lib.enter(mesh, xf, EXPERT_AXIS)
    dispatch, combine = _dispatch_combine(probs, top_k, cap)
    if rows is not None:
        dispatch, combine = dispatch[rows], combine[rows]
    if ep > 1:
        e0 = mesh.coords[EXPERT_AXIS] * e_local
        dispatch, combine = dispatch[:, e0:e0 + e_local], combine[:, e0:e0 + e_local]

    expert_in = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), xf)
    h = F.relu(torch.einsum("ecd,edh->ech", expert_in, params["moe_w1"].to(x.dtype))
               + params["moe_b1"][:, None].to(x.dtype))
    expert_out = (torch.einsum("ech,ehd->ecd", h, params["moe_w2"].to(x.dtype))
                  + params["moe_b2"][:, None].to(x.dtype))
    y = torch.einsum("nec,ecd->nd", combine.to(x.dtype), expert_out)
    if ep > 1:
        y = mesh_lib.psum_invariant(mesh, y, EXPERT_AXIS)
    return y.reshape(*lead, d), aux
