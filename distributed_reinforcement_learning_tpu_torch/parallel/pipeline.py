"""Pipeline parallelism: the GPipe microbatch schedule over the `pipe` axis
of a mesh of ranks.

Counterpart of the JAX package's `parallel/pipeline.py`. A stack of
identical stages lies one stage a rank along `pipe`; microbatches stream
through them and activations hop stage to stage (`mesh.shift`, JAX's
`lax.ppermute`). The schedule is written out as JAX writes it
(`_pipeline_shard`): M + S - 1 ticks, where stage 0 takes the fresh
microbatch and every other stage what it received, and the last stage's
outputs are broadcast (a masked sum over the axis) so that every pipe
rank returns the whole result, which the learner's loss needs.

Each choice between stages is a `torch.where` on the rank's stage, not a
Python branch, so that every rank builds the same graph and the backward
pass runs its shifts in the same order on every rank. The backward is
autograd's: a shift's transpose is the reverse shift, the masked sum's
is the identity (the last stage alone keeps a nonzero cotangent), and
the activations entering the pipeline sum their cotangents over the axis
(only stage 0 reads them).

Contract, as in JAX:
- `stage_params`: this rank's stage, every leaf with a leading dim of 1
  (its slice of JAX's `[pipe, ...]` stack, `stack_stage_params`);
- `stage_fn(params_i, acts) -> acts`: one stage, activation structure and
  shapes the same in and out (segment ids ride along unchanged);
- `acts`: a tuple of `[B, ...]` tensors, this rank's rows; B must split
  into `num_microbatches` equal microbatches.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from distributed_reinforcement_learning_tpu_torch.parallel import mesh as mesh_lib
from distributed_reinforcement_learning_tpu_torch.parallel.mesh import PIPE_AXIS, RankMesh


def stack_stage_params(init_fn: Callable[[torch.Generator | None], dict], n_stages: int,
                       generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
    """`[n_stages, ...]`-stacked parameters from a per-stage init, the
    stages drawn one after another from `generator`."""
    stages = [init_fn(generator) for _ in range(n_stages)]
    return {k: torch.stack([s[k] for s in stages]) for k in stages[0]}


def _shift_acts(mesh: RankMesh, acts: tuple) -> tuple:
    """Every leaf one stage on (zeros into stage 0): the float leaves
    packed into one differentiable shift, the others (segment ids) in one
    plain shift each."""
    floats = [i for i, a in enumerate(acts) if a.is_floating_point()]
    out = list(acts)
    if floats:
        flat = torch.cat([acts[i].reshape(-1) for i in floats])
        flat = mesh_lib.shift(mesh, flat, PIPE_AXIS, 1, cyclic=False)
        at = 0
        for i in floats:
            n = acts[i].numel()
            out[i] = flat[at:at + n].view_as(acts[i])
            at += n
    for i, a in enumerate(acts):
        if i not in floats:
            out[i] = mesh.shift(a, PIPE_AXIS, 1, cyclic=False)
    return tuple(out)


def _pipeline_shard(mesh: RankMesh, stage_params: dict, acts: tuple, *,
                    stage_fn: Callable[[Any, Any], Any], num_microbatches: int) -> tuple:
    """Per-rank body: this rank's stage over the microbatch stream."""
    n_stages, stage = mesh.size(PIPE_AXIS), mesh.coords[PIPE_AXIS]
    dev = acts[0].device
    first = torch.tensor(stage == 0, device=dev)
    last = torch.tensor(stage == n_stages - 1, device=dev)
    params_local = {k: v[0] for k, v in stage_params.items()}
    m = num_microbatches
    # Only stage 0 reads the fresh activations: their cotangents sum over
    # the axis.
    acts = tuple(mesh_lib.enter(mesh, a, PIPE_AXIS) if a.requires_grad else a for a in acts)
    mb = [a.reshape(m, a.shape[0] // m, *a.shape[1:]) for a in acts]  # [M, B/M, ...]
    recv = tuple(torch.zeros_like(a[0]) for a in mb)
    slots = [tuple(torch.zeros_like(a[0]) for a in mb) for _ in range(m)]
    for t in range(m + n_stages - 1):
        # Ticks past the last microbatch keep feeding the final one; their
        # outputs land outside the collect window below.
        fresh = tuple(a[min(t, m - 1)] for a in mb)
        inp = tuple(torch.where(first, x, r) for x, r in zip(fresh, recv))
        out = stage_fn(params_local, inp)
        recv = _shift_acts(mesh, out)
        # The last stage finishes microbatch t - (S-1) at tick t.
        o = t - (n_stages - 1)
        valid = last & (o >= 0)
        slot = max(o, 0)
        slots[slot] = tuple(torch.where(valid, a, s) for a, s in zip(out, slots[slot]))
    out = []
    for i in range(len(acts)):
        whole = torch.cat([s[i] for s in slots])
        # The masked sum broadcasts the last stage's outputs to every rank.
        whole = torch.where(last, whole, torch.zeros_like(whole))
        out.append(mesh_lib.psum_invariant(mesh, whole, PIPE_AXIS) if whole.is_floating_point()
                   else mesh.all_reduce(whole.clone(), PIPE_AXIS))
    return tuple(out)


def pipeline_apply(mesh: RankMesh, stage_fn: Callable[[Any, Any], Any], stage_params: dict,
                   acts: tuple, *, num_microbatches: int, batch_axis=None) -> tuple:
    """Apply the mesh's `pipe` chained stages to `acts` with the GPipe
    schedule -> `stage_{S-1}(... stage_0(acts))`, the whole result on every
    pipe rank. `batch_axis` is JAX's argument; a rank's rows are already
    its own here (B is the per-rank batch)."""
    n = mesh.shape.get(PIPE_AXIS, 1)
    if n < 2:
        raise ValueError(f"mesh {dict(mesh.shape)} has no '{PIPE_AXIS}' axis > 1")
    lead = {leaf.shape[0] for leaf in stage_params.values()}
    if lead != {1}:
        raise ValueError(f"stage_params leading dims {lead}: a rank holds its one stage of "
                         f"the pipe axis's {n} (leading dim 1)")
    batch = {a.shape[0] for a in acts}
    if len(batch) != 1:
        raise ValueError(f"activation leaves disagree on batch dim: {batch}")
    (per,) = batch
    if per % num_microbatches != 0:
        raise ValueError(
            f"per-device batch {per} not divisible by num_microbatches={num_microbatches}")
    return _pipeline_shard(mesh, stage_params, tuple(acts), stage_fn=stage_fn,
                           num_microbatches=num_microbatches)
