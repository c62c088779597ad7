"""The sharded learner: any agent's learn step over a mesh of ranks.

Counterpart of the JAX package's `parallel/learner.py`, where `jax.jit`
with shardings compiles one learn step over the mesh and GSPMD inserts
the collectives. Here each rank runs the agent's own learn step on its
rows, and the agents' reduction seam (`reducer=`, the counterpart of
JAX's `_learn(axis_name=...)`) calls `MeshReducer` between
`torch.autograd.grad` and the optimizer:

- `data`: the gradients are all-reduced across the axis in one flat
  buffer, together with the loss metrics: **summed** for IMPALA, whose
  losses are sums over the batch, **averaged** for the replay families,
  whose loss is `mean(... * is_weight)` (equal shards, so the mean of
  shard means is the union's). The global-norm clip and `grad_norm`
  act on the reduced gradient; the per-row outputs (priorities, |TD|)
  are all-gathered rank-major into the global `[B]`, which JAX returns
  replicated.
- `model`: each rank stores only its slice of every sharded parameter,
  target parameter and optimizer moment (`place_state`); the seam
  all-gathers the whole tensors before the forward and keeps its slice
  of the reduced gradient for the update. The leaves are JAX's
  (`train_state_sharding`); the gradient norm adds the slices' squares
  across the axis.
- `pipe` and `expert`: each rank stores its stage's layers or its
  experts (the `blocks_stacked` and `moe_*` leaves' leading dim) and
  their moments, and the forward uses them as they are
  (`parallel/pipeline.py`, `ops/moe.py`); their gradients are whole on
  the rank that holds them, and the norm adds their squares across the
  axis.
- `seq`: with the transformer's stream split over the axis
  (`agent.seq_sharded`), each rank's gradient is the part of its steps,
  and the gradients are summed across `seq` (after the data reduction,
  in one more flat all-reduce; the loss metrics are the same on every
  seq rank and are not).

Inside a step the model's own collectives carry their transposes
(`parallel/mesh.py`), so each parameter's gradient is the single-device
agent's on the union batch, with no n-fold count along `seq`, `pipe` or
`expert`.

With no reducer every agent does bit for bit what it did before. In a
world of one no collective runs in a learn step; `init_state`'s
broadcast from rank 0 runs whenever the world is joined.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Any

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.agents import common
from distributed_reinforcement_learning_tpu_torch.models.convert import flax_last_dim
from distributed_reinforcement_learning_tpu_torch.parallel import mesh as mesh_lib
from distributed_reinforcement_learning_tpu_torch.parallel.mesh import (
    DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, Placement, RankMesh)

# The axes along which the ranks of one data coordinate learn on the same rows.
_LINE_AXES = (SEQ_AXIS, PIPE_AXIS, EXPERT_AXIS)

# Leaves smaller than this stay replicated: a gather of a 256-float bias
# costs more than its slice saves.
_MIN_SHARD_SIZE = 4096


def model_dim(name: str, shape: tuple[int, ...]) -> int:
    """The dimension of the port's leaf that JAX's model rule splits: its
    flax counterpart's last (`models/convert.py:flax_last_dim`), dim 0 of
    a Linear or conv weight, the last of the LSTM's fused kernel."""
    return flax_last_dim(name, len(shape))


def train_state_sharding(mesh: RankMesh, params: Any) -> dict[str, Placement]:
    """Placement of each parameter (by name) of a train state, or of a
    `{name: tensor}` dict; the target parameters and optimizer moments
    share the names and take the same placement. JAX's three rules,
    first match wins:

    - leaves under `blocks_stacked` split their leading layer dim over
      `pipe`;
    - the experts' stacked leaves (`moe_*` but the gate) split their
      leading expert dim over `expert`;
    - a leaf of two or more dimensions whose flax last dimension divides
      the `model` axis, with at least `_MIN_SHARD_SIZE` elements, splits
      that dimension over `model`; the rest replicate.

    The first two fire only at pipe or expert sizes above 1."""
    params = getattr(params, "params", params)
    pipe, ep, m = mesh.size(PIPE_AXIS), mesh.size(EXPERT_AXIS), mesh.size(MODEL_AXIS)
    out = {}
    for name, leaf in params.items():
        shape = tuple(leaf.shape)
        keys = name.split(".")
        if (pipe > 1 and any("blocks_stacked" in k for k in keys) and len(shape) >= 1
                and shape[0] % pipe == 0):
            out[name] = Placement(mesh, (PIPE_AXIS,))
        elif (ep > 1 and any("moe_" in k and "moe_gate" not in k for k in keys)
              and len(shape) >= 2 and shape[0] % ep == 0):
            out[name] = Placement(mesh, (EXPERT_AXIS,))
        elif (m > 1 and len(shape) >= 2 and shape[model_dim(name, shape)] % m == 0
              and math.prod(shape) >= _MIN_SHARD_SIZE):
            out[name] = mesh_lib.model_kernel_sharding(mesh, len(shape), model_dim(name, shape))
        else:
            out[name] = mesh_lib.replicated(mesh)
    return out


class MeshReducer:
    """The agents' reduction seam over a mesh (`reducer=` of their learn
    steps). `records` holds (host ms, bytes) of each data-axis reduction,
    `seq_records` of each seq-axis one; the ms wait for the device first
    only when `timed` is set. `shard_dims` maps every leaf split over an
    axis to (axis, dim); `model_dims` those over `model` (gathered before
    the forward). `seq_partial`: the gradients are parts over `seq`."""

    def __init__(self, mesh: RankMesh, placements: dict[str, Placement],
                 seq_partial: bool = False):
        self.mesh = mesh
        self.shard_dims = {}
        for name, p in placements.items():
            for axis in (MODEL_AXIS, PIPE_AXIS, EXPERT_AXIS):
                if p.dim(axis) is not None:
                    self.shard_dims[name] = (axis, p.dim(axis))
        self.model_dims = {name: d for name, (axis, d) in self.shard_dims.items()
                           if axis == MODEL_AXIS}
        self.seq_partial = seq_partial and mesh.size(SEQ_AXIS) > 1
        self.timed = False
        self.records: list[tuple[float, int]] = []
        self.seq_records: list[tuple[float, int]] = []

    def _timed_reduce(self, flat: torch.Tensor, axis: str, op: str, records: list) -> None:
        if self.timed and flat.is_cuda:
            torch.cuda.synchronize(flat.device)
        t0, b0 = time.perf_counter(), self.mesh.bytes_moved
        self.mesh.all_reduce(flat, axis, op)
        if self.timed and flat.is_cuda:
            torch.cuda.synchronize(flat.device)
        records.append(((time.perf_counter() - t0) * 1e3, self.mesh.bytes_moved - b0))

    def gather(self, params: dict[str, torch.Tensor], grad: bool = True) -> dict:
        """The whole tensors of model-sharded leaves (fresh leaves that
        require grad when `grad`); other leaves as they are. Without a
        model axis, `params` itself."""
        if not self.model_dims:
            return params
        out = {}
        for name, p in params.items():
            d = self.model_dims.get(name)
            out[name] = p if d is None else (
                self.mesh.all_gather(p.detach(), MODEL_AXIS, d).requires_grad_(grad))
        return out

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor `t` of a model-sharded
        leaf `name` (the other leaves' gradients are already this rank's)."""
        d = self.model_dims.get(name)
        if d is None:
            return t
        n = t.shape[d] // self.mesh.size(MODEL_AXIS)
        return t.narrow(d, self.mesh.coords[MODEL_AXIS] * n, n)

    def cut(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor `t` of any sharded leaf."""
        if name not in self.shard_dims:
            return t
        axis, d = self.shard_dims[name]
        n = t.shape[d] // self.mesh.size(axis)
        return t.narrow(d, self.mesh.coords[axis] * n, n)

    def whole(self, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """This rank's `{name: tensor}` -> the whole tensors (a collective
        along each sharded axis: every rank of it calls it)."""
        if not self.shard_dims:
            return params
        out = {}
        for name, p in params.items():
            if name in self.shard_dims:
                axis, d = self.shard_dims[name]
                p = self.mesh.all_gather(p.detach(), axis, d)
            out[name] = p
        return out

    def reduce(self, grads: dict[str, torch.Tensor], op: str,
               metrics: dict[str, torch.Tensor] | None = None):
        """-> (this rank's slice of the gradients reduced over `data` by
        `op`, the metrics reduced with them). One all-reduce of one flat
        buffer carries both."""
        metrics = dict(metrics or {})
        names, keys = list(grads), list(metrics)
        if self.mesh.size(DATA_AXIS) > 1:
            ref = grads[names[0]]
            flat = torch.cat([grads[k].reshape(-1) for k in names]
                             + [metrics[k].to(ref).reshape(1) for k in keys])
            self._timed_reduce(flat, DATA_AXIS, op, self.records)
            grads = _unflatten(flat, grads)
            i = sum(g.numel() for g in grads.values())
            metrics = {k: flat[i + j] for j, k in enumerate(keys)}
        if self.seq_partial:
            flat = torch.cat([grads[k].reshape(-1) for k in names])
            self._timed_reduce(flat, SEQ_AXIS, "sum", self.seq_records)
            grads = _unflatten(flat, grads)
        return {k: self.local(k, g) for k, g in grads.items()}, metrics

    def norm(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole reduced gradient from this rank's
        slices: each sharded leaf's squares are summed across its axis."""
        if not self.shard_dims:
            return common.global_norm(grads.values())
        sq = lambda names: sum((torch.sum(torch.square(grads[k])) for k in names),
                               torch.zeros((), device=self.mesh.device))
        total = sq([k for k in grads if k not in self.shard_dims])
        for axis in (PIPE_AXIS, EXPERT_AXIS, MODEL_AXIS):
            names = [k for k, (a, _) in self.shard_dims.items() if a == axis and k in grads]
            if names:
                part = sq(names).to(torch.float32).reshape(1)
                self.mesh.all_reduce(part, axis)
                total = total + part[0]
        return torch.sqrt(total)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Per-row outputs `[B_local]` -> the global `[B]`, rank-major."""
        return self.mesh.all_gather(t, DATA_AXIS, 0)


def is_line_lead(mesh: RankMesh) -> bool:
    """Whether this rank is coordinate 0 on every seq, pipe and expert
    axis: the rank whose rows its line learns on under `lead_rows`."""
    return all(mesh.coords.get(a, 0) == 0 for a in _LINE_AXES)


def _unflatten(flat: torch.Tensor, like: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    out, i = {}, 0
    for k, g in like.items():
        out[k] = flat[i:i + g.numel()].view_as(g)
        i += g.numel()
    return out


def _state_dicts(state) -> list[str]:
    """The `{name: tensor}` fields of a train state (parameters, target,
    moments)."""
    return [f.name for f in dataclasses.fields(state) if isinstance(getattr(state, f.name), dict)]


class ShardedLearner:
    """Bind an agent's learn step to a mesh.

    `num_data_args`: learn arguments after the state with a leading
    batch dimension (IMPALA 1: the batch; Ape-X, R2D2 2: the batch and
    the IS weights). `num_aux_outputs`: outputs after the new state (the
    metrics, and for the replay families the per-row vector, which the
    seam gathers to the global batch). `learn` takes this rank's rows,
    placed or on the host. The split step exists for the replay arity of
    an agent that splits its own (Ape-X), as in JAX: `grads(state,
    batch, is_weight)` -> (this rank's slices of the gradient averaged
    over `data`, the global `[B]` |TD|, the averaged loss), and
    `apply_grads(state, grads, loss)` -> (state, metrics), the update
    of those slices (the learner tier's mesh seat runs its exchange in
    between). `learn_many` (`[K, B_local, ...]` stacks) and
    `stacked_data_sharding` exist for the IMPALA arity. A transformer
    agent built over the same mesh (`mesh=`) runs its sequence, pipeline
    and expert axes; an MoE transformer routes the union batch over the
    data split (`ops/moe.py`). Over a seq, pipe or expert axis the ranks
    of one data coordinate (a line) learn on the same rows, as JAX's
    global batch is replicated along those axes: the caller hands every
    rank of a line the same rows (`shard_batch` of one union batch does).
    With `lead_rows` (a runner whose ranks each sample their own data
    plane, `runner_learner`) `learn` and `learn_many` instead take the
    rows of the line's lead (`is_line_lead`), broadcast along the axes."""

    def __init__(self, agent, mesh: RankMesh, num_data_args: int = 1,
                 num_aux_outputs: int = 1, lead_rows: bool = False):
        if num_data_args not in (1, 2) or num_aux_outputs != num_data_args:
            raise ValueError(f"learn arity ({num_data_args}, {num_aux_outputs}): IMPALA's "
                             "(1, 1) or the replay families' (2, 2)")
        if getattr(agent, "mesh", None) not in (None, mesh):
            raise ValueError("the agent was built over another mesh than the learner's")
        if (getattr(agent.cfg, "num_experts", 0) and mesh.size(DATA_AXIS) > 1
                and getattr(agent, "mesh", None) is not mesh):
            raise ValueError("an MoE transformer over a data split routes the union batch: "
                             "build the agent with mesh= the learner's mesh")
        self.agent = agent
        self.mesh = mesh
        self.num_data_args = num_data_args
        self._line_axes = ([a for a in _LINE_AXES if mesh.size(a) > 1] if lead_rows else [])
        self.state_sharding = train_state_sharding(mesh, agent.model.state_dict())
        self.reducer = MeshReducer(mesh, self.state_sharding,
                                   seq_partial=getattr(agent, "seq_sharded", False))
        self._data_sh = mesh_lib.data_sharding(mesh)
        self._repl = mesh_lib.replicated(mesh)
        if num_data_args == 2 and hasattr(agent, "grads") and hasattr(agent, "apply_grads"):
            self.grads = functools.partial(agent.grads, reducer=self.reducer)
            self.apply_grads = functools.partial(agent.apply_grads, reducer=self.reducer)
        if num_data_args == 1:
            self.stacked_data_sharding = Placement(mesh, (None, DATA_AXIS))
            self.learn_many = self._learn_many

    def learn(self, state, *data):
        """One step of the agent over this rank's rows -> the agent's
        outputs (the state in place, then metrics; for the replay
        families the global `[B]` per-row vector before them)."""
        return self.agent.learn(state, *self._same_rows(data), reducer=self.reducer)

    def _learn_many(self, state, batches):
        """K steps over a `[K, B_local, ...]` stack -> (state, metrics
        stacked `[K]`)."""
        learn = functools.partial(self.agent.learn, reducer=self.reducer)
        (batches,) = self._same_rows((batches,))
        return common.learn_many_unweighted(learn, state, batches, self.agent.device)

    def _same_rows(self, data: tuple) -> tuple:
        """Under `lead_rows`, `data` as the lead of this rank's seq, pipe
        and expert line holds it; else `data`."""
        if not self._line_axes:
            return data
        dev = self.agent.device

        def bcast(x):
            t = torch.as_tensor(x).to(dev)
            wire = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous().clone()
            for axis in self._line_axes:
                self.mesh.broadcast_axis(wire, axis)
            return wire.to(torch.bool) if t.dtype == torch.bool else wire

        return mesh_lib.map_leaves(bcast, data)

    # -- state ------------------------------------------------------------
    def init_state(self, seed: int = 0, params: dict | None = None):
        """The agent's fresh state (or one over `params`, a converted JAX
        checkpoint, through `state_from_params`), made on every rank and
        overwritten by rank 0's, then placed: every rank starts equal."""
        agent = self.agent
        state = agent.init_state(seed) if params is None else agent.state_from_params(params)
        tensors = [t for f in _state_dicts(state) for t in getattr(state, f).values()]
        with torch.no_grad():
            flat = self.mesh.broadcast(torch.cat([t.detach().reshape(-1) for t in tensors]))
            i = 0
            for t in tensors:
                t.copy_(flat[i:i + t.numel()].view_as(t))
                i += t.numel()
        return self.place_state(state)

    def place_state(self, state):
        """A whole state (fresh, converted or restored) -> this rank's:
        each sharded leaf cut to its slice. Unchanged without a sharded
        leaf."""
        if not self.reducer.shard_dims:
            return state
        cut = {}
        for f in _state_dicts(state):
            # A clone, not a view: the whole tensor's storage is let go.
            # The parameters require grad whatever `state` held (a whole
            # state gathered for a checkpoint holds detached tensors).
            cut[f] = {k: self.reducer.cut(k, v.detach()).clone(
                memory_format=torch.contiguous_format).requires_grad_(
                    v.requires_grad or f == "params")
                for k, v in getattr(state, f).items()}
        return dataclasses.replace(state, **cut)

    def gather_params(self, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """This rank's `{name: tensor}` (parameters, or any dict with
        their names) -> the whole tensors, detached; a collective along
        each sharded axis (every rank of it calls it). Without a sharded
        leaf, `params` itself."""
        if not self.reducer.shard_dims:
            return params
        return self.reducer.whole({k: v.detach() for k, v in params.items()})

    def gather_state(self, state):
        """This rank's state -> the whole state (a collective: every rank
        of each sharded axis calls it)."""
        if not self.reducer.shard_dims:
            return state
        whole = {f: self.reducer.whole({k: v.detach() for k, v in getattr(state, f).items()})
                 for f in _state_dicts(state)}
        return dataclasses.replace(state, **whole)

    @staticmethod
    def state_bytes(state) -> int:
        """Bytes of the tensors a rank holds for `state`."""
        return sum(t.numel() * t.element_size() for f in _state_dicts(state)
                   for t in getattr(state, f).values())

    def shard_batch(self, tree):
        """A global host batch (or a tuple such as `(batch, is_weight)`)
        -> this rank's rows on its device: the leading dimension split
        over `data`."""
        d, i = self.mesh.size(DATA_AXIS), self.mesh.coords[DATA_AXIS]

        def rows(x):
            n = np.shape(x)[0]
            if n % d:
                raise ValueError(f"batch of {n} rows not divisible by the data axis ({d})")
            return x[i * (n // d):(i + 1) * (n // d)]

        return mesh_lib.place_local_batch(mesh_lib.map_leaves(rows, tree), self._data_sh)


def runner_learner(agent, mesh: RankMesh, num_data_args: int) -> ShardedLearner:
    """The sharded learner a runner (`runtime/*_runner.py`) trains
    through. Over a model, pipe or expert axis a rank holds slices, and
    the runner publishes and checkpoints the whole tensors
    (`gather_params`, `gather_state`) and restores a whole checkpoint to
    its slices (`place_state`): these are collectives along the sharded
    axes, so every rank publishes, saves and restores at the same steps,
    as the train steps' own cadence has it. Each rank samples its own
    data plane, so over a seq, pipe or expert axis a line learns on its
    lead's rows (`lead_rows`), and only the lead writes priorities back
    (`runtime/replay_train.ReplayTrainMixin._own_rows`)."""
    return ShardedLearner(agent, mesh, num_data_args=num_data_args,
                          num_aux_outputs=num_data_args, lead_rows=True)
