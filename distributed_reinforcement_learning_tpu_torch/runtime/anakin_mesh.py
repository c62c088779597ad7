"""The on-device loops over a mesh of ranks (the Anakin mesh).

Counterpart of the JAX package's `runtime/anakin_mesh.py`, over the
port's mesh of ranks (`parallel/mesh.py`: one rank is one process on one
device, every collective explicit). The replay families (`AnakinApex`,
`AnakinR2D2`) shard over the `data` axis with per-rank ring shards: each
rank steps its own envs, ingests into its own shard of the ring and
samples its local batch from it, so only the gradients and a few
scalars cross between ranks:

- the gradient mean of each learn (the agents' `reducer=` seam through
  `parallel/learner.ShardedLearner`, JAX's `pmean`);
- the IS weights' normalising maximum over the global batch
  (`data/device_replay.sample(mesh=)`, JAX's `pmax`);
- the metrics: episode stats and `replay_size` summed, `epsilon_mean`
  averaged (`_psum`, `_pmean`).

Sampling stays stratified within equal shards, as in JAX; each rank
writes the fresh priorities of its own rows back to its own shard
(`_own_rows`). The ring's bookkeeping (write pointer, fill count, beta)
advances the same way on every rank, so a rank's `replay.size` is its
shard's count and the metric `replay_size` is the global one.

Randomness: one generator a rank, seeded from the seed and the rank's
data coordinate (`rank_generator`); coordinate 0 draws the plain loop's
stream, so a world of one is the plain loop. The ranks of one data
coordinate along `model` (Anakin IMPALA only) draw the same stream and
step the same envs.

JAX's `shard_mapped_chunk` has no counterpart: there one program is
mapped over the devices' shards, where here each rank runs the chunk
body on its own shard, so JAX's `batched_specs`, `replay_specs` and
`state_shardings` have none either. What a rank holds: its
`num_envs_local` envs and their per-env leaves, its `capacity_local`
rows of the ring's storage and priorities, and whole on every rank the
train state, the ring's write pointer, fill count and beta, and the
step counters; its generator is its own.
"""

from __future__ import annotations

import torch

from distributed_reinforcement_learning_tpu_torch.data import device_replay
from distributed_reinforcement_learning_tpu_torch.parallel.learner import ShardedLearner
from distributed_reinforcement_learning_tpu_torch.parallel.mesh import DATA_AXIS, RankMesh

# Seed stride between data coordinates: coordinate c draws from
# `seed + c * SEED_STRIDE`, so coordinate 0 draws the plain loop's stream.
SEED_STRIDE = 1 << 32


def stack_metrics(metrics: list[dict], device: torch.device) -> dict[str, torch.Tensor]:
    """A chunk's per-update metric dicts -> one `[U]` tensor each on
    `device` (a host number, as the learning rate, is copied there)."""
    return {k: torch.stack([torch.as_tensor(m[k], device=device) for m in metrics])
            for k in metrics[0]}


def check_rank_mesh(mesh) -> None:
    """Raise a TypeError for a `mesh` that is not the port's mesh of
    ranks (JAX's `jax.sharding.Mesh` has no counterpart here)."""
    if mesh is not None and not isinstance(mesh, RankMesh):
        raise TypeError(f"mesh must be a parallel/mesh.RankMesh (make_mesh), got "
                        f"{type(mesh).__name__}")


def validate_data_mesh(mesh, **divisible_by_data) -> int:
    """Check a replay-family mesh (data axis only) and return its data
    size (1 when mesh is None). `divisible_by_data` entries must split
    evenly over the axis."""
    if mesh is None:
        return 1
    check_rank_mesh(mesh)
    extra = {a: s for a, s in mesh.shape.items() if a != DATA_AXIS and s > 1}
    if extra:
        raise ValueError(
            "the on-device replay families shard over the data axis only "
            f"(per-device replay shards); mesh also has {extra}")
    d = mesh.shape.get(DATA_AXIS, 1)
    for name, val in divisible_by_data.items():
        if val % d != 0:
            raise ValueError(f"{name} ({val}) must divide over the data axis ({d})")
    return d


def data_size(mesh) -> int:
    """The data-axis size of `mesh`, 1 without one."""
    return 1 if mesh is None else mesh.size(DATA_AXIS)


def rank_generator(seed: int, device, mesh=None) -> torch.Generator:
    """This rank's generator on `device`: seeded `seed` at data
    coordinate 0 (and without a mesh), `seed + c * SEED_STRIDE` at
    coordinate c. Ranks that differ only along `model` share it."""
    c = 0 if mesh is None else mesh.coords[DATA_AXIS]
    return torch.Generator(device=device).manual_seed(seed + c * SEED_STRIDE)


def psum(mesh, tree):
    """A dict of scalar tensors (or one tensor) summed over `data` in one
    all-reduce (JAX's `psum`); the identity without a mesh or on a data
    axis of one."""
    if data_size(mesh) == 1:
        return tree
    if not isinstance(tree, dict):
        return mesh.all_reduce(tree.clone(), DATA_AXIS)
    keys = list(tree)
    flat = torch.stack([torch.as_tensor(tree[k], dtype=torch.float32) for k in keys])
    mesh.all_reduce(flat, DATA_AXIS)
    return {k: flat[i] for i, k in enumerate(keys)}


def pmean(mesh, x: torch.Tensor) -> torch.Tensor:
    """`x` averaged over `data` (JAX's `pmean`); the identity without a
    mesh or on a data axis of one."""
    if data_size(mesh) == 1:
        return x
    return mesh.all_reduce(x.clone(), DATA_AXIS, "mean")


class DataMeshReplayMixin:
    """What the replay loops (`AnakinApex`, `AnakinR2D2`) share: the
    mesh plumbing (local sizes, the sharded learner, the metric
    reducers), the epsilon schedule, the K prioritized learns of an
    update with the target sync, and the chunk loops. The host class
    provides `agent`, `epsilon_decay`, `epsilon_floor`,
    `updates_per_collect`, `target_sync_interval` and
    `_collect_and_ingest(state) -> episode stats`, written in the local
    sizes (`num_envs_local`, `capacity_local`)."""

    def _setup_mesh(self, mesh, *, num_envs: int, batch_size: int, capacity: int) -> None:
        self.mesh = mesh
        self.dshard = validate_data_mesh(mesh, num_envs=num_envs, batch_size=batch_size,
                                         capacity=capacity)
        self.num_envs_local = num_envs // self.dshard
        self.batch_local = batch_size // self.dshard
        self.capacity_local = capacity // self.dshard
        self._sharded = None
        if mesh is not None:
            self._sharded = ShardedLearner(self.agent, mesh, num_data_args=2,
                                           num_aux_outputs=2)

    def _init_train(self, seed: int):
        """Parameters from `seed`: over a mesh made on every rank and
        overwritten by rank 0's (`ShardedLearner.init_state`)."""
        if self._sharded is None:
            return self.agent.init_state(seed)
        return self._sharded.init_state(seed)

    def _psum(self, tree):
        return psum(self.mesh, tree)

    def _pmean(self, x):
        return pmean(self.mesh, x)

    def _own_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a learn step's global `[B]` per-row output
        (rank-major over `data`): the rows it sampled."""
        if self.dshard == 1:
            return rows
        c, n = self.mesh.coords[DATA_AXIS], self.batch_local
        return rows[c * n:(c + 1) * n]

    def _epsilon(self, episodes: torch.Tensor) -> torch.Tensor:
        """The reference's per-episode decay `1 / (decay * episodes + 1)`,
        floored."""
        return torch.clamp(1.0 / (self.epsilon_decay * episodes + 1.0), min=self.epsilon_floor)

    def _learn(self, state, uniforms: torch.Tensor | None = None) -> dict:
        """One prioritized learn from this rank's ring shard: sample its
        `batch_local` rows (from `uniforms [batch_local]`, default drawn)
        with the global IS maximum, step (the gradient averaged over
        `data`), write its own rows' fresh priorities back."""
        if uniforms is None:
            uniforms = torch.rand(self.batch_local, generator=state.generator,
                                  device=state.generator.device)
        batch, idx, weights = device_replay.sample(state.replay, uniforms, self.mesh)
        if self._sharded is None:
            state.train, errs, metrics = self.agent.learn(state.train, batch, weights)
        else:
            state.train, errs, metrics = self._sharded.learn(state.train, batch, weights)
        device_replay.update_priorities(state.replay, idx, self._own_rows(errs))
        return metrics

    def update(self, state) -> dict:
        """One collect and ingest, then K prioritized learns and the target
        sync on a steps-since-last cadence (a modulo misfires when K does
        not divide the interval) -> the last learn's metrics, the collect's
        episode stats and `replay_size` summed over `data`, and
        `epsilon_mean` averaged."""
        stats = self._collect_and_ingest(state)
        for _ in range(self.updates_per_collect):
            metrics = self._learn(state)
        if state.train.step - state.last_sync >= self.target_sync_interval:
            state.train.sync_target()
            state.last_sync = state.train.step
        size = (float(state.replay.size) if self.dshard == 1 else
                torch.tensor(float(state.replay.size), device=state.replay.priorities.device))
        metrics.update(self._psum({**stats, "replay_size": size}))
        metrics["epsilon_mean"] = self._pmean(self._epsilon(state.episodes).mean())
        return metrics

    def train_chunk(self, state, num_updates: int):
        """`num_updates` x (collect + K learns) -> (state, metrics stacked
        `[U]` on the device); the state advances in place."""
        metrics = [self.update(state) for _ in range(num_updates)]
        return state, stack_metrics(metrics, state.replay.priorities.device)

    def collect_chunk(self, state, num_collects: int):
        """Warm-up: fill the ring without training -> (state, episode stats
        summed over `data`, stacked `[num_collects]`)."""
        stats = [self._psum(self._collect_and_ingest(state)) for _ in range(num_collects)]
        return state, stack_metrics(stats, state.replay.priorities.device)
