"""The single-device part of the replay families' mesh plumbing.

Counterpart of the JAX package's `runtime/anakin_mesh.py` where `mesh` is
None: one device holds the envs, the ring and the learner, the local
batch is the batch, the local env count is the env count, and the
metric reducers are the identity. The multi-device part (per-device ring
shards over a data axis, a gradient mean across devices, the IS weights
normalised by the global batch max) needs the Anakin mesh of ROADMAP item 13b-ii:
a `mesh` argument is refused by name (`anakin.refuse_mesh`).
"""

from __future__ import annotations

import torch

from distributed_reinforcement_learning_tpu_torch.data import device_replay
from distributed_reinforcement_learning_tpu_torch.runtime.anakin import refuse_mesh, stack_metrics


def validate_data_mesh(mesh) -> int:
    """The data-axis size of a replay family's mesh: 1 without one (every
    size divides over one device)."""
    refuse_mesh(mesh)
    return 1


class DataMeshReplayMixin:
    """What the replay loops (`AnakinApex`, `AnakinR2D2`) share: the
    constructor's plumbing (the local sizes equal the global ones, the
    metric reducers pass their values through), the epsilon schedule, the
    K prioritized learns of an update with the target sync, and the chunk
    loops. The host class provides `agent`, `epsilon_decay`,
    `epsilon_floor`, `updates_per_collect`, `target_sync_interval` and
    `_collect_and_ingest(state) -> episode stats`."""

    def _setup_mesh(self, mesh, *, batch_size: int) -> None:
        self.dshard = validate_data_mesh(mesh)
        self.batch_local = batch_size // self.dshard

    def _psum(self, tree):
        return tree

    def _pmean(self, x):
        return x

    def _epsilon(self, episodes: torch.Tensor) -> torch.Tensor:
        """The reference's per-episode decay `1 / (decay * episodes + 1)`,
        floored."""
        return torch.clamp(1.0 / (self.epsilon_decay * episodes + 1.0), min=self.epsilon_floor)

    def _learn(self, state, uniforms: torch.Tensor | None = None) -> dict:
        """One prioritized learn from the ring: sample (from `uniforms
        [batch]`, default drawn), step, write the fresh priorities back."""
        if uniforms is None:
            uniforms = torch.rand(self.batch_local, generator=state.generator,
                                  device=state.generator.device)
        batch, idx, weights = device_replay.sample(state.replay, uniforms)
        state.train, errs, metrics = self.agent.learn(state.train, batch, weights)
        device_replay.update_priorities(state.replay, idx, errs)
        return metrics

    def update(self, state) -> dict:
        """One collect and ingest, then K prioritized learns and the target
        sync on a steps-since-last cadence (a modulo misfires when K does
        not divide the interval) -> the last learn's metrics, the collect's
        episode stats, `replay_size` and `epsilon_mean`."""
        stats = self._collect_and_ingest(state)
        for _ in range(self.updates_per_collect):
            metrics = self._learn(state)
        if state.train.step - state.last_sync >= self.target_sync_interval:
            state.train.sync_target()
            state.last_sync = state.train.step
        metrics.update(self._psum(stats))
        metrics["replay_size"] = float(self._psum(state.replay.size))
        metrics["epsilon_mean"] = self._pmean(self._epsilon(state.episodes).mean())
        return metrics

    def train_chunk(self, state, num_updates: int):
        """`num_updates` x (collect + K learns) -> (state, metrics stacked
        `[U]` on the device); the state advances in place."""
        metrics = [self.update(state) for _ in range(num_updates)]
        return state, stack_metrics(metrics, state.replay.priorities.device)

    def collect_chunk(self, state, num_collects: int):
        """Warm-up: fill the ring without training -> (state, episode stats
        stacked `[num_collects]`)."""
        stats = [self._psum(self._collect_and_ingest(state)) for _ in range(num_collects)]
        return state, stack_metrics(stats, state.replay.priorities.device)
