"""Train-call bookkeeping shared by the prioritized-replay learners.

Counterpart of the JAX package's `runtime/replay_train.py`:

- `ReplayTrainMixin` holds the replay the train path samples
  (`_active_replay`: the sharded service of `data/replay_service.py`
  while it is healthy, else the monolithic backend), the guard around
  one train call (`_train_guarded`: the service's empty or dead signal
  becomes a skipped call, after which the next call takes the
  monolithic path), the K clamp (`_init_stride`), the steps-since-last
  cadences of target sync and publication (`_finish_train_call`; a
  modulo goes off-grid under stride-K counters) and their checkpoint
  round trip with the sampling stream's state (`_cadence_extra` /
  `_restore_cadence`; without it a restore would see
  `_last_target_sync = 0` and overwrite the restored target net early).
  Both first close a live device path, which hands the stream back to
  the learn thread rewound past the calls it sampled ahead; the next
  train call builds a new path from there.
- `prioritized_train_call`: K > 1 prioritized updates in one call.
  K batches are sampled up front, run as one `learn_many`, and their K
  priority rows come back in one device-to-host copy. Relative to K
  single calls the only difference is priority staleness: batches
  2..K are drawn under priorities that predate updates 1..K-1.
- The fused device sample path (`data/device_path.py`, opt-in by
  `DRL_DEVICE_PATH` or `device_path_force`): `_device_path_for` builds a
  `DeviceSamplePath` over the healthy sharded service on the first gated
  train call and demotes PERMANENTLY (one log line) when the path
  latches dead or the service demotes; `device_train_call` is its train
  call: K > 1 through `learn_many`, K = 1 through the agent's one-step
  `learn`, on a batch already on the device, and one device-to-host
  copy of the `[K, B]` priorities.

`ApexLearner` and `R2D2Learner` use it.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np

from distributed_reinforcement_learning_tpu_torch.data.device_path import gather_scan_batch
from distributed_reinforcement_learning_tpu_torch.data.fifo import tree_map
from distributed_reinforcement_learning_tpu_torch.data.replay_service import ReplayServiceEmpty
from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS
from distributed_reinforcement_learning_tpu_torch.parallel.mesh import DATA_AXIS, place_local_batch


class ReplayTrainMixin:
    """Host-class contract: `agent`, `state`, `timer`, `replay`,
    `replay_service`, `batch_size`, `_np_rng`, `target_sync_interval`,
    `train_steps`, `_train_once(replay)` and `PublishCadenceMixin`."""

    def _init_stride(self, updates_per_call: int = 1, mesh=None) -> None:
        self.updates_per_call = max(1, int(updates_per_call))
        if self.updates_per_call > 1 and mesh is not None:
            raise ValueError(
                "updates_per_call > 1 is not supported with a sharded mesh "
                "(the weighted learn_many runs one rank alone)")
        if self.updates_per_call > self.target_sync_interval:
            # Every update of one call trains against a frozen target
            # net: a K that swallows whole sync intervals would silently
            # change the dynamics.
            raise ValueError(
                f"updates_per_call ({self.updates_per_call}) must not exceed "
                f"target_sync_interval ({self.target_sync_interval}): one call "
                "cannot sync the target mid-call")
        self._last_target_sync = 0
        # The fused device sample path, built on the first gated train
        # call. `device_path_force` overrides the DRL_DEVICE_PATH gate
        # (None: resolve the gate).
        self._device_path = None
        self._device_path_demoted = False
        self.device_path_force: bool | None = None

    def _init_mesh(self, mesh, init_seed: int):
        """The initial train state, and over `mesh` the sharded learner:
        this learner is then one rank of it (its samples are its own
        rows, the learn step averages across the ranks, every rank starts
        from rank 0's parameters, and the global priorities come back,
        of which it writes back its own rows)."""
        self._sharded = self._batch_sharding = self._whole = None
        if mesh is None:
            return self.agent.sync_target(self.agent.init_state(init_seed))
        from distributed_reinforcement_learning_tpu_torch.parallel.learner import runner_learner
        from distributed_reinforcement_learning_tpu_torch.parallel.mesh import data_sharding

        self._sharded = runner_learner(self.agent, mesh, 2)
        self._batch_sharding = data_sharding(mesh)
        state = self.agent.sync_target(self._sharded.init_state(init_seed))
        self._refresh_whole(state)
        return state

    def _refresh_whole(self, state) -> None:
        """Over a model, pipe or expert axis, gather the whole parameters
        and target that ingest scores new data under (`_scoring_state`):
        a collective along those axes, run where the ranks are in step (construction,
        each train call, a restore), since each rank ingests at its own
        pace."""
        sharded = self._sharded
        if sharded is None or not sharded.reducer.shard_dims:
            self._whole = None
            return
        self._whole = dataclasses.replace(
            state, params=sharded.gather_params(state.params),
            target_params=sharded.gather_params(state.target_params))

    def _scoring_state(self):
        """The train state ingest's `td_error` runs under: the learner's
        own, or over a model axis its whole tensors as of the last train
        call."""
        return self.state if self._whole is None else self._whole

    def _learn(self, state, batch, is_weight):
        """The seam every K = 1 learn step goes through (the agent's
        `learn`, or the sharded learner's over a mesh); the learner tier
        rebinds it on the instance
        (`runtime/learner_tier.LearnerTier.attach`)."""
        if self._sharded is not None:
            batch, is_weight = place_local_batch((batch, is_weight), self._batch_sharding)
            return self._sharded.learn(state, batch, is_weight)
        return self.agent.learn(state, batch, is_weight)

    def _own_rows(self, priorities):
        """This learner's rows of a step's per-row outputs, or None: over a
        mesh the global `[B]` is rank-major, and its samples are rows
        `data_index * B_local` on (the JAX learner writes the first
        `B_local` back on every process, ROADMAP F15). A rank that is not
        its seq, pipe or expert line's lead learned on the lead's rows,
        not on the ones it sampled: it has none to write back (None)."""
        if self._sharded is None:
            return priorities
        from distributed_reinforcement_learning_tpu_torch.parallel.learner import is_line_lead

        mesh = self._sharded.mesh
        if not is_line_lead(mesh):
            return None
        i = mesh.coords[DATA_AXIS]
        return priorities[i * self.batch_size:(i + 1) * self.batch_size]

    def _write_back(self, replay, idxs, priorities) -> None:
        """Re-prioritise the sampled `idxs` with this learner's rows of a
        step's per-row outputs (`_own_rows`), where it has any. A
        deliberate sync: re-prioritisation targets the host sum tree (the
        service only enqueues; its router thread applies it)."""
        rows = self._own_rows(priorities)
        if rows is not None:
            replay.update_batch(idxs, rows.cpu().numpy())

    def _active_replay(self):
        """The replay the train path samples and re-prioritises: the
        sharded service while it is healthy, the monolithic backend
        otherwise (the demotion target)."""
        svc = self.replay_service
        return svc if svc is not None and svc.healthy else self.replay

    def _train_guarded(self, replay) -> dict | None:
        """`_train_once(replay)`, with the service's empty or dead signal
        turned into None (the next call resolves to the monolithic path,
        or waits for re-ingest after a revive emptied the shards); any
        other error, and every error of the monolithic replay,
        propagates."""
        try:
            return self._train_once(replay)
        except ReplayServiceEmpty:
            if replay is self.replay:
                raise
            return None
        except RuntimeError:
            svc = self.replay_service
            if replay is self.replay or (svc is not None and svc.healthy):
                raise
            return None

    def _device_path_for(self, replay):
        """The device path for THIS train call, or None (the host loop).
        Needs the resolved active replay to be the healthy sharded
        service: its per-shard locks make the background gather safe,
        where the monolithic backends are learn-thread-only (a demotion
        closes the path BEFORE the host loop takes the sampling RNG
        back)."""
        if self._device_path_demoted:
            return None
        dp = self._device_path
        svc = self.replay_service
        if svc is None or replay is not svc:
            if dp is not None:
                self._demote_device_path("replay service demoted to the monolithic backend")
            return None
        if dp is None:
            from distributed_reinforcement_learning_tpu_torch.data.device_path import (
                DeviceSamplePath, device_path_enabled)

            force = self.device_path_force
            # A mesh learner stays on the host path, as the JAX learner.
            if (not (device_path_enabled() if force is None else bool(force))
                    or self._batch_sharding is not None):
                self._device_path_demoted = True  # the gate is resolved once
                return None
            self._device_path = dp = DeviceSamplePath(
                svc, self.batch_size, self.updates_per_call, self._np_rng,
                device=self.agent.device)
        elif dp.k != self.updates_per_call:
            dp.reconfigure(self.updates_per_call)
        if dp.dead:
            self._demote_device_path(dp.dead_reason or "gather died")
            return None
        return dp

    def _demote_device_path(self, reason: str) -> None:
        """Permanent demotion to the host path, after `_close_device_path`."""
        self._device_path_demoted = True
        self._close_device_path()
        print(f"[device_path] WARNING: fused sample path demoted to the host loop: "
              f"{reason}", file=sys.stderr)

    def _close_device_path(self) -> None:
        """Close a live device path: close() JOINS the gather thread and
        rewinds `_np_rng` past the calls it sampled ahead, so the stream is
        the learn thread's alone again before it samples or is read. If
        the join times out (a wedged gather round), the shared stream is
        left to that thread and the learner goes on with a fresh one:
        RandomState is not thread-safe. A gated train call builds a new
        path unless the path was demoted."""
        dp, self._device_path = self._device_path, None
        if dp is not None and not dp.close():
            self._np_rng = np.random.RandomState()
            print("[device_path] WARNING: gather thread did not join; the learner "
                  "continues on a fresh sampling stream", file=sys.stderr)

    def _finish_train_call(self) -> None:
        """Advance the step count by the call's K steps; publish and sync
        the target on steps-since-last cadences."""
        self.train_steps += self.updates_per_call
        self.maybe_publish()
        if self.train_steps - self._last_target_sync >= self.target_sync_interval:
            self._last_target_sync = self.train_steps
            self.state = self.agent.sync_target(self.state)
        if self._whole is not None:
            self._refresh_whole(self.state)

    def _cadence_extra(self) -> dict:
        """Checkpoint fields for the cadence counters and the sampling
        stream (`_np_rng`), so that a restored learner samples as the
        saved one would have. A live device path is closed first."""
        self._close_device_path()
        name, keys, pos, has_gauss, gauss = self._np_rng.get_state()
        return {"last_target_sync": self._last_target_sync,
                "np_rng": [name, keys.tolist(), int(pos), int(has_gauss), float(gauss)]}

    def _restore_cadence(self, extra: dict) -> None:
        """Resume the cadences and the sampling stream; an absent cadence
        falls back to `train_steps` (the next sync and publish a full
        interval away, never early)."""
        self._close_device_path()
        self._last_target_sync = int(extra.get("last_target_sync", self.train_steps))
        self._last_publish_step = self.train_steps  # the restore just republished
        if "np_rng" in extra:
            name, keys, pos, has_gauss, gauss = extra["np_rng"]
            self._np_rng.set_state((name, np.asarray(keys, np.uint32), pos, has_gauss, gauss))


def prioritized_train_call(learner, k: int, replay) -> dict:
    """`k` prioritized updates in one call on `learner`, sampled from and
    written back to `replay` (the caller's already-resolved active
    replay, the object its demotion guard reasons about) -> the last
    step's metrics (device tensors). With the sharded service the
    write-back only enqueues: its router thread applies each batch to
    the owning shard."""
    with learner.timer.stage("replay_sample"):
        stacked, weights, idx_list = gather_scan_batch(
            replay, learner.batch_size, k, learner._np_rng)
    with learner.timer.stage("learn"):
        learner.state, prio_stack, metrics_stack = learner.agent.learn_many(
            learner.state, stacked, weights)
        metrics = tree_map(lambda x: x[-1], metrics_stack)
    with learner.timer.stage("replay_update"):
        prio_stack = prio_stack.cpu().numpy()  # the one device-to-host copy of the K rows
        for idxs, prio in zip(idx_list, prio_stack):
            replay.update_batch(idxs, prio)
    return metrics


def device_train_call(learner, path, replay) -> dict | None:
    """One train call off the device path: the entry's batch and IS
    weights are already on the device (the path's thread sampled, stacked
    and issued the copy while the previous call learned), and
    `next_entry` made this stream wait for the copy. K > 1 runs as one
    `learn_many`, K = 1 through the learner's `_learn` seam; the K rows of
    priorities come back in ONE device-to-host copy and fan out to the
    replay's write-back by sampled batch. -> the last step's metrics, or
    None when the gather is behind (train() skips the call; a dead path
    was already demoted by `_device_path_for`)."""
    with learner.timer.stage("replay_sample"):
        entry = path.next_entry(timeout=1.0)
    if entry is None:
        return None
    k, batch, weights, idx_list = entry
    with learner.timer.stage("learn"):
        if k > 1:
            learner.state, prio_stack, metrics_stack = learner.agent.learn_many(
                learner.state, batch, weights)
            metrics = tree_map(lambda x: x[-1], metrics_stack)
        else:
            learner.state, prio, metrics = learner._learn(learner.state, batch, weights)
            prio_stack = prio[None]
    with learner.timer.stage("replay_update"):
        t0 = time.perf_counter()
        prio_host = prio_stack.cpu().numpy()  # THE one device-to-host copy of the K rows
        if _OBS.enabled:
            _OBS.gauge("devpath/d2h_ms", (time.perf_counter() - t0) * 1e3)
            _OBS.gauge("devpath/scan_k", k)
        for idxs, prio in zip(idx_list, prio_host):
            replay.update_batch(idxs, prio)
    return metrics
