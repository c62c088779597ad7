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
- `prioritized_train_call`: K > 1 prioritized updates in one call.
  K batches are sampled up front, run as one `learn_many`, and their K
  priority rows come back in one device-to-host copy. Relative to K
  single calls the only difference is priority staleness: batches
  2..K are drawn under priorities that predate updates 1..K-1.

`ApexLearner` and `R2D2Learner` use it. Not ported: the fused device
sample path (`device_train_call`, `DeviceSamplePath`), which `run_role`
refuses by name.
"""

from __future__ import annotations

import numpy as np

from distributed_reinforcement_learning_tpu_torch.data.device_path import gather_scan_batch
from distributed_reinforcement_learning_tpu_torch.data.fifo import tree_map
from distributed_reinforcement_learning_tpu_torch.data.replay_service import ReplayServiceEmpty


class ReplayTrainMixin:
    """Host-class contract: `agent`, `state`, `timer`, `replay`,
    `replay_service`, `batch_size`, `_np_rng`, `target_sync_interval`,
    `train_steps`, `_train_once(replay)` and `PublishCadenceMixin`."""

    def _init_stride(self, updates_per_call: int = 1) -> None:
        self.updates_per_call = max(1, int(updates_per_call))
        if self.updates_per_call > self.target_sync_interval:
            # Every update of one call trains against a frozen target
            # net: a K that swallows whole sync intervals would silently
            # change the dynamics.
            raise ValueError(
                f"updates_per_call ({self.updates_per_call}) must not exceed "
                f"target_sync_interval ({self.target_sync_interval}): one call "
                "cannot sync the target mid-call")
        self._last_target_sync = 0

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

    def _finish_train_call(self) -> None:
        """Advance the step count by the call's K steps; publish and sync
        the target on steps-since-last cadences."""
        self.train_steps += self.updates_per_call
        self.maybe_publish()
        if self.train_steps - self._last_target_sync >= self.target_sync_interval:
            self._last_target_sync = self.train_steps
            self.state = self.agent.sync_target(self.state)

    def _cadence_extra(self) -> dict:
        """Checkpoint fields for the cadence counters and the sampling
        stream (`_np_rng`), so that a restored learner samples as the
        saved one would have."""
        name, keys, pos, has_gauss, gauss = self._np_rng.get_state()
        return {"last_target_sync": self._last_target_sync,
                "np_rng": [name, keys.tolist(), int(pos), int(has_gauss), float(gauss)]}

    def _restore_cadence(self, extra: dict) -> None:
        """Resume the cadences and the sampling stream; an absent cadence
        falls back to `train_steps` (the next sync and publish a full
        interval away, never early)."""
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
