"""Train-call bookkeeping shared by the prioritized-replay learners.

Counterpart of the part of the JAX package's `runtime/replay_train.py`
that a monolithic single-device replay uses: `ReplayTrainMixin` holds
the replay the train path samples (`_active_replay`), the guard around
one train call (`_train_guarded`), the steps-since-last cadences of
target sync and publication (`_finish_train_call`) and their checkpoint
round trip with the sampling stream's state (`_cadence_extra` /
`_restore_cadence`; without it a restore would see
`_last_target_sync = 0` and overwrite the restored target net early).
`ApexLearner` and `R2D2Learner` use it.

Not ported: the sharded replay service and its demotion (ROADMAP item
9), the fused device sample path (item 14) and K-update strides
(`updates_per_call > 1`, `prioritized_train_call`, item 9); `_init_stride`
raises for the last.
"""

from __future__ import annotations

import numpy as np


class ReplayTrainMixin:
    """Host-class contract: `agent`, `state`, `replay`, `_np_rng`,
    `target_sync_interval`, `train_steps`, `_train_once(replay)` and
    `PublishCadenceMixin`."""

    def _init_stride(self, updates_per_call: int = 1) -> None:
        if int(updates_per_call) != 1:
            raise ValueError("updates_per_call > 1 (several prioritized updates a call) "
                             "is not ported (ROADMAP item 9)")
        self.updates_per_call = 1
        self._last_target_sync = 0

    def _active_replay(self):
        """The replay the train path samples and re-prioritises: the
        monolithic backend (the port has no sharded service)."""
        return self.replay

    def _train_guarded(self, replay) -> dict | None:
        """`_train_once(replay)`. The JAX package turns a sharded
        service's empty or dead signal into None here; with the
        monolithic replay every error propagates."""
        return self._train_once(replay)

    def _finish_train_call(self) -> None:
        """Advance the step count; publish and sync the target on
        steps-since-last cadences."""
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
