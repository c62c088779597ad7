"""Publish cadence, async publication and per-step metric logging shared
by the learners.

Counterpart of the JAX package's `runtime/publishing.py`. The host class
provides `agent`, `weights`, `state`, `train_steps`, `publish_interval`,
`logger` and `timer`.

- Publication is asynchronous by default (`WeightStore.publish_async`:
  a device clone on the learn thread, the host copy and encode on the
  store's worker); `DRL_ASYNC_PUBLISH=0` restores the synchronous path.
  The single-process `run_sync` loops set `sync_publish = True`, which
  flips the unset default to synchronous, as the JAX `run_sync` does.
- Per-step metrics: synchronous `float()` (the step's device sync) or,
  with async metrics, a bounded `MetricsPump` that floats and logs them
  on a worker. `DRL_ASYNC_METRICS` overrides; unset follows the publish
  gate and stays off on the CPU, where a worker thread competes with the
  compute it would not block.
"""

from __future__ import annotations

import os
import queue as _queue
import sys
import threading
import time

from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS


def _async_publish(sync_default: bool) -> bool:
    """DRL_ASYNC_PUBLISH set wins; unset = async unless `sync_default`."""
    env = os.environ.get("DRL_ASYNC_PUBLISH")
    if env is not None:
        return env.strip().lower() not in ("0", "false", "no", "off", "")
    return not sync_default


def _async_metrics(sync_default: bool, device) -> bool:
    """DRL_ASYNC_METRICS set wins; unset follows the publish gate, and is
    off when the learner computes on the CPU."""
    env = os.environ.get("DRL_ASYNC_METRICS")
    if env is not None:
        return env.strip().lower() not in ("0", "false", "no", "off", "")
    return device.type != "cpu" and _async_publish(sync_default)


class MetricsPump:
    """Background metrics materialization for free-running learners: the
    learn thread hands over device tensors; a worker floats and logs them.
    At most 4 batches pending: past that `submit` blocks, which also caps
    how far the host loop can run ahead of the device."""

    # Only the learn thread touches `_thread` and `_logger`; the
    # internally synchronised `_q` is the one cross-thread channel.
    _GUARDED_BY: dict = {}

    def __init__(self, logger):
        self._logger = logger
        self._q: _queue.Queue = _queue.Queue(maxsize=4)
        self._thread: threading.Thread | None = None

    def submit(self, metrics: dict, step: int) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="metrics-pump")
            self._thread.start()
        self._q.put((metrics, step))

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            metrics, step = item
            try:
                floats = {k: float(v) for k, v in metrics.items()}
                self._logger.add_scalars({f"learner/{k}": v for k, v in floats.items()}, step)
            except Exception as e:  # noqa: BLE001 — logging must not kill training
                print(f"[metrics] WARNING: drop step {step}: {e!r}", file=sys.stderr)

    def close(self) -> None:
        if self._thread is not None:
            try:
                self._q.put(None, timeout=10.0)
            except _queue.Full:
                pass
            self._thread.join(timeout=10.0)
            self._thread = None


class PublishCadenceMixin:
    # Single-threaded run_sync loops set this True: there async
    # publication buys nothing and only makes weight staleness depend on
    # thread timing.
    sync_publish = False
    _metrics_pump = None
    # Step count at the last publish. Cadence is "at least every
    # `publish_interval` steps since the last publish", not a modulo on
    # train_steps.
    _last_publish_step = 0

    def maybe_publish(self) -> bool:
        """Publish once `publish_interval` steps accumulate since the last;
        -> whether it published."""
        if self.train_steps - self._last_publish_step < self.publish_interval:
            return False
        self._last_publish_step = self.train_steps
        t0 = time.perf_counter()
        with self.timer.stage("publish"):
            if _async_publish(self.sync_publish):
                self.weights.publish_async(self.state.params, self.train_steps)
                # Bounded staleness: actors must never act on weights more
                # than ~3 publish intervals old; if the worker lags past
                # that, wait for it here (the common case never blocks).
                if self.train_steps - self.weights.version > 3 * self.publish_interval:
                    with self.timer.stage("publish_stall"):
                        ok = self.weights.flush_async(timeout=10.0)
                    if not ok:
                        print(f"[publish] WARNING: async weight publication stalled; "
                              f"actors hold version {self.weights.version} at step "
                              f"{self.train_steps}", file=sys.stderr)
            else:
                self.weights.publish(self.state.params, self.train_steps)
        if _OBS.enabled:
            _OBS.gauge("publish/latency_ms", (time.perf_counter() - t0) * 1e3)
            _OBS.count("publish/count")
        return True

    def log_step_metrics(self, metrics: dict) -> dict:
        """Per-step metrics to the logger: through the MetricsPump (device
        tensors returned as they are) under async metrics, else as host
        floats (the step's device sync)."""
        if _async_metrics(self.sync_publish, self.agent.device):
            if self._metrics_pump is None:
                self._metrics_pump = MetricsPump(self.logger)
            with self.timer.stage("metrics_sync"):
                self._metrics_pump.submit(dict(metrics), self.train_steps)
            return metrics
        with self.timer.stage("metrics_sync"):
            metrics = {k: float(v) for k, v in metrics.items()}
        self.logger.add_scalars({f"learner/{k}": v for k, v in metrics.items()},
                                self.train_steps)
        return metrics

    def close_metrics(self) -> None:
        """Drain pending pump lines at close() (safe when unused)."""
        if self._metrics_pump is not None:
            self._metrics_pump.close()

    def flush_publish(self) -> None:
        """close()-time flush: updates since the last publish would
        otherwise never reach the store; then retire the async worker."""
        if self.train_steps > self._last_publish_step:
            self.weights.publish(self.state.params, self.train_steps)
            self._last_publish_step = self.train_steps
        if _async_publish(self.sync_publish):
            self.weights.close()
