"""Profiling: per-stage learner timing and device-trace capture.

Counterpart of the JAX package's `utils/profiling.py`:

- `StageTimer`: named host-side stages (dequeue / learn / publish / ...)
  accumulated per train step and emitted through the MetricsLogger as
  `profile/<stage>_ms` means every `log_every` steps, and as
  `stage/<name>_ms` gauges and trace spans when the run-wide telemetry
  is on. It also keeps the means over the whole run (`run_means_ms`),
  which the multi-process learner prints when it finishes.
- `ProfilerSession`: a `torch.profiler` trace (host and, on CUDA, device
  activity) over a window of train steps, written as a Chrome trace.
  Enabled by the JAX package's variables:
      DRL_PROFILE_DIR=/tmp/trace DRL_PROFILE_START=50 DRL_PROFILE_STEPS=5
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Iterator

from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS
from distributed_reinforcement_learning_tpu_torch.utils.logger import MetricsLogger


class StageTimer:
    """Accumulates wall-clock per named stage; logs means periodically.

        with timer.stage("dequeue"): batch = queue.get_batch(...)
        with timer.stage("learn"):   state, m = agent.learn(...)
        timer.step_done(train_steps)

    A stage's time is host time: without a synchronise inside it, a
    CUDA stage measures what the host spends enqueueing.
    """

    def __init__(self, logger: MetricsLogger | None = None, prefix: str = "profile/",
                 log_every: int = 100):
        self.logger = logger
        self.prefix = prefix
        self.log_every = log_every
        self._sums: dict[str, float] = {}
        self._counts: dict[str, int] = {}
        self._run_sums: dict[str, float] = {}
        self._run_counts: dict[str, int] = {}
        self._steps = 0
        self.last_means_ms: dict[str, float] = {}

    def reset(self) -> None:
        """Drop accumulated sums (e.g. to exclude a warm-up step)."""
        for d in (self._sums, self._counts, self._run_sums, self._run_counts):
            d.clear()
        self._steps = 0

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        trace = _OBS.trace
        wall = time.time() if trace is not None else 0.0
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            for sums, counts in ((self._sums, self._counts),
                                 (self._run_sums, self._run_counts)):
                sums[name] = sums.get(name, 0.0) + dt
                counts[name] = counts.get(name, 0) + 1
            if trace is not None:
                trace.emit(name, wall, dt)

    def run_means_ms(self) -> dict[str, float]:
        """Mean ms per invocation of each stage since construction (or
        the last `reset`)."""
        return {name: 1e3 * total / self._run_counts[name]
                for name, total in self._run_sums.items()}

    def run_counts(self) -> dict[str, int]:
        """Invocations of each stage since construction (or `reset`)."""
        return dict(self._run_counts)

    def run_totals_ms(self) -> dict[str, float]:
        """Total ms in each stage since construction (or `reset`)."""
        return {name: 1e3 * total for name, total in self._run_sums.items()}

    def step_done(self, step: int) -> None:
        """Mark one train step; every `log_every` steps emit and reset the
        means (per stage invocation, not per train step)."""
        self._steps += 1
        if self._steps < self.log_every:
            return
        self.last_means_ms = {
            name: 1e3 * total / self._counts[name] for name, total in self._sums.items()}
        if self.logger is not None:
            self.logger.add_scalars(
                {f"{self.prefix}{n}_ms": ms for n, ms in self.last_means_ms.items()}, step)
        if _OBS.enabled:
            for name, ms in self.last_means_ms.items():
                _OBS.gauge(f"stage/{name}_ms", ms)
        self._sums.clear()
        self._counts.clear()
        self._steps = 0


class ProfilerSession:
    """Window-triggered `torch.profiler` trace around train steps.

    `on_step(step)` is called once per train step; the trace starts when
    `step` reaches `start_step` and stops `num_steps` later (or at
    `close()`), writing `<out_dir>/trace-<pid>.json`. A no-op unless
    `out_dir` is set, so learners call it unconditionally.
    """

    def __init__(self, out_dir: str | None, start_step: int = 10, num_steps: int = 5):
        self.out_dir = out_dir
        self.start_step = start_step
        self.num_steps = num_steps
        self._prof = None
        self._stop_at = 0
        self._done = out_dir is None

    @classmethod
    def from_env(cls) -> "ProfilerSession":
        """DRL_PROFILE_DIR / DRL_PROFILE_START / DRL_PROFILE_STEPS."""
        return cls(os.environ.get("DRL_PROFILE_DIR") or None,
                   start_step=int(os.environ.get("DRL_PROFILE_START", "10")),
                   num_steps=int(os.environ.get("DRL_PROFILE_STEPS", "5")))

    def on_step(self, step: int) -> None:
        if self._done:
            return
        if self._prof is None and step >= self.start_step:
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
            self._stop_at = step + self.num_steps
        elif self._prof is not None and step >= self._stop_at:
            self._stop()

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self._done = True
        out = Path(self.out_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"trace-{os.getpid()}.json"
        prof.export_chrome_trace(str(path))
        print(f"[profiler] trace written to {path}", flush=True)

    def close(self) -> None:
        if self._prof is not None:
            self._stop()
