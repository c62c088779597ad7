"""Counters/gauges with periodic flush to per-role JSONL shards.

One `Telemetry` object per process (the module-level `TELEMETRY`
singleton), writing `<role>-<rank>.jsonl` under the configured
directory. Three instrument kinds, all safe to call from any thread:

- `count(name, by)`   — monotonic counter; each flush writes the
  cumulative value, so a reader derives rates from consecutive records;
- `gauge(name, value)` — windowed observation; each flush writes the
  window's {n, last, mean, min, max} and resets it, so hot gauges
  (per-enqueue wait, per-publish latency) cost one dict update, not one
  file line, per observation;
- `sample(name, fn, kind="gauge"|"counter")` — registered provider
  polled once per flush (queue depth, weight version, an existing
  cumulative stats dict): a timeline with zero hot-path cost.

Record shapes (one JSON object per line):

    {"kind": "meta",    "t", "role", "rank", "pid"}
    {"kind": "counter", "t", "name", "value"}
    {"kind": "gauge",   "t", "name", "n", "last", "mean", "min", "max"}

The singleton starts DISABLED: every instrument short-circuits on one
attribute read, `span()` hands back a shared no-op context manager, and
nothing is allocated or written (tests/test_observability.py's
disabled-path test pins this, per-train-step hot paths rely on it).
`configure()` — or `maybe_configure()`, the env-gated form used by
`run_role` and the anakin drivers — opens the shard, attaches a
`TraceEmitter` (trace.py), and starts the flush thread
(`DRL_TELEMETRY_FLUSH_S`, default 1 s).
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Any, Callable

from distributed_reinforcement_learning_tpu_torch.observability.trace import TraceEmitter

# Weight-staleness histogram edges — the single source of truth for the
# write side (transport server's observation-time `staleness_bucket/*`
# counters) and the read side (scripts/obs_report.py's display order).
STALENESS_BUCKETS = ((0, "0"), (1, "1"), (2, "2"), (4, "3-4"), (8, "5-8"),
                     (16, "9-16"))
STALENESS_BUCKET_NAMES = tuple(name for _, name in STALENESS_BUCKETS) + (">16",)


def stale_bucket(staleness: float) -> str:
    for edge, name in STALENESS_BUCKETS:
        if staleness <= edge:
            return name
    return ">16"


class _NullSpan:
    """Shared no-op context manager: the disabled `span()` result.

    A singleton so the disabled path allocates nothing per call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Window:
    """One gauge's flush-window aggregate. `weight` lets one call stand
    for N identical observations (a batched PUT's staleness covers K
    unrolls) without N dict updates."""

    __slots__ = ("n", "total", "lo", "hi", "last")

    def __init__(self, value: float, weight: int = 1):
        self.n = weight
        self.total = value * weight
        self.lo = value
        self.hi = value
        self.last = value

    def add(self, value: float, weight: int = 1) -> None:
        self.n += weight
        self.total += value * weight
        if value < self.lo:
            self.lo = value
        if value > self.hi:
            self.hi = value
        self.last = value


class Telemetry:
    # Concurrency map (tools/drlint lock-discipline): the instrument
    # maps are shared between every hot-path caller and the flush
    # thread; the identity/config fields are written by configure()/
    # close() around the threaded phase, with `enabled` read lock-free
    # on hot paths as a deliberate no-op fast check.
    _GUARDED_BY = {
        "_counters": "_lock",
        "_gauges": "_lock",
        "_providers": "_lock",
        "_flush_errors": "_lock",
        "_provider_errors": "_lock",
    }
    _NOT_GUARDED = {
        "enabled": "flipped by configure()/close() around the threaded "
                   "phase; hot-path reads are deliberately lock-free "
                   "no-op checks (stale False costs one dropped sample)",
        "trace": "bound in configure() before the flush thread starts; "
                 "close() is the only other writer",
        "role": "configure()-once identity string",
        "rank": "configure()-once identity int",
        "_file": "opened in configure() before the flush thread starts; "
                 "closed only after the flush thread joins",
        "_thread": "start/stop lifecycle handle, controlling thread only",
    }

    def __init__(self):
        self.enabled = False
        self.trace: TraceEmitter | None = None
        self.role = "proc"
        self.rank = 0
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, _Window] = {}
        # name -> (provider fn, record kind: "gauge" | "counter")
        self._providers: dict[str, tuple[Callable[[], Any], str]] = {}
        self._flush_errors = 0     # whole-flush failures (first one warns)
        self._provider_errors = 0  # dead providers, surfaced as a counter
        self._file = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- configuration ----------------------------------------------------

    def configure(
        self,
        out_dir: str,
        role: str,
        rank: int = 0,
        flush_interval: float | None = None,
        trace: bool = True,
    ) -> "Telemetry":
        """Open the shard + trace for this process and start flushing.

        Idempotent: a second configure on an enabled instance is a no-op
        (first role wins — a process has one identity per run)."""
        if self.enabled:
            return self
        if flush_interval is None:
            flush_interval = float(os.environ.get("DRL_TELEMETRY_FLUSH_S", "1.0"))
        os.makedirs(out_dir, exist_ok=True)
        self.role, self.rank = role, int(rank)
        # "w", matching the trace: one shard file describes one process
        # lifetime. Appending across reused run dirs would splice two
        # runs' cumulative counters into one series (negative rates in
        # the report) while the trace silently truncated to the new run.
        self._file = open(os.path.join(out_dir, f"{role}-{rank}.jsonl"), "w")
        self._file.write(json.dumps({
            "kind": "meta", "t": time.time(), "role": role, "rank": int(rank),
            "pid": os.getpid()}) + "\n")
        self._file.flush()
        if trace:
            self.trace = TraceEmitter(
                os.path.join(out_dir, f"trace-{role}-{rank}.json"),
                label=f"{role}-{rank}")
        self._stop.clear()
        self.enabled = True
        if flush_interval > 0:
            self._thread = threading.Thread(
                target=self._flush_loop, args=(flush_interval,),
                daemon=True, name="telemetry-flush")
            self._thread.start()
        atexit.register(self.close)
        return self

    # -- instruments (all no-ops while disabled) --------------------------

    def count(self, name: str, by: float = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + by

    def gauge(self, name: str, value: float, weight: int = 1) -> None:
        if not self.enabled or weight <= 0:
            return
        with self._lock:
            window = self._gauges.get(name)
            if window is None:
                self._gauges[name] = _Window(float(value), weight)
            else:
                window.add(float(value), weight)

    def sample(self, name: str, fn: Callable[[], Any],
               kind: str = "gauge") -> None:
        """Register `fn` to be polled once per flush (e.g. queue depth):
        a timeline with zero hot-path cost. kind="counter" writes the
        polled value as a cumulative counter record instead of a gauge —
        the way to surface an existing cumulative stats dict (e.g. the
        transport server's / client's) as report throughput without
        double-counting it on the hot path."""
        if not self.enabled:
            return
        with self._lock:
            self._providers[name] = (fn, kind)

    def span(self, name: str):
        trace = self.trace
        if trace is None:
            return _NULL_SPAN
        return trace.span(name)

    # -- flushing ----------------------------------------------------------

    def _flush_loop(self, interval: float) -> None:
        import sys

        while not self._stop.wait(interval):
            try:
                self.flush()
            except Exception as e:  # noqa: BLE001 — telemetry must never
                with self._lock:    # kill a run; count it, warn ONCE
                    self._flush_errors += 1
                    first = self._flush_errors == 1
                if first:
                    print(f"[telemetry] WARNING: flush failed (further "
                          f"failures counted silently): {e!r}",
                          file=sys.stderr)

    def flush(self) -> None:
        if not self.enabled or self._file is None:
            return
        now = time.time()
        with self._lock:
            counters = dict(self._counters)
            gauges, self._gauges = self._gauges, {}
            providers = dict(self._providers)
        lines = []
        for name, value in sorted(counters.items()):
            lines.append({"kind": "counter", "t": now, "name": name, "value": value})
        for name, w in sorted(gauges.items()):
            lines.append({"kind": "gauge", "t": now, "name": name, "n": w.n,
                          "last": w.last, "mean": w.total / w.n,
                          "min": w.lo, "max": w.hi})
        for name, (fn, kind) in sorted(providers.items()):
            try:
                value = float(fn())
            except Exception:  # noqa: BLE001 — a dead provider (closed queue
                with self._lock:        # at shutdown) must not poison the
                    self._provider_errors += 1  # flush; counted + emitted
                continue
            if kind == "counter":
                lines.append({"kind": "counter", "t": now, "name": name,
                              "value": value})
            else:
                lines.append({"kind": "gauge", "t": now, "name": name, "n": 1,
                              "last": value, "mean": value, "min": value,
                              "max": value})
        with self._lock:
            perrs, ferrs = self._provider_errors, self._flush_errors
        if perrs:
            lines.append({"kind": "counter", "t": now,
                          "name": "telemetry.provider_errors",
                          "value": perrs})
        if ferrs:
            lines.append({"kind": "counter", "t": now,
                          "name": "telemetry.flush_errors", "value": ferrs})
        if lines:
            self._file.write("".join(json.dumps(line) + "\n" for line in lines))
            self._file.flush()
        if self.trace is not None:
            self.trace.flush()

    def close(self) -> None:
        """Final flush, terminate the trace, release files; re-disables."""
        if not self.enabled:
            return
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.flush()
        self.enabled = False
        if self.trace is not None:
            self.trace.close()
            self.trace = None
        if self._file is not None:
            self._file.close()
            self._file = None
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._providers.clear()


TELEMETRY = Telemetry()


def telemetry_dir(run_dir: str | None = None) -> str | None:
    """Resolve the shard directory from the env (None = stay disabled).

    `DRL_TELEMETRY_DIR` names it outright (what the cluster launcher
    exports to every child); `DRL_TELEMETRY=1` derives it from a run
    directory the process already has."""
    out = os.environ.get("DRL_TELEMETRY_DIR")
    if out:
        return out
    if run_dir and os.environ.get(
            "DRL_TELEMETRY", "").strip().lower() in ("1", "true", "yes", "on"):
        return os.path.join(run_dir, "telemetry")
    return None


def maybe_configure(role: str, rank: int = 0, run_dir: str | None = None) -> bool:
    """Env-gated configure of the global TELEMETRY; False = left disabled."""
    out = telemetry_dir(run_dir)
    if out is None:
        return False
    TELEMETRY.configure(out, role, rank)
    return True
