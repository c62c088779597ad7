"""Chrome-trace/Perfetto span emitter: a host-side timeline per process.

The learner's `StageTimer` already measures dequeue/learn/publish, but it
reduces everything to windowed means — "publish averaged 3 ms" cannot
show the one 400 ms stall that starved the chip. A `TraceEmitter`
records every stage invocation as a complete-duration event (`ph: "X"`)
in the Trace Event Format, so `trace-<role>-<rank>.json` opens directly
in Perfetto (ui.perfetto.dev) or chrome://tracing — next to the XLA
device trace `ProfilerSession` captures, giving host timeline + device
timeline side by side.

Timestamps are wall-clock epoch microseconds (not perf_counter): spans
from different PROCESSES of one run then align on a shared axis, which
is what makes the merged cross-role trace of `scripts/obs_report.py`
meaningful (actor enqueue stalls visibly overlapping learner queue
waits). Durations come from `perf_counter` deltas, so they stay
monotonic even if the wall clock steps.

The file is streamed: events append as a JSON array that `close()`
terminates, so a crashed process still leaves a loadable trace
(`load_trace` tolerates the missing `]`; a clean close writes strictly
valid JSON). A bounded event cap (`DRL_TRACE_MAX_EVENTS`) keeps a
long run from growing the trace without limit — past it, new events are
counted as dropped, not stored.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Iterator

DEFAULT_MAX_EVENTS = 100_000


class TraceEmitter:
    """Buffered Chrome-trace writer for one process's host spans."""

    # Concurrency map (tools/drlint lock-discipline): every span
    # emitter shares the buffer with the telemetry flush thread; all
    # five fields only move under `_lock` (emit/flush/close).
    _GUARDED_BY = {
        "dropped": "_lock",
        "_pending": "_lock",
        "_written": "_lock",
        "_file": "_lock",
        "_closed": "_lock",
    }

    def __init__(
        self,
        path: str,
        label: str,
        pid: int | None = None,
        max_events: int | None = None,
    ):
        self.path = path
        self.label = label
        self.pid = os.getpid() if pid is None else pid
        if max_events is None:
            max_events = int(os.environ.get("DRL_TRACE_MAX_EVENTS",
                                            str(DEFAULT_MAX_EVENTS)))
        self.max_events = max_events
        self.dropped = 0
        self._lock = threading.Lock()
        self._pending: list[dict] = []
        self._written = 0
        self._file = None
        self._closed = False

    def emit(self, name: str, wall_start_s: float, duration_s: float,
             tid: int | None = None, args: dict | None = None) -> None:
        """Record one complete span (start wall-clock seconds + duration)."""
        event = {
            "name": name,
            "ph": "X",
            "ts": round(wall_start_s * 1e6, 1),
            "dur": round(duration_s * 1e6, 1),
            "pid": self.pid,
            "tid": tid if tid is not None else threading.get_ident(),
            "cat": "host",
        }
        if args:
            event["args"] = args
        with self._lock:
            if self._closed or self._written + len(self._pending) >= self.max_events:
                self.dropped += 1
                return
            self._pending.append(event)

    @contextlib.contextmanager
    def span(self, name: str, args: dict | None = None) -> Iterator[None]:
        wall = time.time()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.emit(name, wall, time.perf_counter() - t0, args=args)

    def _open(self):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        f = open(self.path, "w")
        f.write("[\n")
        # Process metadata so viewers label the track by role, not pid.
        f.write(json.dumps({"ph": "M", "name": "process_name", "pid": self.pid,
                            "tid": 0, "args": {"name": self.label}}))
        return f

    def flush(self) -> None:
        """Append pending events to the on-disk (still-open) JSON array."""
        with self._lock:
            if self._closed or not self._pending:
                return
            if self._file is None:
                self._file = self._open()
            for event in self._pending:
                self._file.write(",\n" + json.dumps(event))
            self._written += len(self._pending)
            self._pending.clear()
            self._file.flush()

    def close(self) -> None:
        """Terminate the array: the file becomes strictly valid JSON."""
        self.flush()
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._file is None:
                self._file = self._open()
            if self.dropped:
                self._file.write(",\n" + json.dumps(
                    {"ph": "M", "name": "trace_dropped_events", "pid": self.pid,
                     "tid": 0, "args": {"dropped": self.dropped}}))
            self._file.write("\n]\n")
            self._file.close()
            self._file = None


def load_trace(path: str) -> list[dict]:
    """Load a trace written by `TraceEmitter` (or any Chrome-trace JSON).

    Tolerates the streaming form a crashed process leaves behind (open
    array, no terminator) and the `{"traceEvents": [...]}` wrapper some
    tools produce.
    """
    with open(path) as f:
        text = f.read().strip()
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        try:
            data = json.loads(text.rstrip().rstrip(",") + "\n]")
        except json.JSONDecodeError:
            # A SIGTERM mid-flush can cut the final event at an arbitrary
            # byte. Events are one-per-line on disk, so recover every
            # complete line and drop the torn tail — one mangled shard
            # must not abort the whole run's report.
            data = []
            for line in text.splitlines():
                line = line.strip().rstrip(",")
                if not line or line in ("[", "]"):
                    continue
                try:
                    data.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    if isinstance(data, dict):
        data = data.get("traceEvents", [])
    return data
