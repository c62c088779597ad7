"""Run-wide distributed telemetry: spans, counters/gauges, per-role shards.

Copy of the JAX package's `observability/` (it imports no jax): the same
shard layout and names, so `scripts/obs_report.py` reads a run of
either package.

Every process of a topology (learner, actors, anakin drivers) writes its
own `telemetry/<role>-<rank>.jsonl` shard plus a Chrome-trace timeline
`telemetry/trace-<role>-<rank>.json`; `scripts/obs_report.py` merges all
shards of a run directory into one report + one merged trace.

OFF by default: the module-level `TELEMETRY` singleton starts disabled
and every instrumentation call short-circuits on one attribute read —
no files, no threads, no per-step allocations (`span()` returns a shared
no-op context manager; tests/test_observability.py pins this). Enable
with:

    DRL_TELEMETRY_DIR=/path/to/run/telemetry   # explicit shard dir
    DRL_TELEMETRY=1                            # + a run_dir the process
                                               # already has -> <run_dir>/telemetry

See docs/performance.md ("Observability") for the shard layout and the
report CLI.
"""

from distributed_reinforcement_learning_tpu_torch.observability.metrics import (
    TELEMETRY,
    Telemetry,
    maybe_configure,
)
from distributed_reinforcement_learning_tpu_torch.observability.trace import (
    TraceEmitter,
    load_trace,
)

__all__ = ["TELEMETRY", "Telemetry", "TraceEmitter", "load_trace", "maybe_configure"]
