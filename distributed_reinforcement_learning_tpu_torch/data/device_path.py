"""The fused device sample path: gather -> stack -> H2D off the learn thread.

Counterpart of the JAX package's `data/device_path.py`. On the host path
a prioritized learner's train call is

    sample (shard gather) -> stack -> H2D -> learn -> D2H priorities
    -> write-back

all on the learn thread. `DeviceSamplePath` is the replay plane's
`data/prefetch.DevicePrefetcher`: one background gather thread samples
the next K prioritized batches from the thread-safe sharded service
(`data/replay_service.py`: its per-shard locks make a concurrent gather
safe; the monolithic backends stay on the host path), stacks the
`[K, B, ...]` batch on the host, and issues its host-to-device copy on
its own CUDA stream, so that the copy for call k+1 runs while call k's
`learn_many` does. On CUDA each stacked leaf is written into pinned
host memory (index fields as int64, the dtype the learn step gathers
with), copied with `non_blocking=True` on the path's stream, and an
event is recorded behind the copies; `next_entry` makes the caller's
current stream wait on that event and marks each device tensor as used
on it (`record_stream`). Without the wait the learn step would read
half-copied rows, which only the card can show. On the CPU the entry is
the host batch itself. `depth` bounds the sampled calls that wait beside
the one in use (1: double buffering).

The learn side (`runtime/replay_train.device_train_call`) runs K > 1
steps as one `learn_many`, copies the `[K, B]` priorities to the host
in ONE device-to-host copy, and fans them out to the service's
write-back router by the packed (tag|epoch|shard|tree_idx) indices, so
a shard that dies mid-K drops only its own stale-epoch updates.

Semantics: sampled batches are the host gather's at a fixed RNG
(`gather_scan_batch` IS the host path's gather). The one difference is
priority staleness: with K steps a call and `depth` waiting calls a
batch can be sampled up to ~K + depth updates before its priorities
refresh, the class of staleness the host K > 1 call already has.

Demotion (permanent, logged once by the learner): an oversize stacked
call (`DRL_DEVICE_PATH_MAX_MB`) or a gather fault latches the path dead
and the learner returns to the host loop; a service demotion (all
shards dead) closes the path before the learner samples on the host
(the RNG hand-back). `reconfigure` changes K: entries stacked at the
old K carry an older epoch and are dropped, never fed to a learn step
of the new shape. `close` joins the gather thread and rewinds the
sampling stream to where the first sampled call that no caller took
began, so the stream the learner takes back (for the host loop, or for
a checkpoint) is where the host path's would be after the calls that
trained.

Gate: `DRL_DEVICE_PATH` (0 off, 1 force); unset takes
`DEVICE_PATH_VERDICT`, this module's copy of the JAX package's
`benchmarks/device_path_verdict.json` (off).

Concurrency (no class-owned locks, so `_GUARDED_BY` is the
documentation form): ONE gather thread produces, ONE learn thread
consumes, through a bounded `queue.Queue`; `_cfg` is an immutable
`(k, epoch)` tuple swapped by the consumer and read once a round by the
producer; `dead_reason` is written once by whichever side latches.
"""

from __future__ import annotations

import os
import queue as _queue
import threading
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.data.fifo import (
    stack_pytrees, tree_leaves, tree_map)
from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS

# The JAX package's benchmarks/device_path_verdict.json as it stands: the
# device path against the host path at K = 4, median 0.97x, below its
# 1.2x bar, so the path ships off.
DEVICE_PATH_VERDICT = {"auto_enable": False}

# The batch fields the learn steps gather with (`agents/common.py`).
_INDEX_FIELDS = ("action", "previous_action")


def device_path_enabled() -> bool:
    """`DRL_DEVICE_PATH=1` forces the path on, `=0` off; unset defers to
    `DEVICE_PATH_VERDICT`."""
    env = os.environ.get("DRL_DEVICE_PATH", "").strip()
    if env:
        return env != "0"
    return bool(DEVICE_PATH_VERDICT.get("auto_enable", False))


def path_depth() -> int:
    """`DRL_DEVICE_PATH_DEPTH`: sampled calls waiting on the device beside
    the one in use (1 = double buffering)."""
    env = os.environ.get("DRL_DEVICE_PATH_DEPTH", "").strip()
    if not env:
        return 1
    try:
        return max(1, int(env))
    except ValueError as e:
        raise ValueError(f"DRL_DEVICE_PATH_DEPTH must be an integer, got {env!r}") from e


def path_max_bytes() -> int:
    """`DRL_DEVICE_PATH_MAX_MB`: the stacked-call size past which the
    path demotes to the host loop instead of risking device memory."""
    env = os.environ.get("DRL_DEVICE_PATH_MAX_MB", "").strip()
    if not env:
        return 256 * 1024 * 1024
    try:
        return max(1, int(float(env) * 1024 * 1024))
    except ValueError as e:
        raise ValueError(f"DRL_DEVICE_PATH_MAX_MB must be a number, got {env!r}") from e


# -- the gather (shared with the host path) -----------------------------------


def gather_scan_batch(replay, batch_size: int, k: int, rng
                      ) -> tuple[Any, np.ndarray, list[np.ndarray]]:
    """Sample `k` prioritized batches and assemble them on the host:
    -> (stacked `[k, B, ...]` batch, IS weights `[k, B]` float32, the
    per-batch index arrays). The one gather of the host path
    (`replay_train.prioritized_train_call`) and of the device path's
    thread, so their batches are the same at a fixed RNG. All k batches
    are drawn before any of their priority updates lands."""
    sampled = [replay.sample(batch_size, rng) for _ in range(k)]
    if getattr(replay, "stacked_samples", False):
        # The array backend hands back already-stacked [B, ...] batches.
        stacked = stack_pytrees([items for items, _, _ in sampled])
    else:
        # Item lists: stack all k*B items once, view as [k, B, ...].
        flat = stack_pytrees([it for items, _, _ in sampled for it in items])
        stacked = tree_map(lambda x: x.reshape((k, -1) + x.shape[1:]), flat)
    weights = np.stack([np.asarray(w, np.float32) for _, _, w in sampled])
    return stacked, weights, [idxs for _, idxs, _ in sampled]


def gather_single_batch(replay, batch_size: int, rng
                        ) -> tuple[Any, np.ndarray, list[np.ndarray]]:
    """The K == 1 gather: -> (`[B, ...]` batch, IS weights `[B]` float32,
    [indices]). No call axis: the entry feeds the agent's one-step
    `learn` directly."""
    items, idxs, weights = replay.sample(batch_size, rng)
    batch = items if getattr(replay, "stacked_samples", False) else stack_pytrees(items)
    return batch, np.asarray(weights, np.float32), [idxs]


def _tree_nbytes(tree: Any) -> int:
    return sum(np.asarray(leaf).nbytes for leaf in tree_leaves(tree))


class PinnedTransfer:
    """The path's host-to-device copy on CUDA: each leaf of `(batch,
    weights)` is written into pinned host memory (torch's caching host
    allocator, which keeps a block until the copies out of it are done)
    and copied with `non_blocking=True` on the path's own stream, with
    timing events around the copies. Called on the gather thread ->
    (device batch, device weights, the copies' done event)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._stream = torch.cuda.Stream(device=self.device)
        self.timing: deque = deque(maxlen=256)  # (start, done) events of each entry

    def __call__(self, batch, weights):
        fields = batch._asdict() if hasattr(batch, "_fields") else batch
        host = {}
        for name, x in fields.items():
            arr = np.asarray(x)
            if name in _INDEX_FIELDS:
                arr = arr.astype(np.int64, copy=False)
            pinned = torch.empty(arr.shape, dtype=torch.from_numpy(np.empty(0, arr.dtype)).dtype,
                                 pin_memory=True)
            pinned.numpy()[...] = arr
            host[name] = pinned
        w = torch.empty(weights.shape, dtype=torch.float32, pin_memory=True)
        w.numpy()[...] = weights
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._stream):
            # Allocate first, so that the timed window holds the copies.
            dev = {k: torch.empty(h.shape, dtype=h.dtype, device=self.device)
                   for k, h in host.items()}
            dev_w = torch.empty(w.shape, dtype=w.dtype, device=self.device)
            start.record(self._stream)
            for k, t in dev.items():
                t.copy_(host[k], non_blocking=True)
            dev_w.copy_(w, non_blocking=True)
            done.record(self._stream)
        self.timing.append((start, done))
        out = type(batch)(**dev) if hasattr(batch, "_fields") else dev
        return out, dev_w, done

    def h2d_ms(self) -> list[float]:
        """Device ms of each of the last (up to 256) entries' copies;
        waits for them to finish."""
        out = []
        for start, done in list(self.timing):
            done.synchronize()
            out.append(start.elapsed_time(done))
        return out


def _host_transfer(batch, weights):
    """The CPU entry: the host batch itself, no copy and no event."""
    return batch, weights, None


# -- the path -----------------------------------------------------------------


class DeviceSamplePath:
    """Background sample + stack + H2D pipeline over a prioritized replay
    (the thread-safe sharded service in deployment).

    `next_entry(timeout)` -> `(k, device batch, device weights, idx_list)`,
    or None on a timeout or once the path latched dead (the caller then
    demotes to the host loop; `dead_reason` says why). `rng` is the
    learner's sampling stream: while the path is live the gather thread
    OWNS it, and `close()` joins the thread before the host path takes
    the stream back. `transfer(batch, weights)` -> (batch, weights,
    event or None) is the copy, `PinnedTransfer` on a CUDA `device`
    (tests inject a slow one to pin that the copy overlaps the learn).
    """

    _GUARDED_BY: dict = {}
    _NOT_GUARDED = {
        "_cfg": "immutable (k, epoch) tuple; the consumer swaps the whole "
                "reference, the producer reads it once a round",
        "dead_reason": "write-once latch reason (a str reference); whichever "
                       "side latches first wins",
        "dropped_entries": "consumer-thread-only stale-epoch tally",
        "h2d_bytes": "gather-thread-only byte counter",
        "entries_out": "gather-thread-only entry counter",
        "gather_rounds": "gather-thread-only round counter",
        "_unput_state": "gather-thread-only until close() has joined the thread",
    }

    def __init__(self, replay, batch_size: int, k: int, rng,
                 device: str | torch.device = "cpu", depth: int | None = None,
                 max_bytes: int | None = None, transfer: Callable | None = None):
        self.replay = replay
        self.batch_size = batch_size
        self.rng = rng
        self.device = torch.device(device)
        self.max_bytes = path_max_bytes() if max_bytes is None else max_bytes
        if transfer is None:
            transfer = (PinnedTransfer(self.device) if self.device.type == "cuda"
                        else _host_transfer)
        self._transfer = transfer
        self._cfg: tuple[int, int] = (max(1, int(k)), 0)
        self._out: _queue.Queue = _queue.Queue(
            maxsize=path_depth() if depth is None else max(1, depth))
        self.dead_reason: str | None = None
        self.dropped_entries = 0  # stale-epoch entries (K changed)
        self.h2d_bytes = 0
        self.entries_out = 0
        self.gather_rounds = 0
        # The stream's state before the last round that sampled and was
        # not queued (the thread stopped, or the call was oversize).
        self._unput_state = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="device-sample-path")
        self._thread.start()

    # -- state -------------------------------------------------------------

    @property
    def k(self) -> int:
        return self._cfg[0]

    @property
    def dead(self) -> bool:
        return self.dead_reason is not None

    def stats(self) -> dict:
        return {"k": self._cfg[0], "depth": self._out.qsize(),
                "entries_out": self.entries_out, "h2d_bytes": self.h2d_bytes,
                "dropped_entries": self.dropped_entries,
                "gather_rounds": self.gather_rounds, "dead_reason": self.dead_reason}

    def h2d_ms(self) -> list[float]:
        """Device ms of each recent entry's copies (CUDA only, else [])."""
        return self._transfer.h2d_ms() if hasattr(self._transfer, "h2d_ms") else []

    # -- consumer side -----------------------------------------------------

    def reconfigure(self, k: int) -> None:
        """Change K: entries already stacked at the old K carry the old
        epoch and are dropped at `next_entry`."""
        k = max(1, int(k))
        cur_k, epoch = self._cfg
        if k != cur_k:
            self._cfg = (k, epoch + 1)

    def next_entry(self, timeout: float | None = 0.5):
        """-> (k, batch, weights, idx_list) or None (the gather is behind,
        or the path died: see `dead`). Stale-epoch entries are consumed
        and dropped here; their sampled indices lose only their priority
        write-back. On CUDA the caller's current stream waits for the
        entry's copies before anything it enqueues next."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                wait = (0.2 if deadline is None
                        else max(0.0, min(0.2, deadline - time.monotonic())))
                epoch, k, batch, weights, done, idxs, _ = self._out.get(timeout=wait)
            except _queue.Empty:
                if self.dead:
                    return None
                if deadline is not None and time.monotonic() >= deadline:
                    return None
                continue
            if epoch != self._cfg[1]:
                self.dropped_entries += 1
                if _OBS.enabled:
                    _OBS.count("devpath/dropped_entries")
                continue
            if done is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(done)
                fields = batch._asdict() if hasattr(batch, "_fields") else batch
                for t in (*fields.values(), weights):
                    t.record_stream(stream)  # read on this stream: keep its memory
            return k, batch, weights, idxs

    def close(self) -> bool:
        """Stop and JOIN the gather thread, drop the queued entries and
        rewind the RNG stream to where the first of them (or the round
        that was never queued) began sampling; True when the join landed —
        only then is the stream the learner's alone again, where the host
        path's would be after the calls that were taken. On False the
        caller must not touch the shared stream
        (`ReplayTrainMixin._close_device_path` takes a fresh one)."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            return False
        states = []
        while True:
            try:
                states.append(self._out.get_nowait()[-1])
            except _queue.Empty:
                break
        states.append(self._unput_state)
        first = next((st for st in states if st is not None), None)
        if first is not None:
            self.rng.set_state(first)
        return True

    # -- gather thread -----------------------------------------------------

    def _latch_dead(self, reason: str) -> None:
        if self.dead_reason is None:
            self.dead_reason = reason

    def _loop(self) -> None:
        try:
            self._loop_inner()
        except BaseException as e:  # noqa: BLE001 — surfaced via dead_reason
            self._latch_dead(f"gather thread died: {type(e).__name__}: {e}")

    def _loop_inner(self) -> None:
        from distributed_reinforcement_learning_tpu_torch.data.replay_service import (
            ReplayServiceEmpty)

        while not self._stop.is_set():
            k, epoch = self._cfg
            t0 = time.perf_counter()
            state = self.rng.get_state()  # where this round's draws begin
            try:
                if k > 1:
                    batch, weights, idxs = gather_scan_batch(
                        self.replay, self.batch_size, k, self.rng)
                else:
                    batch, weights, idxs = gather_single_batch(
                        self.replay, self.batch_size, self.rng)
            except ReplayServiceEmpty:
                # Passing while the service is healthy (a revive can empty
                # the shards mid-run); terminal once it demoted.
                if not getattr(self.replay, "healthy", True):
                    self._latch_dead("replay service demoted (all shards dead)")
                    return
                self._stop.wait(0.005)
                continue
            gather_ms = (time.perf_counter() - t0) * 1e3
            self.gather_rounds += 1
            nbytes = _tree_nbytes(batch) + weights.nbytes
            if nbytes > self.max_bytes:
                self._unput_state = state
                self._latch_dead(f"oversize sampled call: {nbytes / 1e6:.1f} MB > "
                                 f"DRL_DEVICE_PATH_MAX_MB — demoting to the host path")
                return
            t1 = time.perf_counter()
            dev_batch, dev_weights, done = self._transfer(batch, weights)
            h2d_ms = (time.perf_counter() - t1) * 1e3
            self.h2d_bytes += nbytes
            if _OBS.enabled:
                _OBS.gauge("devpath/gather_ms", gather_ms)
                _OBS.gauge("devpath/h2d_issue_ms", h2d_ms)
                _OBS.count("devpath/h2d_bytes", nbytes)
                _OBS.gauge("devpath/depth", self._out.qsize())
            entry = (epoch, k, dev_batch, dev_weights, done, idxs, state)
            while not self._stop.is_set():
                try:
                    self._out.put(entry, timeout=0.2)
                    self.entries_out += 1
                    if _OBS.enabled:
                        _OBS.count("devpath/entries")
                    break
                except _queue.Full:
                    continue
            else:
                self._unput_state = state  # stopped before the entry was queued
