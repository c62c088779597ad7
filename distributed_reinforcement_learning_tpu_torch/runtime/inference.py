"""Served acts: actors ship observation rows, one service acts for many.

Counterpart of the JAX package's `runtime/inference.py` (SEED RL's
centralized inference). A learner-side (or replica) service batches the
act requests of many actors into one act call on its device and replies
with the action rows, so an actor needs no weights and no network math:
it only steps envs and ships rows.

Requests and replies are flat dicts of `[n, ...]` numpy row arrays, the
JAX package's row layouts key for key, so the act wire crosses between
the packages. A per-family adapter (`make_act_adapter`) maps a merged
row dict through the agent's `act`: IMPALA rows carry (obs, prev_action,
h, c); Ape-X (obs, prev_action, epsilon: the actor keeps its exploration
schedule); R2D2 (obs, h, c, prev_action, epsilon); the transformer
families their rolling windows `[n, W, ...]` (obs, prev_action, done,
and epsilon for Transformer-R2D2). Recurrent state and windows stay on
the actor, so the service is stateless and any request joins any batch.

`InferenceServer.submit()` blocks the calling (connection-handler)
thread until its rows come back. Batching: run once `max_batch` rows are
pending, or `max_wait_ms` after the first arrival; a request wider than
`max_batch` is served in `max_batch`-row chunks. Rows are padded to a
power of two by repeating row 0, so the device sees a handful of shapes.

On the device, where the JAX service splits a `PRNGKey(seed)` per batch,
this one draws from one `torch.Generator` on the act device seeded with
`seed`, consumed by the dispatch thread alone: two services with the
same seed and parameters that see the same first batch give the same
actions (padded rows draw too, so the pin needs the same bucket).
Parameters are read from the weight store every batch and moved to the
act device once per published version (a learner's store already holds
them there), keyed by version identity (`!=`: a rollback republish
lands too). A batch's rows go to the device in one copy a key; on CUDA
through pinned buffers with no host wait, the act is enqueued on the
current stream, each output is copied back into a pinned buffer behind
it and a `torch.cuda.Event` marks the batch: the waiter waits on that
event alone, never on the whole device (a learner's step shares the
stream and would hold it). An act that fails on the device reaches its
requesters as an error; nothing falls back to another device.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS


class InferenceBusy(RuntimeError):
    """Admission-control reject: the service is alive but its bounded
    pending-rows budget is full. `retryable = True` is what the transport
    server reads to answer ST_BUSY (the client retries with jitter or
    fails over to another replica) instead of ST_ERROR."""

    retryable = True


def _bucket(n: int) -> int:
    """Smallest power of two >= n."""
    b = 1
    while b < n:
        b *= 2
    return b


def make_act_adapter(algo: str, agent) -> Callable:
    """-> act_fn(params, rows: dict of tensors on the agent's device,
    generator) -> dict of `[n, ...]` output tensors, with `expected_keys`
    (the request's row keys) and `device` (the agent's)."""
    if algo == "impala":
        def impala_fn(params, rows, generator):
            out = agent.act(params, rows["obs"], rows["prev_action"], rows["h"], rows["c"],
                            generator)
            return {"action": out.action.to(torch.int32), "policy": out.policy,
                    "h": out.h, "c": out.c}
        fn, keys = impala_fn, {"obs", "prev_action", "h", "c"}
    elif algo == "apex":
        def apex_fn(params, rows, generator):
            action, q = agent.act(params, rows["obs"], rows["prev_action"], rows["epsilon"],
                                  generator)
            return {"action": action.to(torch.int32), "q": q}
        fn, keys = apex_fn, {"obs", "prev_action", "epsilon"}
    elif algo == "r2d2":
        def r2d2_fn(params, rows, generator):
            action, q, h, c = agent.act(params, rows["obs"], rows["h"], rows["c"],
                                        rows["prev_action"], rows["epsilon"], generator)
            return {"action": action.to(torch.int32), "q": q, "h": h, "c": c}
        fn, keys = r2d2_fn, {"obs", "h", "c", "prev_action", "epsilon"}
    elif algo == "xformer":
        # Rows carry the actor's rolling window, the transformer's
        # stand-in for recurrent state.
        def xformer_fn(params, rows, generator):
            action, q = agent.act(params, rows["obs"], rows["prev_action"], rows["done"],
                                  rows["epsilon"], generator)
            return {"action": action.to(torch.int32), "q": q}
        fn, keys = xformer_fn, {"obs", "prev_action", "done", "epsilon"}
    elif algo == "ximpala":
        # Rolling-window rows; the reply carries the behaviour policy the
        # actor records for V-trace.
        def ximpala_fn(params, rows, generator):
            out = agent.act(params, rows["obs"], rows["prev_action"], rows["done"], generator)
            return {"action": out.action.to(torch.int32), "policy": out.policy}
        fn, keys = ximpala_fn, {"obs", "prev_action", "done"}
    else:
        raise ValueError(f"unknown algorithm {algo!r}")
    fn.expected_keys = frozenset(keys)
    fn.device = agent.device
    return fn


def _params_to(params: dict, device: torch.device) -> dict:
    """A store's parameters on the act device: tensors already there are
    used as they are, host arrays are moved once."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))).to(device)
            for k, v in params.items()}


def _rows_to(rows: dict[str, np.ndarray], device: torch.device) -> dict[str, torch.Tensor]:
    """One host-to-device copy a key; on CUDA from pinned buffers, so the
    copy is enqueued on the current stream without a host wait."""
    if device.type != "cuda":
        return {k: torch.from_numpy(v).to(device) for k, v in rows.items()}
    return {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
            for k, v in rows.items()}


class InferenceServer:
    """Batches concurrent act requests into single act calls.

    `act_fn` is a `make_act_adapter` product (or any callable with the
    same contract; `device` defaults to its `device`, else CUDA).
    `weights` is a WeightStore, re-read every batch.
    """

    # The pending-request state is shared between submitter threads and
    # the batcher; `_batch_ready` is a Condition over `_lock`. The batch
    # side (`_generator`, the device cache, the counters) is touched by
    # the batcher thread alone (the completion thread, for the counters,
    # in the continuous server).
    _GUARDED_BY = {
        "_pending": ("_lock", "_batch_ready"),
        "_pending_rows": ("_lock", "_batch_ready"),
        "_stop": ("_lock", "_batch_ready"),
        "_admission_rejects": ("_lock", "_batch_ready"),
    }
    _NOT_GUARDED = {
        "_generator": "dispatch-thread-only act state",
        "_device_params": "dispatch-thread-only device cache",
        "_cached_version": "dispatch-thread-only device-cache version",
        "batches_run": "single-writer counter; racy external reads are monitoring-only",
        "rows_served": "single-writer counter; racy external reads are monitoring-only",
        "padded_rows": "single-writer counter; racy external reads are monitoring-only",
        "latency_ms": "appended by the single writer; deque appends are atomic",
    }

    def __init__(self, act_fn: Callable, weights, max_batch: int = 256,
                 max_wait_ms: float = 2.0, seed: int = 0, admission_rows: int | None = None,
                 device: str | torch.device | None = None):
        self.act_fn = act_fn
        self.weights = weights
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        if device is None:
            device = getattr(act_fn, "device", None)
        if device is None:
            from distributed_reinforcement_learning_tpu_torch.utils.device import resolve_device

            device = resolve_device(None)
        self.device = torch.device(device)
        # Admission control: None queues submits without bound (the
        # learner-hosted service); an integer bounds the pending rows, and
        # a submit past it raises InferenceBusy (ST_BUSY on the wire).
        self.admission_rows = admission_rows
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._device_params = None
        self._cached_version: int | None = None
        self._lock = threading.Lock()
        self._batch_ready = threading.Condition(self._lock)
        self._pending: deque[dict] = deque()
        self._pending_rows = 0
        self._stop = False
        self._admission_rejects = 0
        self.batches_run = 0
        self.rows_served = 0
        self.padded_rows = 0  # the buckets' rows: occupancy = rows_served / padded_rows
        # ms from a batch's dispatch to its outputs on the host (the last
        # 4096): on a learner's device this includes the learn steps
        # already enqueued ahead of the act.
        self.latency_ms: deque = deque(maxlen=4096)
        self._thread = threading.Thread(target=self._loop, daemon=True, name="inference")
        self._thread.start()

    @classmethod
    def for_agent(cls, algo: str, agent, weights, **kwargs) -> "InferenceServer":
        return cls(make_act_adapter(algo, agent), weights, **kwargs)

    def submit(self, request: dict) -> dict:
        """Act for one request's `[n, ...]` row dict; blocks until served.

        Validated here, so a malformed or family-mismatched request fails
        alone instead of poisoning the batch it would join. A request
        wider than `max_batch` goes as `max_batch`-row chunks, each in a
        bounded batch, and the outputs are concatenated back."""
        request = {k: np.asarray(v) for k, v in request.items()}
        if not request:
            raise RuntimeError("empty inference request")
        expected = getattr(self.act_fn, "expected_keys", None)
        if expected is not None and set(request) != set(expected):
            raise RuntimeError(
                f"inference request keys {sorted(request)} != expected "
                f"{sorted(expected)} (actor/learner algorithm mismatch?)")
        ns = {k: v.shape[0] if v.ndim else -1 for k, v in request.items()}
        if len(set(ns.values())) != 1:
            raise RuntimeError(f"inference request row counts disagree: {ns}")
        n = next(iter(request.values())).shape[0]
        reqs = []
        for lo in range(0, max(n, 1), self.max_batch):
            hi = min(lo + self.max_batch, n)
            rows = request if n <= self.max_batch else {k: v[lo:hi] for k, v in request.items()}
            reqs.append({"rows": rows, "n": hi - lo, "event": threading.Event(),
                         "out": None, "error": None, "t": time.monotonic()})
        with self._batch_ready:
            if self._stop:
                raise RuntimeError("inference server stopped")
            # Admission judges the whole request: its chunks land together
            # or not at all.
            if (self.admission_rows is not None
                    and self._pending_rows + n > self.admission_rows
                    and self._pending_rows > 0):
                self._admission_rejects += 1
                raise InferenceBusy(
                    f"admission budget full: {self._pending_rows} pending "
                    f"+ {n} requested > {self.admission_rows} rows")
            self._pending.extend(reqs)
            self._pending_rows += n
            self._batch_ready.notify()
        for req in reqs:
            req["event"].wait()
        for req in reqs:
            if req["error"] is not None:
                raise RuntimeError("inference batch failed") from req["error"]
        if len(reqs) == 1:
            return reqs[0]["out"]
        return {k: np.concatenate([r["out"][k] for r in reqs]) for k in reqs[0]["out"]}

    def admission_reject_count(self) -> int:
        with self._batch_ready:
            return self._admission_rejects

    def stats(self) -> dict:
        """Counters and the dispatch-to-host latency's p50 / p99 (ms)."""
        lat = list(self.latency_ms)
        return {"batches_run": self.batches_run, "rows_served": self.rows_served,
                "padded_rows": self.padded_rows,
                "occupancy": self.rows_served / self.padded_rows if self.padded_rows else None,
                "admission_rejects": self.admission_reject_count(),
                "latency_ms_p50": float(np.percentile(lat, 50)) if lat else None,
                "latency_ms_p99": float(np.percentile(lat, 99)) if lat else None}

    def _take_whole_requests(self) -> list[dict]:
        """Pop whole pending requests up to max_batch rows (at least one);
        called under the lock."""
        batch, rows = [], 0
        while self._pending:
            k = self._pending[0]["n"]
            if batch and rows + k > self.max_batch:
                break
            rows += k
            batch.append(self._pending.popleft())
        self._pending_rows -= rows
        return batch

    def _take_batch(self) -> list[dict]:
        """Wait for work: pending requests once max_batch rows are queued
        or max_wait has passed since the first arrival."""
        with self._batch_ready:
            deadline = None
            while not self._stop:
                if self._pending and deadline is None:
                    deadline = time.monotonic() + self.max_wait
                if self._pending_rows >= self.max_batch or (
                        deadline is not None and time.monotonic() >= deadline
                        and self._pending):
                    return self._take_whole_requests()
                self._batch_ready.wait(
                    timeout=None if deadline is None
                    else max(1e-4, deadline - time.monotonic()))
            return []

    def _loop(self) -> None:
        while True:
            reqs = self._take_batch()
            if not reqs:
                return  # stopped
            try:
                self._run(reqs)
            except Exception as e:  # noqa: BLE001 — deliver to every waiter
                self._fail(reqs, e)

    @staticmethod
    def _fail(reqs: list[dict], error: BaseException) -> None:
        for r in reqs:
            r["error"] = error
            r["event"].set()

    def _dispatch(self, reqs: list[dict]) -> tuple:
        """Merge, pad and enqueue one batch's act -> (outputs, n, event,
        t0): `outputs` are host tensors (pinned on CUDA, filled once
        `event` completes; `event` is None off CUDA, where they are
        ready). Only the dispatch thread runs this."""
        t0 = time.perf_counter()
        params, version = self.weights.get()
        if params is None:
            raise RuntimeError("no weights published yet")
        if version != self._cached_version or self._device_params is None:
            # Versions are snapshot identities, not an order: a rollback
            # republish at a lower version must land here too.
            self._device_params = _params_to(params, self.device)
            self._cached_version = version
        keys = reqs[0]["rows"].keys()
        rows = {k: np.concatenate([r["rows"][k] for r in reqs]) for k in keys}
        n = sum(r["n"] for r in reqs)
        b = _bucket(n)
        if b > n:
            # Pad by repeating row 0 (valid values for any key), sliced
            # off before the scatter.
            rows = {k: np.concatenate([v, np.repeat(v[:1], b - n, axis=0)])
                    for k, v in rows.items()}
        with torch.no_grad():
            out = self.act_fn(self._device_params, _rows_to(rows, self.device),
                              self._generator)
            event = None
            if self.device.type == "cuda":
                host = {}
                for k, v in out.items():
                    host[k] = torch.empty(v[:n].shape, dtype=v.dtype, pin_memory=True)
                    host[k].copy_(v[:n], non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host = {k: v[:n] for k, v in out.items()}
        if _OBS.enabled:
            now = time.monotonic()
            _OBS.gauge("inference/batch_occupancy", n / b)
            _OBS.gauge("inference/batch_rows", n)
            for r in reqs:
                _OBS.gauge("inference/queue_wait_ms", (now - r.get("t", now)) * 1e3)
        self.padded_rows += b
        return host, n, event, t0

    def _materialize(self, host: dict, event, t0: float) -> dict[str, np.ndarray]:
        """Wait for the batch's own event (never the whole device) and
        view its outputs as numpy."""
        if event is not None:
            event.synchronize()
        self.latency_ms.append((time.perf_counter() - t0) * 1e3)
        return {k: v.numpy() for k, v in host.items()}

    def _scatter(self, reqs: list[dict], out: dict, n: int) -> None:
        """Deliver the `[:n]` host outputs to the waiting submitters."""
        row = 0
        for r in reqs:
            sl = slice(row, row + r["n"])
            r["out"] = {k: v[sl] for k, v in out.items()}
            row += r["n"]
            r["event"].set()
        self.batches_run += 1
        self.rows_served += n

    def _run(self, reqs: list[dict]) -> None:
        host, n, event, t0 = self._dispatch(reqs)
        self._scatter(reqs, self._materialize(host, event, t0), n)

    def stop(self) -> None:
        with self._batch_ready:
            self._stop = True
            self._batch_ready.notify_all()
        self._thread.join(timeout=5.0)
        # Unblock submitters that raced the shutdown (drained under the
        # lock: one may still be appending).
        with self._batch_ready:
            pending, self._pending = self._pending, deque()
        for r in pending:
            r["error"] = RuntimeError("inference server stopped")
            r["event"].set()
