"""Versioned weight publication: learner -> actors.

Counterpart of the JAX package's `runtime/weights.py`. The learner
publishes a version-stamped snapshot; in-process actors poll
`get_if_newer` once per unroll and get the snapshot's tensors on the
learner's device; the transport server serves `get_blob`, the snapshot
encoded once per version as a codec blob of the flat `{name: ndarray}`
dict of the port's parameter names.

Every publish CLONES the parameters on the device first: the learner
updates them in place (`agents/common.py`), so a consumer holding the
live tensors would read a later step than the version it recorded (JAX
arrays are immutable; the JAX store never had this hazard). The clone
is enqueued on the caller's current stream, so it reads the parameters
as they stand after every step already enqueued and before any step
enqueued later.

- `publish` (synchronous): the clone is the snapshot; its blob is
  encoded when the transport first asks for it (`get_blob`), once per
  version, so an in-process run never pays the device-to-host copy.
- `publish_async`: the clone is the only work on the caller's thread.
  One background worker, latest submit wins, copies the clone into
  pinned host buffers on a side CUDA stream (after an event recorded
  behind the clone), waits for that copy, encodes the blob and lands
  the version. `flush_async` waits for the worker; `close` retires it,
  and a later `publish_async` publishes synchronously.

Not ported: sharded publication (`sharded` is always False, so the
transport server answers the shard-scoped op as for an unsharded store)
and the shm weight board.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.data import codec
from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS


def _device_clone(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    with torch.no_grad():
        return {k: v.detach().clone() for k, v in params.items()}


class WeightStore:
    _GUARDED_BY = {
        "_params": "_lock",
        "_blob": "_lock",
        "_version": "_lock",
        "_applied_seq": "_lock",
        "_seq": ("_async_lock", "_cond"),
        "_pending": ("_async_lock", "_cond"),
        "_busy": ("_async_lock", "_cond"),
        "_closed": ("_async_lock", "_cond"),
        "_worker": ("_async_lock", "_cond"),
    }
    _NOT_GUARDED = {
        "_pinned": "publish worker only",
        "_stream": "publish worker only",
        "land_ms": "appended by the publish worker only; deque appends are atomic",
    }

    # The port publishes whole blobs only (see the module docstring).
    sharded = False

    def __init__(self):
        self._lock = threading.Lock()
        self._params: dict[str, torch.Tensor] | None = None
        self._blob: np.ndarray | None = None
        self._version = -1
        self._applied_seq = 0
        # Async publication: races are arbitrated by SUBMISSION order
        # (`_seq`), not by version: a checkpoint restore may republish
        # a lower version, and the last submit must win.
        self._async_lock = threading.Lock()
        self._cond = threading.Condition(self._async_lock)
        self._seq = 0
        self._pending: tuple | None = None
        self._busy = False
        self._worker: threading.Thread | None = None
        self._closed = False
        self._pinned: dict[str, torch.Tensor] | None = None
        self._stream = None
        # Submit-to-landed ms of each async publication (the last 1024).
        self.land_ms: deque = deque(maxlen=1024)

    def _next_seq(self) -> int:
        with self._async_lock:
            self._seq += 1
            return self._seq

    def _apply(self, snap: dict[str, torch.Tensor], blob: np.ndarray | None, version: int,
               seq: int) -> None:
        with self._lock:
            applied = seq >= self._applied_seq
            if applied:
                self._params, self._blob = snap, blob
                self._version, self._applied_seq = version, seq
        if applied and _OBS.enabled:
            _OBS.gauge("weights/version", version)

    def publish(self, params: dict[str, torch.Tensor], version: int) -> None:
        """Store a device snapshot of `params` as `version`."""
        self._apply(_device_clone(params), None, version, self._next_seq())

    def publish_async(self, params: dict[str, torch.Tensor], version: int) -> None:
        """Versioned publish off the caller's critical path: clone on the
        device now, copy to the host and land on the worker (latest submit
        wins). After close(), publishes synchronously."""
        snap = _device_clone(params)
        ready = None
        first = next(iter(snap.values()))
        if first.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(first.device))
        with self._cond:
            closed = self._closed
            if not closed:
                self._seq += 1
                self._pending = (snap, ready, version, self._seq, time.perf_counter())
                if self._worker is None:
                    self._worker = threading.Thread(
                        target=self._drain, daemon=True, name="weights-publish")
                    self._worker.start()
                self._cond.notify_all()
        if closed:
            self.publish(params, version)

    def _host_blob(self, snap: dict[str, torch.Tensor], ready) -> np.ndarray:
        """The snapshot's blob: on CUDA through pinned buffers on a side
        stream that waits on `ready`, then one wait for the copies."""
        first = next(iter(snap.values()))
        if not first.is_cuda:
            return codec.encode({k: v.numpy() for k, v in snap.items()}, cache=True)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=first.device)
        if self._pinned is None or any(
                k not in self._pinned or self._pinned[k].shape != v.shape
                for k, v in snap.items()):
            self._pinned = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                            for k, v in snap.items()}
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(ready)
            for k, v in snap.items():
                v.record_stream(self._stream)  # read on this stream: keep its memory
                self._pinned[k].copy_(v, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        done.synchronize()
        # encode copies the pinned bytes out, so the next publish may
        # refill the same buffers.
        return codec.encode({k: self._pinned[k].numpy() for k in snap}, cache=True)

    def _drain(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._closed:
                    self._cond.wait(timeout=5.0)
                if self._pending is None:
                    return  # closed and drained
                item, self._pending = self._pending, None
                self._busy = True
            snap, ready, version, seq, t_submit = item
            try:
                blob = self._host_blob(snap, ready)
                self._apply(snap, blob, version, seq)
                self.land_ms.append((time.perf_counter() - t_submit) * 1e3)
            except Exception as e:  # noqa: BLE001 — drop the item, keep the worker:
                import sys  # a dead worker would freeze actor weights for good

                print(f"[weights] WARNING: async publish of version {version} failed: "
                      f"{e!r}", file=sys.stderr)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def flush_async(self, timeout: float = 30.0) -> bool:
        """Block until every pending async publish has landed."""
        with self._cond:
            return self._cond.wait_for(
                lambda: self._pending is None and not self._busy, timeout)

    def close(self) -> None:
        self.flush_async()
        with self._cond:
            self._closed = True
            worker = self._worker
            self._cond.notify_all()
        if worker is not None:
            worker.join(timeout=5.0)

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def get(self) -> tuple[Any, int]:
        with self._lock:
            return self._params, self._version

    def get_blob(self) -> tuple[np.ndarray | None, int]:
        """(encoded blob, version) of the current snapshot, encoded once
        per version; (None, -1) before the first publish. The buffer is
        shared by every pull: read-only by contract."""
        with self._lock:
            if self._blob is None and self._params is not None:  # a synchronous D2H
                self._blob = codec.encode(
                    {k: v.cpu().numpy() for k, v in self._params.items()}, cache=True)
            return self._blob, self._version

    def get_if_newer(self, have_version: int) -> tuple[Any, int] | None:
        """None if the caller already holds the newest version."""
        with self._lock:
            if self._version <= have_version:
                return None
            return self._params, self._version
