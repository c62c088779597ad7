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
  With a weight board attached, the blob is encoded at publish time.
- `publish_async`: the clone is the only work on the caller's thread.
  One background worker, latest submit wins, copies the clone into
  pinned host buffers on a side CUDA stream (after an event recorded
  behind the clone), waits for that copy, encodes the blob and lands
  the version. `flush_async` waits for the worker; `close` retires it,
  and a later `publish_async` publishes synchronously.

`attach_board` mirrors every landed version into a shm weight board
(`runtime/weight_board.py`), as the JAX store's does: the board write is
one memcpy of the encoded blob inside `_apply`, under the store's lock,
so it follows the submission-order rule (a rolled-back version that
lands last is the board's version too). Under `publish_async` the
copy, the encode and the board write all run on the publish worker,
never on the learn thread.

Not ported: sharded publication (`sharded` is always False, so the
transport server answers the shard-scoped op as for an unsharded store;
ROADMAP item 12e).
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


def _encode_host(params: dict[str, torch.Tensor]) -> np.ndarray:
    """The snapshot's blob through a synchronous device-to-host copy."""
    return codec.encode({k: v.cpu().numpy() for k, v in params.items()}, cache=True)


class WeightStore:
    _GUARDED_BY = {
        "_params": "_lock",
        "_blob": "_lock",
        "_version": "_lock",
        "_applied_seq": "_lock",
        "_board": "_lock",
        "_board_writes": "_lock",
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
        "board_write_ms": "appended under _lock by the thread that lands a version; "
                          "deque appends are atomic",
    }

    # The port publishes whole blobs only (see the module docstring).
    sharded = False

    def __init__(self):
        self._lock = threading.Lock()
        self._params: dict[str, torch.Tensor] | None = None
        self._blob: np.ndarray | None = None
        self._version = -1
        self._applied_seq = 0
        self._board = None  # optional shm WeightBoard (attach_board)
        self._board_writes = 0
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
        # Submit-to-landed ms of each async publication (the last 1024);
        # with a board attached a version lands once it is on the board.
        self.land_ms: deque = deque(maxlen=1024)
        # ms of each board write (the memcpy and the meta flip).
        self.board_write_ms: deque = deque(maxlen=1024)

    def _next_seq(self) -> int:
        with self._async_lock:
            self._seq += 1
            return self._seq

    def attach_board(self, board) -> None:
        """Mirror every landed version into a shm weight board. An
        already-published snapshot is written at once (encoded here if
        it has no blob yet), so a late attach never leaves the board
        empty behind live actors."""
        with self._lock:
            self._board = board
            if self._params is not None:
                if self._blob is None:
                    self._blob = _encode_host(self._params)
                self._board_publish_locked(self._version)

    def board_stats(self) -> dict:
        """Board writes so far, the mean ms of the last 1024, and the mean
        ms from an async handoff to its version landing (on the board
        when one is attached)."""
        with self._lock:
            attached, n = self._board is not None, self._board_writes
        writes, land = list(self.board_write_ms), list(self.land_ms)
        return {"attached": attached, "writes": n,
                "write_ms": sum(writes) / len(writes) if writes else None,
                "handoff_to_board_ms": sum(land) / len(land) if land else None}

    def _board_publish_locked(self, version: int) -> None:
        # Failure latches the board off for good (an oversize blob, an
        # unmapped segment at shutdown): the store keeps publishing
        # in-process and over TCP, and closing the writer side lets
        # attached actors demote themselves to TCP pulls.
        board = self._board
        if board is None or self._blob is None:
            return
        t0 = time.perf_counter()
        try:
            board.publish_blob(self._blob, version)
        except Exception as e:  # noqa: BLE001 — the board is an optimization
            self._board = None
            import sys

            try:
                board.close_writer()
            except Exception as ce:  # noqa: BLE001 — segment already gone
                print(f"[weights] WARNING: board close_writer failed during disable: "
                      f"{ce!r}", file=sys.stderr)
            print(f"[weights] WARNING: shm weight board disabled ({e}); actors fall back "
                  f"to TCP pulls", file=sys.stderr)
            return
        self._board_writes += 1
        self.board_write_ms.append((time.perf_counter() - t0) * 1e3)

    def _apply(self, snap: dict[str, torch.Tensor], blob: np.ndarray | None, version: int,
               seq: int) -> None:
        with self._lock:
            applied = seq >= self._applied_seq
            if applied:
                self._params, self._blob = snap, blob
                self._version, self._applied_seq = version, seq
                self._board_publish_locked(version)
        if applied and _OBS.enabled:
            _OBS.gauge("weights/version", version)

    def publish(self, params: dict[str, torch.Tensor], version: int) -> None:
        """Store a device snapshot of `params` as `version` (encoded now
        when a board is attached, which needs the bytes)."""
        snap = _device_clone(params)
        with self._lock:
            board = self._board
        blob = _encode_host(snap) if board is not None else None
        self._apply(snap, blob, version, self._next_seq())

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
                self._blob = _encode_host(self._params)
            return self._blob, self._version

    def get_if_newer(self, have_version: int) -> tuple[Any, int] | None:
        """None if the caller already holds the newest version."""
        with self._lock:
            if self._version <= have_version:
                return None
            return self._params, self._version
