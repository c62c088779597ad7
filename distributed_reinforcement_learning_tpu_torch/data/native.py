"""ctypes bindings for the C++ data plane (`cpp/ring_queue.cc`,
`sumtree.cc`, `batch_stack.cc`).

Counterpart of the JAX package's `data/native.py`, over the port's own
copy of the sources under `cpp/` (its sum tree adds an exact
export/import for checkpoints). The port never loads the JAX package's
library. Public:

- `NativeByteQueue`: bounded MPMC blob queue with backpressure.
- `NativeTrajectoryQueue`: the `fifo.TrajectoryQueue` surface
  (put/get/take/get_batch/size/close) with pytrees crossing the C++
  queue as codec blobs; `put_bytes` lets the transport server enqueue
  wire payloads without a decode/encode round trip.
- `NativeSumTree`: batch add/sample/update priority tree; payloads stay
  in Python.

The library builds on first use with `g++ -O2 -std=c++17 -fPIC -shared
... -lpthread` into `cpp/build/`, under the `fcntl` build lock of
`ops/kernels/_build.py` (a learner and its actor processes may start at
once): g++ writes a per-process temporary name that is renamed into
place, and the file name carries a hash of the sources and flags, so an
edited source builds anew. `native_available()` says whether it builds
and loads here; `build(force=True)` compiles it anew.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np

from distributed_reinforcement_learning_tpu_torch.data import codec
from distributed_reinforcement_learning_tpu_torch.data.fifo import stack_pytrees
from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS

CPP_DIR = Path(__file__).resolve().parents[1] / "cpp"
BUILD_DIR = CPP_DIR / "build"
SOURCES = ("ring_queue.cc", "sumtree.cc", "batch_stack.cc")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_RQ_OK, _RQ_TIMEOUT, _RQ_CLOSED, _RQ_TOO_SMALL = 0, -1, -2, -3

_lib = None
_lib_path: Path | None = None
_lib_lock = threading.Lock()
_build_error: str | None = None


def library_path() -> Path:
    """Where the library of the current sources lives."""
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update((CPP_DIR / src).read_bytes())
    return BUILD_DIR / f"libdistrl_native-{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile the library unless it is there (always with `force`), under
    the cross-process build lock; -> its path. Raises RuntimeError with
    the compiler's output on failure."""
    from distributed_reinforcement_learning_tpu_torch.ops.kernels._build import build_lock

    lib = library_path()
    with build_lock(BUILD_DIR):
        if lib.exists() and not force:
            return lib
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
               *[str(CPP_DIR / s) for s in SOURCES], "-lpthread"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"native library build failed ({' '.join(cmd)}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib)
        except OSError as e:  # no compiler
            raise RuntimeError(f"native library build failed: {e}") from e
        finally:
            tmp.unlink(missing_ok=True)
    return lib


def loaded_path() -> Path | None:
    """The library file this process has loaded, or None."""
    return _lib_path


def _load():
    global _lib, _lib_path, _build_error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise RuntimeError(f"native library unavailable: {_build_error}")
        try:
            path = build()
            lib = ctypes.CDLL(str(path))
        except (RuntimeError, OSError) as e:
            _build_error = str(e)
            raise RuntimeError(f"native library unavailable: {e}") from e

        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        sigs = {
            "rq_create": ([ctypes.c_int64], ctypes.c_void_p),
            "rq_destroy": ([ctypes.c_void_p], None),
            "rq_size": ([ctypes.c_void_p], ctypes.c_int64),
            "rq_close": ([ctypes.c_void_p], None),
            "rq_put": ([ctypes.c_void_p, u8p, ctypes.c_int64, ctypes.c_double], ctypes.c_int64),
            "rq_peek_size": ([ctypes.c_void_p, ctypes.c_double], ctypes.c_int64),
            "rq_get": ([ctypes.c_void_p, u8p, ctypes.c_int64, ctypes.c_double], ctypes.c_int64),
            "rq_get_batch": (
                [ctypes.c_void_p, ctypes.c_int64, u8p, ctypes.c_int64, i64p, ctypes.c_double],
                ctypes.c_int64,
            ),
            "st_create": ([ctypes.c_int64], ctypes.c_void_p),
            "st_destroy": ([ctypes.c_void_p], None),
            "st_total": ([ctypes.c_void_p], ctypes.c_double),
            "st_size": ([ctypes.c_void_p], ctypes.c_int64),
            "st_leaf_priority": ([ctypes.c_void_p, ctypes.c_int64], ctypes.c_double),
            "st_leaf_priorities": (
                [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, f64p], None),
            "st_add_batch": ([ctypes.c_void_p, f64p, ctypes.c_int64, i64p], None),
            "st_update_batch": ([ctypes.c_void_p, i64p, f64p, ctypes.c_int64], None),
            "st_get_batch": ([ctypes.c_void_p, f64p, ctypes.c_int64, i64p, f64p], None),
            "st_export": ([ctypes.c_void_p, f64p, i64p, i64p], None),
            "st_import": ([ctypes.c_void_p, f64p, ctypes.c_int64, ctypes.c_int64], None),
            "bs_all_equal_prefix": (
                [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64],
                ctypes.c_int64,
            ),
            "bs_gather": (
                [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, u8p],
                None,
            ),
        }
        for name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib, _lib_path = lib, path
        return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


def _as_u8p(buf) -> Any:
    if isinstance(buf, memoryview):
        buf = np.frombuffer(buf, np.uint8)  # zero-copy
    if isinstance(buf, np.ndarray):
        return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    return (ctypes.c_uint8 * len(buf)).from_buffer(buf) if isinstance(buf, bytearray) else \
        ctypes.cast(ctypes.c_char_p(buf), ctypes.POINTER(ctypes.c_uint8))


class NativeByteQueue:
    """Bounded MPMC queue of byte blobs backed by cpp/ring_queue.cc."""

    def __init__(self, capacity: int):
        self._lib = _load()
        self._h = self._lib.rq_create(capacity)
        if not self._h:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._closed = False

    def __len__(self) -> int:
        return int(self._lib.rq_size(self._h))

    def size(self) -> int:
        return len(self)

    def close(self) -> None:
        self._closed = True
        self._lib.rq_close(self._h)

    @property
    def closed(self) -> bool:
        return self._closed

    def put(self, blob: bytes, timeout: float | None = None) -> bool:
        rc = self._lib.rq_put(
            self._h, _as_u8p(blob), len(blob), -1.0 if timeout is None else timeout
        )
        if rc == _RQ_CLOSED:
            raise RuntimeError("queue closed")
        return rc == _RQ_OK

    def peek_size(self, timeout: float | None = None) -> int | None:
        size = self._lib.rq_peek_size(self._h, -1.0 if timeout is None else timeout)
        return None if size < 0 else int(size)

    def get(self, timeout: float | None = None) -> bytes | None:
        # `timeout` is a total deadline across the peek + pop (+ regrow) calls.
        deadline = None if timeout is None else time.monotonic() + timeout
        remaining = lambda: -1.0 if deadline is None else max(0.0, deadline - time.monotonic())
        size = self._lib.rq_peek_size(self._h, remaining())
        if size < 0:
            return None
        buf = bytearray(int(size) + 256)  # slack: a racing consumer may swap heads
        while True:
            n = self._lib.rq_get(self._h, _as_u8p(buf), len(buf), remaining())
            if n == _RQ_TOO_SMALL:
                size = self._lib.rq_peek_size(self._h, remaining())
                if size < 0:
                    return None
                buf = bytearray(int(size) + 256)
                continue
            if n < 0:
                return None
            return bytes(buf[: int(n)])

    def get_batch_raw(self, n: int, item_cap: int, timeout: float | None = None,
                      scratch: np.ndarray | None = None):
        """Pop n blobs in ONE native call -> (buffer, stride, lens);
        None on timeout (nothing consumed).

        If an item exceeds `item_cap`, the stride doubles and the call
        retries within the same deadline (rather than masquerading as a
        timeout and livelocking the caller).

        `scratch`: optional reusable destination (grown copies are
        returned instead when too small). Callers that pass it must not
        let views of the returned buffer escape past their next call.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        lens = np.zeros(n, np.int64)
        while True:
            # np.empty, not bytearray: a bytearray memsets its whole
            # length, and at Atari shapes that zero-fill of ~2x the
            # payload dominated the entire batch pop (~10ms for a 72MB
            # stride buffer on this host). A reused scratch additionally
            # skips the page-fault cost of a fresh mapping per batch.
            if scratch is not None and len(scratch) >= n * item_cap:
                buf = scratch
            else:
                buf = np.empty(n * item_cap, np.uint8)
            rc = self._lib.rq_get_batch(
                self._h,
                n,
                _as_u8p(buf),
                item_cap,
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                -1.0 if deadline is None else max(0.0, deadline - time.monotonic()),
            )
            if rc == _RQ_TOO_SMALL:
                item_cap *= 2
                continue
            if rc != _RQ_OK:
                return None
            return buf, item_cap, lens

    def get_batch_blobs(self, n: int, item_cap: int, timeout: float | None = None):
        """Pop n blobs -> list of memoryviews; None on timeout."""
        raw = self.get_batch_raw(n, item_cap, timeout)
        if raw is None:
            return None
        buf, stride, lens = raw
        view = memoryview(buf)
        return [view[i * stride : i * stride + int(lens[i])] for i in range(n)]

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rq_destroy(self._h)
            self._h = None


class NativeTrajectoryQueue:
    """`fifo.TrajectoryQueue` interface over the C++ byte queue.

    Pytrees are codec-encoded on put and decoded on get; the transport
    server can `put_bytes` wire payloads directly (no re-serialize). The
    blob size of the first item fixes the batch-dequeue stride, so all
    trajectories in one queue must share a schema — true by construction
    (fixed unroll shapes, like the reference's fixed-shape placeholders at
    `buffer_queue.py:40-50`).
    """

    supports_pooled_get = True  # DevicePrefetcher keys pooled dequeue on this
    # How many pooled output sets get_batch(pooled=True) rotates through.
    # A consumer that confirms the previous transfer completed before its
    # next pooled call (DevicePrefetcher does) needs only 2.
    POOL_SETS = 2

    # Concurrency map (tools/drlint lock-discipline): the reusable batch
    # scratch and the pooled output sets may only be touched by the
    # consumer that won the try-acquire on `_scratch_lock` (get_batch) —
    # losers fall back to fresh allocations. `_item_cap` is deliberately
    # unannotated: it is a monotonic int hint racily grown by producers
    # AND consumers, and a lost update only costs one stride-regrow
    # retry on a later pop, never correctness. The C++ queue itself is
    # internally synchronized (cpp/ring_queue.cc).
    _GUARDED_BY = {
        "_scratch": "_scratch_lock",
        "_pool": "_scratch_lock",
        "_pool_sig": "_scratch_lock",
        "_pool_idx": "_scratch_lock",
    }
    _NOT_GUARDED = {
        "_item_cap": "monotonic int hint racily grown by producers and "
                     "consumers; a lost update costs one stride-regrow "
                     "retry on a later pop, never correctness",
    }

    def __init__(self, capacity: int):
        self._q = NativeByteQueue(capacity)
        self.capacity = capacity
        self._item_cap = 0  # learned from the first put
        # Reused batch-pop destination: every view taken of it in
        # get_batch is copied into the returned arrays before the next
        # call can overwrite it. The try-lock keeps concurrent consumers
        # correct (the loser of the race pays a fresh allocation instead
        # of sharing the buffer) — the queue itself stays MPMC.
        self._scratch = np.empty(0, np.uint8)
        self._scratch_lock = threading.Lock()
        # Pooled field outputs (get_batch(pooled=True)): the decoded batch
        # arrays themselves are reused across calls, killing the
        # ~batch-sized np.empty + page-fault cost per dequeue. Rotates
        # POOL_SETS sets; callers own the safety contract (see get_batch).
        self._pool: list[list[np.ndarray] | None] = [None] * self.POOL_SETS
        self._pool_sig: tuple | None = None
        self._pool_idx = 0

    def __len__(self) -> int:
        return len(self._q)

    def size(self) -> int:
        return len(self._q)

    def close(self) -> None:
        self._q.close()

    @property
    def closed(self) -> bool:
        return self._q.closed

    def put(self, item: Any, timeout: float | None = None) -> bool:
        return self.put_bytes(codec.encode(item), timeout)

    def put_bytes(self, blob: bytes, timeout: float | None = None) -> bool:
        if len(blob) > self._item_cap:
            self._item_cap = len(blob)
        ok = self._q.put(blob, timeout)
        # Same fifo/* signals as the pure-Python TrajectoryQueue: the
        # default deployment uses THIS queue (native_available()), and
        # the transport server's raw path enters here via put_bytes.
        if ok and _OBS.enabled:
            _OBS.count("fifo/puts")
            _OBS.gauge("fifo/fill", len(self._q) / self.capacity)
        return ok

    def put_many(self, items: list[Any], timeout: float | None = None) -> int:
        return self.put_bytes_many([codec.encode(i) for i in items], timeout)

    def put_bytes_many(self, blobs: list[bytes], timeout: float | None = None) -> int:
        """Enqueue encoded blobs; returns how many were accepted (stops at
        the first refusal — the rest is NOT enqueued, callers may retry)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        accepted = 0
        for blob in blobs:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            if not self.put_bytes(blob, remaining):
                break
            accepted += 1
        return accepted

    def get(self, timeout: float | None = None) -> Any | None:
        blob = self._q.get(timeout)
        if blob is None:
            return None
        if _OBS.enabled:
            _OBS.count("fifo/gets")
        return codec.decode(blob, copy=True)

    def take(self, batch_size: int, timeout: float | None = None) -> list[Any] | None:
        """Dequeue `batch_size` items, unstacked (the device prefetcher
        stacks them straight into pinned memory). `timeout` is a total
        deadline; on timeout nothing is consumed and None is returned."""
        deadline = None if timeout is None else time.monotonic() + timeout
        item_cap = self._item_cap
        if item_cap == 0:
            head = self._q.peek_size(timeout)
            if head is None:
                return None
            item_cap = head + 256
        remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
        blobs = self._q.get_batch_blobs(batch_size, item_cap, remaining)
        if blobs is None:
            return None
        if _OBS.enabled:
            _OBS.count("fifo/gets", batch_size)
        return [codec.decode(b, copy=True) for b in blobs]

    def _pooled_outputs_locked(self, batch_size: int, metas: list[dict]) -> list[np.ndarray] | None:
        """Next rotation of reusable gather destinations, or None if the
        schema changed mid-stream (fall back to fresh allocations).
        Caller holds `_scratch_lock` (get_batch's winning try-acquire)."""
        sig = (batch_size, tuple((m["dtype"], tuple(m["shape"])) for m in metas))
        if sig != self._pool_sig:
            self._pool = [None] * self.POOL_SETS
            self._pool_sig = sig
        self._pool_idx = (self._pool_idx + 1) % self.POOL_SETS
        if self._pool[self._pool_idx] is None:
            self._pool[self._pool_idx] = [
                np.empty((batch_size, *codec.meta_layout(m)[1]), codec.meta_layout(m)[0])
                for m in metas
            ]
        return self._pool[self._pool_idx]

    def _take_scratch_locked(self, nbytes: int) -> np.ndarray:
        """Grow-and-return the shared pop destination. Caller holds
        `_scratch_lock` (get_batch's winning try-acquire)."""
        if len(self._scratch) < nbytes:
            self._scratch = np.empty(nbytes, np.uint8)
        return self._scratch

    def _keep_scratch_locked(self, buf: np.ndarray) -> None:
        """Adopt a buffer the native pop regrew past the scratch. Caller
        holds `_scratch_lock`."""
        if len(buf) > len(self._scratch):
            self._scratch = buf

    def get_batch(self, batch_size: int, timeout: float | None = None,
                  pooled: bool = False) -> Any | None:
        """Pop + assemble a `[B, ...]` batch (see class docstring).

        pooled=True returns arrays from a rotating pool of POOL_SETS
        reusable buffer sets instead of fresh allocations. Safety
        contract: the caller must be the queue's only pooled consumer
        and must be done with set k's memory (e.g. confirmed its H2D
        transfer completed) before its (k + POOL_SETS)'th call. Never
        use pooled batches with a backend that may alias host memory
        (JAX CPU arrays can) — the pool would overwrite live training
        data. DevicePrefetcher enforces both.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        item_cap = self._item_cap
        if item_cap == 0:
            # Nothing put through *this* wrapper yet (e.g. learner polling at
            # startup, or a fresh wrapper over a shared queue): size the
            # stride from the head item instead of guessing. Shares the one
            # total deadline with the batch pop below.
            head = self._q.peek_size(timeout)
            if head is None:
                return None
            item_cap = head + 256
        remaining = (
            None if deadline is None else max(0.0, deadline - time.monotonic())
        )
        # The try-lock decides whether this call may use the shared
        # scratch buffer; the lock is held through ASSEMBLY too, because
        # until the gathers/decodes finish, `buf` (== scratch) must not
        # be overwritten by another consumer. A loser of the race just
        # pays a fresh per-call allocation — the queue stays MPMC-safe.
        have_scratch = self._scratch_lock.acquire(blocking=False)
        try:
            scratch = (self._take_scratch_locked(batch_size * item_cap)
                       if have_scratch else None)
            raw = self._q.get_batch_raw(batch_size, item_cap, remaining,
                                        scratch=scratch)
            if raw is None:
                return None
            if _OBS.enabled:
                _OBS.count("fifo/gets", batch_size)
            buf, stride, lens = raw
            if have_scratch:
                self._keep_scratch_locked(buf)  # stride regrew in the pop
            # Persist a regrown stride so later batches don't repeat the
            # doomed small-stride native call (one wasted lock+retry each).
            self._item_cap = max(self._item_cap, stride)
            base = _as_u8p(buf)
            lib = self._q._lib
            skel, metas, payload_start = codec.parse_layout(
                memoryview(buf)[: int(lens[0])])
            # Fast path: every blob shares blob 0's header (one schema per
            # queue — true by construction), so the batch is assembled by L
            # native field gathers instead of N decodes + L np.stacks.
            if batch_size == 1 or lib.bs_all_equal_prefix(
                base, stride, batch_size, payload_start
            ):
                outs = (self._pooled_outputs_locked(batch_size, metas)
                        if pooled and have_scratch else None)
                arrays = []
                for j, meta in enumerate(metas):
                    dtype, shape, nbytes = codec.meta_layout(meta)
                    out = outs[j] if outs is not None else np.empty(
                        (batch_size, *shape), dtype)
                    lib.bs_gather(
                        base, stride, batch_size, payload_start + meta["offset"],
                        nbytes,
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    )
                    arrays.append(out)
                return codec.assemble(skel, arrays)
            # Mixed headers (shouldn't happen in practice): per-blob decode.
            view = memoryview(buf)
            blobs = [view[i * stride : i * stride + int(lens[i])]
                     for i in range(batch_size)]
            return stack_pytrees([codec.decode(b) for b in blobs])
        finally:
            if have_scratch:
                self._scratch_lock.release()


class NativeSumTree:
    """Priority tree backed by cpp/sumtree.cc; same surface as replay.SumTree
    plus batch entry points. Data payloads live in the Python caller."""

    def __init__(self, capacity: int):
        self._lib = _load()
        self._h = self._lib.st_create(capacity)
        if not self._h:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._closed = False

    def __len__(self) -> int:
        return int(self._lib.st_size(self._h))

    @property
    def total(self) -> float:
        return float(self._lib.st_total(self._h))

    def leaf_priority(self, tree_idx: int) -> float:
        return float(self._lib.st_leaf_priority(self._h, tree_idx))

    def leaf_priorities(self, start: int, n: int) -> np.ndarray:
        """Priorities of data slots [start, start+n) in ONE native call."""
        out = np.empty(n, np.float64)
        self._lib.st_leaf_priorities(
            self._h, start, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return out

    def add_batch(self, priorities: np.ndarray) -> np.ndarray:
        """Returns the data slots written (tree idx = slot + capacity - 1)."""
        p = np.ascontiguousarray(priorities, np.float64)
        out = np.empty(len(p), np.int64)
        self._lib.st_add_batch(
            self._h,
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(p),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return out

    def update_batch(self, tree_idxs: np.ndarray, priorities: np.ndarray) -> None:
        i = np.ascontiguousarray(tree_idxs, np.int64)
        p = np.ascontiguousarray(priorities, np.float64)
        self._lib.st_update_batch(
            self._h,
            i.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(i),
        )

    def get_batch(self, values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Subtractive descent per value -> (tree_idxs, priorities)."""
        v = np.ascontiguousarray(values, np.float64)
        idxs = np.empty(len(v), np.int64)
        prios = np.empty(len(v), np.float64)
        self._lib.st_get_batch(
            self._h,
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(v),
            idxs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            prios.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        return idxs, prios

    def export(self) -> tuple[np.ndarray, int, int]:
        """-> (the whole tree, inner sums included; write cursor; count)."""
        tree = np.empty(2 * self.capacity - 1, np.float64)
        write, count = ctypes.c_int64(), ctypes.c_int64()
        self._lib.st_export(self._h, tree.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                            ctypes.byref(write), ctypes.byref(count))
        return tree, int(write.value), int(count.value)

    def import_(self, tree: np.ndarray, write: int, count: int) -> None:
        """Overwrite this tree with `export()`'s output from a tree of the
        same capacity."""
        t = np.ascontiguousarray(tree, np.float64)
        if t.shape != (2 * self.capacity - 1,):
            raise ValueError(f"sum tree of capacity {(len(t) + 1) // 2}, this tree holds "
                             f"{self.capacity}")
        if not (0 <= count <= self.capacity and 0 <= write < self.capacity):
            raise ValueError(f"bad cursor: write {write}, count {count}")
        self._lib.st_import(self._h, t.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                            write, count)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.st_destroy(self._h)
            self._h = None
