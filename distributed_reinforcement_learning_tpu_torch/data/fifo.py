"""Bounded trajectory FIFO with blocking backpressure.

Counterpart of the JAX package's `data/fifo.py`: a thread-safe bounded
queue of numpy trajectories. Producers (actor threads or the transport
server) block when it is full, and the learner drains a whole batch in
one call as stacked `[B, ...]` arrays (or, through `take`, as the list
of items, which the device prefetcher stacks straight into pinned
memory). `blob_ingest` feeds codec blobs from the wire into it.

The C++ ring-buffer backend is `data/native.py`'s `NativeTrajectoryQueue`
(the learner server's queue wherever the library builds). Not ported:
the replay-shard ingest facade.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any

import numpy as np

from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS


def stack_pytrees(items: list[Any]) -> Any:
    """Stack NamedTuples of numpy arrays (or arrays) along a new axis 0.
    A namedtuple decoded from the wire (`codec.decode` rebuilds one with
    the same name and fields) stacks into its own class."""
    first = items[0]
    if isinstance(first, tuple):
        return type(first)(*(np.stack(xs) for xs in zip(*items)))
    if isinstance(first, dict):
        return {k: np.stack([it[k] for it in items]) for k in first}
    return np.stack(items)


def tree_map(fn, *trees):
    """`fn` over the array leaves of NamedTuples, dicts and arrays (the
    batches the queues and replays hold), keeping the structure."""
    first = trees[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The array leaves of `tree`, in `tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def blob_ingest(queue: Any) -> tuple[Any, Any]:
    """-> (prepare, put) for feeding codec blobs into a trajectory queue.

    - A blob-native queue (`put_bytes`, the C++ backend) takes the raw
      bytes, routed through `codec.unpack_blob` (after `strip_stamp`) so
      that a dedup-packed blob reaches the queue in the plain layout its
      batch gather assumes; `put_bytes` copies them before it returns.
    - A pytree queue takes a decoded COPY: the blob's buffer may be
      reused by the caller the moment `prepare` returns (the transport
      server's per-connection receive buffer), and decode reconstructs
      a dedup-packed blob bit-identically as part of that copy.

    `put(item, timeout=...)` follows the queue's blocking-put contract
    (False on timeout, RuntimeError once closed)."""
    from distributed_reinforcement_learning_tpu_torch.data import codec

    if hasattr(queue, "put_bytes"):
        return (lambda blob: codec.unpack_blob(codec.strip_stamp(blob))), queue.put_bytes
    return (lambda blob: codec.decode(blob, copy=True)), queue.put


def put_batch_size() -> int:
    """How many unrolls ride one batched exchange (`DRL_PUT_BATCH`). 0
    (the default) ships the whole `extract()` round in one exchange."""
    try:
        return max(0, int(os.environ.get("DRL_PUT_BATCH", "0") or 0))
    except ValueError:
        return 0


def put_round(queue: Any, items: list[Any]) -> None:
    """Ship one actor round (the N trajectories of an `extract()`),
    batched when the queue supports it: over the socket data plane
    `put_many` is one round trip for the whole round. `DRL_PUT_BATCH=k`
    chunks the round into k-unroll exchanges."""
    put_many = getattr(queue, "put_many", None)
    if put_many is None:
        for item in items:
            queue.put(item)
        return
    chunk = put_batch_size()
    if chunk <= 0 or chunk >= len(items):
        put_many(items)
    else:
        for i in range(0, len(items), chunk):
            put_many(items[i:i + chunk])


class TrajectoryQueue:
    """Bounded MPMC queue of trajectory pytrees.

    put() blocks when full (backpressure on actors); get_batch(n) blocks
    until n items are available and returns them stacked along a new
    leading batch axis; take(n) returns them unstacked. close() wakes
    every blocked producer and consumer; later puts raise.
    """

    _GUARDED_BY = {
        "_items": ("_lock", "_not_full", "_not_empty"),
        "_closed": ("_lock", "_not_full", "_not_empty"),
    }

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._items: deque = deque()
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def size(self) -> int:
        return len(self)

    def close(self) -> None:
        """Wake all blocked producers/consumers; subsequent puts raise."""
        with self._lock:
            self._closed = True
            self._not_full.notify_all()
            self._not_empty.notify_all()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def put(self, item: Any, timeout: float | None = None) -> bool:
        with self._not_full:
            if not self._not_full.wait_for(
                    lambda: len(self._items) < self.capacity or self._closed, timeout):
                return False
            if self._closed:
                raise RuntimeError("queue closed")
            self._items.append(item)
            depth = len(self._items)
            self._not_empty.notify()
        if _OBS.enabled:
            _OBS.count("fifo/puts")
            _OBS.gauge("fifo/fill", depth / self.capacity)
        return True

    def put_many(self, items: list[Any], timeout: float | None = None) -> int:
        """Enqueue items in order; -> how many were accepted. Stops at the
        first timeout (the rest is NOT enqueued)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        accepted = 0
        for item in items:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            if not self.put(item, timeout=remaining):
                break
            accepted += 1
        return accepted

    def get(self, timeout: float | None = None) -> Any | None:
        with self._not_empty:
            if not self._not_empty.wait_for(lambda: self._items or self._closed, timeout):
                return None
            if not self._items:  # closed and drained
                return None
            item = self._items.popleft()
            self._not_full.notify()
        if _OBS.enabled:
            _OBS.count("fifo/gets")
        return item

    def take(self, batch_size: int, timeout: float | None = None) -> list[Any] | None:
        """Dequeue `batch_size` items, unstacked.

        `timeout` is a total deadline across the whole batch. On timeout
        the items already taken go back to the FRONT of the queue in
        order (no loss, no reordering) and None is returned.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        items = []
        for _ in range(batch_size):
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            item = self.get(remaining)
            if item is None:
                if items:
                    with self._lock:
                        self._items.extendleft(reversed(items))
                        self._not_empty.notify_all()
                return None
            items.append(item)
        return items

    def get_batch(self, batch_size: int, timeout: float | None = None) -> Any | None:
        """`take`, stacked into `[B, ...]` arrays."""
        items = self.take(batch_size, timeout)
        return None if items is None else stack_pytrees(items)
