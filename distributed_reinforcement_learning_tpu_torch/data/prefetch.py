"""Host -> device batch prefetcher: overlap the H2D copy with compute.

Counterpart of the JAX package's `data/prefetch.py` (`DevicePrefetcher`,
one batch stacked at a time). A background thread dequeues batch k+1
while batch k trains:

- On CUDA it stacks the `batch_size` dequeued trajectories straight into
  a pinned host buffer (no pageable `np.stack` first), issues the H2D
  copy with `non_blocking=True` on its own CUDA stream and records an
  event behind it. `get_batch` makes the caller's current (compute)
  stream wait on that event and marks each device tensor as used on
  that stream (`record_stream`), so the caching allocator cannot hand
  its memory out again while the learn step still reads it.
- One batch waits on the device beside the one in use (double
  buffering); there are two pinned buffers, used in turn; each carries
  the event of its last copy, and the thread waits on that event before
  it refills the buffer.
- On the CPU it stacks and hands the numpy batch over, with no stream:
  the learn step then sees exactly what `TrajectoryQueue.get_batch`
  would have given it.

`stack_calls` K > 1 (the K-update learners' `updates_per_call`) makes
each `get_batch` a `[K, B, ...]` stack of K dequeued batches, stacked on
the background thread with `np.stack` and copied from pageable memory:
as in the JAX package, the pinned pool serves only K == 1, since a stack
holds K batches alive at once. `reconfigure` changes K later: the live
setting is one `(K, epoch)` tuple swapped by the controlling thread and
read once a round by the prefetch thread; batches stacked under an older
epoch are dropped at `get_batch` (counted in `dropped_batches`), so a
changed K never hands the learner a stack of the old shape. Over a mesh
(`sharding`) the rows are one rank's, placed on its device like any
batch; K > 1 then needs `stack_sharding`, as in the JAX package.

`h2d_ms()` reads the device time of the copies (CUDA events on the copy
stream around each batch's copies, after its device buffers are
allocated).
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.data.fifo import stack_pytrees


def _fields(item: Any) -> dict[str, np.ndarray]:
    if hasattr(item, "_fields"):
        return item._asdict()
    if isinstance(item, dict):
        return item
    raise TypeError(f"cannot prefetch a {type(item).__name__}: a namedtuple or dict "
                    "of arrays is needed")


def _check_stack(k: int, sharding: Any, stack_sharding: Any) -> None:
    if k > 1 and sharding is not None and stack_sharding is None:
        raise ValueError("stack_calls > 1 over a mesh needs stack_sharding "
                         "(a [K, B, ...] spec with the batch dim on the data axis)")


class _PinnedSlot:
    """One set of pinned host buffers, their device copies and the event
    of the last copy out of them."""

    def __init__(self):
        self.host: dict[str, torch.Tensor] = {}
        self.copied: torch.cuda.Event | None = None

    def buffers(self, first: dict[str, np.ndarray], n: int) -> dict[str, np.ndarray]:
        """numpy views of pinned buffers shaped `[n, *leaf.shape]` (made
        anew when the layout changes)."""
        for k, v in first.items():
            arr = np.asarray(v)
            shape = (n, *arr.shape)
            t = self.host.get(k)
            if t is None or tuple(t.shape) != shape or t.numpy().dtype != arr.dtype:
                self.host[k] = torch.from_numpy(np.empty(shape, arr.dtype)).pin_memory()
        return {k: self.host[k].numpy() for k in first}


class DevicePrefetcher:
    """Background dequeue + H2D pipeline over a TrajectoryQueue.

    `get_batch(timeout)` returns the next batch (device tensors on CUDA,
    numpy on the CPU) as the items' namedtuple (or dict), or None on
    timeout, the queue's own surface, so a learner can swap it in.
    """

    def __init__(self, source: Any, batch_size: int, device: torch.device,
                 stack_calls: int = 1, sharding: Any | None = None,
                 stack_sharding: Any | None = None):
        self.source = source  # TrajectoryQueue-like: take(batch_size, timeout), closed
        self.batch_size = batch_size
        self.device = torch.device(device)
        # Over a mesh (`sharding`, a `parallel/mesh.Placement` of the data
        # axis) the dequeued rows are this rank's shard, copied to its
        # device as any batch is; a K-stack needs its own placement
        # (`stack_sharding`: B on the data axis, K whole), as in JAX.
        self.sharding = sharding
        k = max(1, int(stack_calls))
        _check_stack(k, sharding, stack_sharding)
        self._cfg: tuple[int, Any, int] = (k, stack_sharding, 0)  # (K, stack placement, epoch)
        self.dropped_batches = 0  # dequeued but never trained
        self._cuda = self.device.type == "cuda"
        self._out: _queue.Queue = _queue.Queue(maxsize=1)
        self._slots = [_PinnedSlot(), _PinnedSlot()] if self._cuda else []
        self._stream = torch.cuda.Stream(device=self.device) if self._cuda else None
        self._timing: deque = deque(maxlen=256)  # (start, end) events of each copy
        self.batches = 0  # handed to the learner
        self._error: BaseException | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="device-prefetch")
        self._thread.start()

    @property
    def stack_calls(self) -> int:
        return self._cfg[0]

    @property
    def stack_sharding(self):
        return self._cfg[1]

    def reconfigure(self, stack_calls: int, stack_sharding: Any | None = None) -> None:
        """Change the stack depth K (and the stack's placement, kept when
        None): the next round stacks at the new K, and batches already
        stacked at the old one are dropped at `get_batch`. Called from
        the learner's controlling thread (one reference swap, which the
        prefetch thread reads once a round)."""
        k = max(1, int(stack_calls))
        cur, cur_sharding, epoch = self._cfg
        if stack_sharding is None:
            stack_sharding = cur_sharding
        _check_stack(k, self.sharding, stack_sharding)
        if k != cur or stack_sharding is not cur_sharding:
            self._cfg = (k, stack_sharding, epoch + 1)

    def _loop(self) -> None:
        try:
            self._loop_inner()
        except BaseException as e:  # noqa: BLE001 — surfaced by get_batch
            self._error = e

    def _take(self) -> list | None:
        """The next `batch_size` items, or None once stopped or closed."""
        while not self._stop.is_set():
            try:
                items = self.source.take(self.batch_size, timeout=0.2)
            except RuntimeError:
                if getattr(self.source, "closed", False):
                    return None
                raise
            if items is not None:
                return items
            if getattr(self.source, "closed", False):
                return None
        return None

    def _to_device(self, items: list, slot: _PinnedSlot):
        """Stack `items` into the slot's pinned buffers and enqueue their
        H2D copy on the copy stream -> (device batch, copy-done event)."""
        if slot.copied is not None:
            slot.copied.synchronize()  # the last copy out of these buffers
        rows = [_fields(it) for it in items]
        host = slot.buffers(rows[0], len(rows))
        for i, row in enumerate(rows):
            for k, dst in host.items():
                dst[i] = row[k]
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._stream):
            # Allocate first, so that the timed window holds the copies
            # alone (a fresh cudaMalloc can wait for the device).
            dev = {k: torch.empty(slot.host[k].shape, dtype=slot.host[k].dtype,
                                  device=self.device) for k in host}
            start.record(self._stream)
            for k, t in dev.items():
                t.copy_(slot.host[k], non_blocking=True)
            done.record(self._stream)
        slot.copied = done
        self._timing.append((start, done))
        first = items[0]
        batch = type(first)(**dev) if hasattr(first, "_fields") else dev
        return batch, done

    def _stack_to_device(self, parts: list[list]):
        """`[K, B, ...]`-stack K dequeued batches (pageable) and enqueue
        their H2D copy on the copy stream -> (device batch, copy-done
        event)."""
        stacked = stack_pytrees([stack_pytrees(items) for items in parts])
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in _fields(stacked).items()}
        with torch.cuda.stream(self._stream):
            dev = {k: torch.empty_like(h, device=self.device) for k, h in host.items()}
            start.record(self._stream)
            for k, t in dev.items():
                t.copy_(host[k])
            done.record(self._stream)
        self._timing.append((start, done))
        batch = type(stacked)(**dev) if hasattr(stacked, "_fields") else dev
        return batch, done

    def _loop_inner(self) -> None:
        n = 0
        while not self._stop.is_set():
            # One read a round: a reconfigure lands at the next round.
            k, _, epoch = self._cfg
            parts = []
            while len(parts) < k:
                items = self._take()
                if items is None:
                    self.dropped_batches += len(parts)  # stopped mid-stack
                    return
                parts.append(items)
            if k > 1:
                out = (self._stack_to_device(parts) if self._cuda
                       else (stack_pytrees([stack_pytrees(p) for p in parts]), None))
            elif self._cuda:
                out = self._to_device(parts[0], self._slots[n % len(self._slots)])
            else:
                out = (stack_pytrees(parts[0]), None)
            out = (*out, k, epoch)
            n += 1
            while True:
                try:
                    self._out.put(out, timeout=0.2)
                    break
                except _queue.Full:
                    if self._stop.is_set():
                        return

    def get_batch(self, timeout: float | None = None) -> Any | None:
        """The next batch; None on timeout. Raises if the prefetch thread
        died. On CUDA the caller's current stream waits for the batch's
        copy before anything it enqueues next."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            wait = 0.2 if deadline is None else max(0.0, min(0.2, deadline - time.monotonic()))
            try:
                batch, done, k, epoch = self._out.get(timeout=wait)
                if epoch != self._cfg[2]:
                    self.dropped_batches += k  # stacked at a depth since changed
                    continue
                break
            except _queue.Empty:
                if self._error is not None:
                    raise RuntimeError("prefetch thread died") from self._error
                if deadline is not None and time.monotonic() >= deadline:
                    return None
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in (batch._asdict() if hasattr(batch, "_fields") else batch).values():
                t.record_stream(stream)
        self.batches += 1
        return batch

    def h2d_ms(self) -> list[float]:
        """Device ms of each of the last (up to 256) H2D copies; waits for
        them to finish. Empty on the CPU."""
        out = []
        for start, done in list(self._timing):
            done.synchronize()
            out.append(start.elapsed_time(done))
        return out

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
