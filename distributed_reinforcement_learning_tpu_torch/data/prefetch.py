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

`h2d_ms()` reads the device time of the copies (CUDA events on the copy
stream around each batch's copies, after its device buffers are
allocated). Not ported: `stack_calls` (several batches a call) and
`reconfigure`; they come with `updates_per_call`.
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

    def __init__(self, source: Any, batch_size: int, device: torch.device):
        self.source = source  # TrajectoryQueue-like: take(batch_size, timeout), closed
        self.batch_size = batch_size
        self.device = torch.device(device)
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

    def _loop_inner(self) -> None:
        n = 0
        while not self._stop.is_set():
            items = self._take()
            if items is None:
                return
            if self._cuda:
                out = self._to_device(items, self._slots[n % len(self._slots)])
            else:
                out = (stack_pytrees(items), None)
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
                batch, done = self._out.get(timeout=wait)
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
