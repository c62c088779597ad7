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

Sharded publication (`WeightStore(sharded=, quant=)`; the default
follows `DRL_WEIGHTS_SHARDED`, off as in the JAX package): a landed
version is also split along the partition-rule shards
(`runtime/weight_shards.py`) into one encode-once blob a shard and one
json manifest, the actors' bytes cast to bfloat16 or int8 when a quant
mode is on (the in-process `get` / `get_if_newer` snapshot never
quantizes). A shard whose `(len, crc)` and bytes equal the previous
version's is unchanged: the board memcpys only the changed shards, and
with deltas on (`DRL_WEIGHTS_DELTA`) a changed shard also keeps its
byte-range delta against the previous version for TCP pulls
(`get_sharded`). `get_blob` keeps whole-blob clients working by
encoding the version's float32 leaves once, on the first such pull.
Under `publish_async` the bundle is built on the publish worker, never
on the learn thread.
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
from distributed_reinforcement_learning_tpu_torch.runtime import weight_shards


def _device_clone(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    with torch.no_grad():
        return {k: v.detach().clone() for k, v in params.items()}


def _host_arrays(params: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The snapshot on the host, through a synchronous device-to-host copy."""
    return {k: v.cpu().numpy() for k, v in params.items()}


def _encode_host(params: dict[str, torch.Tensor]) -> np.ndarray:
    """The snapshot's blob through a synchronous device-to-host copy."""
    return codec.encode(_host_arrays(params), cache=True)


class WeightStore:
    _GUARDED_BY = {
        "_params": "_lock",
        "_blob": "_lock",
        "_version": "_lock",
        "_applied_seq": "_lock",
        "_board": "_lock",
        "_board_writes": "_lock",
        "_host": "_lock",
        "_manifest": "_lock",
        "_manifest_bytes": "_lock",
        "_bcast": "_lock",
        "_prev_bcast": "_lock",
        "_prev_version": "_lock",
        "_changed": "_lock",
        "_deltas": "_lock",
        "_shard_stats": "_lock",
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

    def __init__(self, sharded: bool | None = None, quant: str | None = None):
        self._lock = threading.Lock()
        self._params: dict[str, torch.Tensor] | None = None
        self._blob: np.ndarray | None = None
        self._version = -1
        self._applied_seq = 0
        self._board = None  # optional shm WeightBoard (attach_board)
        self._board_writes = 0
        # Sharded publication. `sharded` is public: the transport server
        # answers the shard-scoped op ST_UNAVAILABLE for a store without
        # it. `quant`: None defers to the gate, "" forces it off, "bf16"
        # or "int8" force a mode.
        self.sharded = (weight_shards.sharded_enabled() if sharded is None
                        else bool(sharded))
        if not self.sharded:
            self._quant = None
        elif quant is None:
            self._quant = weight_shards.quant_mode()
        else:
            self._quant = quant or None
        self._delta_on = weight_shards.delta_enabled() if self.sharded else False
        self._host: dict[str, np.ndarray] | None = None  # the version's f32 leaves
        self._manifest: dict | None = None
        self._manifest_bytes: bytes | None = None
        self._bcast: dict[str, np.ndarray] = {}  # the current broadcast blobs
        self._prev_bcast: dict[str, np.ndarray] = {}  # the previous version's
        self._prev_version = -2
        self._changed: set[str] = set()  # shards whose bytes moved last publish
        self._deltas: dict[str, bytes] = {}  # key -> delta against _prev_version
        self._shard_stats = {"shard_publishes": 0, "shards_changed": 0,
                             "broadcast_bytes": 0, "quant_bytes_saved": 0,
                             "deltas_encoded": 0, "delta_bytes": 0,
                             "manifest_bytes": 0}
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
        """Mirror every landed version into a shm weight board (the
        segmented one for a sharded store). An already-published snapshot
        is written at once (a whole blob encoded here if it has none yet;
        every shard of a sharded one), so a late attach never leaves the
        board empty behind live actors."""
        with self._lock:
            self._board = board
            if self._manifest is not None:
                # Every shard must land for the late attacher (this also
                # turns off unchanged-shard elision until the next publish).
                self._changed = set(self._bcast)
                self._board_publish_locked(self._version)
            elif self._params is not None:
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
        # unmapped segment at shutdown, a whole-blob board under a
        # sharded store): the store keeps publishing in-process and over
        # TCP, and closing the writer side lets attached actors demote
        # themselves to TCP pulls. One oversize SHARD is not a board
        # failure: the segmented board latches that shard alone.
        board = self._board
        if board is None or (self._blob is None and self._manifest is None):
            return
        t0 = time.perf_counter()
        try:
            if self._manifest is not None:
                if not hasattr(board, "publish_shards"):
                    raise ValueError("a whole-blob board cannot carry a sharded publication")
                board.publish_shards(version, self._manifest, self._bcast, self._changed)
            else:
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
               seq: int, bundle=None) -> None:
        with self._lock:
            applied = seq >= self._applied_seq
            if applied:
                prev_bcast, prev_version = self._bcast, self._version
                self._params = snap
                self._version, self._applied_seq = version, seq
                if bundle is None:
                    self._blob, self._host = blob, None
                    self._manifest = self._manifest_bytes = None
                    self._bcast, self._prev_bcast = {}, {}
                    self._deltas, self._changed = {}, set()
                else:
                    self._apply_bundle_locked(bundle, version, prev_bcast, prev_version)
                self._board_publish_locked(version)
        if applied and _OBS.enabled:
            _OBS.gauge("weights/version", version)

    def _apply_bundle_locked(self, bundle, version: int, prev_bcast: dict,
                             prev_version: int) -> None:
        """Land a sharded publication: the whole blob is encoded lazily
        (`get_blob`) for whole-blob clients. A shard is changed unless its
        (len, crc) match the previous version's and then its bytes too."""
        self._blob = None
        self._host = codec.assemble(bundle.manifest["skel"], list(bundle.host_leaves))
        manifest = bundle.manifest
        manifest["version"] = version
        prev_sums = {sh["key"]: (sh["nbytes"], sh["crc"])
                     for sh in (self._manifest or {}).get("shards", [])}
        changed = set()
        for sh in manifest["shards"]:
            k = sh["key"]
            if (prev_sums.get(k) != (sh["nbytes"], sh["crc"]) or k not in prev_bcast
                    or not np.array_equal(bundle.blobs[k], prev_bcast[k])):
                changed.add(k)
        deltas: dict[str, bytes] = {}
        if self._delta_on and prev_version >= 0:
            for k in changed:
                if k in prev_bcast:
                    d = weight_shards.delta_encode(bundle.blobs[k], prev_bcast[k])
                    if d is not None:
                        deltas[k] = d
        self._prev_bcast, self._prev_version = prev_bcast, prev_version
        self._bcast, self._changed, self._deltas = bundle.blobs, changed, deltas
        self._manifest = manifest
        self._manifest_bytes = weight_shards.manifest_bytes(manifest)
        st = self._shard_stats
        st["shard_publishes"] += 1
        st["shards_changed"] += len(changed)
        st["broadcast_bytes"] += sum(len(bundle.blobs[k]) for k in changed)
        st["quant_bytes_saved"] += max(
            bundle.nbytes_f32 - sum(len(b) for b in bundle.blobs.values()), 0)
        st["deltas_encoded"] += len(deltas)
        st["delta_bytes"] += sum(len(d) for d in deltas.values())
        st["manifest_bytes"] = len(self._manifest_bytes)

    def _host_publication(self, host: dict[str, np.ndarray]):
        """-> (blob, bundle) of a version's host arrays: the shard bundle
        of a sharded store, else the whole blob. A tree the sharded path
        cannot carry falls back to the whole blob for that publish."""
        if self.sharded:
            try:
                return None, weight_shards.build_bundle(host, quant=self._quant)
            except (TypeError, ValueError):
                pass
        return codec.encode(host, cache=True), None

    def publish(self, params: dict[str, torch.Tensor], version: int) -> None:
        """Store a device snapshot of `params` as `version` (encoded now
        when a board is attached or the store is sharded, both of which
        need the bytes)."""
        snap = _device_clone(params)
        with self._lock:
            board = self._board
        blob = bundle = None
        if self.sharded or board is not None:
            blob, bundle = self._host_publication(_host_arrays(snap))
        self._apply(snap, blob, version, self._next_seq(), bundle)

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

    def _host_publication_of(self, snap: dict[str, torch.Tensor], ready):
        """-> (blob, bundle) of the snapshot (`_host_publication`): on CUDA
        through pinned buffers on a side stream that waits on `ready`,
        then one wait for the copies."""
        first = next(iter(snap.values()))
        if not first.is_cuda:
            return self._host_publication({k: v.numpy() for k, v in snap.items()})
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
        # The encode copies the pinned bytes out (every shard blob too),
        # so the next publish may refill the same buffers.
        return self._host_publication({k: self._pinned[k].numpy() for k in snap})

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
                blob, bundle = self._host_publication_of(snap, ready)
                self._apply(snap, blob, version, seq, bundle)
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
        shared by every pull: read-only by contract. A sharded version
        encodes its float32 host leaves (the same bytes as a direct
        encode), an unsharded one its snapshot through a synchronous
        device-to-host copy."""
        with self._lock:
            if self._blob is None and self._host is not None:
                self._blob = codec.encode(self._host, cache=True)
            elif self._blob is None and self._params is not None:
                self._blob = _encode_host(self._params)
            return self._blob, self._version

    def get_sharded(self, have_version: int, keys=None, base_version: int = -2,
                    accept_delta: bool = False):
        """The shard-scoped pull: None when the caller holds the committed
        version (identity, as `get_if_newer`) or nothing sharded is
        published; else (version, manifest bytes, shards), shards being
        [(key, enc, base, payload), ...] for each manifest shard in `keys`
        (None: all). With `accept_delta` and `base_version` equal to the
        PREVIOUS published version, an untouched shard is elided
        (ENC_SKIP: the client reuses its cached blob) and a changed one
        carries its delta (ENC_DELTA) where one was worth encoding;
        every other shard is ENC_FULL, its broadcast blob. Base matching
        is by version identity, so rollback republishes stay correct."""
        with self._lock:
            version = self._version
            if self._manifest is None or version < 0 or version == have_version:
                return None
            use_base = (accept_delta and base_version >= 0
                        and base_version == self._prev_version)
            shards = []
            for sh in self._manifest["shards"]:
                k = sh["key"]
                if keys is not None and k not in keys:
                    continue
                if use_base and k not in self._changed:
                    shards.append((k, weight_shards.ENC_SKIP, base_version, b""))
                elif use_base and k in self._deltas:
                    shards.append((k, weight_shards.ENC_DELTA, base_version, self._deltas[k]))
                else:
                    shards.append((k, weight_shards.ENC_FULL, -1, self._bcast[k]))
            return version, self._manifest_bytes, shards

    def shard_stats(self) -> dict:
        """A copy of the sharded-publication counters."""
        with self._lock:
            return dict(self._shard_stats)

    def shard_stat(self, key: str) -> int:
        with self._lock:
            return self._shard_stats[key]

    def get_if_newer(self, have_version: int) -> tuple[Any, int] | None:
        """None if the caller already holds the newest version."""
        with self._lock:
            if self._version <= have_version:
                return None
            return self._params, self._version
