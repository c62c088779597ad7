"""Shared-memory weight board: publish-once broadcast for co-hosted actors.

Copy of the JAX package's `runtime/weight_board.py` (it imports no jax):
the same segment layouts, seqlock protocol, creator-pid word and gate,
so a board one package writes is read by the other at the same versions
with the same bytes (`tests/test_torch_weight_board.py`, and for the
segmented board `tests/test_torch_weight_shards.py`). The unset gate
is the constant `BOARD_AUTO_ENABLE`, which holds the JAX package's
committed verdict. Under sharded publication (`DRL_WEIGHTS_SHARDED`)
`serve_board` creates the segmented `ShardedWeightBoard` (one
double-buffered slot pair a shard, a publish memcpys only the changed
shards) and `BoardWeights` assembles a pull through
`weight_shards.materialize`.

The learner->actor mirror of `runtime/shm_ring.py`'s trajectory path. A
remote weight pull over TCP carries the full encoded parameter blob per
actor per new version; co-hosted actors would pay the wire frame, two
kernel copies and the round trip for bytes that already live on their
own host. The board is ONE seqlock-style double-buffered shared-memory
segment, written once per published version by the learner's weight
store and read by every co-hosted actor:

- a PUBLISH is one memcpy of the encoded blob (the bytes
  `WeightStore.get_blob` serves) into the INACTIVE slot plus an atomic
  meta flip — cost independent of actor count;
- a PULL is a pure shared-memory version peek (no syscall, no wire) and,
  only when the version actually changed, one memcpy out.

Memory layout (offsets in the shared segment; cache-line-spaced like
`shm_ring`):

    0    magic u32 | version u32 | slot_bytes u64
    24   creator pid u64 (same offset as the ring layout)
    64   meta_seq u64     — seqlock word: odd = meta write in progress
    72   active u64       — which slot holds the committed blob (0/1)
    80   version i64      — the committed publication's version
    88   blob_len u64
    128  slot0_seq u64    — per-slot seqlock word (odd = being written)
    192  slot1_seq u64
    256  writer_closed u32
    320  slot0[slot_bytes] | slot1[slot_bytes]

Write protocol (single writer — the weight store, under its lock):
slot_seq[target]+1 (odd) -> payload memcpy -> slot_seq[target]+1 (even)
-> meta_seq+1 (odd) -> {active, version, len} -> meta_seq+1 (even).
Readers read meta under the meta seqlock, then copy the active slot and
validate the slot's seq was even and unchanged across the copy. Double
buffering makes retries RARE, not merely detectable: a publish never
touches the slot a reader selected — only a second publish during one
read does, and that is exactly what the slot seq catches.

Why this is safe without atomics — and WHERE: same argument as
`shm_ring` (single writer per word, aligned 8-byte stores/loads through
a memoryview are single memcpys CPython never tears, x86-64 TSO orders
payload stores before the seq/meta publish stores). On weakly-ordered
CPUs that argument does not hold, so `board_enabled()` refuses to
auto-enable off x86-64 (DRL_SHM_WEIGHTS=1 still forces, for
single-machine testing) and a read that never stabilizes fails LOUDLY
(BoardClosed -> the actor's TCP fallback) instead of decoding garbage.

Lifecycle: the LEARNER creates the board (`serve_board`, name from
`DRL_SHM_WEIGHTS_CREATE`), attaches it to its WeightStore, and unlinks
at exit (atexit backstop; the local-cluster launcher additionally reaps
leaked segments). Actors attach by name (`DRL_SHM_WEIGHTS_NAME`) with a
bounded retry and FALL BACK to TCP pulls when the board never appears,
the writer latches closed, or a read fails. `DRL_SHM_WEIGHTS` gates the
feature: 1 forces on, 0 off, unset defers to `BOARD_AUTO_ENABLE` on
x86-64.
"""

from __future__ import annotations

import atexit
import json
import os
import struct
import threading
import time
from typing import Any

import numpy as np

from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS
from distributed_reinforcement_learning_tpu_torch.runtime.fleet import ShmReattachMixin
from distributed_reinforcement_learning_tpu_torch.runtime.shm_ring import (
    _attach_shm,
    create_or_reclaim_shm,
)
from distributed_reinforcement_learning_tpu_torch.runtime.transport import _LockedStatsMixin

_MAGIC = 0x44525742  # "DRWB"
_MAGIC_SHARDED = 0x44525753  # "DRWS": segmented (per-shard) layout
_VERSION = 1
_PID_OFF = 24  # creator pid u64 — same offset as the ring layout
_META_SEQ_OFF = 64
_ACTIVE_OFF = 72
_VER_OFF = 80
_LEN_OFF = 88
_SLOT_SEQ_OFF = (128, 192)
_WCLOSED_OFF = 256
_DATA_OFF = 320
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")
_SPIN = 200          # bounded spin before the first sleep (shm_ring's)
_SLEEP_MIN = 50e-6
_SLEEP_MAX = 1e-3


def _align8(n: int) -> int:
    return (n + 7) & ~7


class BoardClosed(ConnectionError):
    """The board is unusable (writer gone/latched closed, or a read that
    never stabilized — torn publish on a weakly-ordered CPU). Subclasses
    ConnectionError so actor loops treat it like a transport outage."""


class WeightBoard:
    """One double-buffered versioned blob board. Exactly one process
    writes (`publish_blob` — the learner's WeightStore, serialized under
    its lock); any number of co-hosted processes read (`read_blob`);
    the creator additionally owns `unlink`.

    Concurrency map (tools/drlint lock-discipline): deliberately EMPTY
    and kept as documentation — the board is lock-free by construction.
    Every shared word has a single writer (the learner side), readers
    validate via the seqlocks, and the local attributes (`_active`,
    `read_retries`) are each touched by exactly one side's single
    thread. Cross-process visibility goes through the shared segment,
    never through Python attributes.
    """

    _GUARDED_BY: dict = {}

    def __init__(self, shm, slot_bytes: int, owner: bool):
        self._shm = shm
        self._buf = shm.buf
        self.slot_bytes = slot_bytes
        self.name = shm.name.lstrip("/")
        self._owner = owner
        self._closed = False
        self._active = int(self._read_u64(_ACTIVE_OFF))  # writer-side only
        self.read_retries = 0  # reader-side only (seqlock retry count)

    # -- construction -----------------------------------------------------

    @classmethod
    def create(cls, name: str, slot_bytes: int) -> "WeightBoard":
        slot_bytes = _align8(max(slot_bytes, 4096))
        # create_or_reclaim: a respawned learner re-creates its board
        # under the SAME name; a dead incarnation's stale segment is
        # reclaimed by creator-pid (runtime/shm_ring.py).
        shm = create_or_reclaim_shm(name, _DATA_OFF + 2 * slot_bytes)
        board = cls(shm, slot_bytes, owner=True)
        # Magic is written LAST: the header's commit word (an attacher
        # racing this constructor either sees no magic and retries, or a
        # fully-initialized header — never a zero slot size).
        board._write_u64(8, slot_bytes)
        board._write_u64(_PID_OFF, os.getpid())
        board._write_u64(_META_SEQ_OFF, 0)
        board._write_u64(_ACTIVE_OFF, 0)
        board._write_i64(_VER_OFF, -1)  # nothing published yet
        board._write_u64(_LEN_OFF, 0)
        board._write_u64(_SLOT_SEQ_OFF[0], 0)
        board._write_u64(_SLOT_SEQ_OFF[1], 0)
        board._write_u32(_WCLOSED_OFF, 0)
        board._write_u32(4, _VERSION)
        board._write_u32(0, _MAGIC)
        return board

    @classmethod
    def attach(cls, name: str) -> "WeightBoard":
        shm = _attach_shm(name)
        view = shm.buf
        magic = _U32.unpack_from(view, 0)[0]
        version = _U32.unpack_from(view, 4)[0]
        slot_bytes = int(_U64.unpack_from(view, 8)[0])
        if (magic != _MAGIC or version != _VERSION or slot_bytes <= 0
                or shm.size < _DATA_OFF + 2 * slot_bytes):
            shm.close()
            raise ValueError(f"{name}: not an initialized v{_VERSION} "
                             f"shm weight board")
        return cls(shm, slot_bytes, owner=False)

    # -- raw header access -------------------------------------------------

    def _read_u32(self, off: int) -> int:
        return _U32.unpack_from(self._buf, off)[0]

    def _write_u32(self, off: int, value: int) -> None:
        _U32.pack_into(self._buf, off, value)

    def _read_u64(self, off: int) -> int:
        return _U64.unpack_from(self._buf, off)[0]

    def _write_u64(self, off: int, value: int) -> None:
        _U64.pack_into(self._buf, off, value)

    def _read_i64(self, off: int) -> int:
        return _I64.unpack_from(self._buf, off)[0]

    def _write_i64(self, off: int, value: int) -> None:
        _I64.pack_into(self._buf, off, value)

    @property
    def creator_pid(self) -> int:
        """The creating process's pid (header word, offset 24 in every
        layout): reattach probes validate a reappeared board belongs to
        the CURRENT learner incarnation."""
        return int(self._read_u64(_PID_OFF))

    @property
    def writer_closed(self) -> bool:
        return self._read_u32(_WCLOSED_OFF) != 0

    # -- writer side -------------------------------------------------------

    def publish_blob(self, blob, version: int) -> None:
        """One memcpy into the inactive slot + the meta flip. Single
        writer; the caller's buffer is consumed by value. Raises
        ValueError when the blob cannot fit a slot (the store latches
        the board off and stays on TCP)."""
        n = len(blob)
        if n > self.slot_bytes:
            raise ValueError(
                f"weight blob of {n} bytes cannot fit a {self.slot_bytes}-"
                f"byte board slot (raise DRL_SHM_WEIGHTS_MB)")
        target = 1 - self._active
        seq_off = _SLOT_SEQ_OFF[target]
        s = self._read_u64(seq_off)
        self._write_u64(seq_off, s + 1)  # odd: slot write in progress
        off = _DATA_OFF + target * self.slot_bytes
        if n:
            self._buf[off:off + n] = memoryview(blob).cast("B")
        self._write_u64(seq_off, s + 2)  # even: slot committed
        m = self._read_u64(_META_SEQ_OFF)
        self._write_u64(_META_SEQ_OFF, m + 1)  # odd: meta write in progress
        self._write_u64(_ACTIVE_OFF, target)
        self._write_i64(_VER_OFF, version)
        self._write_u64(_LEN_OFF, n)
        self._write_u64(_META_SEQ_OFF, m + 2)  # even: publication committed
        self._active = target
        if _OBS.enabled:
            _OBS.count("board/publishes")
            _OBS.count("board/published_bytes", n)

    def close_writer(self) -> None:
        """Latch 'no more publications' so readers demote to TCP."""
        self._write_u32(_WCLOSED_OFF, 1)

    # -- reader side -------------------------------------------------------

    def _read_meta(self) -> tuple[int, int, int, int] | None:
        """One consistent (slot, version, blob_len, meta_seq), or None to
        retry. The meta_seq is part of the result: `read_blob` must
        prove its slot-seq read happened while this meta was still
        current (see below), so the validation word travels with the
        values it validated."""
        s0 = self._read_u64(_META_SEQ_OFF)
        if s0 & 1:
            return None
        slot = int(self._read_u64(_ACTIVE_OFF))
        version = self._read_i64(_VER_OFF)
        n = int(self._read_u64(_LEN_OFF))
        if self._read_u64(_META_SEQ_OFF) != s0 or slot not in (0, 1) \
                or n > self.slot_bytes:
            return None
        return slot, version, n, s0

    def version(self, timeout: float = 1.0) -> int:
        """The committed publication's version — a pure shared-memory
        read (-1 before the first publish). BoardClosed if the meta
        seqlock never stabilizes (writer died mid-publish)."""
        deadline = time.monotonic() + timeout
        spins, sleep_s = 0, _SLEEP_MIN
        while True:
            meta = self._read_meta()
            if meta is not None:
                return meta[1]
            self.read_retries += 1
            spins += 1
            if spins <= _SPIN:
                continue
            if time.monotonic() >= deadline:
                raise BoardClosed(
                    f"board {self.name}: meta seqlock never stabilized "
                    f"(writer died mid-publish?)")
            time.sleep(sleep_s)
            sleep_s = min(2 * sleep_s, _SLEEP_MAX)

    def _pre_slot_read(self) -> None:
        """No-op seam between the meta read and the slot-seq read, so
        tests can inject the exact two-publish race the meta re-check
        above exists to catch."""

    def _copy_slot(self, slot: int, n: int) -> np.ndarray:
        """One memcpy of the slot's first n bytes into an owned buffer
        (split out so tests can inject a racing publish mid-copy)."""
        out = np.empty(n, np.uint8)
        off = _DATA_OFF + slot * self.slot_bytes
        memoryview(out)[:] = self._buf[off:off + n]
        return out

    def read_blob(self, have_version: int = -2,
                  timeout: float = 5.0) -> tuple[np.ndarray, int] | None:
        """The committed blob as an OWNED copy, or None when the
        committed version equals `have_version` (version IDENTITY, like
        the TCP server: a rollback republish's backward version must
        still reach actors) or nothing is published yet. Retries while a
        publish overlaps the read; BoardClosed if it never stabilizes.
        """
        deadline = time.monotonic() + timeout
        spins, sleep_s = 0, _SLEEP_MIN
        while True:
            meta = self._read_meta()
            if meta is not None:
                slot, version, n = meta[0], meta[1], meta[2]
                if version < 0 or version == have_version:
                    return None
                self._pre_slot_read()  # test hook (no-op in production)
                d0 = self._read_u64(_SLOT_SEQ_OFF[slot])
                # d0 must predate any re-targeting of `slot`: a writer
                # can only rewrite the ACTIVE slot after first flipping
                # meta away from it, so an unchanged meta_seq here proves
                # d0 was read while the slot still held version's bytes.
                # Without this check, TWO publishes completing between
                # the meta read and the d0 read would pair the new slot
                # contents with the OLD (version, len) — stable seqs,
                # wrong label.
                if not d0 & 1 and \
                        self._read_u64(_META_SEQ_OFF) == meta[3]:
                    out = self._copy_slot(slot, n)
                    if self._read_u64(_SLOT_SEQ_OFF[slot]) == d0:
                        return out, version
            # Meta mid-write, slot mid-write, a publish committed between
            # the meta and slot-seq reads, or the slot was re-targeted by
            # a second publish during the copy: go around.
            self.read_retries += 1
            spins += 1
            if spins <= _SPIN:
                continue
            if time.monotonic() >= deadline:
                raise BoardClosed(
                    f"board {self.name}: read never stabilized "
                    f"(torn publish?)")
            time.sleep(sleep_s)
            sleep_s = min(2 * sleep_s, _SLEEP_MAX)

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Release this process's mapping (idempotent; both sides)."""
        if self._closed:
            return
        self._closed = True
        self._buf = None
        self._shm.close()

    def unlink(self) -> None:
        """Remove the segment from /dev/shm (creator only; idempotent)."""
        if not self._owner:
            return
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass


# -- segmented (sharded) board -----------------------------------------------

# Sharded layout offsets. Meta words share the writer's cache line
# (single writer, like the whole-blob board); the manifest is double-
# buffered under the meta seqlock; each shard gets two payload slots
# with per-slot seq words spaced a cache line apart.
_S_MSEQ_OFF = 64
_S_MACT_OFF = 72
_S_VER_OFF = 80
_S_MLEN_OFF = 88
_S_WCLOSED_OFF = 128
_S_MSLOT_OFF = 192


def _align64(n: int) -> int:
    return (n + 63) & ~63


class _Seg:
    """Writer-side bookkeeping for one shard's segment pair."""

    __slots__ = ("seq_off", "slots", "cap", "active", "latched")

    def __init__(self, seq_off: int, slots: tuple[int, int], cap: int):
        self.seq_off = seq_off
        self.slots = slots
        self.cap = cap
        self.active = 0
        self.latched = False


class ShardedWeightBoard:
    """Segmented shm weight board: one double-buffered segment PER SHARD
    plus a double-buffered json manifest, under the same seqlock/version
    -identity discipline as the whole-blob `WeightBoard`.

    A publish memcpys ONLY the shards whose bytes changed (the
    WeightStore's memcmp against the previous publication) into each
    shard's inactive slot, then commits the new manifest + version under
    the meta seqlock — publish cost tracks the size of the UPDATE, not
    the policy. A pull reads the manifest, copies each needed shard's
    active slot (validating its slot seq across the copy and that the
    meta did not move between the manifest read and the slot-seq read —
    the same two-publish ABA argument as the whole-blob board's
    `read_blob`), and assembles via `runtime/weight_shards.materialize`.

    An OVERSIZE SINGLE SHARD (bigger than its slot pair, at layout time
    or after growth) latches ONLY that shard off the board (`"board":
    false` in the published manifest — readers fetch it over TCP); the
    rest of the plane keeps broadcasting through shared memory. A NEW
    shard key after layout (schema change mid-run) is a whole-board
    failure: publish raises and the store latches the board off
    entirely, the PR-3/5 demote discipline.

    Concurrency map (tools/drlint lock-discipline): deliberately EMPTY,
    documentation form — lock-free by construction like `WeightBoard`.
    The writer-side layout dict (`_segs`, `_latched`, `_mslot`) is only
    ever touched by the store's publish path (serialized under the
    store's `_lock`); readers learn placement exclusively through the
    shared manifest and validate through the seqlocks.
    """

    _GUARDED_BY: dict = {}

    def __init__(self, shm, arena_bytes: int, mslot_bytes: int, owner: bool):
        self._shm = shm
        self._buf = shm.buf
        self.arena_bytes = arena_bytes
        self.mslot_bytes = mslot_bytes
        self.name = shm.name.lstrip("/")
        self._owner = owner
        self._closed = False
        # Writer-side only:
        self._segs: dict[str, _Seg] = {}
        self._mslot = int(self._read_u64(_S_MACT_OFF))
        self._alloc = _S_MSLOT_OFF + 2 * mslot_bytes  # next free arena byte
        self._arena_end = _S_MSLOT_OFF + 2 * mslot_bytes + arena_bytes
        self.read_retries = 0  # reader-side only (seqlock retry count)

    # -- construction -----------------------------------------------------

    @classmethod
    def create(cls, name: str, arena_bytes: int,
               mslot_bytes: int = 1 << 20) -> "ShardedWeightBoard":
        arena_bytes = _align64(max(arena_bytes, 1 << 16))
        mslot_bytes = _align64(mslot_bytes)
        size = _S_MSLOT_OFF + 2 * mslot_bytes + arena_bytes
        # Same stale-segment reclaim as the classic board (respawned
        # learner, SAME name, dead creator — runtime/shm_ring.py).
        shm = create_or_reclaim_shm(name, size)
        board = cls(shm, arena_bytes, mslot_bytes, owner=True)
        board._write_u64(8, arena_bytes)
        board._write_u64(16, mslot_bytes)
        board._write_u64(_PID_OFF, os.getpid())
        board._write_u64(_S_MSEQ_OFF, 0)
        board._write_u64(_S_MACT_OFF, 0)
        board._write_i64(_S_VER_OFF, -1)
        board._write_u64(_S_MLEN_OFF, 0)
        board._write_u32(_S_WCLOSED_OFF, 0)
        board._write_u32(4, _VERSION)
        board._write_u32(0, _MAGIC_SHARDED)  # header commit word, last
        return board

    @classmethod
    def attach(cls, name: str) -> "ShardedWeightBoard":
        shm = _attach_shm(name)
        view = shm.buf
        magic = _U32.unpack_from(view, 0)[0]
        version = _U32.unpack_from(view, 4)[0]
        arena = int(_U64.unpack_from(view, 8)[0])
        mslot = int(_U64.unpack_from(view, 16)[0])
        if (magic != _MAGIC_SHARDED or version != _VERSION or arena <= 0
                or mslot <= 0
                or shm.size < _S_MSLOT_OFF + 2 * mslot + arena):
            shm.close()
            raise ValueError(f"{name}: not an initialized v{_VERSION} "
                             f"sharded shm weight board")
        return cls(shm, arena, mslot, owner=False)

    # -- raw header access (same single-writer/aligned-word argument as
    # WeightBoard) --------------------------------------------------------

    _read_u32 = WeightBoard._read_u32
    _write_u32 = WeightBoard._write_u32
    _read_u64 = WeightBoard._read_u64
    _write_u64 = WeightBoard._write_u64
    _read_i64 = WeightBoard._read_i64
    _write_i64 = WeightBoard._write_i64
    creator_pid = WeightBoard.creator_pid

    @property
    def writer_closed(self) -> bool:
        return self._read_u32(_S_WCLOSED_OFF) != 0

    # -- writer side -------------------------------------------------------

    def _alloc_seg(self, key: str, nbytes: int) -> _Seg:
        """Lay out one shard's seq-word pair + two payload slots; a
        shard that cannot fit the remaining arena is born latched (no
        segment — readers fetch it over TCP)."""
        cap = _align64(nbytes + nbytes // 8 + 1024)  # headroom for jitter
        seq_off = _align64(self._alloc)
        data_off = seq_off + 128  # two u64 seq words, a cache line apart
        end = data_off + 2 * cap
        if end > self._arena_end:
            seg = _Seg(0, (0, 0), 0)
            seg.latched = True
            import sys

            print(f"[weight_board] WARNING: shard {key!r} ({nbytes} B) "
                  f"does not fit the board arena; serving it over TCP "
                  f"(raise DRL_SHM_WEIGHTS_MB)", file=sys.stderr)
            return seg
        self._alloc = end
        self._write_u64(seq_off, 0)
        self._write_u64(seq_off + 64, 0)
        return _Seg(seq_off, (data_off, data_off + cap), cap)

    def publish_shards(self, version: int, manifest: dict,
                       blobs: dict[str, Any], changed=None) -> None:
        """Memcpy the CHANGED shards into their inactive slots, then
        commit manifest + version under the meta seqlock. `manifest` is
        the store's dict (never mutated — placement lands on a copy).
        Raises ValueError on whole-board failures (new shard key after
        layout, manifest overflow); an oversize single shard latches
        just itself."""
        keys = [sh["key"] for sh in manifest["shards"]]
        if not self._segs:
            for sh in manifest["shards"]:
                self._segs[sh["key"]] = self._alloc_seg(
                    sh["key"], int(sh["nbytes"]))
        elif any(k not in self._segs for k in keys):
            new = [k for k in keys if k not in self._segs]
            raise ValueError(f"shard keys {new} appeared after board "
                             f"layout (schema changed mid-run)")
        write = set(keys) if changed is None else set(changed)
        nbytes_written = 0
        n_written = 0
        for key in keys:
            seg = self._segs[key]
            if seg.latched or key not in write or key not in blobs:
                continue
            blob = blobs[key]
            n = len(blob)
            if n > seg.cap:
                seg.latched = True
                import sys

                print(f"[weight_board] WARNING: shard {key!r} grew to "
                      f"{n} B past its {seg.cap} B slot; serving it over "
                      f"TCP from here on", file=sys.stderr)
                continue
            target = 1 - seg.active
            s = self._read_u64(seg.seq_off + 64 * target)
            self._write_u64(seg.seq_off + 64 * target, s + 1)  # odd
            off = seg.slots[target]
            if n:
                self._buf[off:off + n] = memoryview(blob).cast("B")
            self._write_u64(seg.seq_off + 64 * target, s + 2)  # even
            seg.active = target
            nbytes_written += n
            n_written += 1
        board_manifest = dict(
            manifest, version=version,
            shards=[dict(sh,
                         board=not self._segs[sh["key"]].latched,
                         seq=self._segs[sh["key"]].seq_off,
                         act=self._segs[sh["key"]].active,
                         seg=list(self._segs[sh["key"]].slots))
                    for sh in manifest["shards"]])
        mbytes = json.dumps(board_manifest, separators=(",", ":")).encode()
        if len(mbytes) > self.mslot_bytes:
            raise ValueError(f"board manifest of {len(mbytes)} bytes "
                             f"cannot fit a {self.mslot_bytes}-byte slot")
        mtarget = 1 - self._mslot
        moff = _S_MSLOT_OFF + mtarget * self.mslot_bytes
        self._buf[moff:moff + len(mbytes)] = mbytes
        m = self._read_u64(_S_MSEQ_OFF)
        self._write_u64(_S_MSEQ_OFF, m + 1)  # odd: meta write in progress
        self._write_u64(_S_MACT_OFF, mtarget)
        self._write_i64(_S_VER_OFF, version)
        self._write_u64(_S_MLEN_OFF, len(mbytes))
        self._write_u64(_S_MSEQ_OFF, m + 2)  # even: publication committed
        self._mslot = mtarget
        if _OBS.enabled:
            _OBS.count("board/publishes")
            _OBS.count("board/published_bytes", nbytes_written)
            _OBS.count("board/shards_written", n_written)

    def close_writer(self) -> None:
        """Latch 'no more publications' so readers demote to TCP."""
        self._write_u32(_S_WCLOSED_OFF, 1)

    # -- reader side -------------------------------------------------------

    def _read_meta(self) -> tuple[int, int, int, int] | None:
        """One consistent (manifest_slot, version, manifest_len,
        meta_seq) or None to retry — same contract as WeightBoard."""
        s0 = self._read_u64(_S_MSEQ_OFF)
        if s0 & 1:
            return None
        mslot = int(self._read_u64(_S_MACT_OFF))
        version = self._read_i64(_S_VER_OFF)
        mlen = int(self._read_u64(_S_MLEN_OFF))
        if self._read_u64(_S_MSEQ_OFF) != s0 or mslot not in (0, 1) \
                or mlen > self.mslot_bytes:
            return None
        return mslot, version, mlen, s0

    def version(self, timeout: float = 1.0) -> int:
        deadline = time.monotonic() + timeout
        spins, sleep_s = 0, _SLEEP_MIN
        while True:
            meta = self._read_meta()
            if meta is not None:
                return meta[1]
            self.read_retries += 1
            spins += 1
            if spins <= _SPIN:
                continue
            if time.monotonic() >= deadline:
                raise BoardClosed(
                    f"board {self.name}: meta seqlock never stabilized "
                    f"(writer died mid-publish?)")
            time.sleep(sleep_s)
            sleep_s = min(2 * sleep_s, _SLEEP_MAX)

    def _pre_slot_read(self) -> None:
        """No-op seam between the manifest read and a shard's slot-seq
        read (test hook: inject the two-publish race)."""

    def _copy_seg(self, off: int, n: int) -> np.ndarray:
        out = np.empty(n, np.uint8)
        memoryview(out)[:] = self._buf[off:off + n]
        return out

    def read_shards(self, have_version: int = -2, keys=None,
                    timeout: float = 5.0):
        """(manifest_dict, {key: owned blob bytes}, version), or None on
        version identity / nothing published. Shards latched off the
        board (`"board": false`) appear in the manifest but not in the
        blob dict — the caller fetches those over TCP. Every accepted
        shard copy was validated by its slot seq across the copy AND by
        the meta seq between the manifest read and the slot-seq read
        (a writer only rewrites a slot after flipping the manifest away
        from it, so an unmoved meta proves the slot still held the
        manifest's bytes — the WeightBoard.read_blob ABA argument,
        per shard). Raises BoardClosed when reads never stabilize."""
        deadline = time.monotonic() + timeout
        spins, sleep_s = 0, _SLEEP_MIN
        while True:
            got = self._try_read(have_version, keys)
            if got is not _RETRY:
                return got
            self.read_retries += 1
            spins += 1
            if spins <= _SPIN:
                continue
            if time.monotonic() >= deadline:
                raise BoardClosed(
                    f"board {self.name}: sharded read never stabilized "
                    f"(torn publish?)")
            time.sleep(sleep_s)
            sleep_s = min(2 * sleep_s, _SLEEP_MAX)

    def _try_read(self, have_version: int, keys):
        meta = self._read_meta()
        if meta is None:
            return _RETRY
        mslot, version, mlen, s0 = meta
        if version < 0 or version == have_version:
            return None
        moff = _S_MSLOT_OFF + mslot * self.mslot_bytes
        mbytes = bytes(self._buf[moff:moff + mlen])
        if self._read_u64(_S_MSEQ_OFF) != s0:
            return _RETRY  # manifest slot re-targeted during the copy
        try:
            manifest = json.loads(mbytes)
        except ValueError:
            return _RETRY  # only reachable if the seqlock contract broke
        blobs: dict[str, np.ndarray] = {}
        for sh in manifest["shards"]:
            key = sh["key"]
            if keys is not None and key not in keys:
                continue
            if not sh.get("board", True):
                continue  # latched off the board: TCP carries it
            self._pre_slot_read()  # test hook (no-op in production)
            seq_off = int(sh["seq"]) + 64 * int(sh["act"])
            d0 = self._read_u64(seq_off)
            if d0 & 1 or self._read_u64(_S_MSEQ_OFF) != s0:
                return _RETRY
            blob = self._copy_seg(int(sh["seg"][int(sh["act"])]),
                                  int(sh["nbytes"]))
            if self._read_u64(seq_off) != d0:
                return _RETRY  # slot re-targeted + rewritten mid-copy
            blobs[key] = blob
        return manifest, blobs, version

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._buf = None
        self._shm.close()

    def unlink(self) -> None:
        if not self._owner:
            return
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass


_RETRY = object()  # read_shards internal sentinel


def attach_any(name: str):
    """Attach whichever board flavor lives at `name` (the learner's
    gate decides what it creates; readers follow the segment's magic)."""
    shm = _attach_shm(name)
    try:
        magic = _U32.unpack_from(shm.buf, 0)[0]
    finally:
        shm.close()
    if magic == _MAGIC_SHARDED:
        return ShardedWeightBoard.attach(name)
    return WeightBoard.attach(name)


# -- adjudication gate -------------------------------------------------------

# Unset-gate default. The JAX package reads it from
# `benchmarks/weights_verdict.json` (`auto_enable`: the board-vs-TCP A/B
# cleared its 1.2x bar with a median of 1.44), which this package does
# not read; true there today. `board_enabled` still refuses it off
# x86-64.
BOARD_AUTO_ENABLE = True


def board_enabled() -> bool:
    """DRL_SHM_WEIGHTS=1 forces the board on, =0 off; unset/auto defers
    to `BOARD_AUTO_ENABLE` — but never auto-enables off x86-64,
    where the seqlock's store-ordering argument does not hold (module
    docstring); the stabilization check + TCP fallback make a forced =1
    survivable for single-machine experimentation there."""
    env = os.environ.get("DRL_SHM_WEIGHTS", "").strip().lower()
    if env in ("1", "true", "yes", "on"):
        return True
    if env in ("0", "false", "no", "off"):
        return False
    import platform

    if platform.machine().lower() not in ("x86_64", "amd64"):
        return False
    return BOARD_AUTO_ENABLE


def board_capacity_bytes() -> int:
    """Per-slot capacity. /dev/shm pages are committed on first touch,
    so a generous default costs address space, not memory, until a blob
    of that size is actually published."""
    return int(float(os.environ.get("DRL_SHM_WEIGHTS_MB", "64")) * 1e6)


# -- learner side: create + attach to the WeightStore -------------------------


def serve_board(name: str):
    """Learner-side wiring: create the board the co-hosted actors will
    attach — SEGMENTED when sharded publication is on (the gate the
    WeightStore resolves too, so writer and board agree on the layout),
    classic double-buffered otherwise. Returns None (TCP-only operation
    continues) if the segment cannot be created — the board is an
    optimization, never a prerequisite. The segment is unlinked at stop
    and again via atexit (crash backstop)."""
    import sys

    from distributed_reinforcement_learning_tpu_torch.runtime import weight_shards

    try:
        if weight_shards.sharded_enabled():
            # The same footprint as the classic board's two slots.
            board = ShardedWeightBoard.create(name, 2 * board_capacity_bytes())
        else:
            board = WeightBoard.create(name, board_capacity_bytes())
    except (OSError, ValueError) as e:
        print(f"[weight_board] WARNING: cannot create board segment "
              f"({e}); weights stay on TCP", file=sys.stderr)
        return None
    atexit.register(board.unlink)
    return board


# -- actor side: get_if_newer surface with graceful TCP fallback --------------


class BoardWeights(_LockedStatsMixin, ShmReattachMixin):
    """The actor-runner weights surface (`get_if_newer`) with the data
    plane on the shm board and the TCP client as fallback. Mirrors
    `RemoteWeights` exactly — version identity (a rollback republish's
    backward version still lands), the pulled `{name: array}` blob as
    tensors on the actor's `device` — and demotes to TCP pulls on any
    board failure (writer latched closed at learner shutdown, a read
    that never stabilizes) rather than killing the actor. Demotion is
    not permanent: `reattach()` (driven from the fleet heartbeat
    cadence, runtime/fleet.py) re-attaches the SAME board name on a
    bounded RetryLadder once a respawned learner re-creates it —
    validated writer-open and belonging to the CURRENT learner
    incarnation (the header's creator-pid word against the
    heartbeat-reported pid). A segmented board's pull reads the changed
    shards and assembles them (`weight_shards.materialize`); a shard the
    board latched off (oversize) is filled over TCP.

    Concurrency map (tools/drlint lock-discipline): `stats` is bumped on
    the actor loop thread and polled by the telemetry flush thread's
    providers (accessors from transport._LockedStatsMixin). `_board` is
    swapped by the actor loop thread (demote/close) AND the heartbeat
    thread (reattach install), so the reference lives under `_lock`;
    the board OBJECT stays actor-thread-only, as does `_retries_seen`.
    """

    _GUARDED_BY = {"stats": "_stats_lock", "_board": "_lock",
                   "_closed": "_lock", "_stale": "_lock"}
    _NOT_GUARDED = {
        "demoted_at": "appended by the actor thread's demote only, read after it stops",
        "_retries_seen": "actor-thread-only seqlock-retry watermark "
                         "(the board object itself is actor-thread-"
                         "only; see class docstring)",
    }

    telemetry_prefix = "board"
    surface_name = "board"  # fleet heartbeat registration label

    def __init__(self, board, client, name: str | None = None,
                 fallback=None, device="cpu"):
        import torch

        from distributed_reinforcement_learning_tpu_torch.runtime.fleet import RetryLadder

        self._board = board  # WeightBoard | ShardedWeightBoard | None
        self._name = name or (board.name if board is not None else None)
        self._client = client
        # Demoted pulls ride `fallback` (a get_if_newer surface —
        # ShardedRemoteWeights in the deployed wiring) when provided;
        # the bare whole-blob client op otherwise.
        self._fallback = fallback
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._closed = False
        self._stale = False  # heartbeat-flagged: demote on next pull
        self._ladder = RetryLadder(f"board-{self._name}")
        self._retries_seen = 0
        self.stats = {"board_pulls": 0, "board_checks": 0,
                      "tcp_fallbacks": 0, "seqlock_retries": 0,
                      "shard_pulls": 0, "board_shard_fallbacks": 0,
                      "reattaches": 0}
        self._stats_lock = threading.Lock()
        # Wall-clock time of each demotion to TCP (the actor thread's own).
        self.demoted_at: list[float] = []

    @property
    def attached(self) -> bool:
        """True when pulls currently ride shared memory (False while
        demoted to TCP — including a demoted-at-birth surface that has
        not yet won a reattach probe)."""
        with self._lock:
            return self._board is not None

    def _board_ref(self):
        """The attached board, or None — handling a heartbeat-flagged
        STALE attachment by demoting here, on the actor thread (the
        board object is actor-thread-owned; the heartbeat thread never
        closes it, only flags it)."""
        with self._lock:
            board, stale = self._board, self._stale
        if board is not None and stale:
            self._demote(reason=f"board {self._name!r} belongs to a dead "
                                f"learner incarnation")
            return None
        return board

    def _tcp_pull(self, have_version: int):
        """One demoted-path pull: the fallback surface when the wiring
        provided one, else the whole-blob client op."""
        if self._fallback is not None:
            return self._fallback.get_if_newer(have_version)
        from distributed_reinforcement_learning_tpu_torch.runtime.transport import (
            params_to_device)

        got = self._client.get_weights_if_newer(have_version)
        if got is None:
            return None
        return params_to_device(got[0], self.device), got[1]

    def _demote(self, reason: str = "board closed under the actor") -> None:
        import sys

        with self._lock:
            board, self._board = self._board, None
            self._stale = False
        if board is not None:
            board.close()
        self.demoted_at.append(time.time())
        self._bump("tcp_fallbacks")
        print(f"[weight_board] WARNING: {reason}; "
              f"falling back to TCP weight pulls", file=sys.stderr)

    # -- reattach (fleet.ShmReattachMixin template) -----------------------
    # The stale-attach consequence here: a SIGKILLed learner latches no
    # writer_closed, so reads off its orphan board would keep
    # 'succeeding' at a frozen weight version forever. The actor thread
    # demotes on its next pull via _board_ref. A respawned learner
    # restores from checkpoint and republishes BEFORE serving, so the
    # very first pull off a re-attached board already lands real
    # weights (version identity tolerates the rollback).

    _ref_attr = "_board"
    # Validate against the BOARD creator's pid from the heartbeat reply
    # (fleet.ProbeContext.board_pid falls back to learner_pid outside a
    # learner tier, where the learner is the board's creator).
    _pid_field = "board_pid"

    def _probe_attach(self):
        return attach_any(self._name)

    def _probe_fresh(self, board, expect) -> bool:
        return (not board.writer_closed
                and (expect is None or board.creator_pid == expect))

    def _install_extra_locked(self) -> None:
        # Reset INSIDE the install's locked section: the actor thread
        # can only obtain the new board ref after this block, so it can
        # never pair the fresh board with the old incarnation's
        # retry-counter base.
        self._retries_seen = 0

    def _on_reattached(self) -> None:
        import sys

        print(f"[weight_board] board {self._name!r} re-attached; weight "
              f"pulls back on shared memory", file=sys.stderr)

    def reset_reattach(self) -> None:
        """Fresh probe budget (learner epoch change)."""
        self._ladder.reset()

    def _fetch_latched(self, manifest: dict, blobs: dict, version: int):
        """Fill the shards the board latched off (oversize) from the TCP
        shard-scoped op, at this exact version -> the completed blob
        dict, or None when TCP cannot supply a consistent set (the
        version moved, the op is unavailable): the caller then takes a
        whole TCP pull for this refresh, and the board stays attached."""
        from distributed_reinforcement_learning_tpu_torch.runtime import weight_shards

        get_sharded = getattr(self._client, "get_weights_sharded", None)
        if get_sharded is None:
            return None
        missing = [sh["key"] for sh in manifest["shards"] if sh.get("board", True) is False]
        try:
            got = get_sharded(-2, keys=missing)
        except (ConnectionError, RuntimeError):
            return None
        if got is None or got[0] != version:
            return None  # the store moved on between the board and TCP reads
        for key, enc, _base, payload in got[2]:
            if enc != weight_shards.ENC_FULL:  # no cache was offered
                return None
            blobs[key] = np.frombuffer(bytes(payload), np.uint8)
        return blobs

    def _read_sharded(self, board, have_version: int):
        """A pull through the segmented board -> (params on `device`,
        version) | None."""
        from distributed_reinforcement_learning_tpu_torch.runtime import weight_shards
        from distributed_reinforcement_learning_tpu_torch.runtime.transport import (
            params_to_device)

        got = board.read_shards(have_version)
        if got is None:
            return None
        manifest, blobs, version = got
        if any(sh.get("board", True) is False for sh in manifest["shards"]):
            # One oversize shard latched off the board: the rest of the
            # plane stays on shared memory, this shard rides TCP.
            self._bump("board_shard_fallbacks")
            filled = self._fetch_latched(manifest, blobs, version)
            if filled is None:
                return self._tcp_pull(have_version)
            blobs = filled
        self._bump("shard_pulls")
        # verify=False: the per-shard seqlocks and the single writer own
        # integrity here; a crc pass would read every copied byte again.
        tree = weight_shards.materialize(manifest, blobs, verify=False)
        return params_to_device(tree, self.device), version

    def get_if_newer(self, have_version: int) -> tuple[Any, int] | None:
        from distributed_reinforcement_learning_tpu_torch.data import codec
        from distributed_reinforcement_learning_tpu_torch.runtime.transport import (
            params_to_device)

        board = self._board_ref()
        if board is None:
            return self._tcp_pull(have_version)
        t0 = time.perf_counter()  # unconditional (see TCP client note)
        try:
            if board.writer_closed:
                raise BoardClosed(f"board {board.name}: writer closed")
            if hasattr(board, "read_shards"):
                # Assembled inside the guarded region: a failure can only
                # mean the seqlock contract broke, a board failure.
                got = self._read_sharded(board, have_version)
            else:
                got = board.read_blob(have_version)
                if got is not None:
                    # Decode inside the guarded region: a blob that fails
                    # to decode can only mean the seqlock contract broke
                    # (e.g. a weakly-ordered CPU with DRL_SHM_WEIGHTS
                    # forced) — treat it like any other board failure,
                    # never kill the actor.
                    got = (params_to_device(codec.decode(got[0]), self.device), got[1])
        except (BoardClosed, ValueError, KeyError):
            self._demote()
            return self._tcp_pull(have_version)
        self._bump("board_checks")
        # Clamped: a reattach swaps in a fresh board whose retry counter
        # restarts at zero, so a raced read here must never go negative.
        retries = max(board.read_retries - self._retries_seen, 0)
        if retries:
            self._retries_seen = board.read_retries
            self._bump("seqlock_retries", retries)
        if got is None:  # already newest: the no-syscall common case
            if _OBS.enabled:
                _OBS.gauge("actor/weight_pull_ms",
                           (time.perf_counter() - t0) * 1e3)
            return None
        # The copy out of the slot is OWNED, so the decode viewed it
        # (no second copy): the same bytes a TCP pull decodes.
        params, version = got
        self._bump("board_pulls")
        if _OBS.enabled:
            _OBS.gauge("actor/weight_pull_ms", (time.perf_counter() - t0) * 1e3)
            _OBS.gauge("actor/weight_version", version)
        return params, version

    def close(self) -> None:
        with self._lock:
            board, self._board = self._board, None
            self._closed = True  # a late reattach must not resurrect us
        if board is not None:
            board.close()


def attach_board_weights(name: str, client,
                         deadline_s: float | None = None,
                         fallback=None, device="cpu") -> BoardWeights | None:
    """Actor-side wiring: attach the named board with a bounded retry
    and wrap it in a BoardWeights. None = stay on plain TCP pulls.

    Short window on purpose (same reasoning as shm_ring's attach): this
    runs after the TransportClient connected, and the learner creates
    its board before serving — a missing segment a few seconds later
    almost certainly means the learner declined.

    With the fleet plane on, attach failure returns a DEMOTED-AT-BIRTH
    BoardWeights (board=None, name kept): pulls ride TCP immediately,
    but the surface still exposes `reattach()` so the heartbeat-driven
    ladder can promote it once the segment appears — a member respawned
    DURING a learner outage must not be stranded on TCP forever.

    `fallback` (the caller's ShardedRemoteWeights in the deployed
    wiring) is the surface demoted pulls ride — without it a demotion
    regresses to whole-blob TCP transfers even against a learner that
    publishes per shard."""
    import sys

    from distributed_reinforcement_learning_tpu_torch.runtime import fleet

    if deadline_s is None:
        deadline_s = float(os.environ.get("DRL_SHM_WEIGHTS_ATTACH_S", "5"))
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            board = attach_any(name)
        except (FileNotFoundError, ValueError) as e:
            if time.monotonic() >= deadline:
                if fleet.fleet_enabled():
                    print(f"[weight_board] WARNING: cannot attach board "
                          f"{name!r} ({e}); starting demoted to TCP "
                          f"weight pulls (reattach ladder armed)",
                          file=sys.stderr)
                    return BoardWeights(None, client, name=name,
                                        fallback=fallback, device=device)
                print(f"[weight_board] WARNING: cannot attach board "
                      f"{name!r} ({e}); falling back to TCP weight pulls",
                      file=sys.stderr)
                return None
            time.sleep(0.2)
            continue
        return BoardWeights(board, client, fallback=fallback, device=device)
