"""Tiered replay: the hot/cold spill tier under the sharded replay service.

Counterpart of the JAX package's `data/replay_spill.py`, host numpy with
the same file formats: a segment file and a `manifest.json` written by
either package are byte for byte the ones the other writes, and each
recovers the other's spill directory.

Each `ReplayShard` gets a `TieredStore` backend: a HOT set of segments
resident in RAM plus COLD segments spilled to disk as codec blobs
(sequence-mode items that arrived stamped are stored as their wire blobs
(`LazyBlob`), so spilling one is a write, not an encode), with their
priority summaries. Priorities for EVERY segment stay resident (8
bytes an item: the sampling DISTRIBUTION fits in RAM even where the
payload does not), so:

- proportional sampling is exact over the full store: draws walk the
  per-segment mass cumsum, then the in-segment priority cumsum;
- priority writebacks are loss-free across spill/promote by
  construction: the float64 priority array never moves to disk only,
  the mover only copies it;
- eviction (capacity overwrite) and spill/promote VICTIM selection are
  by priority mass, the quantity the sampler consumes.

Draws that land on a cold segment are queued (a bounded draw-ahead FIFO)
and the segment is requested for promotion; the learn thread NEVER
touches disk: spill serialization and promote reads ride the ingest
threads (`ReplayShard.tier_step` after each insert) and the service's
update-router thread (`ShardedReplayService._tier_tick`). The queue is
also a prefetch window: `sample_step` tops it up with draws for the NEXT
batch, so promotes overlap the learner's train step instead of stalling
its sample. Every delivered item corresponds to exactly one
full-distribution draw (queued entries deliver later; order does not
change the counts), so aggregate frequencies match the all-RAM backend.
Only the bounded-wait fallback (`forced_pads`, a resident-only fill
after `wait_s`) can bias, and it is counted.

A learner restart recovers cold segments from `manifest.json` (atomic
rewrite) with a crc32 per segment file verified at promote time: a
corrupt file drops that one segment and counts it (`crc_dropped`),
never poisons the shard. The gates (`DRL_REPLAY_SPILL*`) live in
`runtime/replay_shard.py`.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any

import numpy as np

from distributed_reinforcement_learning_tpu_torch.data.fifo import tree_leaves
from distributed_reinforcement_learning_tpu_torch.data.replay import priority_transform

_MAGIC = b"DRLS"
_VERSION = 1

# Packed in-shard sample index: [segment sid : high bits][offset : 20].
# The shard packs this into the low 46 bits of the service-level index,
# so sid has 26 bits of headroom — at the 512-item default segment that
# is ~34e9 items of shard lifetime before wrap.
_OFF_BITS = 20
_SEG_CAP = 1 << _OFF_BITS


class ColdStoreEmpty(RuntimeError):
    """A sample could not complete from resident segments and the
    bounded promote wait expired (or nothing is resident at all — the
    all-cold state right after a restart recovery). The service converts
    this to `ReplayServiceEmpty`: a transient learner skip while the
    router thread promotes, never a learn-step fault."""


@dataclass(frozen=True)
class SpillConfig:
    """Knob bundle for a shard's spill tier (runtime/replay_shard.py
    resolves the DRL_REPLAY_SPILL* environment into one of these)."""

    directory: str
    hot_bytes: int = 256 * 1024 * 1024
    seg_items: int = 512
    wait_s: float = 2.0
    queue_cap: int = 4096
    max_inflight: int = 2
    fresh: bool = False  # True: wipe the directory (shard restart)

    def for_shard(self, shard_id: int) -> "SpillConfig":
        return replace(self,
                       directory=os.path.join(self.directory,
                                              f"shard_{shard_id:03d}"))


class _Segment:
    """One append-ordered run of items. Sealed segments are immutable in
    CONTENT (items/prios length); priorities mutate in place via
    writebacks. `items is None` means the payload is on disk only."""

    __slots__ = ("sid", "state", "gen", "items", "prios", "count", "mass",
                 "cumsum", "payload_bytes", "file", "file_crc", "file_nbytes",
                 "debt")

    def __init__(self, sid: int, seg_items: int):
        self.sid = sid
        self.state = "open"  # open -> hot -> spilling -> cold -> promoting
        self.gen = 0
        self.items: list[Any] | None = []
        self.prios = np.zeros(seg_items, np.float64)
        self.count = 0
        self.mass = 0.0
        self.cumsum: np.ndarray | None = None
        self.payload_bytes = 0
        self.file: str | None = None
        self.file_crc = 0
        self.file_nbytes = 0
        self.debt = 0  # queued draws referencing this segment (pin)

    @property
    def resident(self) -> bool:
        return self.items is not None


class _TierJob:
    """One planned unit of tier maintenance. Planned and committed under
    the owning shard's lock; `run_io` touches ONLY job-local state (the
    sealed segment's immutable items list, a priority COPY, file paths),
    so it runs with no lock held. Never raises: IO/parse failures land
    in `error` for the commit step to adjudicate."""

    __slots__ = ("kind", "sid", "gen", "mode", "items", "prios", "path",
                 "crc", "nbytes", "payload_bytes", "paths", "reuse",
                 "result", "error")

    def __init__(self, kind: str, **kw: Any):
        self.kind = kind
        self.sid = kw.get("sid", -1)
        self.gen = kw.get("gen", 0)
        self.mode = kw.get("mode", "transition")
        self.items = kw.get("items")
        self.prios = kw.get("prios")
        self.path = kw.get("path")
        self.crc = kw.get("crc", 0)
        self.nbytes = kw.get("nbytes", 0)
        self.payload_bytes = kw.get("payload_bytes", 0)
        self.paths = kw.get("paths", ())
        self.reuse = kw.get("reuse", False)
        self.result: Any = None
        self.error: str | None = None

    def run_io(self) -> None:
        try:
            if self.kind == "spill" and self.items is not None:
                self._write_segment()
            elif self.kind == "promote":
                self.result = self._read_segment()
            elif self.kind == "unlink":
                for p in self.paths:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass  # already gone / racing a wipe: the goal state
        except Exception as e:  # adjudicated at commit (spill_errors /
            self.error = f"{type(e).__name__}: {e}"  # crc_dropped), not silent

    # -- segment file format ----------------------------------------------
    #
    # magic | u32 version | u32 header_len | header json | f64 prios |
    # payload records (concatenated codec blobs). header json:
    # {"sid", "mode", "count", "records": [nbytes, ...]}. The manifest
    # carries a crc32 of the WHOLE file, verified at promote time.

    def _write_segment(self) -> None:
        if self.reuse:
            # Re-spill of a previously spilled segment: the payload on
            # disk is still bit-identical (items are immutable); only
            # the RAM copy is dropped. Disk prios go stale — they are
            # advisory recovery seeds, the RAM array stays authoritative.
            self.result = (self.path, self.crc, self.nbytes)
            return
        records = _serialize_records(self.items, self.mode)
        header = json.dumps({"sid": self.sid, "mode": self.mode,
                             "count": int(self.count_items()),
                             "records": [len(r) for r in records]},
                            separators=(",", ":")).encode()
        buf = io.BytesIO()
        buf.write(_MAGIC)
        buf.write(int(_VERSION).to_bytes(4, "little"))
        buf.write(len(header).to_bytes(4, "little"))
        buf.write(header)
        buf.write(np.ascontiguousarray(self.prios, np.float64).tobytes())
        for r in records:
            buf.write(r)
        data = buf.getvalue()
        _atomic_write_bytes(Path(self.path), data)
        self.result = (self.path, zlib.crc32(data), len(data))

    def count_items(self) -> int:
        return len(self.prios) if self.prios is not None else 0

    def _read_segment(self):
        with open(self.path, "rb") as f:
            data = f.read()
        if len(data) != self.nbytes or zlib.crc32(data) != self.crc:
            raise ValueError(
                f"segment {self.sid}: crc/size mismatch "
                f"({len(data)}B vs manifest {self.nbytes}B)")
        header, prios, payload = _parse_segment(memoryview(data))
        if header["sid"] != self.sid:
            raise ValueError(f"segment file sid {header['sid']} != {self.sid}")
        items = _deserialize_records(payload, header["records"],
                                     header["mode"], header["count"])
        return items


def _serialize_records(items: list[Any], mode: str) -> list[bytes]:
    from distributed_reinforcement_learning_tpu_torch.data import codec
    from distributed_reinforcement_learning_tpu_torch.data.replay_service import LazyBlob

    if mode == "transition":
        # One blob for the whole segment: the item list IS a pytree, so
        # one encode/decode round-trips it bit-identically.
        return [bytes(memoryview(codec.encode(list(items))))]
    out = []
    for item in items:
        if isinstance(item, LazyBlob):
            blob = item._blob  # single read: materialize publishes _tree
            if blob is not None:  # before dropping _blob (lock-free pact)
                out.append(blob)  # already a wire blob: a write, not an
                continue          # encode
            item = item.materialize()
        out.append(bytes(memoryview(codec.encode(item))))
    return out


def _deserialize_records(payload: memoryview, lens: list[int], mode: str,
                         count: int) -> list[Any]:
    from distributed_reinforcement_learning_tpu_torch.data import codec
    from distributed_reinforcement_learning_tpu_torch.data.replay_service import LazyBlob

    blobs, pos = [], 0
    for n in lens:
        blobs.append(payload[pos:pos + n])
        pos += n
    if mode == "transition":
        items = codec.decode(blobs[0], copy=True, cache=True)
        if len(items) != count:
            raise ValueError(f"segment payload holds {len(items)} items, "
                             f"header says {count}")
        return list(items)
    # Sequence mode: re-wrap as LazyBlob — promote stays a read+copy,
    # decode is deferred to first materialization on the learner thread.
    for b in blobs:
        codec.check_blob(b)  # poison fails the promote, not the learner
    return [LazyBlob(b) for b in blobs]


def _parse_segment(view: memoryview):
    if bytes(view[:4]) != _MAGIC:
        raise ValueError("bad segment magic")
    if int.from_bytes(view[4:8], "little") != _VERSION:
        raise ValueError("unknown segment version")
    hlen = int.from_bytes(view[8:12], "little")
    header = json.loads(bytes(view[12:12 + hlen]))
    count = int(header["count"])
    p0 = 12 + hlen
    prios = np.frombuffer(view[p0:p0 + 8 * count], np.float64).copy()
    return header, prios, view[p0 + 8 * count:]


def _atomic_write_bytes(path: Path, data: bytes) -> None:
    """mkstemp + fsync + rename: a crash can lose the newest segment,
    never corrupt one."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _item_nbytes(item: Any) -> int:
    blob = getattr(item, "_blob", None)  # unmaterialized LazyBlob
    if blob is not None:
        return len(blob)
    if hasattr(item, "materialize"):
        item = item.materialize()
    return sum(np.asarray(leaf).nbytes for leaf in tree_leaves(item))


class TieredStore:
    """Hot/cold prioritized replay backend for one `ReplayShard`.

    Implements the backend surface the shard drives (`add`/`add_batch`,
    `sample_with_priorities`, `update_batch`, `snapshot`/`restore`,
    `__len__`, `beta`, `tree.total`) plus the tier-maintenance half
    (`plan_tier_work`/`commit_tier_work`, driven by
    `ReplayShard.tier_step`). See the module docstring for semantics.
    """

    # Concurrency map (tools/drlint lock-discipline): this store is
    # EXTERNALLY synchronized — every state-mutating entry point runs
    # under the owning ReplayShard's `_lock` (the shard brackets
    # plan/commit in tier_step; sample/update/add arrive already locked).
    # The IO half (`_TierJob.run_io`) runs lock-free on job-local state
    # only: sealed item lists are immutable and priority arrays are
    # copied into the job. The one cross-thread field this class owns is
    # the manifest write cursor, below.
    _GUARDED_BY = {
        "_manifest_written_ver": "_io_lock",
        "_closed": "_io_lock",
    }
    _NOT_GUARDED = {
        "_segments": "externally synchronized: accessed only under the "
                     "owning ReplayShard._lock (shard-bracketed calls)",
        "_order": "externally synchronized under ReplayShard._lock",
        "_ready": "externally synchronized under ReplayShard._lock",
        "_blocked": "externally synchronized under ReplayShard._lock",
        "_promote_req": "externally synchronized under ReplayShard._lock",
        "_promote_set": "externally synchronized under ReplayShard._lock",
        "_promote_t": "externally synchronized under ReplayShard._lock",
        "_promote_inflight": "externally synchronized under "
                             "ReplayShard._lock",
        "_open": "externally synchronized under ReplayShard._lock",
        "_next_sid": "externally synchronized under ReplayShard._lock",
        "_count": "externally synchronized under ReplayShard._lock",
        "_hot_bytes": "externally synchronized under ReplayShard._lock",
        "_cold_bytes": "externally synchronized under ReplayShard._lock",
        "_disk_bytes": "externally synchronized under ReplayShard._lock",
        "_partial": "externally synchronized under ReplayShard._lock",
        "_pending_unlinks": "externally synchronized under "
                            "ReplayShard._lock",
        "_manifest_dirty": "externally synchronized under "
                           "ReplayShard._lock",
        "_manifest_ver": "externally synchronized under ReplayShard._lock",
        "_obs_events": "externally synchronized under ReplayShard._lock",
        "stats": "externally synchronized under ReplayShard._lock",
        "beta": "externally synchronized under ReplayShard._lock",
    }

    stacked_samples = False

    def __init__(self, capacity: int, cfg: SpillConfig, mode: str = "transition",
                 beta: float = 0.4, seed: int = 0):
        if mode not in ("transition", "sequence"):
            raise ValueError(f"unknown tier mode {mode!r}")
        self.capacity = int(capacity)
        self.mode = mode
        self.beta = beta
        self.cfg = cfg
        self._dir = Path(cfg.directory)
        self._seg_items = max(1, min(int(cfg.seg_items),
                                     max(1, self.capacity // 4),
                                     _SEG_CAP - 1))
        self._segments: dict[int, _Segment] = {}
        self._order: deque[int] = deque()  # insertion order (eviction)
        self._open: _Segment | None = None
        self._next_sid = 0
        self._count = 0
        self._hot_bytes = 0   # resident payload bytes (open + hot)
        self._cold_bytes = 0  # payload bytes whose only copy is on disk
        self._disk_bytes = 0  # bytes of live segment files on disk
        self._ready: deque[tuple[int, int]] = deque()  # draw-ahead FIFO
        # Cold draws park here (keyed by sid) instead of churning the
        # ready FIFO: one promote request when parked, requeued in one
        # move when the promote commits — a drain never rescans them.
        self._blocked: dict[int, list[tuple[int, int]]] = {}
        self._partial: list[tuple[Any, int, float]] = []
        self._promote_req: deque[int] = deque()
        self._promote_set: set[int] = set()
        self._promote_t: dict[int, float] = {}
        self._promote_inflight = 0
        self._pending_unlinks: list[str] = []
        self._manifest_dirty = False
        self._manifest_ver = 0
        self._io_lock = threading.Lock()
        self._manifest_written_ver = -1
        self._closed = False
        # Owned, seeded sampling stream (same contract as the all-RAM
        # backends: callers passing an rng are unaffected).
        self._default_rng = np.random.RandomState(seed)
        self.stats = {
            "spilled_segments": 0, "spilled_bytes": 0,
            "promoted_segments": 0, "promoted_bytes": 0,
            "evicted_segments": 0, "evicted_items": 0,
            "crc_dropped": 0, "spill_errors": 0,
            "forced_pads": 0, "queue_dropped": 0,
            "updates_dropped_evicted": 0, "recovered_segments": 0,
            "recovered_items": 0, "promote_waits": 0,
        }
        self._obs_events: list[tuple[str, float]] = []
        self._dir.mkdir(parents=True, exist_ok=True)
        if cfg.fresh:
            self._wipe_dir()
        else:
            self._recover()
        self._new_open()

    # -- construction helpers ----------------------------------------------

    def _wipe_dir(self) -> None:
        for p in self._dir.glob("seg_*.bin"):
            try:
                p.unlink()
            except OSError:
                pass  # concurrent cleanup: absence is the goal state
        man = self._dir / "manifest.json"
        if man.exists():
            try:
                man.unlink()
            except OSError:
                pass  # ditto

    def _recover(self) -> None:
        """Register manifested cold segments: priorities load into RAM
        now (8B/item), payloads stay on disk until sampled-cold draws
        promote them. Unreadable entries are skipped and counted —
        recovery is best-effort by design (a lost segment is the same
        class of loss as RAM contents on any crash)."""
        man_path = self._dir / "manifest.json"
        if not man_path.exists():
            self._gc_orphans(set())
            return
        try:
            man = json.loads(man_path.read_text())
        except (ValueError, OSError):
            self._gc_orphans(set())
            return
        live: set[str] = set()
        for ent in man.get("segments", []):
            path = self._dir / ent["file"]
            try:
                with open(path, "rb") as f:
                    head = f.read(12)
                    if head[:4] != _MAGIC:
                        raise ValueError("bad magic")
                    if int.from_bytes(head[4:8], "little") != _VERSION:
                        raise ValueError("bad version")
                    hlen = int.from_bytes(head[8:12], "little")
                    header = json.loads(f.read(hlen))
                    count = int(header["count"])
                    if count != int(ent["count"]) or count <= 0:
                        raise ValueError("count mismatch")
                    prios = np.frombuffer(f.read(8 * count), np.float64).copy()
                    if prios.size != count:
                        raise ValueError("truncated priorities")
            except (OSError, ValueError, KeyError):
                self.stats["crc_dropped"] += 1
                continue
            seg = _Segment(ent["sid"], 0)
            seg.state = "cold"
            seg.items = None
            seg.prios = prios
            seg.count = count
            seg.mass = float(prios.sum())
            seg.payload_bytes = int(ent.get("payload_bytes", 0))
            seg.file = str(path)
            seg.file_crc = int(ent["crc"])
            seg.file_nbytes = int(ent["nbytes"])
            self._segments[seg.sid] = seg
            self._order.append(seg.sid)
            self._count += count
            self._cold_bytes += seg.payload_bytes
            self._disk_bytes += seg.file_nbytes
            live.add(ent["file"])
            self._next_sid = max(self._next_sid, seg.sid + 1)
            self.stats["recovered_segments"] += 1
            self.stats["recovered_items"] += count
        self._gc_orphans(live)
        # Evict down to capacity immediately: a shrunk-capacity restart
        # must not carry more items than the live config allows.
        self._evict_over_capacity()
        self._manifest_dirty = True
        self._manifest_ver += 1

    def _gc_orphans(self, live: set[str]) -> None:
        for p in self._dir.glob("seg_*.bin"):
            if p.name in live:
                continue
            self._pending_unlinks.append(str(p))
            try:
                # Keep sids ahead of any orphan (a crash between segment
                # write and manifest sync) so a fresh segment never spills
                # onto a stale file before its deferred unlink runs.
                self._next_sid = max(self._next_sid,
                                     int(p.stem.split("_")[1]) + 1)
            except (IndexError, ValueError):
                continue  # foreign file matching the glob: unlink only

    def _new_open(self) -> None:
        seg = _Segment(self._next_sid, self._seg_items)
        self._next_sid += 1
        self._open = seg
        self._segments[seg.sid] = seg
        self._order.append(seg.sid)

    # -- backend surface: size / mass --------------------------------------

    class _MassView:
        """`.tree.total` shim: ReplayShard's stats/mass_count read the
        backend's sum-tree total; here the total is the segment masses."""

        __slots__ = ("_store",)

        def __init__(self, store: "TieredStore"):
            self._store = store

        @property
        def total(self) -> float:
            return sum(s.mass for s in self._store._segments.values())

    @property
    def tree(self) -> "TieredStore._MassView":
        return TieredStore._MassView(self)

    def __len__(self) -> int:
        return self._count

    def ram_bytes(self) -> int:
        """Accounted replay RAM: resident payloads + the always-resident
        priority arrays and their cumsum caches (16B/item upper bound) —
        the honest denominator for stored-transitions-per-GB-RAM."""
        return self._hot_bytes + 16 * self._count

    def disk_bytes(self) -> int:
        return self._disk_bytes

    def approx_snapshot_nbytes(self) -> int:
        return self._hot_bytes + self._cold_bytes + 8 * self._count

    # -- backend surface: ingest -------------------------------------------

    def add(self, error: float, sample: Any) -> int:
        return self._append(float(priority_transform(
            np.asarray([error]))[0]), sample)

    def add_batch(self, errors: np.ndarray, samples: list[Any]) -> list[int]:
        prios = priority_transform(errors)
        return [self._append(float(p), s) for p, s in zip(prios, samples)]

    def _append(self, prio: float, item: Any) -> int:
        seg = self._open
        if seg is None or seg.count >= self._seg_items:
            if seg is not None:
                self._seal(seg)
            self._new_open()
            seg = self._open
        off = seg.count
        seg.items.append(item)
        seg.prios[off] = prio
        seg.count += 1
        seg.mass += prio
        seg.cumsum = None
        nb = _item_nbytes(item)
        seg.payload_bytes += nb
        self._hot_bytes += nb
        self._count += 1
        self._evict_over_capacity()
        return (seg.sid << _OFF_BITS) | off

    def _seal(self, seg: _Segment) -> None:
        seg.prios = seg.prios[:seg.count].copy()
        seg.state = "hot"
        seg.cumsum = None

    def _evict_over_capacity(self) -> None:
        """Drop the OLDEST sealed segment(s) while over capacity — the
        monolithic ring's overwrite-oldest semantic at segment grain."""
        while self._count > self.capacity:
            victim = None
            for sid in self._order:
                seg = self._segments[sid]
                if seg.state != "open":
                    victim = seg
                    break
            if victim is None:
                return  # only the open segment exists (capacity tiny)
            self._drop_segment(victim)
            self.stats["evicted_segments"] += 1
            self.stats["evicted_items"] += victim.count

    def _drop_segment(self, seg: _Segment) -> None:
        self._order.remove(seg.sid)
        del self._segments[seg.sid]
        seg.gen += 1  # in-flight jobs against it discard at commit
        self._count -= seg.count
        if seg.resident:
            self._hot_bytes -= seg.payload_bytes
        else:
            self._cold_bytes -= seg.payload_bytes
        if seg.file is not None:
            self._disk_bytes -= seg.file_nbytes
            self._pending_unlinks.append(seg.file)
        self._promote_set.discard(seg.sid)
        self._promote_t.pop(seg.sid, None)
        dropped = self._blocked.pop(seg.sid, None)
        if dropped:
            self.stats["queue_dropped"] += len(dropped)
        self._manifest_dirty = True
        self._manifest_ver += 1

    # -- backend surface: sampling -----------------------------------------

    def sample_with_priorities(self, n: int, rng=None):
        """One-shot completion path (monolithic surface parity — the
        shard's tiered sampling loop calls `sample_step` directly so it
        can wait for promotes between steps)."""
        out = self.sample_step(n, rng, force=True)
        assert out is not None  # force=True completes or raises
        return out

    def sample_step(self, n: int, rng, force: bool = False):
        """Advance one delivery attempt; returns (items, idxs, prios) or
        None when queued draws still await promotion (the caller kicks
        the router and waits on the shard condvar, then retries).
        `force=True` completes with resident-only pads (counted) or
        raises ColdStoreEmpty."""
        if rng is None:
            rng = self._default_rng
        got = self._partial
        self._drain_ready(got, n)
        seg_list, cumsum, total = self._mass_table()
        if total <= 0 and not got:
            self._partial = []
            raise ColdStoreEmpty("tiered store has no priority mass")
        attempts, cap = 0, 8 * n + 64
        while len(got) < n and attempts < cap:
            batch = self._draw_many(n - len(got), seg_list, cumsum, total,
                                    rng)
            if not batch:
                break
            attempts += len(batch)
            for sid, off in batch:
                seg = self._segments[sid]
                if seg.resident:
                    got.append((seg.items[off], (sid << _OFF_BITS) | off,
                                float(seg.prios[off])))
                else:
                    self._queue_draw(sid, off)
        if len(got) < n:
            if not force:
                self._partial = got
                return None
            self._forced_fill(got, n, rng)
        self._partial = []
        self._prefetch(n, seg_list, cumsum, total, rng)
        items = [item for item, _, _ in got]
        idxs = np.fromiter((idx for _, idx, _ in got), np.int64, len(got))
        prios = np.fromiter((p for _, _, p in got), np.float64, len(got))
        return items, idxs, prios

    def _drain_ready(self, got: list, n: int) -> None:
        scanned, qlen = 0, len(self._ready)
        while scanned < qlen and len(got) < n:
            scanned += 1
            sid, off = self._ready.popleft()
            seg = self._segments.get(sid)
            if seg is None or off >= seg.count:
                self.stats["queue_dropped"] += 1  # evicted under the draw
                continue
            if seg.resident:
                seg.debt -= 1
                got.append((seg.items[off], (sid << _OFF_BITS) | off,
                            float(seg.prios[off])))
            else:
                self._blocked.setdefault(sid, []).append((sid, off))
                self._request_promote(sid)

    def _mass_table(self):
        seg_list = [self._segments[sid] for sid in self._order
                    if self._segments[sid].mass > 0]
        if not seg_list:
            return [], np.zeros(0, np.float64), 0.0
        cumsum = np.cumsum(np.asarray([s.mass for s in seg_list], np.float64))
        return seg_list, cumsum, float(cumsum[-1])

    def _draw_many(self, k, seg_list, cumsum, total, rng):
        """k independent mass-proportional draws -> [(sid, off), ...].

        Vectorized two-level inverse-CDF: one searchsorted over the
        segment cumsum for all k, then ONE searchsorted per DISTINCT
        segment for the within-segment offsets — identical distribution
        to k scalar draws (same math, batched), at numpy-call cost
        O(segments touched) instead of O(k). Returned in segment-grouped
        order; draws are iid so order carries no information."""
        if total <= 0 or k <= 0:
            return []
        rs = rng.uniform(0.0, total, k)
        seg_is = np.minimum(np.searchsorted(cumsum, rs, side="right"),
                            len(seg_list) - 1)
        within = rs - np.where(seg_is > 0, cumsum[seg_is - 1], 0.0)
        order = np.argsort(seg_is, kind="stable")
        out = []
        i = 0
        while i < k:
            si = int(seg_is[order[i]])
            j = i
            while j < k and int(seg_is[order[j]]) == si:
                j += 1
            seg = seg_list[si]
            if seg.cumsum is None:
                seg.cumsum = np.cumsum(seg.prios[:seg.count])
            offs = np.minimum(
                np.searchsorted(seg.cumsum, within[order[i:j]],
                                side="right"),
                seg.count - 1)
            sid = seg.sid
            out.extend((sid, int(off)) for off in offs)
            i = j
        return out

    def _queue_draw(self, sid: int, off: int) -> None:
        if len(self._ready) >= self.cfg.queue_cap:
            self.stats["queue_dropped"] += 1
            return
        seg = self._segments[sid]
        seg.debt += 1
        self._blocked.setdefault(sid, []).append((sid, off))
        self._request_promote(sid)

    def _forced_fill(self, got: list, n: int, rng) -> None:
        res = [s for s in self._segments.values() if s.resident and s.mass > 0]
        if not res:
            self._partial = []
            raise ColdStoreEmpty(
                "no resident segment to sample (all-cold store: the "
                "router is still promoting)")
        cumsum = np.cumsum(np.asarray([s.mass for s in res], np.float64))
        while len(got) < n:
            for sid, off in self._draw_many(n - len(got), res, cumsum,
                                            float(cumsum[-1]), rng):
                seg = self._segments[sid]
                got.append((seg.items[off], (sid << _OFF_BITS) | off,
                            float(seg.prios[off])))
                self.stats["forced_pads"] += 1

    def _prefetch(self, n: int, seg_list, cumsum, total, rng) -> None:
        """Top up the draw-ahead window so next batch's cold picks are
        already promoting while the learner trains on this one."""
        target = min(max(2 * n, 16), self.cfg.queue_cap)
        need = target - len(self._ready)
        if need <= 0:
            return
        for sid, off in self._draw_many(need, seg_list, cumsum, total, rng):
            seg = self._segments[sid]
            seg.debt += 1
            if seg.resident:
                self._ready.append((sid, off))
            else:
                self._blocked.setdefault(sid, []).append((sid, off))
                self._request_promote(sid)

    def _request_promote(self, sid: int) -> None:
        if sid in self._promote_set:
            return
        seg = self._segments.get(sid)
        if seg is None or seg.state not in ("cold",):
            return
        self._promote_set.add(sid)
        self._promote_req.append(sid)
        self._promote_t.setdefault(sid, time.monotonic())
        if len(self._promote_req) > 4 * self.cfg.max_inflight + 16:
            dropped = self._promote_req.popleft()  # latest wins; its
            self._promote_set.discard(dropped)     # parked draws return
            self._promote_t.pop(dropped, None)     # to the FIFO so a
            #   later drain re-requests the promote (nothing strands)
            self._ready.extend(self._blocked.pop(dropped, ()))

    def has_queued_cold(self) -> bool:
        """True when completion is blocked on promotes (the shard's
        sampling loop uses this to decide to wait vs force)."""
        return bool(self._promote_req) or self._promote_inflight > 0

    # -- backend surface: priority writebacks ------------------------------

    def update_batch(self, idxs: np.ndarray, errors: np.ndarray) -> None:
        """Loss-free across spill/promote by construction: the priority
        array is RAM-resident for every live segment, whatever the
        payload tier. Writebacks to EVICTED segments are dropped and
        counted — the monolithic ring's overwrite-oldest semantic."""
        prios = np.asarray(priority_transform(errors), np.float64).reshape(-1)
        idxs = np.asarray(idxs, np.int64).reshape(-1)
        if idxs.size == 0:
            return
        sids = idxs >> _OFF_BITS
        offs = idxs & (_SEG_CAP - 1)
        order = np.argsort(sids, kind="stable")
        k = idxs.size
        i = 0
        while i < k:
            sid = int(sids[order[i]])
            j = i
            while j < k and int(sids[order[j]]) == sid:
                j += 1
            sel = order[i:j]
            i = j
            seg = self._segments.get(sid)
            if seg is None:
                self.stats["updates_dropped_evicted"] += len(sel)
                continue
            o = offs[sel]
            live = o < seg.count
            if not live.all():
                self.stats["updates_dropped_evicted"] += int((~live).sum())
                sel, o = sel[live], o[live]
                if o.size == 0:
                    continue
            # Duplicate offsets within a batch: numpy fancy assignment
            # keeps the LAST write, matching the sequential scalar
            # semantic; the full-array re-sum then makes the mass exact
            # (no incremental-delta drift).
            seg.prios[o] = prios[sel]
            seg.mass = float(np.sum(seg.prios[:seg.count]))
            seg.cumsum = None

    def update(self, idx: int, error: float) -> None:
        self.update_batch(np.asarray([idx]), np.asarray([error]))

    # -- tier maintenance (ingest + router threads, shard-bracketed) -------

    def tier_pending(self) -> bool:
        return bool(self._promote_req or self._promote_inflight
                    or self._pending_unlinks or self._manifest_dirty
                    or self._spill_victim() is not None
                    or any(s.state in ("spilling", "promoting")
                           for s in self._segments.values()))

    def _spill_victim(self) -> _Segment | None:
        if self._hot_bytes <= self.cfg.hot_bytes:
            return None
        eligible = [s for s in self._segments.values()
                    if s.state == "hot" and s.debt == 0
                    and s.payload_bytes > 0]
        if not eligible:
            return None
        victim = min(eligible, key=lambda s: s.mass)
        # Never spill the last resident mass: the forced-fill fallback
        # (and the all-cold ColdStoreEmpty) need something to stand on.
        resident_mass = sum(s.mass for s in self._segments.values()
                            if s.resident)
        if resident_mass - victim.mass <= 0:
            return None
        return victim

    def _plan_spill(self) -> _TierJob | None:
        victim = self._spill_victim()
        if victim is None:
            return None
        victim.state = "spilling"
        victim.gen += 1
        return _TierJob(
            "spill", sid=victim.sid, gen=victim.gen, mode=self.mode,
            items=victim.items,
            prios=victim.prios.copy(),  # RAM array stays authoritative
            path=victim.file or str(
                self._dir / f"seg_{victim.sid:010d}.bin"),
            crc=victim.file_crc, nbytes=victim.file_nbytes,
            payload_bytes=victim.payload_bytes,
            reuse=victim.file is not None)

    def plan_tier_work(self) -> _TierJob | None:
        """Pick ONE unit of maintenance (promote > spill > unlink >
        manifest sync). Runs under the shard lock; the returned job's
        `run_io` then runs with no lock held.

        Promotes lead because a queued cold draw is a learner waiting —
        EXCEPT under budget pressure (resident payload > 1.25x the hot
        budget): sustained cold sampling promotes faster than the idle
        spill slot drains, and strict promote priority would grow
        resident payload without bound. Past the pressure line spills
        go first; queued promotes run as soon as the tier is back near
        budget."""
        if self._hot_bytes > self.cfg.hot_bytes + self.cfg.hot_bytes // 4:
            job = self._plan_spill()
            if job is not None:
                return job
        while self._promote_req and self._promote_inflight < self.cfg.max_inflight:
            sid = self._promote_req.popleft()
            self._promote_set.discard(sid)
            seg = self._segments.get(sid)
            if seg is None or seg.state != "cold":
                self._promote_t.pop(sid, None)
                continue
            seg.state = "promoting"
            seg.gen += 1
            self._promote_inflight += 1
            return _TierJob("promote", sid=sid, gen=seg.gen, path=seg.file,
                            crc=seg.file_crc, nbytes=seg.file_nbytes,
                            mode=self.mode, payload_bytes=seg.payload_bytes)
        job = self._plan_spill()
        if job is not None:
            return job
        if self._pending_unlinks:
            paths = tuple(self._pending_unlinks)
            self._pending_unlinks.clear()
            return _TierJob("unlink", paths=paths)
        if self._manifest_dirty:
            return _TierJob("sync")
        return None

    def commit_tier_work(self, job: _TierJob) -> dict | None:
        """Apply a finished job under the shard lock; returns a manifest
        snapshot to persist (outside the lock) when tier state changed."""
        if job.kind == "promote":
            self._commit_promote(job)
        elif job.kind == "spill":
            self._commit_spill(job)
        # unlink/sync carry no state; fall through to the manifest check
        if self._manifest_dirty:
            self._manifest_dirty = False
            return self._manifest_snapshot()
        return None

    def _commit_promote(self, job: _TierJob) -> None:
        self._promote_inflight -= 1
        seg = self._segments.get(job.sid)
        if seg is None or seg.gen != job.gen or seg.state != "promoting":
            return  # evicted/restarted under the read: nothing to place
        if job.error is not None or job.result is None:
            # Poison isolation: ONE segment drops (crc/decode failure),
            # the shard keeps serving. Queued draws against it fall out
            # of the ready queue as queue_dropped.
            self.stats["crc_dropped"] += 1
            self._drop_segment(seg)
            self._obs_events.append(("crc_dropped", 1.0))
            return
        seg.items = list(job.result)
        seg.state = "hot"
        self._hot_bytes += seg.payload_bytes
        self._cold_bytes -= seg.payload_bytes
        # Parked draws jump the FIFO: they have waited a promote round
        # trip already, and delivering them clears the segment's debt so
        # it becomes spillable again.
        for entry in self._blocked.pop(job.sid, ()):
            self._ready.appendleft(entry)
        self.stats["promoted_segments"] += 1
        self.stats["promoted_bytes"] += seg.payload_bytes
        wait_ms = (time.monotonic()
                   - self._promote_t.pop(job.sid, time.monotonic())) * 1e3
        self._obs_events.append(("promote_wait_ms", wait_ms))
        self._obs_events.append(("promoted_bytes", float(seg.payload_bytes)))

    def _commit_spill(self, job: _TierJob) -> None:
        seg = self._segments.get(job.sid)
        if seg is None or seg.gen != job.gen or seg.state != "spilling":
            # Evicted while the write was in flight: the freshly written
            # file (if any) has no owner left — reclaim it.
            if seg is None and not job.reuse and job.result is not None:
                self._pending_unlinks.append(job.result[0])
            return
        if job.error is not None or job.result is None:
            seg.state = "hot"  # keep it resident; retry on a later pass
            self.stats["spill_errors"] += 1
            return
        path, crc, nbytes = job.result
        if seg.file is None:
            self._disk_bytes += nbytes
        seg.file, seg.file_crc, seg.file_nbytes = path, crc, nbytes
        seg.items = None
        seg.state = "cold"
        self._hot_bytes -= seg.payload_bytes
        self._cold_bytes += seg.payload_bytes
        self.stats["spilled_segments"] += 1
        self.stats["spilled_bytes"] += seg.payload_bytes
        self._manifest_dirty = True
        self._manifest_ver += 1
        self._obs_events.append(("spilled_bytes", float(seg.payload_bytes)))

    def _manifest_snapshot(self) -> dict:
        return {
            "ver": self._manifest_ver,
            "segments": [
                {"sid": s.sid, "file": os.path.basename(s.file),
                 "count": s.count, "mass": s.mass, "crc": s.file_crc,
                 "nbytes": s.file_nbytes, "payload_bytes": s.payload_bytes}
                for sid in self._order
                for s in (self._segments[sid],)
                # Any file-backed segment recovers, even if currently
                # hot (promoted copies keep their file for cheap
                # re-spill) — restart then re-reads it as cold.
                if s.file is not None
            ],
        }

    def write_manifest(self, snap: dict) -> None:
        """Persist a manifest snapshot (OUTSIDE the shard lock). Writes
        are version-ordered so two maintenance threads interleaving
        commits can never regress the file to an older snapshot."""
        with self._io_lock:
            if self._closed or snap["ver"] <= self._manifest_written_ver:
                return
            _atomic_write_bytes(
                self._dir / "manifest.json",
                json.dumps(snap, separators=(",", ":")).encode())
            self._manifest_written_ver = snap["ver"]

    def take_obs(self) -> list[tuple[str, float]]:
        events, self._obs_events = self._obs_events, []
        return events

    def close(self) -> None:
        with self._io_lock:
            self._closed = True

    # -- tier telemetry -----------------------------------------------------

    def tier_stats(self) -> dict:
        hot_items = sum(s.count for s in self._segments.values() if s.resident)
        return dict(self.stats,
                    hot_items=hot_items,
                    cold_items=self._count - hot_items,
                    hot_bytes=self._hot_bytes,
                    cold_bytes=self._cold_bytes,
                    disk_bytes=self._disk_bytes,
                    ram_bytes=self.ram_bytes(),
                    segments=len(self._segments),
                    queue_depth=(len(self._ready)
                                 + sum(len(v)
                                       for v in self._blocked.values())))

    # -- checkpoint round trip ----------------------------------------------

    def snapshot(self) -> dict:
        """List-backend snapshot format. Cold items come back as lazy
        per-item refs (`materialize()` loads the segment file ONCE, on
        the checkpoint thread, outside the shard lock — the shard's
        snapshot() materializes after releasing its lock)."""
        prios: list[np.ndarray] = []
        items: list[Any] = []
        for sid in self._order:
            seg = self._segments[sid]
            if seg.count == 0:
                continue
            prios.append(seg.prios[:seg.count].copy())
            if seg.resident:
                items.extend(seg.items)
            else:
                loader = _SegmentLoader(seg.file, seg.file_crc,
                                        seg.file_nbytes, self.mode, seg.count)
                items.extend(_SegmentRef(loader, i) for i in range(seg.count))
        return {"priorities": (np.concatenate(prios) if prios
                               else np.zeros(0, np.float64)),
                "items": items, "beta": float(self.beta)}

    def restore(self, snap: dict) -> None:
        from distributed_reinforcement_learning_tpu_torch.data.replay import _snapshot_items

        for p, item in zip(np.asarray(snap["priorities"], np.float64),
                           _snapshot_items(snap)):
            self._append(float(p), item)  # raw: already transformed
        self.beta = float(snap.get("beta", self.beta))


class _SegmentLoader:
    """Shared one-shot loader behind a cold segment's snapshot refs —
    the file is read and decoded at most once per snapshot pass (single
    checkpoint thread by contract, like LazyBlob's materializer)."""

    __slots__ = ("_job", "_items")

    def __init__(self, path: str, crc: int, nbytes: int, mode: str,
                 count: int):
        self._job = _TierJob("promote", sid=-1, path=path, crc=crc,
                             nbytes=nbytes, mode=mode)
        self._items: list[Any] | None = None

    def get(self, i: int):
        if self._items is None:
            header, _, payload = _parse_segment(
                memoryview(Path(self._job.path).read_bytes()))
            self._items = _deserialize_records(
                payload, header["records"], header["mode"], header["count"])
        item = self._items[i]
        return item.materialize() if hasattr(item, "materialize") else item


class _SegmentRef:
    """One cold item inside a snapshot; duck-types LazyBlob's
    `materialize()` so `replay_service._materialize` resolves it on the
    checkpoint/learner thread."""

    __slots__ = ("_loader", "_i")

    def __init__(self, loader: _SegmentLoader, i: int):
        self._loader = loader
        self._i = i

    def materialize(self):
        return self._loader.get(self._i)
