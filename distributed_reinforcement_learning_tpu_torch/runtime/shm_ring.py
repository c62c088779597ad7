"""Zero-copy shared-memory ring transport for co-hosted actors.

Copy of the JAX package's `runtime/shm_ring.py` (it imports no jax): the
same segment layout, record framing, creator-pid word and gate, so a
ring one package creates is attached and drained by the other byte for
byte (`tests/test_torch_shm_ring.py`). The unset gate is the constant
`RING_AUTO_ENABLE`, which holds the JAX package's committed verdict.

The actor -> learner PUT path over loopback TCP pays the wire frame, two
kernel copies and a request/reply round trip even when actor and
learner share a host. This module is the co-hosted alternative: a
lock-free SPSC byte ring over `multiprocessing.shared_memory` — ONE ring
per co-hosted actor (the actor's process is the single producer, a
learner-side drainer thread the single consumer), carrying framed codec
blobs. An actor PUT becomes a single memcpy into shared memory: no wire
frame, no syscalls, no per-unroll round trip. Control traffic (weight
pulls, stats, queue-size polls, fleet heartbeats) stays on the TCP
transport.

Memory layout (offsets in the shared segment):

    0    magic u32 | version u32 | capacity u64
    24   creator pid u64 (shared with the weight-board layouts)
    32   learner admission pressure u32 (permille)
    64   head u64   — producer cursor (monotonic byte count, incl. pads)
    128  tail u64   — consumer cursor (monotonic)
    192  producer_closed u32 | consumer_closed u32
    256  data[capacity]

head and tail live on their own cache lines (each side OWNS one index
and only READS the other); each side additionally caches the remote
index and re-reads it only when the cached value is insufficient, so the
steady-state put/get touches one shared word. Records are [u32
len][payload] padded to 8 bytes; a record that would straddle the end of
the buffer is preceded by a 0xFFFFFFFF wrap marker (or, when fewer than
4 bytes remain, an implicit skip both sides compute) so every blob is
one contiguous memcpy on both ends.

Why this is safe without atomics — and WHERE: each index has exactly
one writer; aligned 8-byte stores/loads through a memoryview are single
memcpy calls (not torn by CPython), and the payload bytes are written
before the head store in program order. On x86-64, TSO guarantees other
cores observe those stores in that order, so the head store is a valid
publish. On weakly-ordered CPUs (aarch64) that guarantee does NOT hold —
pure Python has no portable store fence — so `ring_enabled()` refuses
to auto-enable off x86-64 (DRL_SHM_RING=1 still forces, for
single-machine testing), and the consumer validates every record length
against the readable span, failing LOUDLY (RingClosed -> the actor's TCP
fallback) instead of decoding garbage if a torn publish ever surfaces.
Full or empty rings wait with a bounded spin on the shared index, then
escalate to short sleeps (50us doubling to 1ms).

Lifecycle: the LEARNER creates rings (`serve_rings`, names from
`DRL_SHM_RING_CREATE`), registers an atexit unlink, and drains them
into its ingest queue (`fifo.blob_ingest`, the same seam the TCP server
uses: under the sharded replay service each drain thread ingests into a
shard); the actor attaches by name (`DRL_SHM_RING_NAME`) with a bounded
retry and FALLS BACK to the TCP queue when the ring never appears or
dies mid-run; the local-cluster launcher (`launch_local_cluster.py`)
additionally reaps the segments after the topology exits, so a
SIGKILLed learner cannot leak /dev/shm. `DRL_SHM_RING` gates the whole
feature: 1 forces on, 0 forces off, unset defers to `RING_AUTO_ENABLE`
on x86-64.
"""

from __future__ import annotations

import atexit
import os
import struct
import threading
import time
from typing import Any

from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS
from distributed_reinforcement_learning_tpu_torch.runtime.fleet import ShmReattachMixin
from distributed_reinforcement_learning_tpu_torch.runtime.transport import _LockedStatsMixin

_MAGIC = 0x52494E47  # "RING"
_VERSION = 1
_PID_OFF = 24  # creator pid u64 — shared with the weight-board layouts
_PRESSURE_OFF = 32  # learner admission pressure, u32 permille (consumer
#   writes, producer reads): ring PUTs have no reply payload, so the
#   live backpressure signal TCP actors get on every PUT reply
#   (runtime/transport.py) rides the shared header instead.
_HEAD_OFF = 64
_TAIL_OFF = 128
_PCLOSED_OFF = 192
_CCLOSED_OFF = 196
_DATA_OFF = 256
_WRAP = 0xFFFFFFFF
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_SPIN = 200          # bounded spin before the first sleep
_SLEEP_MIN = 50e-6   # first sleep once the spin budget is burned
_SLEEP_MAX = 1e-3    # backoff cap: worst-case wake latency
# Confirm-before-corrupt budget for the consumer: a record-length
# validation failure is re-checked this many times (fresh head + length
# re-reads; the first _SPIN confirms are back-to-back, the remainder
# sleep with the same 50us->1ms escalation as the empty-ring wait, so
# the full budget spans ~200ms of wall clock) before the ring is
# declared corrupt. Rationale: on some kernels a
# cross-process mmap read can TRANSIENTLY
# return stale bytes — observed as a zero head word while the producer
# was thousands of records ahead — and the old fail-fast check turned
# that one stale read into a permanently dropped ring. A real torn
# publish stays torn across every re-read (the ~200ms confirm cost is
# paid once, on the way to a permanent verdict); a stale snapshot
# heals within the window.
_CORRUPT_CONFIRM = 400


def _align8(n: int) -> int:
    return (n + 7) & ~7


class RingClosed(ConnectionError):
    """The other side of the ring is gone (subclasses ConnectionError so
    the actor's elastic-grace loop treats it like a transport outage)."""


def _attach_shm(name: str):
    """Attach an existing segment WITHOUT handing it to this process's
    resource tracker: the creator owns unlink, and (pre-3.13, where
    there is no track=False) an attached process exiting would otherwise
    unlink the segment under the creator or spam tracker warnings."""
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(name=name, create=False)
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
    except Exception:  # noqa: BLE001  # drlint: disable=silent-except(tracker internals are stdlib-version-dependent; worst case is a spurious resource_tracker warning at exit, never corruption)
        pass
    return shm


def pid_alive(pid: int) -> bool:
    """Best-effort liveness for the creator-pid word (0 = unknown
    creator, treated as not-alive: only ever consulted for a segment
    bearing OUR name, so reclaiming an unowned homonym is correct)."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, just not ours to signal


def segment_owner_pid(name: str) -> int:
    """Creator pid recorded in a ring/board segment header (offset 24 in
    every layout); 0 when unreadable/absent. The launcher's reaper keys
    its sweep on this so it never unlinks a RESPAWNED learner's live
    segment while reaping the dead incarnation's leftovers."""
    try:
        shm = _attach_shm(name)
    except (FileNotFoundError, OSError, ValueError):
        return 0
    try:
        if shm.size < _PID_OFF + 8:
            return 0
        return int(_U64.unpack_from(shm.buf, _PID_OFF)[0])
    finally:
        shm.close()


def create_or_reclaim_shm(name: str, size: int):
    """`SharedMemory(create=True)` that RECLAIMS a stale same-name
    segment whose creator process is dead (the header's pid word,
    offset 24). A SIGKILLed learner leaves its segments in /dev/shm;
    without this, the respawned learner's create fails and the whole
    fast plane silently stays demoted to TCP. A live creator still
    fails the create — two learners must never share a segment name."""
    from multiprocessing import shared_memory

    try:
        return shared_memory.SharedMemory(name=name, create=True, size=size)
    except FileExistsError:
        if pid_alive(segment_owner_pid(name)):
            raise
        import sys

        try:
            stale = _attach_shm(name)
            stale.unlink()
            stale.close()
        except (FileNotFoundError, OSError):
            pass  # raced another reaper: the name may be free now
        print(f"[shm] reclaimed stale segment {name!r} (creator dead)",
              file=sys.stderr)
        return shared_memory.SharedMemory(name=name, create=True, size=size)


class ShmRing:
    """One SPSC ring. Exactly one process calls `put_blob` (the
    producer) and exactly one calls `get_blob` (the consumer); the
    creator additionally owns `unlink`.

    Concurrency map (tools/drlint lock-discipline): deliberately EMPTY
    and kept as documentation — the ring is lock-free by construction.
    Each shared index has a single writer (`_head`: producer,
    `_tail`: consumer), the flags are monotonic one-way latches, and
    every local attribute is touched only by its own side's single
    thread. Cross-thread/-process visibility goes through the shared
    segment, never through Python attributes.
    """

    _GUARDED_BY: dict = {}

    def __init__(self, shm, capacity: int, owner: bool):
        self._shm = shm
        self._buf = shm.buf
        self.capacity = capacity
        self.name = shm.name.lstrip("/")
        self._owner = owner
        self._closed = False
        # Each side's authoritative copy of ITS index plus a cache of the
        # remote one (refreshed only when insufficient).
        self._head = self._read_u64(_HEAD_OFF)
        self._tail = self._read_u64(_TAIL_OFF)
        self._cached_tail = self._tail
        self._cached_head = self._head
        # Confirm-before-corrupt state (consumer-thread-only): persists
        # ACROSS get_blob calls so a short-timeout caller (the drainer's
        # 0.2s polls) still accumulates toward the corrupt verdict on a
        # genuinely torn record instead of restarting the budget every
        # call and spinning on it forever.
        self._suspect = 0  # consecutive failed validations at one tail
        self._confirm_sleep = _SLEEP_MIN

    # -- construction -----------------------------------------------------

    @classmethod
    def create(cls, name: str, capacity: int) -> "ShmRing":
        capacity = _align8(max(capacity, 4096))
        # create_or_reclaim: a respawned learner re-creates its rings
        # under the SAME names; the dead incarnation's stale segment
        # (SIGKILL skipped the unlink) is reclaimed by creator-pid.
        shm = create_or_reclaim_shm(name, _DATA_OFF + capacity)
        ring = cls(shm, capacity, owner=True)
        # Magic is written LAST: it is the header's commit word, so an
        # attacher racing this constructor either sees no magic (and
        # retries) or a fully-initialized header — never a zero capacity.
        ring._write_u64(8, capacity)
        ring._write_u64(_PID_OFF, os.getpid())
        ring._write_u64(_HEAD_OFF, 0)
        ring._write_u64(_TAIL_OFF, 0)
        ring._write_u32(_PCLOSED_OFF, 0)
        ring._write_u32(_CCLOSED_OFF, 0)
        ring._write_u32(_PRESSURE_OFF, 0)
        ring._write_u32(4, _VERSION)
        ring._write_u32(0, _MAGIC)
        return ring

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        shm = _attach_shm(name)
        view = shm.buf
        magic = _U32.unpack_from(view, 0)[0]
        version = _U32.unpack_from(view, 4)[0]
        capacity = int(_U64.unpack_from(view, 8)[0])
        # Capacity/segment-size validation doubles as the race guard for
        # the commit-word scheme above: a half-written header can never
        # hand back a usable-looking ring.
        if (magic != _MAGIC or version != _VERSION or capacity <= 0
                or shm.size < _DATA_OFF + capacity):
            shm.close()
            raise ValueError(f"{name}: not an initialized v{_VERSION} shm ring")
        return cls(shm, capacity, owner=False)

    # -- raw header access -------------------------------------------------

    def _read_u32(self, off: int) -> int:
        return _U32.unpack_from(self._buf, off)[0]

    def _write_u32(self, off: int, value: int) -> None:
        _U32.pack_into(self._buf, off, value)

    def _read_u64(self, off: int) -> int:
        return _U64.unpack_from(self._buf, off)[0]

    def _write_u64(self, off: int, value: int) -> None:
        _U64.pack_into(self._buf, off, value)

    @property
    def creator_pid(self) -> int:
        """The creating process's pid (header word): reattach probes
        validate a reappeared segment belongs to the CURRENT learner
        incarnation, not the dead one's un-reaped corpse."""
        return int(self._read_u64(_PID_OFF))

    @property
    def producer_closed(self) -> bool:
        return self._read_u32(_PCLOSED_OFF) != 0

    @property
    def consumer_closed(self) -> bool:
        return self._read_u32(_CCLOSED_OFF) != 0

    def set_pressure(self, permille: int) -> None:
        """Consumer-side: publish the learner's live ingest pressure
        (0..1000 permille) into the shared header — the ring's
        equivalent of the u16 the TCP server appends to PUT replies.
        Single writer (the drain thread), word-sized: tearing-free."""
        self._write_u32(_PRESSURE_OFF, max(0, min(1000, int(permille))))

    def pressure(self) -> int:
        """Producer-side: the last pressure permille the consumer
        published (0 until it ever does)."""
        return int(self._read_u32(_PRESSURE_OFF))

    def used_bytes(self) -> int:
        """Bytes in flight (includes framing/padding) — the `ring/depth`
        telemetry signal; safe to poll from any thread."""
        return max(self._read_u64(_HEAD_OFF) - self._read_u64(_TAIL_OFF), 0)

    # -- producer side -----------------------------------------------------

    def put_blob(self, blob, timeout: float | None = None) -> bool:
        """One framed memcpy into the ring. Blocks (bounded spin, then
        sleeps) while full; False on timeout; RingClosed once the
        consumer is gone. The caller's buffer is consumed by value — it
        may be reused the moment this returns."""
        if self.consumer_closed:  # fail fast, not only once full
            raise RingClosed(f"ring {self.name}: consumer closed")
        n = len(blob)
        rec = _align8(4 + n)
        if 2 * rec > self.capacity:
            raise ValueError(
                f"blob of {n} bytes cannot fit a {self.capacity}-byte ring "
                f"(need 2*{rec} <= capacity for guaranteed progress)")
        pos = self._head % self.capacity
        to_end = self.capacity - pos
        if to_end < 4:
            skip = to_end          # no room for a wrap marker: implicit
            start, marker = 0, False  # skip both sides compute from pos
        elif to_end < rec:
            skip = to_end
            start, marker = 0, True
        else:
            skip = 0
            start, marker = pos, False
        total = skip + rec
        deadline = None if timeout is None else time.monotonic() + timeout
        waited_since: float | None = None
        spins = 0
        sleep_s = _SLEEP_MIN
        while self.capacity - (self._head - self._cached_tail) < total:
            if self.consumer_closed:
                raise RingClosed(f"ring {self.name}: consumer closed")
            self._cached_tail = self._read_u64(_TAIL_OFF)
            if self.capacity - (self._head - self._cached_tail) >= total:
                break
            if waited_since is None:
                waited_since = time.perf_counter()
            spins += 1
            if spins <= _SPIN:
                continue
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(sleep_s)
            sleep_s = min(2 * sleep_s, _SLEEP_MAX)
        if marker:
            self._write_u32(_DATA_OFF + pos, _WRAP)
        self._write_u32(_DATA_OFF + start, n)
        if n:
            self._buf[_DATA_OFF + start + 4:_DATA_OFF + start + 4 + n] = blob
        # Publish AFTER the payload bytes: the head store is the commit.
        self._head += total
        self._write_u64(_HEAD_OFF, self._head)
        if _OBS.enabled:
            _OBS.count("ring/bytes_total", n)
            if waited_since is not None:
                _OBS.gauge("ring/full_wait_ms",
                           (time.perf_counter() - waited_since) * 1e3)
        return True

    def close_producer(self) -> None:
        """Latch 'no more blobs' so the consumer can drain-and-stop."""
        self._write_u32(_PCLOSED_OFF, 1)

    # -- consumer side -----------------------------------------------------

    def get_blob(self, timeout: float | None = None) -> bytes | None:
        """Pop one blob (copied out of the segment, so the slot frees
        immediately); None on timeout. `drained()` distinguishes a
        producer that is gone from one that is merely quiet."""
        deadline = None if timeout is None else time.monotonic() + timeout
        spins = 0
        sleep_s = _SLEEP_MIN
        while True:
            if self._cached_head == self._tail:
                self._cached_head = self._read_u64(_HEAD_OFF)
                if self._cached_head == self._tail:
                    spins += 1
                    if spins <= _SPIN:
                        continue
                    if deadline is not None and time.monotonic() >= deadline:
                        return None
                    time.sleep(sleep_s)
                    sleep_s = min(2 * sleep_s, _SLEEP_MAX)
                    continue
            pos = self._tail % self.capacity
            to_end = self.capacity - pos
            if to_end < 4:
                self._tail += to_end  # implicit skip (mirrors the producer)
                self._write_u64(_TAIL_OFF, self._tail)
                continue
            n = self._read_u32(_DATA_OFF + pos)
            if n == _WRAP:
                self._tail += to_end
                self._write_u64(_TAIL_OFF, self._tail)
                self._suspect = 0  # tail advanced: suspicion resolved
                self._confirm_sleep = _SLEEP_MIN
                continue
            if n == 0 and self._suspect <= _CORRUPT_CONFIRM:
                # A zero length here is almost certainly the same stale
                # read as above (no plane ships empty blobs), and unlike
                # an oversize length it would pass validation and DESYNC
                # the framing. Confirm through the same budget; a zero
                # that persists is a genuine empty record and falls
                # through to normal consumption.
                self._suspect += 1
                self._cached_head = self._read_u64(_HEAD_OFF)
                if deadline is not None and time.monotonic() >= deadline:
                    return None  # confirm state persists to the next call
                if self._suspect > _SPIN:
                    time.sleep(self._confirm_sleep)
                    self._confirm_sleep = min(2 * self._confirm_sleep,
                                              _SLEEP_MAX)
                continue
            if _align8(4 + n) > to_end or \
                    self._tail + _align8(4 + n) > self._cached_head:
                # A length that overruns the readable span is EITHER a
                # real torn publish (weakly-ordered CPU without
                # DRL_SHM_RING forced — module docstring) or a stale
                # cross-process read (some kernels: observed
                # zero head words; _CORRUPT_CONFIRM comment). CONFIRM
                # before the nuclear verdict: refresh the head snapshot
                # and re-read the length; only a validation failure that
                # SURVIVES the whole confirm budget drops the ring.
                self._suspect += 1
                if self._suspect <= _CORRUPT_CONFIRM:
                    self._cached_head = self._read_u64(_HEAD_OFF)
                    if deadline is not None and time.monotonic() >= deadline:
                        return None  # confirm state persists to next call
                    if self._suspect > _SPIN:
                        time.sleep(self._confirm_sleep)
                        self._confirm_sleep = min(2 * self._confirm_sleep,
                                                  _SLEEP_MAX)
                    continue
                self.close_consumer()
                raise RingClosed(
                    f"ring {self.name}: corrupt record length {n} at "
                    f"tail {self._tail} (torn publish? confirmed "
                    f"{_CORRUPT_CONFIRM}x)")
            self._suspect = 0
            self._confirm_sleep = _SLEEP_MIN
            start = _DATA_OFF + pos + 4
            blob = bytes(self._buf[start:start + n])
            self._tail += _align8(4 + n)
            self._write_u64(_TAIL_OFF, self._tail)
            return blob

    def drained(self) -> bool:
        """True only when the producer latched closed AND everything it
        published has been consumed (flag read BEFORE the final head
        re-read, so a put racing the close is never missed)."""
        if not self.producer_closed:
            return False
        return self._read_u64(_HEAD_OFF) == self._tail

    def close_consumer(self) -> None:
        """Latch 'stop producing' so a blocked producer fails fast."""
        self._write_u32(_CCLOSED_OFF, 1)

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


# -- adjudication gate -------------------------------------------------------

# Unset-gate default. The JAX package reads it from
# `benchmarks/transport_verdict.json` (`auto_enable`: the ring-vs-TCP PUT
# A/B had to reach 1.2x; its median was 1.16), which this package does
# not read; false there today.
RING_AUTO_ENABLE = False


def ring_enabled() -> bool:
    """DRL_SHM_RING=1 forces rings on, =0 off; unset/auto defers to
    `RING_AUTO_ENABLE` — but never auto-enables off x86-64, where
    the ring's store-ordering argument does not hold (module docstring);
    the corrupt-record check + TCP fallback make a forced =1 survivable
    for single-machine experimentation there."""
    env = os.environ.get("DRL_SHM_RING", "").strip().lower()
    if env in ("1", "true", "yes", "on"):
        return True
    if env in ("0", "false", "no", "off"):
        return False
    import platform

    if platform.machine().lower() not in ("x86_64", "amd64"):
        return False
    return RING_AUTO_ENABLE


def ring_capacity_bytes() -> int:
    return int(float(os.environ.get("DRL_SHM_RING_MB", "64")) * 1e6)


# -- learner side: create + drain into the TrajectoryQueue -------------------


class RingDrainer(_LockedStatsMixin):
    """One thread per ring popping blobs into the learner's bounded
    queue — the learner-side half of the zero-copy PUT path. Ingest
    semantics are shared with the TCP server via `fifo.blob_ingest`
    (raw bytes for blob-native queues, a decoded copy otherwise), so the
    two transports cannot drift on what lands in the queue. Under
    DRL_REPLAY_SHARDS the "queue" is the replay-shard facade
    (runtime/replay_shard.py): the same seam then makes each drain
    thread the owner of a replay shard — decode + initial priority +
    insert happen right here instead of on the learner thread."""

    # Concurrency map (tools/drlint lock-discipline): the per-ring drain
    # threads bump `stats` while telemetry providers and stop() read it
    # from other threads (accessors from transport._LockedStatsMixin,
    # the same locked-stats contract the TCP server/client use), and
    # `_dropped` is written by a drain thread on corruption while the
    # telemetry flush thread reads it in depth_bytes. Rings themselves
    # are SPSC (each drain thread is the sole consumer of its ring) and
    # `_threads` is written once in start() before the threads exist,
    # then only read.
    _GUARDED_BY = {"stats": "_stats_lock", "_dropped": "_stats_lock"}
    _NOT_GUARDED = {
        "_threads": "written once in start() before the drain threads "
                    "exist, then only read (see map comment above)",
    }

    def __init__(self, rings: list[ShmRing], queue):
        self.rings = rings
        self.queue = queue
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.stats = {"unrolls_drained": 0, "bytes_drained": 0}
        self._dropped: set[int] = set()  # ids of corrupt, abandoned rings
        self._stats_lock = threading.Lock()

    def depth_bytes(self) -> int:
        """Summed in-flight bytes across LIVE rings (the `ring/depth`
        provider): a corruption-dropped ring's never-to-drain backlog
        must not render as a frozen stall in obs_report."""
        with self._stats_lock:
            dropped = set(self._dropped)
        return sum(r.used_bytes() for r in self.rings
                   if id(r) not in dropped)

    def start(self) -> "RingDrainer":
        self._threads = [
            threading.Thread(target=self._drain_loop, args=(ring,),
                             daemon=True, name=f"ring-drain-{i}")
            for i, ring in enumerate(self.rings)
        ]
        for t in self._threads:
            t.start()
        return self

    def _drain_loop(self, ring: ShmRing) -> None:
        import time as _time

        from distributed_reinforcement_learning_tpu_torch.data.fifo import blob_ingest

        prepare, put = blob_ingest(self.queue)
        # Backpressure parity with TCP actors: the sharded-ingest facade
        # exposes the learner's live pressure permille (the value the
        # TCP server appends to PUT replies); publish it through the
        # ring header so co-hosted producers run the SAME admission
        # ladder. Throttled — a header word per ~100ms, not per blob.
        pressure = getattr(self.queue, "ingest_pressure", None)
        last_pub = 0.0
        while not self._stop.is_set():
            if pressure is not None:
                now = _time.monotonic()
                if now - last_pub >= 0.1:
                    last_pub = now
                    ring.set_pressure(pressure())
            try:
                blob = ring.get_blob(timeout=0.2)
            except RingClosed as e:  # corrupt record: drop the ring, the
                import sys           # producer demotes itself to TCP

                print(f"[shm_ring] WARNING: {e}; ring dropped",
                      file=sys.stderr)
                with self._stats_lock:  # hide its backlog from ring/depth
                    self._dropped.add(id(ring))
                return
            if blob is None:
                if ring.drained():
                    return
                continue
            item = prepare(blob)
            try:
                # _stop-aware slices, like the TCP server's _enqueue: the
                # bounded queue's backpressure propagates to the ring
                # (which fills, blocking the actor) instead of dropping.
                while not self._stop.is_set():
                    if put(item, timeout=0.5):
                        self._bump("unrolls_drained")
                        self._bump("bytes_drained", len(blob))
                        break
            except RuntimeError:  # queue closed: learner shutting down
                return

    def stop(self) -> None:
        self._stop.set()
        for ring in self.rings:
            ring.close_consumer()
        for t in self._threads:
            t.join(timeout=2.0)
        for ring in self.rings:
            ring.close()
            ring.unlink()


def serve_rings(names: list[str], queue) -> RingDrainer | None:
    """Learner-side wiring: create one ring per co-hosted actor and start
    the drainer. Returns None (TCP-only operation continues) if any
    segment cannot be created — the ring is an optimization, never a
    prerequisite. Created segments are unlinked at stop() and again via
    atexit (crash backstop)."""
    import sys

    rings: list[ShmRing] = []
    capacity = ring_capacity_bytes()
    try:
        for name in names:
            rings.append(ShmRing.create(name, capacity))
    except (OSError, ValueError) as e:
        print(f"[shm_ring] WARNING: cannot create ring segments ({e}); "
              f"staying on TCP", file=sys.stderr)
        for ring in rings:
            ring.close()
            ring.unlink()
        return None
    drainer = RingDrainer(rings, queue).start()
    atexit.register(lambda: [r.unlink() for r in rings])
    return drainer


# -- actor side: put surface with graceful TCP fallback ----------------------


class RingQueue(_LockedStatsMixin, ShmReattachMixin):
    """The actor-runner queue surface (`put`/`put_many`/`size`) with the
    DATA plane on a shm ring and the CONTROL plane (queue-size polls) on
    the TCP client. Mirrors `RemoteQueue` semantics: puts block under
    backpressure, a wedged learner surfaces as ConnectionError after
    `full_timeout`, and a dead ring (consumer closed — learner gone or
    restarted) demotes this queue to the TCP path rather than killing
    the actor. Demotion is no longer permanent: `reattach()` (driven
    from the fleet heartbeat cadence, runtime/fleet.py) re-attaches the
    SAME ring name on a bounded RetryLadder once a respawned learner
    re-creates the segment — validated fresh (neither side latched
    closed) and belonging to the CURRENT learner incarnation (the
    header's creator-pid word against the heartbeat-reported pid), so
    the probe can never re-adopt the dead incarnation's corpse.

    Concurrency map (tools/drlint lock-discipline): `stats` is bumped on
    the actor loop thread and polled by the telemetry flush thread's
    providers (accessors from transport._LockedStatsMixin). `_ring` is
    swapped by the actor loop thread (demote/close) AND the heartbeat
    thread (reattach install), so the reference lives under `_lock`;
    the ring OBJECT stays actor-thread-only — the heartbeat thread only
    installs a fresh attach it has not used, never touches an installed
    one.
    """

    _GUARDED_BY = {"stats": "_stats_lock", "_ring": "_lock",
                   "_closed": "_lock", "_stale": "_lock"}
    _NOT_GUARDED = {
        "demoted_at": "appended by the actor thread's demote only, read after it stops",
        "_admission": "set once by the owning actor runner "
                      "(set_admission) before the publish thread starts; "
                      "read-only on the put paths thereafter",
    }

    surface_name = "ring"  # fleet heartbeat registration label

    def __init__(self, ring: ShmRing | None, client,
                 full_timeout: float = 90.0, name: str | None = None):
        from distributed_reinforcement_learning_tpu_torch.runtime.fleet import RetryLadder

        self._closed = False
        self._stale = False  # heartbeat-flagged: demote on next put
        self._ring: ShmRing | None = ring
        self._name = name or (ring.name if ring is not None else None)
        self._client = client
        self.full_timeout = full_timeout
        self._lock = threading.Lock()
        self._ladder = RetryLadder(f"ring-{self._name}")
        self.stats = {"unrolls_sent": 0, "bytes_sent": 0, "tcp_fallbacks": 0,
                      "reattaches": 0, "unrolls_admission_dropped": 0}
        self._stats_lock = threading.Lock()
        # Wall-clock time of each demotion to TCP (the actor thread's own).
        self.demoted_at: list[float] = []
        self._admission = None  # data/admission.AdmissionController —
        #   set once by the owning runner before the publish thread
        #   starts (see set_admission), read-only on put paths after

    def set_admission(self, controller) -> None:
        """Attach an actor-side admission controller
        (data/admission.AdmissionController): ring PUTs score + stamp
        each unroll, and each PUT feeds the controller the learner's
        live pressure permille from the ring header's pressure word
        (published by the drain thread) — the same admission ladder TCP
        actors drive from PUT-reply pressure. `DRL_ADMISSION_PRESSURE`
        still overrides both; the demote-to-TCP path falls back to
        plain (learner-scored) PUTs."""
        self._admission = controller

    @property
    def attached(self) -> bool:
        """True when PUTs currently ride shared memory (False while
        demoted to TCP — including a demoted-at-birth queue that has
        not yet won a reattach probe)."""
        with self._lock:
            return self._ring is not None

    def _ring_ref(self) -> ShmRing | None:
        """The attached ring, or None — handling a heartbeat-flagged
        STALE attachment by demoting here, on the actor thread (the
        ring object is actor-thread-owned; the heartbeat thread never
        closes it, only flags it)."""
        with self._lock:
            ring, stale = self._ring, self._stale
        if ring is not None and stale:
            self._demote(reason=f"ring {self._name!r} belongs to a dead "
                                f"learner incarnation")
            return None
        return ring

    def _demote(self, reason: str = "ring closed under the actor") -> None:
        import sys

        with self._lock:
            ring, self._ring = self._ring, None
            self._stale = False
        if ring is not None:
            ring.close()
        self.demoted_at.append(time.time())
        self._bump("tcp_fallbacks")
        print(f"[shm_ring] WARNING: {reason}; "
              f"falling back to TCP PUTs", file=sys.stderr)

    # -- reattach (fleet.ShmReattachMixin template) -----------------------
    # The stale-attach consequence here: a SIGKILLed learner latches
    # nothing, so the actor would otherwise keep memcpying unrolls into
    # the dead incarnation's orphan segment forever — a trajectory
    # black hole no put-side error ever surfaces. The actor thread
    # demotes on its next put via _ring_ref.

    _ref_attr = "_ring"

    def _probe_attach(self):
        return ShmRing.attach(self._name)

    def _probe_fresh(self, ring, expect) -> bool:
        return (not ring.consumer_closed
                and not ring.producer_closed
                and (expect is None or ring.creator_pid == expect))

    def _on_reattached(self) -> None:
        import sys

        print(f"[shm_ring] ring {self._name!r} re-attached; PUTs back on "
              f"shared memory", file=sys.stderr)

    def reset_reattach(self) -> None:
        """Fresh probe budget (learner epoch change)."""
        self._ladder.reset()

    def _put_blob(self, ring: ShmRing, blob) -> None:
        if not ring.put_blob(blob, timeout=self.full_timeout):
            # Learner alive but the ring stayed full through the whole
            # window: the ring analogue of the TCP client's busy_timeout.
            raise ConnectionError(
                f"ring full for >{self.full_timeout:.0f}s (wedged learner?)")
        self._bump("unrolls_sent")
        self._bump("bytes_sent", len(blob))

    def put(self, item: Any, timeout: float | None = None) -> bool:
        from distributed_reinforcement_learning_tpu_torch.data import codec

        ring = self._ring_ref()
        if ring is None:
            return self._client.put_trajectory(item)
        if self._admission is not None:
            # Header pressure word -> admission ladder (the ring-path
            # mirror of the TCP client's PUT-reply observe_pressure).
            self._admission.observe_pressure(ring.pressure())
        try:
            # Same dedup gating as the TCP client's trajectory PUTs: the
            # drainer's blob_ingest reconstructs before the queue.
            blob = self._admitted_blob(item, codec)
            if blob is None:  # dropped at source (mass folded)
                return True
            self._put_blob(ring, blob)
            return True
        except (RingClosed, ValueError):
            # ValueError = blob too large for this ring's capacity: TCP
            # has no such limit, so demote instead of killing the actor.
            self._demote()
            return self._client.put_trajectory(item)

    def put_many(self, items: list[Any], timeout: float | None = None) -> int:
        from distributed_reinforcement_learning_tpu_torch.data import codec

        ring = self._ring_ref()
        if ring is None:
            return self._client.put_trajectories(items)
        if self._admission is not None:
            self._admission.observe_pressure(ring.pressure())
        sent = 0
        for item in items:
            try:
                blob = self._admitted_blob(item, codec)
                if blob is None:  # dropped at source (mass folded)
                    sent += 1
                    continue
                self._put_blob(ring, blob)
                sent += 1
            except (RingClosed, ValueError):  # dead ring / oversize blob
                self._demote()
                return sent + self._client.put_trajectories(items[sent:])
        return sent

    def _admitted_blob(self, item: Any, codec):
        """Encode one unroll for the ring, applying admission + the
        priority stamp when a controller is attached. None = the
        controller dropped the unroll whole."""
        ctrl = self._admission
        dedup = codec.obs_dedup_enabled()
        if ctrl is None:
            return codec.encode(item, dedup=dedup)
        decision = ctrl.admit(item)
        if not decision.send:
            self._bump("unrolls_admission_dropped")
            return None
        tree = item if decision.tree is None else decision.tree
        blob = codec.stamp_blob(codec.encode(tree, dedup=dedup),
                                decision.stamp)
        ctrl.note_wire(len(blob), decision)
        return blob

    def size(self) -> int:
        return self._client.queue_size()

    def close(self) -> None:
        with self._lock:
            ring, self._ring = self._ring, None
            self._closed = True  # a late reattach must not resurrect us
        if ring is not None:
            ring.close()


def attach_ring_queue(name: str, client,
                      deadline_s: float | None = None) -> RingQueue | None:
    """Actor-side wiring: attach the named ring with a bounded retry and
    wrap it in a RingQueue. None = fall back to the plain TCP queue.

    The window is deliberately SHORT: this runs after the TransportClient
    connected, and the learner creates its rings milliseconds after its
    server starts accepting — so a missing segment a few seconds past
    connect almost certainly means the learner declined (creation
    failed, e.g. an undersized /dev/shm) and a long wait would only
    delay every actor's start in an already-degraded run.

    With the fleet plane on, attach failure returns a DEMOTED-AT-BIRTH
    RingQueue (ring=None, name kept): PUTs ride TCP immediately, but
    the queue still exposes `reattach()` so the heartbeat-driven ladder
    can promote it once the segment appears — an actor respawned
    DURING a learner outage must not be stranded on TCP forever."""
    import sys

    from distributed_reinforcement_learning_tpu_torch.runtime import fleet

    if deadline_s is None:
        deadline_s = float(os.environ.get("DRL_SHM_RING_ATTACH_S", "5"))
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            return RingQueue(ShmRing.attach(name), client)
        except (FileNotFoundError, ValueError) as e:
            if time.monotonic() >= deadline:
                if fleet.fleet_enabled():
                    print(f"[shm_ring] WARNING: cannot attach ring "
                          f"{name!r} ({e}); starting demoted to TCP "
                          f"(reattach ladder armed)", file=sys.stderr)
                    return RingQueue(None, client, name=name)
                print(f"[shm_ring] WARNING: cannot attach ring {name!r} "
                      f"({e}); falling back to TCP", file=sys.stderr)
                return None
            time.sleep(0.2)
