"""Socket data plane: the learner serves trajectories-in / weights-out.

Counterpart of the JAX package's `runtime/transport.py`, with its wire
protocol byte for byte (the op and status codes, the `[u8 op|status]
[u32 len][payload]` framing, the batched PUT payload of `pack_batch`),
so a client of one package talks to a server of the other:

  (i)   PUT_TRAJ / PUT_TRAJ_N  actor -> learner codec blobs, blocking
                                enqueue (the reply waits until the
                                bounded queue accepts: backpressure)
  (ii)  GET_WEIGHTS             learner -> actor versioned snapshot,
                                encoded once per version
        GET_WEIGHTS_SHARDED     the sharded store's manifest and shards,
                                each full, a byte-range delta or elided
                                (runtime/weight_shards.py)
  (iii) QUEUE_SIZE / PING       polls and liveness
  (iv)  REGISTER / HEARTBEAT    the fleet control plane (runtime/fleet.py)
  (v)   ACT                     served acts: actor -> service observation
                                rows, service -> actor action rows
                                (runtime/inference.py), ST_BUSY when the
                                service's admission budget is full

Trajectories cross between the packages: both codecs give the same
bytes for the same tree, and `codec.decode` rebuilds a namedtuple by
name and fields. Weight blobs do not: the port's blob is a flat
`{parameter name: array}` dict of its own module names, a JAX learner's
a flax tree, so `RemoteWeights` refuses anything but a flat dict. The
sharded pull's manifest and shard layouts are the JAX package's, so a
JAX client pulls a port store's shards as bytes. Act
rows are plain numpy row dicts, the JAX package's layouts, and do cross:
a JAX actor acts through a port service and a port actor through a JAX
one.

`run_role` starts one process of the reference topology: `--mode
learner` (queue, weight store, learner on `resolve_device(device)`, this
server; with `serve_inference` an `InferenceServer` on the learner's
device that answers OP_ACT), `--mode actor --task k` (an actor whose
queue and weight store are `RemoteQueue` / `RemoteWeights` over one
`TransportClient`; with `remote_act` it acts through `RemoteInference`,
the learner's service, or `RemoteActService` over the replicas that
`DRL_INFER_ADDRS` names, and pulls no weights), or `--mode inference
--task k` (an act-serving replica, `runtime/serving.run_replica`).
Co-hosted roles take the JAX package's shared-memory planes by the same
names: a learner with `DRL_SHM_RING_CREATE` drains one shm ring per
actor into the queue this server feeds (`runtime/shm_ring.py`), and with
`DRL_SHM_WEIGHTS_CREATE` mirrors every landed version into a weight
board (`runtime/weight_board.py`); an actor with `DRL_SHM_RING_NAME` /
`DRL_SHM_WEIGHTS_NAME` puts and pulls through them, demoting to TCP if
they fail. Under `DRL_WEIGHTS_SHARDED` the learner's store publishes
per shard and its board is the segmented one; every actor's and
replica's TCP pull is shard-scoped (`ShardedRemoteWeights`, scoped to
`DRL_WEIGHTS_KEYS`), demoting itself to the whole-blob op against an
unsharded store. A learner under `DRL_COORDINATOR` / `DRL_NUM_PROCESSES`
/ `DRL_PROCESS_ID` is one rank of a multi-process learner
(`parallel/distributed.py`, `parallel/learner.py`); other roles ignore
those names, as in the JAX package. The group's mesh carries the
transformer families' sequence, pipeline and expert axes
(`runtime/launch.mesh_axes_for`); a config that needs them where no mesh
fits is refused, as in JAX. `--mode anakin` under a learner group is
refused: the JAX package's builds no mesh and ignores the names, so it
would run one independent loop a process (ROADMAP F14); the Anakin loops
take a mesh of ranks in the library (`runtime/anakin_mesh.py`).
The learner's queue is
`_make_queue`'s: the C++ ring queue (`data/native.py:NativeTrajectoryQueue`)
wherever the native library builds, else the Python `TrajectoryQueue`.
A replay learner (Ape-X, R2D2) serves, as the JAX package's does by
default, a `runtime/replay_shard.ReplayIngestFifo` in front of that
queue: each serve thread ingests into its own shard of the sharded
replay service (with the spill tier), and the queue stays the demotion
target. Its PUT replies carry the ingest pressure that drives an
actor's admission controller (`data/admission.py`), which the client
consults before each PUT when actor-side priorities are on.
"""

from __future__ import annotations

import json
import os
import random
import socket
import struct
import sys
import threading
import time
from collections import Counter, deque
from typing import Any

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.data import codec
from distributed_reinforcement_learning_tpu_torch.data.fifo import blob_ingest
from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS
from distributed_reinforcement_learning_tpu_torch.observability import maybe_configure
from distributed_reinforcement_learning_tpu_torch.observability.metrics import stale_bucket

OP_PUT_TRAJ = 1
OP_GET_WEIGHTS = 2
OP_QUEUE_SIZE = 3
OP_PING = 4
OP_ACT = 5  # served acts (runtime/inference.py); ST_UNAVAILABLE without a service
OP_PUT_TRAJ_N = 6  # K unrolls per round trip
OP_GET_WEIGHTS_SHARDED = 7  # manifest + per-shard blobs (weight_shards)
OP_REGISTER = 8  # fleet control plane: member registration (runtime/fleet.py)
OP_HEARTBEAT = 9  # fleet control plane: liveness + incarnation echo

ST_OK = 0
ST_ERROR = 1
ST_CLOSED = 2
ST_BUSY = 3  # bounded-queue timeout: retryable, not a dead learner
ST_UNAVAILABLE = 4  # op permanently not served here

_HDR = struct.Struct("<BI")  # (op|status, payload_len)
_I64 = struct.Struct("<q")
_U32 = struct.Struct("<I")
_U16 = struct.Struct("<H")


def pack_batch(blobs: list) -> list:
    """OP_PUT_TRAJ_N payload parts: [u32 count][u32 len_i]*count [blobs...],
    as parts for `_send_msg` (the blobs are never concatenated)."""
    head = bytearray(_U32.size * (1 + len(blobs)))
    _U32.pack_into(head, 0, len(blobs))
    for i, b in enumerate(blobs):
        _U32.pack_into(head, _U32.size * (1 + i), len(b))
    return [head, *blobs]


def unpack_batch(payload) -> list[memoryview]:
    """Inverse of `pack_batch`: zero-copy views into the payload."""
    (count,) = _U32.unpack_from(payload, 0)
    view = memoryview(payload)
    offset = _U32.size * (1 + count)
    out = []
    for i in range(count):
        (n,) = _U32.unpack_from(payload, _U32.size * (1 + i))
        out.append(view[offset: offset + n])
        offset += n
    if offset != len(payload):
        raise ValueError(f"batch payload length mismatch: {offset} != {len(payload)}")
    return out


def _pack_shard_req(have_version: int, keys, base_version: int,
                    accept_delta: bool) -> bytearray:
    """OP_GET_WEIGHTS_SHARDED request:
    [i64 have][i64 base][u8 flags][u32 nkeys]{[u16 klen][key]}*nkeys.
    nkeys=0 means every manifest shard."""
    keys = keys or ()
    req = bytearray(_I64.size * 2 + 1 + _U32.size)
    _I64.pack_into(req, 0, have_version)
    _I64.pack_into(req, 8, base_version)
    req[16] = 1 if accept_delta else 0
    _U32.pack_into(req, 17, len(keys))
    for key in keys:
        kb = key.encode()
        req += _U16.pack(len(kb)) + kb
    return req


def _parse_shard_req(payload) -> tuple[int, list[str] | None, int, int]:
    have = _I64.unpack_from(payload, 0)[0]
    base = _I64.unpack_from(payload, 8)[0]
    flags = payload[16]
    (nkeys,) = _U32.unpack_from(payload, 17)
    keys: list[str] | None = None
    off = 21
    if nkeys:
        keys = []
        for _ in range(nkeys):
            (klen,) = _U16.unpack_from(payload, off)
            off += _U16.size
            keys.append(bytes(payload[off:off + klen]).decode())
            off += klen
    return have, keys, base, flags


def _pack_shard_reply(version: int, mbytes: bytes, shards
                      ) -> tuple[list, int, int, int]:
    """OP_GET_WEIGHTS_SHARDED reply payload as `_send_msg` parts (the
    multi-MB shard blobs are never concatenated host-side):
    [i64 version][u32 mlen][manifest][u32 n]
    then per shard [u16 klen][key][u8 enc][i64 base][u32 blen][bytes].
    Returns (parts, payload_bytes, n_full, n_delta, n_skip)."""
    from distributed_reinforcement_learning_tpu_torch.runtime import weight_shards

    parts: list = [_I64.pack(version), _U32.pack(len(mbytes)), mbytes,
                   _U32.pack(len(shards))]
    nbytes = nfull = ndelta = nskip = 0
    for key, enc, base, blob in shards:
        kb = key.encode()
        parts.append(_U16.pack(len(kb)) + kb + bytes([enc]) + _I64.pack(base)
                     + _U32.pack(len(blob)))
        if len(blob):
            parts.append(blob)
        nbytes += len(blob)
        nfull += enc == weight_shards.ENC_FULL
        ndelta += enc == weight_shards.ENC_DELTA
        nskip += enc == weight_shards.ENC_SKIP
    return parts, nbytes, nfull, ndelta, nskip


def _parse_shard_reply(resp) -> tuple[int, bytes, list]:
    """Inverse of `_pack_shard_reply`; shard payloads are zero-copy
    views into `resp` (a fresh buffer per `_recv_msg`)."""
    view = memoryview(resp)
    version = _I64.unpack_from(view, 0)[0]
    (mlen,) = _U32.unpack_from(view, 8)
    off = 12
    mbytes = bytes(view[off:off + mlen])
    off += mlen
    (n,) = _U32.unpack_from(view, off)
    off += _U32.size
    shards = []
    for _ in range(n):
        (klen,) = _U16.unpack_from(view, off)
        off += _U16.size
        key = bytes(view[off:off + klen]).decode()
        off += klen
        enc = view[off]
        off += 1
        base = _I64.unpack_from(view, off)[0]
        off += _I64.size
        (blen,) = _U32.unpack_from(view, off)
        off += _U32.size
        shards.append((key, enc, base, view[off:off + blen]))
        off += blen
    if off != len(view):
        raise ValueError(f"shard reply length mismatch: {off} != {len(view)}")
    return version, mbytes, shards


class TransportError(ConnectionError):
    pass


class InferenceUnavailableError(RuntimeError):
    """OP_ACT permanently unserved (a learner without --serve_inference).
    Not a TransportError: the actor's grace loop would ride it out as an
    outage, and a misconfigured learner never recovers."""


class InferenceBusyError(RuntimeError):
    """OP_ACT answered ST_BUSY: the service's admission budget is full.
    Not a TransportError: a busy replica is alive and must not be
    demoted; RemoteActService fails the request over to a sibling, and
    `remote_act(busy_retry=True)` retries it."""


class RemoteActFailed(TransportError):
    """OP_ACT answered ST_ERROR: the endpoint is alive but this request,
    or the batch it joined, failed on the serving side. A TransportError,
    so a single-endpoint actor's grace loop retries; RemoteActService
    tells it apart and does not demote the replica that reported it."""


class _BusyBackoff:
    """The act paths' ST_BUSY wait: full jitter around an exponential base
    (capped at 50 ms), bounded by a deadline from the first busy reply."""

    def __init__(self, timeout: float, rng: random.Random):
        self.timeout = timeout
        self.deadline = time.monotonic() + timeout
        self._delay = 2e-3
        self._rng = rng

    def sleep_or_raise(self, what: str) -> None:
        if time.monotonic() >= self.deadline:
            raise TransportError(f"{what} busy for >{self.timeout:.0f}s")
        time.sleep(self._rng.uniform(0.5, 1.5) * self._delay)
        self._delay = min(2 * self._delay, 0.05)


class ShardedWeightsUnavailableError(RuntimeError):
    """OP_GET_WEIGHTS_SHARDED unserved: the learner's store publishes whole
    blobs (or an old server answers ST_ERROR). Not a TransportError: the
    caller demotes to the whole-blob op, not treating the learner as a
    passing outage."""


class FleetUnavailableError(RuntimeError):
    """OP_REGISTER/OP_HEARTBEAT unserved here (no supervisor, or
    DRL_FLEET=0). `permanent` is True for ST_UNAVAILABLE; ST_ERROR is
    ambiguous, and the heartbeat loop latches only after a streak."""

    def __init__(self, msg: str, permanent: bool = True):
        super().__init__(msg)
        self.permanent = permanent


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    _recv_into_exact(sock, memoryview(buf))
    return buf


def _send_msg(sock: socket.socket, tag: int, *parts) -> None:
    """One framed message; the parts go out in vectored `sendmsg` calls,
    never concatenated."""
    bufs = [memoryview(_HDR.pack(tag, sum(len(p) for p in parts)))]
    bufs += [memoryview(p).cast("B") for p in parts if len(p)]
    while bufs:
        sent = sock.sendmsg(bufs[:1024])  # IOV_MAX caps one writev
        if sent == 0:
            raise TransportError("peer closed")
        i = 0
        while i < len(bufs) and sent >= len(bufs[i]):
            sent -= len(bufs[i])
            i += 1
        bufs = bufs[i:]
        if sent and bufs:
            bufs[0] = bufs[0][sent:]


def _recv_msg(sock: socket.socket) -> tuple[int, bytearray]:
    tag, length = _HDR.unpack(_recv_exact(sock, _HDR.size))
    payload = _recv_exact(sock, length) if length else bytearray()
    return tag, payload


def _recv_into_exact(sock: socket.socket, view: memoryview) -> None:
    got, n = 0, len(view)
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise TransportError("peer closed")
        got += k


class _ConnRecvBuf:
    """Per-connection receive buffer, reused across requests: every op
    copies what it keeps before the next request is read."""

    __slots__ = ("hdr", "buf")

    def __init__(self):
        self.hdr = bytearray(_HDR.size)
        self.buf = bytearray(1 << 16)

    def recv_msg(self, sock: socket.socket) -> tuple[int, memoryview]:
        _recv_into_exact(sock, memoryview(self.hdr))
        tag, length = _HDR.unpack(self.hdr)
        if length > len(self.buf):
            self.buf = bytearray(max(length, 2 * len(self.buf)))
        view = memoryview(self.buf)[:length]
        if length:
            _recv_into_exact(sock, view)
        return tag, view


class _LockedStatsMixin:
    """Counters behind `_stats_lock` (dict-item += is not atomic across
    threads); the host class provides `stats` and `_stats_lock`."""

    def _bump(self, key: str, by: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += by

    def stat(self, key: str) -> int:
        with self._stats_lock:
            return self.stats[key]

    def snapshot_stats(self) -> dict:
        with self._stats_lock:
            return dict(self.stats)


class TransportServer(_LockedStatsMixin):
    """Learner-side service: serves the queue and the weight store (which
    must have `get_blob` and `version`), an act service's OP_ACT
    (`inference`, an `InferenceServer`) and a fleet supervisor's ops when
    they are given. Queue-less (`queue` None: an act-serving replica), it
    answers the trajectory ops with ST_UNAVAILABLE."""

    _GUARDED_BY = {
        "stats": "_stats_lock",
        "_conns": "_conns_lock",
        "_threads": "_conns_lock",
    }
    _NOT_GUARDED = {
        "_sock": "bound in start() before the accept thread spawns; stop() "
                 "closes it cross-thread on purpose to end the accept loop",
    }

    def __init__(self, queue, weights, host: str = "0.0.0.0", port: int = 8000, fleet=None,
                 inference=None):
        self.queue = queue
        self.weights = weights
        self.fleet = fleet
        self.inference = inference
        self.host, self.port = host, port
        self._sock: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self.stats = {"unrolls_accepted": 0, "busy_replies": 0, "partial_accepts": 0,
                      "weight_sends": 0, "weight_bytes_sent": 0, "shard_sends": 0,
                      "shard_bytes_sent": 0, "shard_full_sends": 0, "shard_delta_sends": 0,
                      "shard_skip_sends": 0, "bytes_received": 0,
                      "fleet_msg_errors": 0, "acts_served": 0, "act_busy_replies": 0}
        self._stats_lock = threading.Lock()

    def start(self) -> "TransportServer":
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self._sock.listen(128)
        self._sock.settimeout(0.5)
        t = threading.Thread(target=self._accept_loop, daemon=True, name="transport-accept")
        t.start()
        with self._conns_lock:
            self._threads.append(t)
        stats_s = float(os.environ.get("DRL_TRANSPORT_STATS_S", "0"))
        if stats_s > 0:
            t2 = threading.Thread(target=self._stats_loop, args=(stats_s,), daemon=True,
                                  name="transport-stats")
            t2.start()
            with self._conns_lock:
                self._threads.append(t2)
        return self

    def _stats_loop(self, interval: float) -> None:
        """One data-plane stats line on stderr every `interval` seconds
        (`DRL_TRANSPORT_STATS_S`)."""
        while not self._stop.wait(interval):
            s = self.snapshot_stats()
            depth = self.queue.size() if self.queue is not None else 0
            print(f"[transport] depth={depth} acts={s['acts_served']} "
                  f"unrolls={s['unrolls_accepted']} "
                  f"busy={s['busy_replies']} partial={s['partial_accepts']} "
                  f"weight_sends={s['weight_sends']}", file=sys.stderr, flush=True)

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            self._sock.close()
        # Close every accepted connection too: a handler blocked in recv
        # would otherwise outlive this server and answer from its store.
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        with self._conns_lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=2.0)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                if self._stop.is_set():
                    conn.close()
                    return
                self._conns.add(conn)
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            with self._conns_lock:
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)

    def _serve(self, conn: socket.socket) -> None:
        try:
            self._serve_inner(conn)
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _put_one(self, put, item, deadline: float) -> bool:
        """Blocking put in stop-aware slices, up to `deadline`."""
        t0 = time.perf_counter()
        try:
            while not self._stop.is_set():
                slice_t = min(0.5, deadline - time.monotonic())
                if slice_t <= 0:
                    return False
                if put(item, timeout=slice_t):
                    return True
            return False
        finally:
            if _OBS.enabled:
                _OBS.gauge("transport/enqueue_wait_ms", (time.perf_counter() - t0) * 1e3)

    def _enqueue_many(self, blobs: list, total_wait: float = 30.0) -> int:
        """Enqueue blobs in order; -> how many were accepted. Acceptance
        stops at the first refusal (the tail is NOT enqueued, so the
        client may resend it). The bounded wait keeps a stalled learner
        surfacing as a retryable busy reply."""
        deadline = time.monotonic() + total_wait
        prepare, put = blob_ingest(self.queue)
        accepted = 0
        for blob in blobs:
            if not self._put_one(put, prepare(blob), deadline):
                break
            accepted += 1
        return accepted

    def _observe_put(self, accepted: int, conn_version: int) -> None:
        """Weight staleness at queue ingest: the learner's version minus the
        version this connection last confirmed holding (a lower bound on
        staleness at train time)."""
        if accepted > 0 and conn_version >= 0:
            staleness = max(self.weights.version - conn_version, 0)
            _OBS.gauge("learner/weight_staleness", staleness, weight=accepted)
            _OBS.count(f"staleness_bucket/{stale_bucket(staleness)}", accepted)

    def _pressure_permille(self) -> int:
        """Learner ingest pressure, 0..1000, carried on PUT replies: a
        replay-shard facade's own meter (its busy fraction: its depth is
        always 0), else the bounded queue's fill."""
        meter = getattr(self.queue, "ingest_pressure", None)
        if meter is not None:
            return max(0, min(1000, int(meter())))
        capacity = getattr(self.queue, "capacity", 0)
        if capacity:
            return int(min(1.0, self.queue.size() / capacity) * 1000)
        return 0

    def _serve_inner(self, conn: socket.socket) -> None:
        rbuf = _ConnRecvBuf()
        conn_version = -1  # newest weight version this peer confirmed holding
        while not self._stop.is_set():
            try:
                op, payload = rbuf.recv_msg(conn)
            except (TransportError, OSError):
                return
            try:
                if self.queue is None and op in (OP_PUT_TRAJ, OP_PUT_TRAJ_N, OP_QUEUE_SIZE):
                    # A queue-less endpoint (a replica) never takes trajectories.
                    _send_msg(conn, ST_UNAVAILABLE)
                elif op == OP_PUT_TRAJ:
                    self._bump("bytes_received", len(payload))
                    ok = self._enqueue_many([payload]) == 1
                    self._bump("unrolls_accepted" if ok else "busy_replies")
                    if _OBS.enabled:
                        self._observe_put(1 if ok else 0, conn_version)
                    _send_msg(conn, ST_OK if ok else ST_BUSY,
                              _U16.pack(self._pressure_permille()))
                elif op == OP_PUT_TRAJ_N:
                    self._bump("bytes_received", len(payload))
                    blobs = unpack_batch(payload)
                    accepted = self._enqueue_many(blobs)
                    self._bump("unrolls_accepted", accepted)
                    if accepted < len(blobs):
                        self._bump("partial_accepts")
                    if _OBS.enabled:
                        self._observe_put(accepted, conn_version)
                    _send_msg(conn, ST_OK, _I64.pack(accepted),
                              _U16.pack(self._pressure_permille()))
                elif op == OP_GET_WEIGHTS:
                    # Versions are snapshot identities, not an order: a
                    # restarted learner republishes from 0, and an actor
                    # holding the old run's higher version must update.
                    have = _I64.unpack(payload)[0]
                    blob, version = self.weights.get_blob()
                    if version == have or blob is None:
                        conn_version = have
                        _send_msg(conn, ST_OK, _I64.pack(have))
                    else:
                        self._bump("weight_sends")
                        self._bump("weight_bytes_sent", len(blob))
                        conn_version = version
                        _send_msg(conn, ST_OK, _I64.pack(version), blob)
                elif op == OP_GET_WEIGHTS_SHARDED:
                    # The shard-scoped pull: the manifest and the asked
                    # shards, each full, a delta against the client's base
                    # version, or elided when unchanged since it; version
                    # identity as OP_GET_WEIGHTS. ST_UNAVAILABLE when the
                    # store publishes whole blobs: the client demotes to
                    # the whole-blob op for good.
                    if not getattr(self.weights, "sharded", False):
                        _send_msg(conn, ST_UNAVAILABLE)
                    else:
                        have, keys, base, flags = _parse_shard_req(payload)
                        got = self.weights.get_sharded(have, keys=keys, base_version=base,
                                                       accept_delta=bool(flags & 1))
                        if got is None:
                            conn_version = have
                            _send_msg(conn, ST_OK, _I64.pack(have))
                        else:
                            version, mbytes, shards = got
                            parts, nbytes, nfull, ndelta, nskip = _pack_shard_reply(
                                version, mbytes, shards)
                            with self._stats_lock:
                                self.stats["shard_sends"] += 1
                                self.stats["shard_bytes_sent"] += nbytes
                                self.stats["shard_full_sends"] += nfull
                                self.stats["shard_delta_sends"] += ndelta
                                self.stats["shard_skip_sends"] += nskip
                            conn_version = version
                            _send_msg(conn, ST_OK, *parts)
                elif op == OP_ACT:
                    # Its own RuntimeError handling: a failed act (no weights
                    # yet, a bad request, a failed batch) answers ST_ERROR,
                    # never the queue-closed ST_CLOSED below; an admission
                    # reject (`retryable`) answers ST_BUSY.
                    if self.inference is None:
                        _send_msg(conn, ST_UNAVAILABLE)
                    else:
                        try:
                            out = self.inference.submit(codec.decode(payload, copy=True))
                        except RuntimeError as e:
                            if getattr(e, "retryable", False):
                                self._bump("act_busy_replies")
                                _send_msg(conn, ST_BUSY)
                            else:
                                _send_msg(conn, ST_ERROR)
                        else:
                            self._bump("acts_served")
                            _send_msg(conn, ST_OK, codec.encode(out))
                elif op in (OP_REGISTER, OP_HEARTBEAT):
                    if self.fleet is None:
                        _send_msg(conn, ST_UNAVAILABLE)
                    else:
                        from distributed_reinforcement_learning_tpu_torch.runtime import (
                            fleet as _fleet)

                        try:
                            info = _fleet.unpack_fleet_msg(payload)
                            reply = (self.fleet.register(info) if op == OP_REGISTER
                                     else self.fleet.heartbeat(info))
                            blob = _fleet.pack_fleet_msg(reply)
                        except Exception:  # noqa: BLE001 — a malformed member, not fatal
                            self._bump("fleet_msg_errors")
                            _send_msg(conn, ST_ERROR)
                        else:
                            _send_msg(conn, ST_OK, blob)
                elif op == OP_QUEUE_SIZE:
                    _send_msg(conn, ST_OK, _I64.pack(self.queue.size()))
                elif op == OP_PING:
                    _send_msg(conn, ST_OK)
                else:
                    _send_msg(conn, ST_ERROR)
            except RuntimeError:  # queue closed -> learner shutting down
                try:
                    _send_msg(conn, ST_CLOSED)
                except OSError:
                    pass
                return
            except (TransportError, OSError):
                return


# A connected client's reconnect tries, for the clients that set
# `reconnect_retries`: a peer that was up and went away is dead, not
# starting, so the start-up budget (`connect_retries`) no longer applies.
RECONNECT_RETRIES = 3


class TransportClient(_LockedStatsMixin):
    """Actor-side connection with bounded-retry reconnect. One lock
    serialises each request/reply exchange, reconnects included. Once it
    has connected, a reconnect tries at most `reconnect_retries` times
    when that is set (RECONNECT_RETRIES at every call site that does)."""

    _GUARDED_BY = {"_sock": "_lock", "_connected": "_lock", "stats": "_stats_lock"}
    _NOT_GUARDED = {
        "_admission": "set once by the actor's runner (set_admission) before "
                      "any PUT; the controller locks itself",
    }

    def __init__(self, host: str, port: int, connect_retries: int = 60,
                 retry_interval: float = 1.0, busy_timeout: float = 90.0,
                 connect: bool = True, reconnect_retries: int | None = None):
        self.host, self.port = host, port
        self.connect_retries = connect_retries
        self.reconnect_retries = reconnect_retries
        self._connected = False
        self.retry_interval = retry_interval
        self.busy_timeout = busy_timeout
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()
        self.stats = {"unrolls_sent": 0, "busy_waits": 0, "partial_accepts": 0,
                      "weight_pulls": 0, "weight_bytes_received": 0,
                      "unrolls_admission_dropped": 0, "acts": 0, "act_busy_waits": 0}
        self._stats_lock = threading.Lock()
        self._admission = None  # data/admission.AdmissionController
        # Jittered act-busy backoff: fixed seeds would march rejected
        # actors back in lockstep.
        self._jitter = random.Random()
        if connect:
            self._connect_locked()

    def _connect_locked(self) -> None:
        last: Exception | None = None
        tries = self.connect_retries
        if self._connected and self.reconnect_retries is not None:
            tries = min(tries, self.reconnect_retries)
        for _ in range(tries):
            try:
                sock = socket.create_connection((self.host, self.port), timeout=300.0)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._sock = sock
                self._connected = True
                return
            except OSError as e:
                last = e
                time.sleep(self.retry_interval)
        raise TransportError(f"cannot reach learner at {self.host}:{self.port}: {last}")

    def _exchange(self, op: int, payload, retry: bool, resend: bool) -> tuple[int, bytearray]:
        """One request/response; on a dropped connection reconnect and, for
        idempotent ops (`resend`), send again. A non-idempotent op raises
        instead: the server may have acted on the lost request."""
        parts = payload if isinstance(payload, list) else [payload]
        with self._lock:
            if self._sock is None:
                self._connect_locked()
            try:
                _send_msg(self._sock, op, *parts)
                return _recv_msg(self._sock)
            except (TransportError, OSError):
                if not retry:
                    raise
                self._close_locked()
                self._connect_locked()
                if not resend:
                    raise TransportError("connection lost mid-request") from None
                _send_msg(self._sock, op, *parts)
                return _recv_msg(self._sock)

    def _is_down(self) -> bool:
        """True when the last reconnect attempt failed (learner gone)."""
        with self._lock:
            return self._sock is None

    def _call(self, op: int, payload=b"", retry: bool = True) -> bytearray:
        status, resp = self._exchange(op, payload, retry, resend=True)
        if status == ST_CLOSED:
            raise TransportError("learner closed the data plane")
        if status != ST_OK:
            raise TransportError(f"op {op} failed on the learner side")
        return resp

    def set_admission(self, controller) -> None:
        """Attach an actor-side admission controller
        (`data/admission.AdmissionController`): the PUT paths score and
        stamp each unroll, and feed each reply's pressure back to it.
        Call before the first PUT."""
        self._admission = controller

    def put_trajectory(self, tree: Any) -> bool:
        """Ship one trajectory; retries while the learner's queue is full
        (ST_BUSY), up to `busy_timeout`. At-most-once: a connection that
        drops mid-request loses the unroll (False), never duplicates it.
        With an admission controller the unroll goes stamped (the stamp
        frame as its own send part, the blob untouched), thinned, or not
        at all (True: dropped at the source by design)."""
        ctrl = self._admission
        payload: Any
        if ctrl is not None:
            decision = ctrl.admit(tree)
            if not decision.send:  # dropped at the source; its mass folds
                self._bump("unrolls_admission_dropped")  # into the next stamp
                return True
            if decision.tree is not None:
                tree = decision.tree
            payload = [codec.stamp_frame(decision.stamp),
                       codec.encode(tree, dedup=codec.obs_dedup_enabled())]
            ctrl.note_wire(len(payload[0]) + len(payload[1]), decision)
        else:
            payload = codec.encode(tree, dedup=codec.obs_dedup_enabled())
        busy_since: float | None = None
        while True:
            try:
                status, resp = self._exchange(OP_PUT_TRAJ, payload, retry=True, resend=False)
            except TransportError:
                if self._is_down():
                    raise
                return False
            if ctrl is not None and len(resp) >= _U16.size:
                # The ingest pressure rides every PUT reply (ST_BUSY too).
                ctrl.observe_pressure(_U16.unpack_from(resp, 0)[0])
            if status == ST_OK:
                self._bump("unrolls_sent")
                return True
            if status == ST_BUSY:
                self._bump("busy_waits")
                now = time.monotonic()
                busy_since = busy_since or now
                if now - busy_since > self.busy_timeout:
                    raise TransportError(f"learner queue busy for >{self.busy_timeout:.0f}s")
                continue
            if status == ST_CLOSED:
                raise TransportError("learner closed the data plane")
            raise TransportError("put_trajectory failed on the learner side")

    def put_trajectories(self, trees: list[Any]) -> int:
        """Ship K trajectories in one round trip (OP_PUT_TRAJ_N); -> how
        many the learner accepted. A partial accept (the bounded queue
        refused the tail) resends the tail until accepted or
        `busy_timeout` passes without progress. Unrolls the admission
        controller drops at the source count as accepted."""
        ctrl = self._admission
        dedup = codec.obs_dedup_enabled()
        dropped = 0
        if ctrl is not None:
            blobs = []
            for t in trees:
                decision = ctrl.admit(t)
                if not decision.send:
                    dropped += 1
                    continue
                sent_tree = t if decision.tree is None else decision.tree
                # One buffer an unroll: pack_batch frames each blob by
                # its length, stamp included.
                blob = codec.stamp_blob(codec.encode(sent_tree, dedup=dedup), decision.stamp)
                ctrl.note_wire(len(blob), decision)
                blobs.append(blob)
            if dropped:
                self._bump("unrolls_admission_dropped", dropped)
        else:
            blobs = [codec.encode(t, dedup=dedup) for t in trees]
        sent = 0
        busy_since: float | None = None
        while sent < len(blobs):
            try:
                status, resp = self._exchange(OP_PUT_TRAJ_N, pack_batch(blobs[sent:]),
                                              retry=True, resend=False)
            except TransportError:
                if self._is_down():
                    raise
                return sent  # batch fate unknown: drop, never duplicate
            if status == ST_CLOSED:
                raise TransportError("learner closed the data plane")
            if status != ST_OK:
                raise TransportError("put_trajectories failed on the learner side")
            accepted = _I64.unpack_from(resp, 0)[0]
            if ctrl is not None and len(resp) >= _I64.size + _U16.size:
                ctrl.observe_pressure(_U16.unpack_from(resp, _I64.size)[0])
            sent += accepted
            self._bump("unrolls_sent", accepted)
            if sent < len(blobs):
                self._bump("partial_accepts")
                now = time.monotonic()
                busy_since = busy_since or now
                if now - busy_since > self.busy_timeout:
                    raise TransportError(f"learner queue busy for >{self.busy_timeout:.0f}s")
                if accepted:
                    busy_since = now  # progress resets the wedge clock
        return sent + dropped

    def get_weights_if_newer(self, have_version: int) -> tuple[Any, int] | None:
        """(decoded tree, version), or None when the learner's version is
        `have_version` (or nothing is published)."""
        t0 = time.perf_counter()
        resp = self._call(OP_GET_WEIGHTS, _I64.pack(have_version))
        version = _I64.unpack(resp[: _I64.size])[0]
        if _OBS.enabled:
            _OBS.gauge("actor/weight_pull_ms", (time.perf_counter() - t0) * 1e3)
            _OBS.gauge("actor/weight_version", version)
        if version == have_version:
            return None
        self._bump("weight_pulls")
        self._bump("weight_bytes_received", len(resp) - _I64.size)
        return codec.decode(resp[_I64.size:], copy=True), version

    def get_weights_sharded(self, have_version: int, keys=None, base_version: int = -2,
                            accept_delta: bool = False) -> tuple[int, bytes, list] | None:
        """The raw shard-scoped pull (OP_GET_WEIGHTS_SHARDED): None on
        version identity, else (version, manifest bytes, shards), shards
        being [(key, enc, base, payload view), ...]. Raises
        ShardedWeightsUnavailableError when the learner's store is not
        sharded: callers latch over to the whole-blob op
        (`ShardedRemoteWeights` does)."""
        req = _pack_shard_req(have_version, keys, base_version, accept_delta)
        status, resp = self._exchange(OP_GET_WEIGHTS_SHARDED, req, retry=True, resend=True)
        if status == ST_CLOSED:
            raise TransportError("learner closed the data plane")
        if status != ST_OK:
            raise ShardedWeightsUnavailableError("endpoint does not serve sharded weight pulls")
        if len(resp) == _I64.size:  # identity: nothing newer to carry
            return None
        self._bump("weight_bytes_received", len(resp))
        return _parse_shard_reply(resp)

    def remote_act(self, request: dict, busy_retry: bool = True) -> dict:
        """A served act: ship the family's observation rows, get its action
        rows, computed with the service's newest weights. Resend-safe
        (acting twice on the same rows is a fresh sample). ST_BUSY is
        retried with jittered backoff up to `busy_timeout`; with
        `busy_retry=False` it raises InferenceBusyError, so a caller with
        several endpoints can fail over instead."""
        blob = codec.encode(request)
        backoff: _BusyBackoff | None = None
        while True:
            status, resp = self._exchange(OP_ACT, blob, retry=True, resend=True)
            if status == ST_BUSY:
                self._bump("act_busy_waits")
                if not busy_retry:
                    raise InferenceBusyError("inference service admission budget full")
                backoff = backoff or _BusyBackoff(self.busy_timeout, self._jitter)
                backoff.sleep_or_raise("inference service")
                continue
            if status == ST_UNAVAILABLE:
                raise InferenceUnavailableError(
                    "endpoint does not serve inference "
                    "(start the learner with --serve_inference)")
            if status == ST_CLOSED:
                raise TransportError("learner closed the data plane")
            if status != ST_OK:
                raise RemoteActFailed("remote act failed on the serving side")
            self._bump("acts")
            return codec.decode(resp, copy=True)

    def queue_size(self) -> int:
        return _I64.unpack(self._call(OP_QUEUE_SIZE))[0]

    def ping(self) -> bool:
        try:
            self._call(OP_PING, retry=False)
            return True
        except (TransportError, OSError):
            return False

    def _fleet_call(self, op: int, info: dict) -> dict:
        from distributed_reinforcement_learning_tpu_torch.runtime import fleet as _fleet

        status, resp = self._exchange(op, _fleet.pack_fleet_msg(info), retry=True, resend=True)
        if status == ST_CLOSED:
            raise TransportError("learner closed the data plane")
        if status != ST_OK:
            raise FleetUnavailableError("endpoint does not serve the fleet control plane",
                                        permanent=(status == ST_UNAVAILABLE))
        return _fleet.unpack_fleet_msg(resp)

    def fleet_register(self, info: dict) -> dict:
        return self._fleet_call(OP_REGISTER, info)

    def fleet_heartbeat(self, info: dict) -> dict:
        return self._fleet_call(OP_HEARTBEAT, info)

    def abort(self) -> None:
        """Lock-free teardown for shutdown paths: makes a blocked exchange
        raise at once (the owner then closes under the lock)."""
        sock = self._sock  # drlint: disable=lock-discipline — lock-free on purpose
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def _close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None


class RemoteQueue:
    """`TrajectoryQueue` put/size surface for actor runners, over the wire."""

    def __init__(self, client: TransportClient):
        self._client = client

    def set_admission(self, controller) -> None:
        """The client's PUT paths own scoring and stamping."""
        self._client.set_admission(controller)

    def put(self, item: Any, timeout: float | None = None) -> bool:
        return self._client.put_trajectory(item)  # False = dropped (at-most-once)

    def put_many(self, items: list[Any], timeout: float | None = None) -> int:
        return self._client.put_trajectories(items)

    def size(self) -> int:
        return self._client.queue_size()


def params_to_device(tree: Any, device: torch.device) -> dict[str, torch.Tensor]:
    """A pulled weight blob's tree -> the port's parameter dict on
    `device`. Only a flat `{name: array}` dict is the port's layout: a
    nested tree (a JAX learner's flax parameters) is refused."""
    if not isinstance(tree, dict) or not all(isinstance(v, np.ndarray) for v in tree.values()):
        raise TypeError("the pulled weights are not a flat {name: array} dict of the port's "
                        "parameters (weight blobs do not cross between the packages)")
    # A shard pull's leaves view its read-only reply bytes: copied, so that
    # the tensors own writable memory (torch does not track read-only).
    return {k: torch.from_numpy(v if v.flags.writeable else v.copy()).to(device)
            for k, v in tree.items()}


class RemoteWeights:
    """`WeightStore.get_if_newer` surface for actor runners, over the wire:
    the pulled parameters as tensors on the actor's device."""

    def __init__(self, client: TransportClient, device: str | torch.device = "cpu"):
        self._client = client
        self.device = torch.device(device)

    def get_if_newer(self, have_version: int) -> tuple[Any, int] | None:
        got = self._client.get_weights_if_newer(have_version)
        if got is None:
            return None
        tree, version = got
        return params_to_device(tree, self.device), version


class ShardedRemoteWeights(_LockedStatsMixin):
    """`get_if_newer` over the shard-scoped op (runtime/weight_shards):
    pulls the manifest + per-shard blobs, keeps a per-shard cache so
    the next pull can receive byte-range DELTAS and skip untouched
    shards entirely, dequantizes a bf16/int8 broadcast back to f32,
    and assembles the parameters via `weight_shards.materialize`, as
    tensors on the actor's `device` (as `RemoteWeights`).

    Demotes to the whole-blob op on the first ST_UNAVAILABLE/ST_ERROR
    (the learner's store is not sharded, or an old server), so
    pre-shard topologies pay one round trip at startup and nothing
    after. The latch is re-probeable on a bounded RetryLadder
    (runtime/fleet.py): `reattach()` — driven from the fleet heartbeat
    cadence — clears it so the NEXT pull retries the sharded op (one
    extra round trip per probe, on the pull cadence, never a second
    hot-path exchange); a restarted learner that now publishes per
    shard re-promotes this client, while a genuinely un-sharded
    learner re-latches and the exhausted ladder restores the old
    permanent behavior. Any cache/protocol inconsistency (a delta
    whose base this client no longer holds) is repaired with ONE full
    sharded pull, never an actor kill.

    `keys` scopes REFRESHES to the listed shard keys after the first
    full pull (`DRL_WEIGHTS_KEYS`): unlisted shards stay pinned at
    their last-pulled bytes — for roles that deliberately freeze part
    of the tree. A pinned shard materializes with the manifest entry
    CACHED from the version its bytes came from (crc, quant scales):
    decoding old int8 codes with the current version's scales would
    silently drift the "frozen" leaves every pull.

    Concurrency map (tools/drlint lock-discipline): `stats` is bumped
    on the actor loop thread and polled by the telemetry flush thread
    (accessors from _LockedStatsMixin); `_plain`/`_reprobe` share that
    lock because the fleet heartbeat thread's reattach() clears the
    latch while the actor loop reads it. `_blobs`/`_cache_version` are
    only ever touched by the actor loop thread — same single-thread
    contract as BoardWeights' cache."""

    _GUARDED_BY = {
        "stats": "_stats_lock",
        "_plain": "_stats_lock",
        "_reprobe": "_stats_lock",
    }
    _NOT_GUARDED = {
        "_blobs": "actor-loop-thread-only shard cache (same "
                  "single-thread contract as BoardWeights' cache)",
        "_metas": "actor-loop-thread-only manifest-entry cache",
        "_cache_version": "actor-loop-thread-only cache version",
    }

    telemetry_prefix = "wshard"
    surface_name = "wshard"  # fleet heartbeat registration label

    def __init__(self, client: TransportClient, device: str | torch.device = "cpu",
                 keys=None):
        from distributed_reinforcement_learning_tpu_torch.runtime.fleet import RetryLadder

        self._client = client
        self.device = torch.device(device)
        self._keys = list(keys) if keys else None
        self._plain = False    # whole-blob demote latch (ladder-probed)
        self._reprobe = False  # a reattach probe is pending on the pull path
        self._ladder = RetryLadder("wshard-op")
        self._blobs: dict[str, np.ndarray] = {}
        self._metas: dict[str, dict] = {}  # manifest entry per cached blob
        self._cache_version = -2
        self.stats = {"shard_pulls": 0, "shards_full": 0, "shards_delta": 0,
                      "shards_skipped": 0, "bytes_received": 0,
                      "repair_pulls": 0, "whole_fallbacks": 0,
                      "reattaches": 0}
        self._stats_lock = threading.Lock()

    def _resolve(self, shards):
        """Wire shards -> (owned blob dict, cache_derived) against the
        cache; None when the cache cannot honor a delta/skip (repair
        with a full pull). `cache_derived` drives checksum
        verification: blobs rebuilt from cached bases (delta/skip) are
        the case the manifest crc exists for — a reused version number
        against a stale cache; an all-FULL pull is plain TCP bytes."""
        from distributed_reinforcement_learning_tpu_torch.runtime import weight_shards

        out = dict(self._blobs) if self._keys is not None else {}
        nfull = ndelta = nskip = nbytes = 0
        for key, enc, base, payload in shards:
            if enc == weight_shards.ENC_FULL:
                out[key] = np.frombuffer(bytes(payload), np.uint8)
                nfull += 1
                nbytes += len(payload)
            elif enc == weight_shards.ENC_DELTA:
                if base != self._cache_version or key not in self._blobs:
                    return None
                out[key] = weight_shards.delta_apply(self._blobs[key], payload)
                ndelta += 1
                nbytes += len(payload)
            elif enc == weight_shards.ENC_SKIP:
                if base != self._cache_version or key not in self._blobs:
                    return None
                out[key] = self._blobs[key]
                nskip += 1
            else:
                return None
        with self._stats_lock:
            self.stats["shards_full"] += nfull
            self.stats["shards_delta"] += ndelta
            self.stats["shards_skipped"] += nskip
            self.stats["bytes_received"] += nbytes
        return out, (ndelta + nskip) > 0

    def _merged_manifest(self, mbytes, shards) -> dict:
        """Parse the pulled manifest; with role-scoped `keys`, PINNED
        shards (absent from this reply) swap in the manifest entry
        cached from the version their bytes came from — crc and quant
        scales must describe the cached blob, not the current one."""
        from distributed_reinforcement_learning_tpu_torch.runtime import weight_shards

        manifest = weight_shards.parse_manifest(mbytes)
        if self._keys is None:
            return manifest
        refreshed = {k for k, _, _, _ in shards}
        manifest["shards"] = [
            sh if sh["key"] in refreshed or sh["key"] not in self._metas
            else self._metas[sh["key"]]
            for sh in manifest["shards"]]
        return manifest

    def reattach(self, ctx=None) -> None:
        """Clear the whole-blob latch (bounded ladder) so the NEXT pull
        re-probes the sharded op. Driven from the fleet heartbeat
        cadence; the probe itself rides the normal pull path — one
        extra round trip against a still-unsharded learner, never a
        hot-path reconnect storm."""
        del ctx  # nothing shm-backed to validate: the op IS the probe
        with self._stats_lock:
            plain = self._plain
        if not plain or not self._ladder.try_acquire():
            return
        with self._stats_lock:
            self._plain = False
            self._reprobe = True

    def reset_reattach(self) -> None:
        """Fresh probe budget (learner epoch change: the restarted
        learner may publish sharded where the old one did not)."""
        self._ladder.reset()

    def _note_sharded_ok(self) -> None:
        """The sharded op answered: if a reattach probe was pending,
        the re-promotion is confirmed."""
        with self._stats_lock:
            confirmed = self._reprobe
            self._reprobe = False
            if confirmed:
                self.stats["reattaches"] += 1
        if confirmed:
            self._ladder.note_success()
            import sys

            print("[wshard] sharded weight pulls re-promoted (learner "
                  "serves the shard-scoped op again)", file=sys.stderr)

    def _whole_pull(self, have_version: int) -> tuple[Any, int] | None:
        got = self._client.get_weights_if_newer(have_version)
        if got is None:
            return None
        return params_to_device(got[0], self.device), got[1]

    def get_if_newer(self, have_version: int) -> tuple[Any, int] | None:
        from distributed_reinforcement_learning_tpu_torch.runtime import weight_shards

        with self._stats_lock:
            plain = self._plain
        if plain:
            return self._whole_pull(have_version)
        t0 = time.perf_counter()
        keys = self._keys if self._cache_version >= 0 else None
        try:
            got = self._client.get_weights_sharded(
                have_version, keys=keys,
                base_version=self._cache_version, accept_delta=True)
        except ShardedWeightsUnavailableError:
            with self._stats_lock:
                self._plain = True
                reprobe = self._reprobe
                self._reprobe = False
                self.stats["whole_fallbacks"] += 1
            if reprobe:  # a failed reattach probe burns a ladder slot
                self._ladder.note_failure()
            return self._whole_pull(have_version)
        self._note_sharded_ok()
        if got is None:
            if _OBS.enabled:
                _OBS.gauge("actor/weight_pull_ms",
                           (time.perf_counter() - t0) * 1e3)
            return None
        version, mbytes, shards = got
        params = blobs = manifest = None
        resolved = self._resolve(shards)
        if resolved is not None:
            blobs, derived = resolved
            try:
                manifest = self._merged_manifest(mbytes, shards)
                # Checksums run only for cache-DERIVED pulls (delta/
                # skip): that is where a reused version number against
                # a stale cache can silently mispair bytes. An all-FULL
                # pull is plain framed TCP, and a crc pass would re-read
                # every transferred byte for nothing.
                params = weight_shards.materialize(manifest, blobs,
                                                   verify=derived)
            except (KeyError, ValueError):
                # Checksum/coverage failure: the cache paired a stale
                # blob with a reused version number (restarted learner
                # republishing from 0 — version IDENTITY has no global
                # uniqueness). Repair below.
                params = None
        if params is None:
            # ONE full sharded pull (no deltas, no elision) repairs any
            # cache inconsistency; a second failure is a real server
            # fault and surfaces as a ConnectionError for the actor's
            # elastic-grace loop.
            self._bump("repair_pulls")
            self._blobs, self._metas, self._cache_version = {}, {}, -2
            got = self._client.get_weights_sharded(have_version)
            if got is None:
                return None
            version, mbytes, shards = got
            resolved = self._resolve(shards)
            if resolved is None:
                raise TransportError("sharded weight pull unresolvable "
                                     "after a full repair pull")
            blobs, _ = resolved
            try:
                manifest = weight_shards.parse_manifest(mbytes)
                params = weight_shards.materialize(manifest, blobs,
                                                   verify=False)
            except (KeyError, ValueError) as e:
                raise TransportError(
                    f"sharded weight pull corrupt after repair: {e}") from e
        self._blobs = blobs
        self._metas = {sh["key"]: sh for sh in manifest["shards"]}
        self._cache_version = version
        self._bump("shard_pulls")
        if _OBS.enabled:
            _OBS.gauge("actor/weight_pull_ms", (time.perf_counter() - t0) * 1e3)
            _OBS.gauge("actor/weight_version", version)
        return params_to_device(params, self.device), version


class RemoteInference:
    """An actor's act surface over one endpoint's OP_ACT (the learner's
    service): callable with the family's row dict, -> the reply dict."""

    def __init__(self, client: TransportClient):
        self._client = client

    def __call__(self, request: dict) -> dict:
        return self._client.remote_act(request)


class RemoteActService(_LockedStatsMixin):
    """An actor's act surface over a replicated serving tier: N replica
    endpoints, and the learner's own service as the fallback.

    Each request goes to the live endpoint with the fewest requests in
    flight (a rotating cursor breaks ties). ST_BUSY fails over at once to
    a live replica that has not refused this round; only when all have
    does the request back off with jitter (up to `busy_timeout`) and start
    a new round. A dead replica (TransportError or OSError after the
    client's own reconnects) is demoted, and acts skip it from then on;
    `reattach()` (the fleet heartbeat's cadence, never the act path) pings
    demoted replicas on a bounded ladder each and re-promotes one that
    answers. ST_ERROR (RemoteActFailed) propagates without a demotion: one
    bad request must not take a healthy replica out. With every replica
    demoted, requests go to the learner's client.

    An endpoint connects with `connect_retries` tries (60 x 1 s from
    `from_addrs`: at topology start a replica binds its port only after
    the learner's first publish), and once it has connected reconnects
    with `RECONNECT_RETRIES`: a replica that dies mid-run is demoted after
    ~3 s, where the JAX package's tier keeps the start-up budget for the
    whole run and stalls each actor's in-flight act ~60 s on it (ROADMAP
    F9).

    `_sel_lock` covers the selection state that actor threads race on;
    the endpoint list is fixed after construction, each client locks
    itself."""

    _GUARDED_BY = {"stats": "_stats_lock", "_pending": "_sel_lock", "_dead": "_sel_lock",
                   "_rr": "_sel_lock"}
    _NOT_GUARDED = {
        "_endpoints": "fixed after construction; each client serialises itself",
        "_ladders": "fixed after construction; each RetryLadder locks itself",
    }

    surface_name = "remote_act"  # the fleet heartbeat's registration label

    def __init__(self, endpoints: list[TransportClient], fallback: TransportClient | None = None,
                 busy_timeout: float = 90.0):
        from distributed_reinforcement_learning_tpu_torch.runtime.fleet import RetryLadder

        self._endpoints = list(endpoints)
        self._fallback = fallback
        self.busy_timeout = busy_timeout
        self._sel_lock = threading.Lock()
        self._pending = [0] * len(self._endpoints)
        self._dead = [False] * len(self._endpoints)
        self._rr = 0
        self.stats = {"acts": 0, "busy_failovers": 0, "replica_demotes": 0,
                      "fallback_acts": 0, "replica_repromotes": 0}
        self._stats_lock = threading.Lock()
        self._jitter = random.Random()
        self._ladders = [RetryLadder(f"replica-{c.host}:{c.port}") for c in self._endpoints]

    @classmethod
    def from_addrs(cls, addrs: list[str], fallback: TransportClient | None = None,
                   connect_retries: int = 60, **kwargs) -> "RemoteActService":
        """From "host:port" strings. Endpoints connect on their first act;
        the generous default retries cover a replica that binds its port
        only after the learner's first publish."""
        clients = []
        for addr in addrs:
            host, _, p = addr.rpartition(":")
            clients.append(TransportClient(host, int(p), connect=False,
                                           connect_retries=connect_retries,
                                           reconnect_retries=RECONNECT_RETRIES))
        return cls(clients, fallback=fallback, **kwargs)

    def _pick(self, skip: set | frozenset = frozenset()) -> int | None:
        """Take a slot on the live endpoint with the fewest requests in
        flight, outside `skip`; None when there is none."""
        with self._sel_lock:
            n = len(self._endpoints)
            best: int | None = None
            for off in range(n):
                i = (self._rr + off) % n
                if self._dead[i] or i in skip:
                    continue
                if best is None or self._pending[i] < self._pending[best]:
                    best = i
            if best is None:
                return None
            self._rr += 1
            self._pending[best] += 1
            return best

    def _release(self, i: int) -> None:
        with self._sel_lock:
            self._pending[i] -= 1

    def _demote(self, i: int) -> None:
        with self._sel_lock:
            was_dead, self._dead[i] = self._dead[i], True
        if not was_dead:
            self._bump("replica_demotes")
            ep = self._endpoints[i]
            print(f"[remote_act] WARNING: inference replica {ep.host}:{ep.port} demoted (dead)",
                  file=sys.stderr, flush=True)
            try:
                ep.close()
            except OSError:
                pass

    def __call__(self, request: dict) -> dict:
        backoff: _BusyBackoff | None = None
        busy_round: set[int] = set()
        while True:
            i = self._pick(skip=busy_round)
            if i is None:
                if busy_round and self.live_endpoints() > 0:
                    # Every live replica refused this round: back off, then
                    # a fresh round.
                    backoff = backoff or _BusyBackoff(self.busy_timeout, self._jitter)
                    backoff.sleep_or_raise("inference tier")
                    busy_round.clear()
                    continue
                if self._fallback is None:
                    raise TransportError("no live inference replicas and no learner fallback")
                self._bump("fallback_acts")
                out = self._fallback.remote_act(request)
                self._bump("acts")
                return out
            try:
                out = self._endpoints[i].remote_act(request, busy_retry=False)
            except InferenceBusyError:
                self._bump("busy_failovers")  # saturated, not dead
                busy_round.add(i)
            except RemoteActFailed:
                raise  # alive: the caller's grace loop owns the retry
            except (InferenceUnavailableError, TransportError, OSError):
                # Dead or misrouted: demote and act again on a survivor
                # (resend-safe, so no request is lost while one is up).
                self._demote(i)
            else:
                self._bump("acts")
                return out
            finally:
                self._release(i)

    def live_endpoints(self) -> int:
        with self._sel_lock:
            return sum(not d for d in self._dead)

    def reattach(self, ctx=None) -> None:
        """Ping demoted replicas, each on its bounded ladder, and
        re-promote those that answer (a respawned replica)."""
        del ctx  # replicas carry no shm identity to check
        with self._sel_lock:
            dead = [i for i, d in enumerate(self._dead) if d]
        for i in dead:
            ladder = self._ladders[i]
            if not ladder.try_acquire():
                continue
            ep = self._endpoints[i]
            # A short probe, then the act path's reconnect budget back.
            saved, ep.connect_retries = ep.connect_retries, 1
            try:
                alive = ep.ping()
            finally:
                ep.connect_retries = saved
            if alive:
                with self._sel_lock:
                    self._dead[i] = False
                ladder.note_success()
                self._bump("replica_repromotes")
                print(f"[remote_act] inference replica {ep.host}:{ep.port} re-promoted "
                      f"(answered ping)", file=sys.stderr, flush=True)
            else:
                ladder.note_failure()

    def reset_reattach(self) -> None:
        """Fresh probe budgets (a learner epoch change)."""
        for ladder in self._ladders:
            ladder.reset()

    def close(self) -> None:
        """Close the replica clients (the fallback is the caller's)."""
        with self._sel_lock:
            dead = list(self._dead)
        for i, client in enumerate(self._endpoints):
            if not dead[i]:
                try:
                    client.close()
                except OSError:
                    pass


def resolve_learner_addr(rt) -> tuple[str, int]:
    """The learner's address:

      DRL_LEARNER_ADDR=host:port — full address;
      DRL_LEARNER_INDEX=k — port offset against it, or against the
        config's server_ip/server_port (co-hosted learner seats: seat k
        serves on the base port + k).

    Actors connect to it, and the port's learner binds its port (the JAX
    learner binds the config's `server_port`)."""
    index = int(os.environ.get("DRL_LEARNER_INDEX", "0"))
    addr = os.environ.get("DRL_LEARNER_ADDR")
    if addr:
        host, _, p = addr.rpartition(":")
        return host, int(p) + index
    return rt.server_ip, rt.server_port + index


# A learner-tier seat logs its progress every this many train steps.
TIER_LOG_STEPS = 10

# The families with an on-device loop (`--mode anakin`), as in the JAX
# launchers: the transformer families have none.
ANAKIN_FAMILIES = ("impala", "apex", "r2d2")


def refuse_unported(mode: str, algo: str) -> None:
    """Raise a ValueError naming the ROADMAP item for each plane of the
    JAX topology that the caller asks for and the port lacks. Every mode,
    the act-serving and on-device ones included, takes these refusals;
    `--mode anakin` is refused for a family the JAX package has no
    on-device loop for."""
    if mode == "anakin" and algo not in ANAKIN_FAMILIES:
        raise ValueError(f"--mode anakin: the on-device loops (ROADMAP item 14) run "
                         f"{', '.join(ANAKIN_FAMILIES)}; the JAX package has none for {algo}")
    from distributed_reinforcement_learning_tpu_torch.parallel import distributed

    if mode == "anakin" and distributed.requested():
        raise ValueError("--mode anakin over a multi-process learner group (DRL_COORDINATOR): "
                         "the JAX package's --mode anakin builds no mesh and ignores these "
                         "names, so each process would run one independent loop; the port "
                         "refuses instead (ROADMAP F14). The Anakin loops take a mesh of "
                         "ranks in the library (runtime/anakin_mesh.py)")


def _multihost_mesh(algo: str, agent_cfg, rt, world: int, multihost: bool = True):
    """-> (rt with this rank's `batch_size / data`, the mesh) for a
    learner group of `world` ranks, or the JAX package's refusals: a
    batch that does not divide, a pipeline whose per-rank batch does not
    split into its microbatches, a config whose learn step shards beyond
    the data where no mesh fits, a group with no mesh to run. A single
    learner (`multihost` False, a world of one) gets no mesh, or the same
    refusal when its config needs one."""
    import dataclasses

    from distributed_reinforcement_learning_tpu_torch.parallel.mesh import make_mesh
    from distributed_reinforcement_learning_tpu_torch.runtime import launch

    if multihost and rt.batch_size % world:
        raise ValueError(f"batch_size {rt.batch_size} not divisible by {world} processes")
    seq, pipe, expert = launch.mesh_axes_for(agent_cfg, rt)
    inner = pipe * expert * seq
    data_axis = world // inner if world % inner == 0 else 0
    mesh = None
    if world > 1 and data_axis > 0 and rt.batch_size % data_axis == 0:
        if pipe > 1:
            micro = agent_cfg.pipeline_microbatches
            if (rt.batch_size // data_axis) % micro != 0:
                raise ValueError(f"pipeline needs the per-device batch "
                                 f"({rt.batch_size}/{data_axis}) divisible by "
                                 f"pipeline_microbatches={micro}")
        mesh = make_mesh(seq_parallel=seq, pipe_parallel=pipe, expert_parallel=expert)
    elif inner > 1 and launch.needs_sharded_learner(algo, agent_cfg, rt):
        why = (f"device count {world} is not divisible by the inner axes product {inner} — "
               "adjust seq_parallel/pipeline_stages/expert_parallel"
               if world % inner else f"batch_size {rt.batch_size} is not divisible by the "
               f"data axis ({world}//{inner} = {world // inner})")
        raise ValueError(f"config requires a sharded learner (seq={seq}, pipe={pipe}, "
                         f"expert={expert}) but no valid mesh fits on {world} devices: {why}")
    elif multihost:
        # N independent learners would diverge: refused, as in JAX.
        raise ValueError(f"multi-host learner needs batch_size divisible by the global device "
                         f"count ({rt.batch_size} global batch, {world} devices)")
    if not multihost:
        return rt, None
    # A rank holds its data coordinate's rows: B / data (B / world without
    # seq, pipe or expert axes).
    return dataclasses.replace(rt, batch_size=rt.batch_size // data_axis), mesh


def _make_queue(capacity: int):
    """The learner server's queue: the C++ ring queue where the native
    library builds, else the Python one."""
    from distributed_reinforcement_learning_tpu_torch.data.native import native_available

    if native_available():
        from distributed_reinforcement_learning_tpu_torch.data.native import (
            NativeTrajectoryQueue)

        return NativeTrajectoryQueue(capacity)
    from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue

    return TrajectoryQueue(capacity)


def _kernel_launches() -> dict[str, int]:
    """Every kernel wrapper's launch count in this process."""
    from distributed_reinforcement_learning_tpu_torch.ops.kernels import attention as kattn
    from distributed_reinforcement_learning_tpu_torch.ops.kernels import lstm as klstm
    from distributed_reinforcement_learning_tpu_torch.ops.kernels import vtrace as kvt

    return {"vtrace": kvt.vtrace_cuda.launches, "lstm_fwd": klstm.lstm_fwd_cuda.launches,
            "lstm_bwd": klstm.lstm_bwd_cuda.launches,
            "attention_fwd": kattn.flash_fwd_cuda.launches,
            "attention_dq": kattn.flash_dq_cuda.launches,
            "attention_dkv": kattn.flash_dkv_cuda.launches}


def run_role(algo: str, config_path: str, section: str, mode: str, task: int,
             num_updates: int = 1000, run_dir: str | None = None, seed: int = 0,
             checkpoint_dir: str | None = None, checkpoint_interval: int = 500,
             actor_grace: float = 120.0, device: str | torch.device | None = None,
             serve_inference: bool = False, remote_act: bool = False) -> dict:
    """One process of the reference topology: `--mode learner`, `--mode
    actor --task k` or `--mode inference --task k` (an act-serving
    replica, `runtime/serving.run_replica`, which stops once the learner
    has been gone for `actor_grace` seconds). Runs on CUDA unless
    `device` names another device.

    The learner prints `[learner] serving on :<port>` when it listens,
    `[learner] done: N updates` when it stops, then one JSON line: train
    steps, frames learned, the kernels' launches in its process, stage ms
    (the first step, which pays the start-up costs, apart from the mean
    over the rest), the prefetcher's H2D ms a batch, publication latency,
    the queue depth and time at each step, bytes received, peak device
    memory, the queue's and the replay's classes, the sequences or
    unrolls ingested, and for a replay learner its sharded replay (shards,
    scorer, spill tier on or off, each shard's counts, the tier's
    counters, whether it demoted). An Ape-X actor's round is 64 env steps, another
    family's one unroll. An actor runs until the learner has been gone for
    `actor_grace` seconds and then prints one JSON line (frames of its
    completed rounds, seconds from its first round's start to its last
    round's end, the env steps it took with a round cut short by the
    learner's exit included and the seconds they took, the newest weight
    version it held).

    With `serve_inference` the learner also answers OP_ACT through an
    `InferenceServer` on its own device (seed `seed + 7777`), logs
    `[learner] SEED-style inference service enabled`, and its JSON holds
    the service's counters and latency (`inference`). With `remote_act` an
    actor acts through the learner's service, or through the replicas
    `DRL_INFER_ADDRS` names (the learner as the fallback), pulls no
    weights, and its JSON holds the acts' round trip (`remote_act`).

    With `DRL_LEARNER_RANK` and `DRL_LEARNER_PEERS` set (the launcher's
    `--learners N --learner_sync allreduce|async`) the learner is one
    seat of the learner tier (`runtime/learner_tier.py`): it serves on
    the base port + its rank, creates the shared board only while it
    publishes, and its JSON holds the tier's counters (`tier`).

    With `DRL_COORDINATOR`, `DRL_NUM_PROCESSES` and `DRL_PROCESS_ID`
    (the launcher's `--learners N` without a tier sync) the learner is
    one rank of a multi-process learner (`parallel/distributed.py`): on
    `cuda:{rank % devices}` (or the CPU), it serves on the base port +
    its rank, takes `batch_size / N` rows a step from its own data plane,
    and runs each learn step with the other ranks over a data mesh
    (`parallel/learner.py`). Every rank restores the checkpoint; only
    rank 0 writes it. Its JSON holds the group's rank, world, backend,
    mesh and the gradient reduction's ms and bytes (`multihost`).
    -> the printed dict."""
    from distributed_reinforcement_learning_tpu_torch.runtime import fleet as fleet_mod
    from distributed_reinforcement_learning_tpu_torch.runtime import launch
    from distributed_reinforcement_learning_tpu_torch.utils.config import load_config
    from distributed_reinforcement_learning_tpu_torch.utils.device import resolve_device
    from distributed_reinforcement_learning_tpu_torch.utils.logger import MetricsLogger

    refuse_unported(mode, algo)
    if mode == "inference":
        from distributed_reinforcement_learning_tpu_torch.runtime import serving

        return serving.run_replica(algo, config_path, section, task=task, seed=seed,
                                   run_dir=run_dir, grace=actor_grace, device=device)
    if mode not in ("learner", "actor"):
        raise ValueError(f"unknown mode {mode!r}")
    agent_cfg, rt = load_config(config_path, section)
    if launch.algo_of(agent_cfg) != algo:
        raise ValueError(f"section {section!r} is a {launch.algo_of(agent_cfg)} section, "
                         f"not {algo}")
    interval_env = os.environ.get("DRL_PUBLISH_INTERVAL")
    if interval_env:
        import dataclasses

        rt = dataclasses.replace(rt, publish_interval=max(1, int(interval_env)))
    device = resolve_device(device)
    host, port = resolve_learner_addr(rt)

    if mode == "learner":
        from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

        from distributed_reinforcement_learning_tpu_torch.runtime import learner_tier, replay_shard

        # The learner tier: when the launcher exported a seat identity,
        # this process is ONE of N cooperating seats (its own data port,
        # base + rank, and replay; train steps exchanged through the host
        # collective; one elected seat publishing to the shared board).
        # None: the single learner, untouched. The endpoint comes up
        # first, so that peers' startup barriers find it.
        from distributed_reinforcement_learning_tpu_torch.parallel import distributed

        tier = learner_tier.build_tier()
        if tier is not None and distributed.requested():
            tier.close()
            raise ValueError("the learner tier (DRL_LEARNER_SEATS, ROADMAP item 13a) and the "
                             "multi-process learner (DRL_COORDINATOR, item 13b) are different "
                             "scale-out planes: pick one")
        if tier is not None:
            tier.start()
            port += tier.rank
            print(f"[learner] tier seat {tier.rank}/{tier.seats} (sync={tier.sync}, "
                  f"publisher={tier.is_publisher()})", flush=True)
        # The multi-process learner: a no-op without the env names. Each
        # rank serves its own data plane on the base port + its rank and
        # takes batch_size / N rows a step; the mesh splits the data.
        multihost = distributed.initialize(device=device)
        rank, world = distributed.process_info()
        rt, mesh = _multihost_mesh(algo, agent_cfg, rt, world, multihost)
        if multihost:
            device = distributed.device()
            port += rank
            print(f"[learner] multi-host: process {rank}/{world}, local batch "
                  f"{rt.batch_size}, mesh {mesh.shape}", flush=True)
        queue = _make_queue(rt.queue_size)
        weights = WeightStore()
        # Co-hosted actors' publish-once weight plane: the launcher names
        # one board per learner (one for the whole tier, which only the
        # publishing seat writes); this side creates the segment and the
        # store mirrors every landed version into it (from the first
        # publish on, which the learner makes as it is built). Failure
        # leaves TCP-only weight pulls.
        board = None
        board_name = os.environ.get("DRL_SHM_WEIGHTS_CREATE", "").strip()
        if board_name and (tier is None or tier.is_publisher()):
            from distributed_reinforcement_learning_tpu_torch.runtime import weight_board

            board = weight_board.serve_board(board_name)
            if board is not None:
                weights.attach_board(board)
                print("[learner] shm weight board serving co-hosted actors", flush=True)
        # The sharded replay with ingest-time priorities (on by default,
        # as in the JAX package): each serve thread decodes, scores and
        # inserts into its own shard through the facade; the real queue
        # stays built as the demotion target (the learner keeps draining
        # it, normally idle). The spill tier anchors its segments beside
        # the checkpoints, so a restarted learner recovers them.
        spill_dir = os.path.join(checkpoint_dir, "replay_spill") if checkpoint_dir else None
        replay_service = replay_shard.build_service(algo, rt, seed=seed, spill_dir=spill_dir)
        ingest_queue: Any = queue
        if replay_service is not None:
            ingest_queue = replay_shard.ReplayIngestFifo(replay_service, queue)
        try:
            learner = launch.make_learner(
                algo, agent_cfg, rt, queue, weights, logger=MetricsLogger(run_dir), seed=seed,
                device=device, prefetch=algo in ("impala", "ximpala"),
                replay_service=replay_service, mesh=mesh)
            if tier is not None:
                # Rebind the learn seam with the collective exchange
                # (allreduce refuses a family without the split step).
                tier.attach(learner)
        except BaseException:
            if replay_service is not None:
                replay_service.close()
            if board is not None:
                board.close()
                board.unlink()
            if tier is not None:
                tier.close()
            raise
        if tier is not None:
            # The publication takeover: on promotion (the lowest live rank
            # after a death) this seat re-creates the shared board under
            # the same name (creator-pid reclaim) and the store writes its
            # current snapshot into it; the actors' reattach ladders find
            # it as after a learner restart.
            def on_promoted() -> None:
                nonlocal board
                if not board_name or board is not None:
                    return
                from distributed_reinforcement_learning_tpu_torch.runtime import weight_board

                board = weight_board.serve_board(board_name)
                if board is not None:
                    weights.attach_board(board)
                    print("[learner] tier takeover: shm weight board re-created for "
                          "co-hosted actors", flush=True)

            tier.set_promote_cb(on_promoted)
        ckpt = None
        if checkpoint_dir is not None:
            from distributed_reinforcement_learning_tpu_torch.utils.checkpoint import (
                Checkpointer)

            ckpt = Checkpointer(checkpoint_dir)
            if learner.restore_checkpoint(ckpt):
                print(f"[learner] resumed from step {learner.train_steps}", flush=True)
            if rank != 0:
                # Every rank restores; only rank 0 writes. Over a pipe,
                # expert or model axis the others still join each save's
                # gather of the whole state.
                sharded = getattr(learner, "_sharded", None)
                ckpt = (Checkpointer(checkpoint_dir, writes=False)
                        if sharded is not None and sharded.reducer.shard_dims else None)
        inference = None
        if serve_inference:
            from distributed_reinforcement_learning_tpu_torch.runtime.inference import (
                InferenceServer)

            # Acts on the learner's device and its current stream, behind
            # the learn steps already enqueued there (ordered after each
            # publish's device snapshot).
            inference = InferenceServer.for_agent(algo, learner.agent, weights, seed=seed + 7777)
            print(f"[learner] SEED-style inference service enabled on {device}", flush=True)
        supervisor = member_loop = None
        if fleet_mod.fleet_enabled():
            # A tier seat's reply names the elected publisher as the
            # board's creator, so members validate the shared board
            # against it; seats past 0 are also members of seat 0's roster.
            supervisor = fleet_mod.FleetSupervisor(
                board_pid_fn=tier.publisher_pid if tier is not None else None).start()
            if tier is not None and tier.rank != 0:
                member_loop = fleet_mod.start_member_loop(
                    rt, "learner", tier.rank, version_fn=lambda: weights.version)
        if supervisor is not None and replay_service is not None:
            supervisor.watch(ingest_queue)  # revives dead shards on its sweep
        server = TransportServer(ingest_queue, weights, host="0.0.0.0", port=port,
                                 fleet=supervisor, inference=inference).start()
        # Co-hosted actors' zero-copy data plane: the launcher names one
        # ring per co-hosted actor; this side creates the segments and
        # drains them into the same queue the TCP server feeds (the
        # replay shards' facade for the replay families). Failure leaves
        # TCP-only operation.
        ring_drainer = None
        ring_names = [n for n in os.environ.get("DRL_SHM_RING_CREATE", "").split(",") if n]
        if ring_names:
            from distributed_reinforcement_learning_tpu_torch.runtime import shm_ring

            ring_drainer = shm_ring.serve_rings(ring_names, ingest_queue)
            if ring_drainer is not None:
                print(f"[learner] shm rings serving {len(ring_names)} co-hosted actor(s)",
                      flush=True)
        if maybe_configure("learner", tier.rank if tier is not None else rank, run_dir):
            _OBS.sample("transport/queue_depth", queue.size)
            _OBS.sample("learner/weight_version", lambda: weights.version)
            if weights.sharded:
                for key in weights.shard_stats():
                    _OBS.sample(f"weights/{key}", lambda k=key: weights.shard_stat(k),
                                kind="counter")
            for key in server.snapshot_stats():
                _OBS.sample(f"transport/{key}", lambda k=key: server.stat(k), kind="counter")
            if supervisor is not None:
                fleet_mod.register_supervisor_telemetry(supervisor)
            if replay_service is not None:
                replay_shard.register_telemetry(replay_service)
            if inference is not None:
                _OBS.sample("inference/rows_served", lambda: inference.rows_served,
                            kind="counter")
                _OBS.sample("inference/batches_run", lambda: inference.batches_run,
                            kind="counter")
                _OBS.sample("inference/admission_rejects", inference.admission_reject_count,
                            kind="counter")
            if ring_drainer is not None:
                _OBS.sample("ring/depth", ring_drainer.depth_bytes)
                for key in ring_drainer.snapshot_stats():
                    _OBS.sample(f"ring/{key}", lambda k=key: ring_drainer.stat(k),
                                kind="counter")
            if member_loop is not None:
                fleet_mod.register_member_telemetry(member_loop)
            if tier is not None:
                learner_tier.register_telemetry(tier)
        if tier is not None and not tier.await_peers():
            print(f"[learner] tier seat {tier.rank}: some peers never answered the startup "
                  f"barrier; starting degraded over {tier.collective.membership.live()}",
                  flush=True)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        print(f"[learner] serving on :{port}; training {num_updates} updates on {device}; "
              f"queue {type(queue).__name__}; {_describe_service(replay_service)}", flush=True)
        steps: list[tuple[float, int]] = []
        first_step_ms: dict[str, float] = {}
        first_calls: dict[str, int] = {}

        def on_step() -> None:
            steps.append((time.perf_counter() - t0, queue.size()))
            if tier is not None and len(steps) % TIER_LOG_STEPS == 0:
                st = tier.snapshot_stats()
                print(f"[learner] tier seat {tier.rank}: step {learner.train_steps}, rounds "
                      f"{st['rounds']}, retries {st['round_retries']}, giveups "
                      f"{st['round_giveups']}, merges {st['merges_applied']}, live "
                      f"{tier.collective.membership.live()}", flush=True)
            if len(steps) == 1:  # the first step pays the one-off start-up costs:
                first_step_ms.update(learner.timer.run_totals_ms())  # kept apart
                first_calls.update(learner.timer.run_counts())
                learner.timer.reset()

        t0 = time.perf_counter()
        try:
            _learner_loop(algo, learner, num_updates, ckpt, checkpoint_interval, on_step)
        finally:
            wall = time.perf_counter() - t0
            shutdown_at = time.time()  # wall clock: actors' demotions are held to it
            if ckpt is not None and learner.train_steps > 0:
                learner.save_checkpoint(ckpt)
            learner.close()  # flush publication, stop the prefetch thread
            queue.close()
            server.stop()
            if ring_drainer is not None:
                ring_drainer.stop()  # closes and unlinks the ring segments
            if board is not None:
                weights.close()  # drain pending async publishes
                board.close_writer()  # attached actors demote to TCP
                board.close()
                board.unlink()
            if inference is not None:
                inference.stop()
            replay_stats = _service_summary(replay_service, ingest_queue)
            if replay_service is not None:
                replay_service.close()  # stop the update-router thread
            if supervisor is not None:
                supervisor.stop()
            if member_loop is not None:
                member_loop.stop()
            tier_stats = None
            if tier is not None:
                tier_stats = {"rank": tier.rank, "seats": tier.seats, "sync": tier.sync,
                              "publisher": tier.is_publisher(),
                              "live": tier.collective.membership.live(),
                              **tier.snapshot_stats(),
                              "collective": tier.collective.snapshot_stats()}
                tier.close()  # stop the sweep and the collective endpoint
            multihost_stats = None
            if multihost:
                reducer = learner._sharded.reducer
                multihost_stats = {
                    "rank": rank, "world": world, "backend": distributed.backend(),
                    "mesh": mesh.shape, "reduce_ms": [ms for ms, _ in reducer.records],
                    "reduce_bytes": [b for _, b in reducer.records]}
                distributed.shutdown()
            _OBS.close()
        print(f"[learner] done: {learner.train_steps} updates", flush=True)
        calls = Counter(first_calls) + Counter(learner.timer.run_counts())
        prefetcher = getattr(learner, "prefetcher", None)
        h2d = prefetcher.h2d_ms() if prefetcher is not None else []
        replay = getattr(learner, "replay", None)
        land = list(weights.land_ms)
        summary = {
            "role": "learner", "algo": algo, "device": str(device),
            "train_steps": learner.train_steps,
            "frames_learned": getattr(learner, "frames_learned", None),
            "ingested_sequences": getattr(learner, "ingested_sequences", None),
            "ingested_unrolls": getattr(learner, "ingested_unrolls", None),
            "queue": type(queue).__name__,
            "replay": None if replay is None else type(replay).__name__,
            "replay_size": None if replay is None else len(replay),
            "replay_service": replay_stats,
            "launches": _kernel_launches(), "wall_s": wall,
            "first_step_stage_ms": first_step_ms,
            "stage_ms": learner.timer.run_means_ms(),
            "stage_total_ms": learner.timer.run_totals_ms(),
            "stage_calls": dict(calls),
            "step_s": [t for t, _ in steps],
            "h2d_ms_per_batch": sum(h2d) / len(h2d) if h2d else None,
            "h2d_ms": h2d,
            "publish_land_ms": sum(land) / len(land) if land else None,
            "publishes_landed": len(land),
            "queue_depth": [d for _, d in steps],
            "transport": server.snapshot_stats(),
            "shutdown_at": shutdown_at,
            "rings": None if ring_drainer is None else ring_drainer.snapshot_stats(),
            "board": None if board is None else weights.board_stats(),
            "weight_shards": weights.shard_stats() if weights.sharded else None,
            "inference": None if inference is None else inference.stats(),
            "tier": tier_stats,
            "multihost": multihost_stats,
            "peak_device_mib": (torch.cuda.max_memory_allocated(device) / 2**20
                                if device.type == "cuda" else None),
        }
        print(json.dumps(summary), flush=True)
        return summary

    # -- actor ---------------------------------------------------------
    if task < 0:
        raise ValueError("actor mode needs --task k")
    from distributed_reinforcement_learning_tpu_torch.data import admission

    client = TransportClient(host, port)
    queue: Any = RemoteQueue(client)
    # Zero-copy data plane for co-hosted actors: when the launcher named
    # a ring for this task, trajectory PUTs become one memcpy into shared
    # memory (control traffic stays on this TCP client). Attach failure
    # or a mid-run ring death falls back to TCP.
    ring_name = os.environ.get("DRL_SHM_RING_NAME", "").strip()
    if ring_name:
        from distributed_reinforcement_learning_tpu_torch.runtime import shm_ring

        rq = shm_ring.attach_ring_queue(ring_name, client)
        if rq is not None:
            queue = rq
            print(f"[actor {task}] shm ring attached: {ring_name}" if rq.attached else
                  f"[actor {task}] shm ring {ring_name} unavailable; starting demoted to TCP "
                  f"(reattach ladder armed)", flush=True)
    # Sample-at-source (off by default, as in the JAX package): score and
    # stamp initial priorities here, and thin low-priority unrolls under
    # the learner's ingest pressure. One controller an actor, shared
    # with the publisher's queue below (one mass ledger, one pressure).
    admission_ctrl = admission.configure(queue, algo, seed=seed + 1 + task)
    if admission_ctrl is not None:
        print(f"[actor {task}] actor-side priority stamping on "
              f"(scorer={admission_ctrl.scorer_name}, "
              f"admission={'on' if admission.admission_enabled() else 'off'})", flush=True)
    # The TCP pull is shard-scoped when the learner publishes per shard
    # (it demotes itself to the whole-blob op against an unsharded
    # store), and DRL_WEIGHTS_KEYS scopes this role's refreshes.
    from distributed_reinforcement_learning_tpu_torch.runtime import weight_shards

    tcp_weights = ShardedRemoteWeights(client, device, keys=weight_shards.role_keys())
    weights: Any = tcp_weights
    # Publish-once weight plane: when the launcher named a board, a pull
    # is a shared-memory version peek plus one memcpy when the version
    # changed; attach failure or a dead board falls back to TCP pulls.
    board_name = os.environ.get("DRL_SHM_WEIGHTS_NAME", "").strip()
    if board_name:
        from distributed_reinforcement_learning_tpu_torch.runtime import weight_board

        bw = weight_board.attach_board_weights(board_name, client, fallback=tcp_weights,
                                               device=device)
        if bw is not None:
            weights = bw
            print(f"[actor {task}] shm weight board attached: {board_name}" if bw.attached else
                  f"[actor {task}] shm weight board {board_name} unavailable; starting demoted "
                  f"to TCP pulls (reattach ladder armed)", flush=True)
    timed = _TimedWeights(weights)
    # Served acts: through the replicas the launcher names (round-robin
    # with a least-pending bias, dead ones demoted, the learner's service
    # as the fallback), else through the learner's service.
    remote: Any = None
    if remote_act:
        infer_addrs = [a for a in os.environ.get("DRL_INFER_ADDRS", "").split(",") if a]
        if infer_addrs:
            remote = RemoteActService.from_addrs(infer_addrs, fallback=client)
            print(f"[actor {task}] remote act via {len(infer_addrs)} inference replica(s)",
                  flush=True)
        else:
            remote = RemoteInference(client)
            print(f"[actor {task}] remote act via the learner's inference service", flush=True)
    timed_act = None if remote is None else _TimedAct(remote)
    actor = launch.make_actor(algo, agent_cfg, rt, task, queue, timed, seed=seed + 1 + task,
                              device=device, remote_act=timed_act)
    from distributed_reinforcement_learning_tpu_torch.runtime import actor_pipeline

    pub_client = None
    if actor_pipeline.pipeline_enabled() and type(queue) is RemoteQueue:
        # The publisher gets its own connection: the shared client's
        # request/reply lock would serialise its PUTs with weight pulls.
        # A ring queue needs none, and its publisher thread is then the
        # ring's one producer.
        pub_client = TransportClient(host, port)
        pub_queue = RemoteQueue(pub_client)
        if admission_ctrl is not None:
            pub_queue.set_admission(admission_ctrl)
        actor = actor_pipeline.maybe_wrap(actor, label=f"actor {task}",
                                          publisher_queue=pub_queue)
        if not isinstance(actor, actor_pipeline.ActorPipeline):
            pub_client.close()
            pub_client = None
    else:
        actor = actor_pipeline.maybe_wrap(actor, label=f"actor {task}")
    # Fleet membership: each heartbeat reply drives the demoted shm
    # surfaces' bounded reattach probes, so a respawned learner's
    # segments come back into service.
    heartbeats = fleet_mod.start_member_loop(
        rt, "actor", task,
        surfaces=[s for s in (queue, weights, remote) if hasattr(s, "reattach")],
        version_fn=lambda: getattr(actor, "_version", -1))
    if maybe_configure("actor", task, run_dir):
        for key in client.snapshot_stats():
            _OBS.sample(f"actor/{key}", lambda k=key: client.stat(k), kind="counter")
        _OBS.sample("actor/weight_version_held", lambda: getattr(actor, "_version", -1))
        if heartbeats is not None:
            fleet_mod.register_member_telemetry(heartbeats)
        for prefix, surface in (("ring", queue), ("board", weights), ("remote_act", remote)):
            if hasattr(surface, "snapshot_stats"):
                for key in surface.snapshot_stats():
                    _OBS.sample(f"{prefix}/{key}", lambda k=key, s=surface: s.stat(k),
                                kind="counter")
    print(f"[actor {task}] connected to {host}:{port} on {device}", flush=True)
    # Elastic recovery: on transport failure keep retrying for
    # `actor_grace` seconds (a learner restart from a checkpoint), then
    # exit. From here each reconnect is short, so this loop owns the
    # deadline.
    client.connect_retries = 3
    frames = 0
    max_version = -1
    down_since: float | None = None
    first_round = last_round = None
    # The first round's start; the end of the last round, or the failure
    # that cut a round short (its steps count in the actor's `_steps`).
    started = stopped = None
    try:
        try:
            while True:
                try:
                    t_round = time.perf_counter()
                    started = started or t_round
                    with _OBS.span("actor_round"):
                        got = _actor_round(algo, actor)
                    first_round = first_round or t_round
                    last_round = stopped = time.perf_counter()
                    frames += got
                    if _OBS.enabled:
                        _OBS.count("actor/env_frames", got)
                    down_since = None
                except (TransportError, OSError):
                    if down_since is None:
                        stopped = time.perf_counter()
                    now = time.time()
                    down_since = down_since or now
                    if now - down_since > actor_grace:
                        print(f"[actor {task}] learner gone >{actor_grace:.0f}s after {frames} "
                              f"frames; exiting", flush=True)
                        break
                    time.sleep(1.0)
                finally:
                    max_version = max(max_version, getattr(actor, "_version", -1))
        except KeyboardInterrupt:  # the cluster launcher's stop request
            print(f"[actor {task}] interrupted; stopping", flush=True)
    finally:
        if heartbeats is not None:
            heartbeats.stop()
        if hasattr(actor, "close"):  # ActorPipeline: drain the publisher
            actor.close()
        if pub_client is not None:
            pub_client.close()
        for surface in (queue, weights, remote):
            if hasattr(surface, "reattach") and hasattr(surface, "close"):
                surface.close()
        client.close()
        _OBS.close()
    summary = {"role": "actor", "task": task, "device": str(device), "frames": frames,
               "active_s": (last_round - first_round) if first_round else 0.0,
               "env_steps": getattr(actor, "_steps", None),
               "stepping_s": (stopped - started) if started and stopped else 0.0,
               "weight_version": max_version, "transport": client.snapshot_stats(),
               "weight_pulls": timed.summary(),
               "ring": _surface_summary(queue), "board": _surface_summary(weights),
               "weight_shards": tcp_weights.snapshot_stats(),
               "remote_act": None if timed_act is None else timed_act.summary(),
               "admission": None if admission_ctrl is None else admission_ctrl.snapshot()}
    print(json.dumps(summary), flush=True)
    return summary


class _TimedWeights:
    """An actor's weight surface with the ms of each `get_if_newer` kept:
    pulls (a new version arrived) apart from checks (already newest)."""

    def __init__(self, inner):
        self.inner = inner
        self.pull_ms: deque = deque(maxlen=4096)
        self.check_ms: deque = deque(maxlen=4096)

    def get_if_newer(self, have_version: int):
        t0 = time.perf_counter()
        got = self.inner.get_if_newer(have_version)
        (self.check_ms if got is None else self.pull_ms).append(
            (time.perf_counter() - t0) * 1e3)
        return got

    def summary(self) -> dict:
        def p50(xs):
            return float(np.median(list(xs))) if xs else None

        return {"surface": type(self.inner).__name__, "pulls": len(self.pull_ms),
                "pull_ms_p50": p50(self.pull_ms), "checks": len(self.check_ms),
                "check_ms_p50": p50(self.check_ms)}


class _TimedAct:
    """An actor's served-act surface with each act's round trip kept (ms,
    the last 4096) and the acts that raised counted (a lost request)."""

    def __init__(self, inner):
        self.inner = inner
        # The act worker and the main thread take turns, never together.
        self.acts = 0
        self.failed = 0
        self.ms: deque = deque(maxlen=4096)

    def __call__(self, request: dict) -> dict:
        t0 = time.perf_counter()
        try:
            out = self.inner(request)
        except Exception:
            self.failed += 1
            raise
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.acts += 1
        return out

    def summary(self) -> dict:
        ms = list(self.ms)
        return {"surface": type(self.inner).__name__, "acts": self.acts, "failed": self.failed,
                "act_ms_p50": float(np.percentile(ms, 50)) if ms else None,
                "act_ms_p99": float(np.percentile(ms, 99)) if ms else None,
                "service": (self.inner.snapshot_stats()
                            if hasattr(self.inner, "snapshot_stats") else None)}


def _surface_summary(surface) -> dict | None:
    """An shm surface's counters and the wall-clock times it demoted to
    TCP; None for a TCP surface."""
    if not hasattr(surface, "demoted_at"):
        return None
    return {**surface.snapshot_stats(), "demoted_at": list(surface.demoted_at)}


def _describe_service(service) -> str:
    """The learner's start-line words for its replay."""
    if service is None:
        return "replay monolithic"
    tier = "on" if service.tier_stats() is not None else "off"
    return (f"sharded replay: {len(service.shards)} shard(s), scorer {service.scorer_name}, "
            f"spill tier {tier}")


def _service_summary(service, facade) -> dict | None:
    """The learner's final-JSON view of its sharded replay."""
    if service is None:
        return None
    return {"shards": len(service.shards), "scorer": service.scorer_name,
            "spill": service.tier_stats() is not None, "healthy": service.healthy,
            "demoted": facade.demoted, "shard_stats": service.shard_stats(),
            "tier_stats": service.tier_stats(), "admission": facade.admission_stats(),
            "updates_dropped": service.updates_dropped}


def _learner_loop(algo: str, learner, num_updates: int, ckpt=None,
                  checkpoint_interval: int = 500, on_step=None) -> None:
    """Train until `num_updates`, checkpointing every `checkpoint_interval`
    steps; `on_step()` runs after each train step."""
    from distributed_reinforcement_learning_tpu_torch.runtime.launch import SEQUENCE_REPLAY

    last_saved = learner.train_steps

    def after_step() -> None:
        nonlocal last_saved
        if on_step is not None:
            on_step()
        if ckpt is not None and learner.train_steps - last_saved >= checkpoint_interval:
            learner.save_checkpoint(ckpt)
            last_saved = learner.train_steps

    if algo in ("impala", "ximpala"):
        while learner.train_steps < num_updates:
            if learner.step(timeout=5.0) is not None:
                after_step()
    elif algo == "apex":
        from distributed_reinforcement_learning_tpu_torch.runtime.apex_runner import (
            drain_ingest)

        while learner.train_steps < num_updates:
            drained = drain_ingest(learner)
            if learner.train() is not None:
                after_step()
            elif not drained:
                time.sleep(0.05)
    elif algo in SEQUENCE_REPLAY:
        while learner.train_steps < num_updates:
            got = learner.ingest_batch(timeout=0.05)
            if learner.train() is not None:
                after_step()
            elif not got:
                time.sleep(0.05)
    else:
        raise ValueError(f"unknown algorithm {algo!r}")


def _actor_round(algo: str, actor) -> int:
    """One actor round: 64 env steps for Ape-X, one unroll otherwise."""
    if algo == "apex":
        return actor.run_steps(64)
    return actor.run_unroll()
