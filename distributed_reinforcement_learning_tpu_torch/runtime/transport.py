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
  (iii) QUEUE_SIZE / PING       polls and liveness
  (iv)  REGISTER / HEARTBEAT    the fleet control plane (runtime/fleet.py)

Trajectories cross between the packages: both codecs give the same
bytes for the same tree, and `codec.decode` rebuilds a namedtuple by
name and fields. Weight blobs do not: the port's blob is a flat
`{parameter name: array}` dict of its own module names, a JAX learner's
a flax tree, so `RemoteWeights` refuses anything but a flat dict.

`run_role` starts one process of the reference topology: `--mode
learner` (queue, weight store, learner on `resolve_device(device)`, this
server) or `--mode actor --task k` (an actor whose queue and weight
store are `RemoteQueue` / `RemoteWeights` over one `TransportClient`).
Co-hosted roles take the JAX package's shared-memory planes by the same
names: a learner with `DRL_SHM_RING_CREATE` drains one shm ring per
actor into the queue this server feeds (`runtime/shm_ring.py`), and with
`DRL_SHM_WEIGHTS_CREATE` mirrors every landed version into a weight
board (`runtime/weight_board.py`); an actor with `DRL_SHM_RING_NAME` /
`DRL_SHM_WEIGHTS_NAME` puts and pulls through them, demoting to TCP if
they fail. Left out, each refused with a ValueError that names its
ROADMAP item: serving acts (`--serve_inference`, `--remote_act`, `--mode
inference`; the server answers OP_ACT with ST_UNAVAILABLE), sharded
weight publication (`DRL_WEIGHTS_SHARDED`), the learner tier and
multi-host learners, and the fused device sample path
(`DRL_DEVICE_PATH`). The learner's queue is
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
OP_ACT = 5  # remote inference: never served by the port (ST_UNAVAILABLE)
OP_PUT_TRAJ_N = 6  # K unrolls per round trip
OP_GET_WEIGHTS_SHARDED = 7  # the port's store is unsharded: ST_UNAVAILABLE
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


class TransportError(ConnectionError):
    pass


class ShardedWeightsUnavailableError(RuntimeError):
    """OP_GET_WEIGHTS_SHARDED unserved: the learner's store publishes whole
    blobs. Not a TransportError: the caller demotes to the whole-blob op."""


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
    must have `get_blob` and `version`), and a fleet supervisor's ops when
    one is given."""

    _GUARDED_BY = {
        "stats": "_stats_lock",
        "_conns": "_conns_lock",
        "_threads": "_conns_lock",
    }
    _NOT_GUARDED = {
        "_sock": "bound in start() before the accept thread spawns; stop() "
                 "closes it cross-thread on purpose to end the accept loop",
    }

    def __init__(self, queue, weights, host: str = "0.0.0.0", port: int = 8000, fleet=None):
        self.queue = queue
        self.weights = weights
        self.fleet = fleet
        self.host, self.port = host, port
        self._sock: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self.stats = {"unrolls_accepted": 0, "busy_replies": 0, "partial_accepts": 0,
                      "weight_sends": 0, "weight_bytes_sent": 0, "bytes_received": 0,
                      "fleet_msg_errors": 0}
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
            print(f"[transport] depth={self.queue.size()} unrolls={s['unrolls_accepted']} "
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
                if op == OP_PUT_TRAJ:
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
                elif op in (OP_GET_WEIGHTS_SHARDED, OP_ACT):
                    # Unsharded store; no act service (ROADMAP items 12d, 12e).
                    _send_msg(conn, ST_UNAVAILABLE)
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


class TransportClient(_LockedStatsMixin):
    """Actor-side connection with bounded-retry reconnect. One lock
    serialises each request/reply exchange, reconnects included."""

    _GUARDED_BY = {"_sock": "_lock", "stats": "_stats_lock"}
    _NOT_GUARDED = {
        "_admission": "set once by the actor's runner (set_admission) before "
                      "any PUT; the controller locks itself",
    }

    def __init__(self, host: str, port: int, connect_retries: int = 60,
                 retry_interval: float = 1.0, busy_timeout: float = 90.0,
                 connect: bool = True):
        self.host, self.port = host, port
        self.connect_retries = connect_retries
        self.retry_interval = retry_interval
        self.busy_timeout = busy_timeout
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()
        self.stats = {"unrolls_sent": 0, "busy_waits": 0, "partial_accepts": 0,
                      "weight_pulls": 0, "weight_bytes_received": 0,
                      "unrolls_admission_dropped": 0}
        self._stats_lock = threading.Lock()
        self._admission = None  # data/admission.AdmissionController
        if connect:
            self._connect_locked()

    def _connect_locked(self) -> None:
        last: Exception | None = None
        for _ in range(self.connect_retries):
            try:
                sock = socket.create_connection((self.host, self.port), timeout=300.0)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._sock = sock
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

    def get_weights_sharded(self, have_version: int) -> Any:
        """The shard-scoped pull, as a probe: raises
        ShardedWeightsUnavailableError when the learner publishes whole
        blobs (every port learner does), ValueError when it serves shards
        (the port has no shard decoder: ROADMAP item 12e)."""
        req = bytearray(21)  # [i64 have][i64 base][u8 flags][u32 nkeys=0]
        _I64.pack_into(req, 0, have_version)
        _I64.pack_into(req, 8, -2)
        status, resp = self._exchange(OP_GET_WEIGHTS_SHARDED, req, retry=True, resend=True)
        if status == ST_CLOSED:
            raise TransportError("learner closed the data plane")
        if status != ST_OK:
            raise ShardedWeightsUnavailableError("endpoint does not serve sharded weight pulls")
        raise ValueError("the learner publishes sharded weights; sharded pulls are not "
                         "ported (ROADMAP item 12e)")

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
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in tree.items()}


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


class ShardedRemoteWeights(RemoteWeights):
    """`get_if_newer` that probes the shard-scoped op once and, as against
    every port learner, demotes itself to whole-blob pulls for good. A JAX
    actor's `ShardedRemoteWeights` takes the same fallback against a port
    learner. A learner that does serve shards raises ValueError (the
    shard decoder is not ported, ROADMAP item 12e)."""

    telemetry_prefix = "wshard"
    surface_name = "wshard"

    def __init__(self, client: TransportClient, device: str | torch.device = "cpu"):
        super().__init__(client, device)
        self._plain = False

    def get_if_newer(self, have_version: int) -> tuple[Any, int] | None:
        if not self._plain:
            try:
                self._client.get_weights_sharded(have_version)
            except ShardedWeightsUnavailableError:
                self._plain = True
        return super().get_if_newer(have_version)


def resolve_learner_addr(rt) -> tuple[str, int]:
    """The learner's address:

      DRL_LEARNER_ADDR=host:port — full address;
      DRL_LEARNER_INDEX=k — port offset against the config's
        server_ip/server_port (co-hosted learner processes).

    Actors connect to it, and the port's learner binds its port (the JAX
    learner binds the config's `server_port`)."""
    addr = os.environ.get("DRL_LEARNER_ADDR")
    if addr:
        host, _, p = addr.rpartition(":")
        return host, int(p)
    return rt.server_ip, rt.server_port + int(os.environ.get("DRL_LEARNER_INDEX", "0"))


def _truthy(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() not in ("", "0", "false", "no", "off")


def refuse_unported(mode: str, serve_inference: bool = False, remote_act: bool = False) -> None:
    """Raise a ValueError naming the ROADMAP item for each plane of the
    JAX topology that the caller asks for and the port lacks."""
    if mode == "inference" or serve_inference or remote_act:
        raise ValueError("serving acts (--serve_inference, --remote_act, --mode inference) "
                         "is not ported (ROADMAP item 12d)")
    if mode == "anakin":
        raise ValueError("the on-device loop (--mode anakin) is not ported (ROADMAP item 14)")
    if _truthy("DRL_WEIGHTS_SHARDED"):
        raise ValueError("DRL_WEIGHTS_SHARDED: sharded weight publication is not ported "
                         "(ROADMAP item 12e)")
    seats = os.environ.get("DRL_LEARNER_SEATS", "").strip()
    if (seats not in ("", "0", "1") or os.environ.get("DRL_LEARNER_PEERS", "").strip()
            or os.environ.get("DRL_COORDINATOR", "").strip()):
        raise ValueError("the learner tier (DRL_LEARNER_SEATS) and multi-host learners "
                         "(DRL_COORDINATOR) are not ported (ROADMAP item 13)")
    if os.environ.get("DRL_DEVICE_PATH", "").strip() not in ("", "0"):
        raise ValueError("DRL_DEVICE_PATH: the fused device sample path is not ported "
                         "(ROADMAP item 16)")


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
    """One process of the reference topology: `--mode learner` or `--mode
    actor --task k`. Runs on CUDA unless `device` names another device.

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
    version it held). -> the printed dict."""
    from distributed_reinforcement_learning_tpu_torch.runtime import fleet as fleet_mod
    from distributed_reinforcement_learning_tpu_torch.runtime import launch
    from distributed_reinforcement_learning_tpu_torch.utils.config import load_config
    from distributed_reinforcement_learning_tpu_torch.utils.device import resolve_device
    from distributed_reinforcement_learning_tpu_torch.utils.logger import MetricsLogger

    refuse_unported(mode, serve_inference, remote_act)
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

        from distributed_reinforcement_learning_tpu_torch.runtime import replay_shard

        queue = _make_queue(rt.queue_size)
        weights = WeightStore()
        # Co-hosted actors' publish-once weight plane: the launcher names
        # one board per learner; this side creates the segment and the
        # store mirrors every landed version into it (from the first
        # publish on, which the learner makes as it is built). Failure
        # leaves TCP-only weight pulls.
        board = None
        board_name = os.environ.get("DRL_SHM_WEIGHTS_CREATE", "").strip()
        if board_name:
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
                replay_service=replay_service)
        except BaseException:
            if replay_service is not None:
                replay_service.close()
            if board is not None:
                board.close()
                board.unlink()
            raise
        ckpt = None
        if checkpoint_dir is not None:
            from distributed_reinforcement_learning_tpu_torch.utils.checkpoint import (
                Checkpointer)

            ckpt = Checkpointer(checkpoint_dir)
            if learner.restore_checkpoint(ckpt):
                print(f"[learner] resumed from step {learner.train_steps}", flush=True)
        supervisor = fleet_mod.FleetSupervisor().start() if fleet_mod.fleet_enabled() else None
        if supervisor is not None and replay_service is not None:
            supervisor.watch(ingest_queue)  # revives dead shards on its sweep
        server = TransportServer(ingest_queue, weights, host="0.0.0.0", port=port,
                                 fleet=supervisor).start()
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
        if maybe_configure("learner", 0, run_dir):
            _OBS.sample("transport/queue_depth", queue.size)
            _OBS.sample("learner/weight_version", lambda: weights.version)
            for key in server.snapshot_stats():
                _OBS.sample(f"transport/{key}", lambda k=key: server.stat(k), kind="counter")
            if supervisor is not None:
                fleet_mod.register_supervisor_telemetry(supervisor)
            if replay_service is not None:
                replay_shard.register_telemetry(replay_service)
            if ring_drainer is not None:
                _OBS.sample("ring/depth", ring_drainer.depth_bytes)
                for key in ring_drainer.snapshot_stats():
                    _OBS.sample(f"ring/{key}", lambda k=key: ring_drainer.stat(k),
                                kind="counter")
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        print(f"[learner] serving on :{port}; training {num_updates} updates on {device}; "
              f"queue {type(queue).__name__}; {_describe_service(replay_service)}", flush=True)
        steps: list[tuple[float, int]] = []
        first_step_ms: dict[str, float] = {}
        first_calls: dict[str, int] = {}

        def on_step() -> None:
            steps.append((time.perf_counter() - t0, queue.size()))
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
            replay_stats = _service_summary(replay_service, ingest_queue)
            if replay_service is not None:
                replay_service.close()  # stop the update-router thread
            if supervisor is not None:
                supervisor.stop()
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
    tcp_weights = ShardedRemoteWeights(client, device)
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
    actor = launch.make_actor(algo, agent_cfg, rt, task, queue, timed, seed=seed + 1 + task,
                              device=device)
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
        surfaces=[s for s in (queue, weights) if hasattr(s, "reattach")],
        version_fn=lambda: getattr(actor, "_version", -1))
    if maybe_configure("actor", task, run_dir):
        for key in client.snapshot_stats():
            _OBS.sample(f"actor/{key}", lambda k=key: client.stat(k), kind="counter")
        _OBS.sample("actor/weight_version_held", lambda: getattr(actor, "_version", -1))
        if heartbeats is not None:
            fleet_mod.register_member_telemetry(heartbeats)
        for prefix, surface in (("ring", queue), ("board", weights)):
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
        for surface in (queue, weights):
            if hasattr(surface, "reattach"):
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


def _surface_summary(surface) -> dict | None:
    """An shm surface's counters and the wall-clock times it demoted to
    TCP; None for a TCP surface."""
    if not hasattr(surface, "reattach"):
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
