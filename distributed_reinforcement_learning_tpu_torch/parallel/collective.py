"""Host-side collective for the learner tier (`runtime/learner_tier.py`).

Copy of the JAX package's `parallel/collective.py` (numpy and sockets,
no jax): the same op numbers (40-42), PART and MERGE headers and
payload formats, so a seat of one package and a seat of the other run
one ring (`tests/test_torch_collective.py`). Its imports are the port's
`data/bf16.py` and `runtime/transport.py`.

Podracer's Sebulba architecture (arXiv:2104.06272) splits the learner
into cooperating seats; this module is the seats' exchange plane — a
TCP peer mesh on the transport's framing (`runtime/transport._send_msg`
/ `_recv_msg`: [u8 op][u32 len][payload] requests, [u8 status][u32 len]
[payload] replies) carrying two traffic classes:

- **ring allreduce** (`allreduce_mean`): the lockstep gradient exchange
  of `DRL_LEARNER_SYNC=allreduce`. Classic 2(k-1)-step ring over the
  seats' flat f32 vectors: k-1 reduce-scatter steps (each seat ends up
  owning one fully-summed chunk) then k-1 allgather steps, sum divided
  by k at the end. Every PART message carries (membership epoch, round
  seq, phase, step, chunk) — a receiver in a different epoch NAKs, and
  the sender raises `RoundAborted` so the learner retries the round
  under the re-formed membership instead of deadlocking on a dead ring.

- **async push** (`push_merge`/`take_merges`): the bounded-wait
  IMPACT-style mode (arXiv:1912.00167) of `DRL_LEARNER_SYNC=async`.
  A seat pushes its params vector to every live peer without waiting
  for anyone (the ack is the only synchronization); each endpoint keeps
  the LATEST vector per sender with its merge-step stamp, and the
  consumer drops contributions staler than its bounded-staleness
  budget (`runtime/learner_tier.py`).

**Membership** is the tier's failure model: the live-rank set plus an
integer epoch. A peer that fails an exchange or a liveness probe is
marked dead — the epoch bumps, every in-flight round aborts (inbox
purged, round seq reset), and the NEXT round runs over the survivors'
ring at k-1, down to solo (a one-member ring returns its input — the
demote-to-solo path). Dead ranks stay dead for the life of this
collective: a rejoining seat's params have diverged, and averaging them
back in would corrupt every survivor.

At a membership change survivors can apply ONE round asymmetrically (a
seat that completed the dying round vs one that aborted and retried it
under the new epoch). Every later round merges the same vector on every
survivor, so the divergence is bounded to that single update.

**Partition-aware rounds** (`allreduce_mean(vec, plan=...)`):
`parallel/partition.build_exchange_plan` classifies every gradient leaf
by its partition spec into an `ExchangePlan` — the flat vector's
segments grouped by spec class. The REPLICATED segments ride the ring;
each sharded class (model / expert / pipe) is exchanged owner-scoped:
members send their class segment to one deterministic owner seat
(phase 2), the owner accumulates in f32, divides by k, and fans the
merged segment back (phase 3) — same OP_COLL_PART framing, same
epoch/NAK failure model. The plan (leaf classes + sizes + quant/overlap
config) is hashed and pinned EQUAL across seats: HELLO carries the
hash, and a mismatch is a `PlanMismatch` refusal, never silent
divergence. Optional bf16 transport (`ExchangePlan(quant="bf16")`)
quantizes every hop through the shared RNE codec (`data/bf16.py`) at
half the wire bytes; accumulation stays f32, and each seat roundtrips
its self-owned chunk so all seats still end bit-identical. A plan-less
call is the whole-vector f32 ring.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import struct
import threading
import time

import numpy as np

from distributed_reinforcement_learning_tpu_torch.data.bf16 import (
    bf16_u16_to_f32,
    f32_to_bf16_u16,
)
from distributed_reinforcement_learning_tpu_torch.runtime.transport import (
    ST_ERROR,
    ST_OK,
    TransportError,
    _recv_msg,
    _send_msg,
)

# Collective op namespace (disjoint from runtime/transport's 1..9; the
# endpoint below is the dispatcher, PeerClient._exchange the sender).
OP_COLL_HELLO = 40  # liveness probe + peer identification + plan hash
OP_COLL_PART = 41   # one allreduce chunk (ring phases 0/1, star 2/3)
OP_COLL_MERGE = 42  # async-mode params push (latest-wins per sender)

# PART: (sender_rank, epoch, seq, phase, step, chunk_idx, fmt) + payload.
# phase 0/1 = ring reduce-scatter/allgather (step = ring step, chunk =
# chunk index); phase 2 = member -> class-owner contribution (step =
# class index, chunk = sender rank); phase 3 = owner -> member merged
# segment (step = class index, chunk = destination rank). fmt tags the
# payload encoding so a receiver never guesses.
_PART_HDR = struct.Struct("<IIqIIII")
# MERGE: (sender_rank, epoch, merge_step) + f32 payload.
_MERGE_HDR = struct.Struct("<IIq")

FMT_F32 = 0   # payload = raw little-endian f32
FMT_BF16 = 1  # payload = u16-carried bf16 (data/bf16.py RNE codec)

_ACCEPT = b"\x01"
_NAK = b"\x00"


def wait_budget_s() -> float:
    """Bounded wait for one collective exchange (`DRL_LEARNER_WAIT_S`):
    past it the blocked seat probes the peer and either keeps waiting
    (peer alive, one extension) or declares it dead and re-forms."""
    env = os.environ.get("DRL_LEARNER_WAIT_S", "").strip()
    try:
        return max(0.1, float(env)) if env else 10.0
    except ValueError as e:
        raise ValueError(
            f"DRL_LEARNER_WAIT_S must be a number, got {env!r}") from e


class CollectiveError(RuntimeError):
    """Base class for collective failures the tier handles."""


class RoundAborted(CollectiveError):
    """The membership epoch changed under an in-flight round (a NAK
    from a re-formed peer, or this seat observed the bump itself).
    Retry the round: the next attempt runs over the new membership."""


class PeerLost(CollectiveError):
    """A peer died mid-exchange (connection failure or a probe-confirmed
    wedge). The membership already marked it dead and bumped the epoch
    by the time this raises — retry the round over the survivors."""


class PlanMismatch(CollectiveError):
    """Two seats negotiated DIFFERENT exchange plans (partition rules,
    quant mode, or overlap depth diverge). Exchanging under skewed plans
    would silently merge mismatched segments — the tier must refuse
    loudly instead (check_plan_agreement raises this)."""


# Spec-class byte accounting: the dynamic spec keys from
# parallel/partition.spec_key ("rep", "-,model", "expert", "pipe", ...)
# fold into a FIXED stat-key vocabulary so telemetry names are stable
# from construction (register_telemetry snapshots the keys once).
_CLASS_LABELS = ("rep", "model", "expert", "pipe", "other")


def class_label(key: str) -> str:
    """Stable stats label for a partition spec class key: the non-None
    axis names joined by `_` ("-,model" -> "model"), "rep" for the
    replicated class, "other" for any axis vocabulary outside the
    default mesh rules."""
    if key == "rep":
        return "rep"
    axes = [a for a in key.split(",") if a and a != "-"]
    label = "_".join(axes) or "other"
    return label if label in _CLASS_LABELS else "other"


class ExchangePlan:
    """Partition classes of the flat exchange vector, leaf by leaf in
    the tier's flatten order (`runtime/learner_tier.flatten_tree`: the
    parameter dict's order; the builder in parallel/partition.py walks
    the SAME order).

    `entries` is [(spec_class_key, size), ...] per leaf; consecutive
    leaves of one class become (start, stop) segments of the flat
    vector. `quant` ("f32" | "bf16") and `overlap` (in-flight round
    depth) ride the plan because every seat must run the SAME exchange
    arithmetic — all three are folded into `plan_hash`, the value HELLO
    pins equal across seats. Plans are immutable once built."""

    __slots__ = ("entries", "quant", "overlap", "length", "segments",
                 "classes", "plan_hash")

    def __init__(self, entries: list[tuple[str, int]], quant: str = "f32",
                 overlap: int = 0):
        if quant not in ("f32", "bf16"):
            raise ValueError(f"ExchangePlan quant must be f32|bf16, "
                             f"got {quant!r}")
        self.entries = [(str(k), int(n)) for k, n in entries]
        self.quant = quant
        self.overlap = int(overlap)
        self.segments: dict[str, list[tuple[int, int]]] = {}
        off = 0
        for key, n in self.entries:
            segs = self.segments.setdefault(key, [])
            if segs and segs[-1][1] == off:  # merge adjacent same-class
                segs[-1] = (segs[-1][0], off + n)
            else:
                segs.append((off, off + n))
            off += n
        self.length = off
        # "rep" first (the ring class), sharded classes in sorted order
        # — the deterministic class walk every seat follows.
        sharded = sorted(k for k in self.segments if k != "rep")
        self.classes = (["rep"] if "rep" in self.segments else []) + sharded
        blob = json.dumps({"leaves": self.entries, "quant": self.quant,
                           "overlap": self.overlap},
                          separators=(",", ":")).encode()
        self.plan_hash = hashlib.sha256(blob).hexdigest()

    @property
    def fmt(self) -> int:
        return FMT_BF16 if self.quant == "bf16" else FMT_F32

    def sharded_classes(self) -> list[str]:
        return [k for k in self.classes if k != "rep"]

    def gather(self, vec: np.ndarray, key: str) -> np.ndarray:
        """Contiguous f32 copy of one class's segments."""
        segs = self.segments[key]
        if len(segs) == 1:
            a, b = segs[0]
            return np.ascontiguousarray(vec[a:b], np.float32)
        return np.concatenate([vec[a:b] for a, b in segs]).astype(
            np.float32, copy=False)

    def scatter(self, vec: np.ndarray, key: str, data: np.ndarray) -> None:
        """Inverse of `gather`: write one class's merged segments back
        into the flat vector."""
        off = 0
        for a, b in self.segments[key]:
            vec[a:b] = data[off:off + (b - a)]
            off += b - a
        if off != data.size:
            raise CollectiveError(
                f"class {key!r} segment size mismatch: {off} != {data.size}")


def _encode_part(arr: np.ndarray, fmt: int) -> bytes:
    if fmt == FMT_BF16:
        return f32_to_bf16_u16(arr).tobytes()
    return arr.tobytes()


def _decode_part(buf: bytes, fmt: int) -> np.ndarray:
    """Wire payload -> f32 (accumulation is ALWAYS f32 — the master-
    accumulation contract that keeps quantized rounds inside the rtol
    pin: only the transported values are rounded, never the sums)."""
    if fmt == FMT_BF16:
        return bf16_u16_to_f32(np.frombuffer(buf, np.uint16))
    if fmt != FMT_F32:
        raise CollectiveError(f"unknown PART payload fmt {fmt}")
    return np.frombuffer(buf, np.float32)


def _roundtrip(arr: np.ndarray, fmt: int) -> np.ndarray:
    """What a receiver of `arr` would hold after decode: the self-owned
    copy every sender applies to ITSELF so quantized rounds stay
    bit-identical across seats (bf16 roundtrip is idempotent, so
    re-quantized forwards carry the exact same u16 words)."""
    if fmt == FMT_BF16:
        return bf16_u16_to_f32(f32_to_bf16_u16(arr))
    return arr


class Membership:
    """Live-rank set + epoch, the collective's failure ground truth.

    Concurrency map: the learn thread
    (allreduce abort paths), the endpoint serve threads (epoch checks
    on every PART/MERGE), and the tier's liveness sweep all read/write
    this state — everything lives under `_lock`.
    """

    _GUARDED_BY = {
        "_live": "_lock",
        "_epoch": "_lock",
    }

    def __init__(self, ranks, rank: int):
        if rank not in ranks:
            raise ValueError(f"own rank {rank} not in roster {sorted(ranks)}")
        self.rank = rank
        self._lock = threading.Lock()
        self._live = set(ranks)
        self._epoch = 0

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def live(self) -> list[int]:
        with self._lock:
            return sorted(self._live)

    def is_live(self, rank: int) -> bool:
        with self._lock:
            return rank in self._live

    @property
    def solo(self) -> bool:
        with self._lock:
            return len(self._live) == 1

    def snapshot(self) -> tuple[list[int], int]:
        """(live ranks, epoch) under ONE lock hold — a round must pin
        both coherently; two separate reads could span a bump."""
        with self._lock:
            return sorted(self._live), self._epoch

    def mark_dead(self, rank: int) -> bool:
        """Remove `rank`; True (and an epoch bump) when it was live.
        Own rank never dies through here — a seat cannot outlive its
        own membership."""
        if rank == self.rank:
            return False
        with self._lock:
            if rank not in self._live:
                return False
            self._live.discard(rank)
            self._epoch += 1
            return True


class PeerClient:
    """Framed point-to-point client for one peer endpoint: connect on
    first use, one bounded reconnect-and-resend per exchange (every
    collective op is idempotent: PART/MERGE re-delivery overwrites the
    same inbox key with identical bytes; HELLO is a pure probe).

    NOT thread-safe and deliberately lock-free: each instance belongs
    to exactly one calling thread (the learn thread's per-rank send
    clients, or a transient probe client) — the collective never shares
    one across threads, so a serializing lock would only buy the
    blocking-under-lock hazards transport's client pays for its shared
    surface.
    """

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 connect_retries: int = 1, retry_interval: float = 0.1):
        self.host, self.port = host, port
        self.timeout = timeout
        self.connect_retries = max(1, connect_retries)
        self.retry_interval = retry_interval
        self._sock: socket.socket | None = None

    def _connect(self) -> None:
        last: Exception | None = None
        for _ in range(self.connect_retries):
            try:
                sock = socket.create_connection((self.host, self.port),
                                                timeout=self.timeout)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._sock = sock
                return
            except OSError as e:
                last = e
                time.sleep(self.retry_interval)
        raise TransportError(
            f"cannot reach collective peer {self.host}:{self.port}: {last}")

    def _exchange(self, op: int, payload) -> tuple[int, bytes]:
        parts = payload if isinstance(payload, list) else [payload]
        if self._sock is None:
            self._connect()
        try:
            _send_msg(self._sock, op, *parts)
            return _recv_msg(self._sock)
        except (TransportError, OSError):
            self.close()
            self._connect()
            _send_msg(self._sock, op, *parts)
            return _recv_msg(self._sock)

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


class CollectiveEndpoint:
    """One seat's listening side: accepts connections from the ring's
    prev peer (PART traffic), async merge pushers, and probe clients,
    dispatching each framed request to the owning HostCollective's
    inbox under ITS synchronization.

    Concurrency map: the accept loop and
    the per-connection serve threads share the connection bookkeeping
    exactly like TransportServer (same stop() contract: close every
    accepted socket so blocked recvs unwedge now).
    """

    _GUARDED_BY = {
        "_conns": "_lock",
        "_threads": "_lock",
    }
    _NOT_GUARDED = {
        "_sock": "bound in start() before the accept thread spawns; "
                 "stop() closes it cross-thread ON PURPOSE to break the "
                 "accept loop out of its timed accept()",
    }

    def __init__(self, owner: "HostCollective", host: str, port: int):
        self._owner = owner
        self.host, self.port = host, port
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()
        self._conns: set[socket.socket] = set()
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()

    def start(self) -> "CollectiveEndpoint":
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self._sock.listen(16)
        self._sock.settimeout(0.5)
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"coll-accept-{self._owner.rank}")
        t.start()
        with self._lock:
            self._threads.append(t)
        return self

    def _accept_loop(self) -> None:
        assert self._sock is not None
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                if self._stop.is_set():
                    conn.close()
                    return
                self._conns.add(conn)
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            with self._lock:
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)

    def _serve(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    op, payload = _recv_msg(conn)
                except (TransportError, OSError):
                    return
                try:
                    if op == OP_COLL_HELLO:
                        reply = self._owner._on_hello(
                            json.loads(bytes(payload)))
                        _send_msg(conn, ST_OK,
                                  json.dumps(reply,
                                             separators=(",", ":")).encode())
                    elif op == OP_COLL_PART:
                        accepted = self._owner._on_part(payload)
                        _send_msg(conn, ST_OK,
                                  _ACCEPT if accepted else _NAK)
                    elif op == OP_COLL_MERGE:
                        accepted = self._owner._on_merge(payload)
                        _send_msg(conn, ST_OK,
                                  _ACCEPT if accepted else _NAK)
                    else:
                        _send_msg(conn, ST_ERROR)
                except (TransportError, OSError):
                    return
                except Exception:  # noqa: BLE001 — malformed peer bytes
                    # must not kill the endpoint: answer ST_ERROR and
                    # count it (snapshot_stats/"serve_errors").
                    self._owner._bump("serve_errors")
                    try:
                        _send_msg(conn, ST_ERROR)
                    except OSError:
                        return
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                # Wakes the accept thread at once (a close alone leaves it
                # in accept() until its 0.5 s timeout).
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()
        with self._lock:
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
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=2.0)


class HostCollective:
    """The seat-side collective: one endpoint (this seat's listen
    address), lazy per-peer send clients, the membership, and the two
    exchange primitives the tier drives (`allreduce_mean`,
    `push_merge`/`take_merges`). See the module docstring for the
    failure model.

    Concurrency map: `_cond` is a
    Condition over `_lock` (alias) — the endpoint serve threads fill
    `_inbox`/`_merges` and notify, the learn thread consumes under
    timed waits; `_seq` shares the lock because the epoch-bump reset
    races the learn thread's increment. `stats` follows the repo's
    locked-stats convention. `_clients` is learn/merge-thread-only by
    contract (probe paths build transient clients instead — see
    PeerClient's docstring).
    """

    _GUARDED_BY = {
        "_inbox": ("_lock", "_cond"),
        "_merges": ("_lock", "_cond"),
        "_peer_pids": ("_lock", "_cond"),
        "_peer_plans": ("_lock", "_cond"),
        "_plan_hash": ("_lock", "_cond"),
        "_plan_warned": ("_lock", "_cond"),
        "_seq": ("_lock", "_cond"),
        "stats": "_stats_lock",
    }
    _NOT_GUARDED = {
        "_clients": "single-caller contract: only the learn/merge "
                    "thread sends parts or pushes merges; probes use "
                    "transient clients",
        "_plan": "learn-thread-only exchange layout (set_plan at attach "
                 "time, read by allreduce callers); serve threads read "
                 "only the guarded _plan_hash",
        "_endpoint": "start()/close() lifecycle handle, controlling "
                     "thread only",
        "addrs": "immutable after construction: the seat roster is "
                 "fixed for the life of the collective (membership "
                 "tracks liveness separately)",
    }

    def __init__(self, rank: int, addrs: list[str],
                 wait_s: float | None = None):
        self.rank = rank
        self.addrs = [self._parse(a) for a in addrs]
        if rank < 0 or rank >= len(self.addrs):
            raise ValueError(
                f"rank {rank} outside the {len(self.addrs)}-seat roster")
        self.wait_s = wait_budget_s() if wait_s is None else wait_s
        self.membership = Membership(range(len(self.addrs)), rank)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._inbox: dict[tuple, np.ndarray] = {}
        self._merges: dict[int, tuple[int, np.ndarray]] = {}
        self._peer_pids: dict[int, int] = {}
        self._peer_plans: dict[int, str] = {}
        self._plan_hash: str | None = None
        self._plan_warned: set[int] = set()
        self._plan: ExchangePlan | None = None
        self._seq = 0
        self._clients: dict[int, PeerClient] = {}
        host, port = self.addrs[rank]
        self._endpoint = CollectiveEndpoint(self, host, port)
        self.stats = {"rounds_ok": 0, "rounds_aborted": 0, "peer_deaths": 0,
                      "serve_errors": 0,
                      "solo_rounds": 0, "bytes_sent": 0, "bytes_received": 0,
                      "merges_sent": 0, "merges_received": 0,
                      "merge_naks": 0, "probes_failed": 0,
                      "recv_waits_extended": 0,
                      # Partition-aware rounds: count + per-spec-class
                      # wire bytes SENT (the obs_report bytes/round
                      # breakdown; labels are the fixed _CLASS_LABELS
                      # vocabulary so telemetry names never churn).
                      "coll_rounds_part": 0, "coll_quant_rounds": 0,
                      "coll_bytes_rep": 0, "coll_bytes_model": 0,
                      "coll_bytes_expert": 0, "coll_bytes_pipe": 0,
                      "coll_bytes_other": 0}
        self._stats_lock = threading.Lock()

    @staticmethod
    def _parse(addr: str) -> tuple[str, int]:
        host, _, port = addr.rpartition(":")
        return host or "127.0.0.1", int(port)

    def start(self) -> "HostCollective":
        self._endpoint.start()
        return self

    def _bump(self, key: str, by: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += by

    def stat(self, key: str) -> int:
        with self._stats_lock:
            return self.stats[key]

    def snapshot_stats(self) -> dict:
        with self._stats_lock:
            return dict(self.stats)

    # -- exchange-plan negotiation -----------------------------------------

    def set_plan(self, plan: ExchangePlan | None) -> None:
        """Pin this seat's partition-aware exchange plan (attach-time,
        before rounds run). The hash becomes part of every HELLO so
        peers can refuse a skewed plan; None reverts to the plan-less
        ring."""
        self._plan = plan
        with self._lock:
            self._plan_hash = None if plan is None else plan.plan_hash
            self._plan_warned.clear()

    @property
    def plan(self) -> "ExchangePlan | None":
        return self._plan

    def plan_hash(self) -> str | None:
        with self._lock:
            return self._plan_hash

    def check_plan_agreement(self) -> None:
        """Loud refusal of plan skew: raise PlanMismatch when any LIVE
        peer has reported (via HELLO, either direction) a non-None plan
        hash different from ours. A peer that has not negotiated yet
        (None) is NOT a mismatch — attach order races are expected; the
        check re-runs at every partitioned round."""
        with self._lock:
            mine = self._plan_hash
            peers = dict(self._peer_plans)
        if mine is None:
            return
        for rank in sorted(peers):
            theirs = peers[rank]
            if (theirs is not None and theirs != mine
                    and self.membership.is_live(rank)):
                raise PlanMismatch(
                    f"seat {self.rank} exchange plan {mine[:16]}... != "
                    f"seat {rank} plan {theirs[:16]}... — the seats were "
                    f"launched with different partition rules, quant "
                    f"mode, or overlap depth; refusing to merge under "
                    f"skewed plans")

    def _note_peer_plan(self, peer: int, plan_hash) -> bool:
        """Record a peer's advertised plan hash; True when it clashes
        with ours (both non-None, different). The first clash per peer
        logs loudly — the serve-side half of the refusal."""
        if not (0 <= peer < len(self.addrs)):
            return False
        with self._lock:
            if plan_hash is not None:
                self._peer_plans[peer] = str(plan_hash)
            mine = self._plan_hash
            clash = (mine is not None and plan_hash is not None
                     and str(plan_hash) != mine)
            warn = clash and peer not in self._plan_warned
            if warn:
                self._plan_warned.add(peer)
        if warn:
            import sys

            print(f"[collective] seat {self.rank}: REFUSING seat {peer} — "
                  f"exchange plan hash {str(plan_hash)[:16]}... != ours "
                  f"{mine[:16]}... (partition rules / quant / overlap "
                  f"skew)", file=sys.stderr)
        return clash

    # -- endpoint callbacks (serve threads) --------------------------------

    def _on_hello(self, info: dict) -> dict:
        peer = int(info.get("rank", -1))
        pid = int(info.get("pid", 0))
        if pid and 0 <= peer < len(self.addrs):
            with self._lock:
                self._peer_pids[peer] = pid
        clash = self._note_peer_plan(peer, info.get("plan"))
        live = self.membership.is_live(peer)
        return {"rank": self.rank, "epoch": self.membership.epoch,
                "pid": os.getpid(), "plan": self.plan_hash(),
                "accepted": live and not clash}

    def _on_part(self, payload) -> bool:
        sender, epoch, seq, phase, step, chunk, fmt = _PART_HDR.unpack_from(
            payload, 0)
        wire = len(payload) - _PART_HDR.size
        arr = _decode_part(bytes(payload[_PART_HDR.size:]), fmt)
        with self._cond:
            # Epoch gate: a PART from a past membership must NAK so the
            # lagging sender aborts its round instead of wedging ours.
            if epoch != self.membership.epoch \
                    or not self.membership.is_live(sender):
                return False
            self._inbox[(epoch, seq, phase, step, chunk)] = arr
            self._cond.notify_all()
        self._bump("bytes_received", wire)
        return True

    def _on_merge(self, payload) -> bool:
        sender, epoch, step = _MERGE_HDR.unpack_from(payload, 0)
        arr = np.frombuffer(bytes(payload[_MERGE_HDR.size:]), np.float32)
        if not self.membership.is_live(sender):
            self._bump("merge_naks")
            return False
        with self._cond:
            # Latest-wins per sender; epoch is informational for merges
            # (async mode tolerates cross-epoch contributions — the
            # staleness bound is in merge STEPS, the consumer's filter).
            prev = self._merges.get(sender)
            if prev is None or step >= prev[0]:
                self._merges[sender] = (step, arr)
        self._bump("merges_received")
        return True

    # -- membership / liveness ---------------------------------------------

    def _note_dead(self, rank: int) -> None:
        if self.membership.mark_dead(rank):
            self._bump("peer_deaths")
            self._on_epoch_change()
            import sys

            print(f"[collective] seat {self.rank}: peer seat {rank} marked "
                  f"dead; membership now {self.membership.live()} "
                  f"(epoch {self.membership.epoch})", file=sys.stderr)

    def _on_epoch_change(self) -> None:
        """Purge round state: in-flight PART keys belong to the dead
        epoch, and the per-epoch round seq restarts so survivors
        re-align on (epoch, seq=0)."""
        with self._cond:
            self._inbox.clear()
            self._seq = 0
            self._cond.notify_all()

    def probe_peer(self, rank: int, timeout: float = 2.0) -> bool:
        """One transient HELLO probe (sweep/timeout paths; never the
        learn thread's cached send clients — see PeerClient)."""
        host, port = self.addrs[rank]
        client = PeerClient(host, port, timeout=timeout)
        try:
            status, resp = client._exchange(
                OP_COLL_HELLO,
                json.dumps({"rank": self.rank, "pid": os.getpid(),
                            "epoch": self.membership.epoch,
                            "plan": self.plan_hash()}).encode())
            if status != ST_OK:
                raise TransportError(f"hello answered status {status}")
            reply = json.loads(bytes(resp))
            pid = int(reply.get("pid", 0))
            if pid:
                with self._lock:
                    self._peer_pids[rank] = pid
            self._note_peer_plan(rank, reply.get("plan"))
            return bool(reply.get("accepted", False))
        except (TransportError, OSError, ValueError):
            self._bump("probes_failed")
            return False
        finally:
            client.close()

    def peer_pid(self, rank: int) -> int | None:
        """Last pid a HELLO exchange proved for `rank` (publisher-pid
        resolution for the fleet's board validation); None before any
        contact."""
        with self._lock:
            return self._peer_pids.get(rank)

    # -- ring allreduce (learn thread) -------------------------------------

    def _client(self, rank: int) -> PeerClient:
        client = self._clients.get(rank)
        if client is None:
            host, port = self.addrs[rank]
            client = PeerClient(host, port, timeout=self.wait_s)
            self._clients[rank] = client
        return client

    def _send_part(self, to_rank: int, epoch: int, seq: int, phase: int,
                   step: int, chunk_idx: int, arr: np.ndarray,
                   fmt: int = FMT_F32, cls: str | None = None) -> None:
        payload = _encode_part(arr, fmt)
        hdr = _PART_HDR.pack(self.rank, epoch, seq, phase, step, chunk_idx,
                             fmt)
        try:
            status, resp = self._client(to_rank)._exchange(
                OP_COLL_PART, [hdr, payload])
        except (TransportError, OSError):
            self._note_dead(to_rank)
            raise PeerLost(f"peer seat {to_rank} died mid-send") from None
        if status != ST_OK or bytes(resp) != _ACCEPT:
            # The peer lives in a different epoch (it re-formed without
            # us, or we re-formed without it): abort and retry under
            # OUR current membership — if the peer really dropped us,
            # its own sends to us will NAK symmetrically.
            raise RoundAborted(
                f"peer seat {to_rank} rejected round part (epoch skew)")
        self._bump("bytes_sent", len(payload))
        if cls is not None:
            self._bump(f"coll_bytes_{cls}", len(payload))

    def _recv_part(self, from_rank: int, epoch: int, seq: int, phase: int,
                   step: int, chunk_idx: int, deadline: float) -> np.ndarray:
        key = (epoch, seq, phase, step, chunk_idx)
        while True:
            with self._cond:
                arr = self._inbox.pop(key, None)
                if arr is None and self.membership.epoch == epoch:
                    self._cond.wait(timeout=0.2)
                    arr = self._inbox.pop(key, None)
                if arr is not None:
                    return arr
            if self.membership.epoch != epoch:
                raise RoundAborted("membership changed under the round")
            if time.monotonic() < deadline:
                continue
            if self.probe_peer(from_rank):
                # Alive but not contributing yet (a starved seat waiting
                # for data, a long jit compile): lockstep allreduce
                # WAITS — that is the BSP contract, and `async` mode is
                # the documented escape when it is too tight. Only an
                # UNREACHABLE peer is dead; each successful probe renews
                # the wait budget.
                self._bump("recv_waits_extended")
                deadline = time.monotonic() + self.wait_s
                continue
            self._note_dead(from_rank)
            raise PeerLost(
                f"peer seat {from_rank} unreachable past the wait budget")

    def allreduce_mean(self, vec: np.ndarray,
                       plan: "ExchangePlan | None" = None) -> np.ndarray:
        """Mean of `vec` across the live seats. Solo membership returns
        a float32 copy of the input (demote-to-solo: the mean of one).
        Raises RoundAborted/PeerLost on membership churn — the caller
        retries, and the next attempt runs over the survivors.

        Plan-less (`plan=None`): today's full-vector f32 ring allreduce,
        byte-for-byte. With an ExchangePlan: the replicated class rides
        the ring, every sharded class goes owner-scoped (phase 2/3 star
        under the same round seq), hops optionally bf16 per the plan's
        quant — and the round first re-checks plan agreement so skewed
        seats refuse loudly instead of merging garbage."""
        ranks, epoch = self.membership.snapshot()
        k = len(ranks)
        vec = np.ascontiguousarray(vec, np.float32)
        if plan is not None and plan.length != vec.size:
            raise CollectiveError(
                f"exchange plan covers {plan.length} elements but the "
                f"vector has {vec.size} — stale plan for this learner")
        if k == 1:
            self._bump("solo_rounds")
            return vec.copy()
        with self._cond:
            seq = self._seq
        if plan is None:
            merged = self._ring_exchange(vec, ranks, epoch, seq)
        else:
            self.check_plan_agreement()
            fmt = plan.fmt
            merged = vec.copy()
            if "rep" in plan.segments:
                rep = self._ring_exchange(plan.gather(vec, "rep"), ranks,
                                          epoch, seq, fmt=fmt, cls="rep")
                plan.scatter(merged, "rep", rep)
            for ci, key in enumerate(plan.sharded_classes()):
                seg = self._star_exchange(plan.gather(vec, key), key, ci,
                                          ranks, epoch, seq, fmt)
                plan.scatter(merged, key, seg)
            self._bump("coll_rounds_part")
            if fmt == FMT_BF16:
                self._bump("coll_quant_rounds")
        with self._cond:
            # Advance only if the epoch survived the round: an abort
            # path resets seq to 0 and this increment must not undo it.
            if self.membership.epoch == epoch:
                self._seq = seq + 1
        self._bump("rounds_ok")
        return merged

    def _ring_exchange(self, vec: np.ndarray, ranks: list[int], epoch: int,
                       seq: int, fmt: int = FMT_F32,
                       cls: str | None = None) -> np.ndarray:
        """Classic 2(k-1)-step ring over `vec` -> elementwise mean.
        Quantized hops (`fmt=FMT_BF16`) decode to f32 at the receiver
        before accumulating (master accumulation); the allgather then
        forwards exactly-roundtripping bf16 words, and each seat
        roundtrips its self-owned chunk at the end, so every seat holds
        bit-identical bytes either way."""
        k = len(ranks)
        p = ranks.index(self.rank)
        nxt, prv = ranks[(p + 1) % k], ranks[(p - 1) % k]
        chunks = [c.copy() for c in np.array_split(vec, k)]
        deadline = time.monotonic() + self.wait_s
        for phase in (0, 1):  # 0 = reduce-scatter, 1 = allgather
            for s in range(k - 1):
                if phase == 0:
                    send_i, recv_i = (p - s) % k, (p - s - 1) % k
                else:
                    send_i, recv_i = (p + 1 - s) % k, (p - s) % k
                self._send_part(nxt, epoch, seq, phase, s, send_i,
                                chunks[send_i], fmt=fmt, cls=cls)
                got = self._recv_part(prv, epoch, seq, phase, s, recv_i,
                                      deadline)
                if got.shape != chunks[recv_i].shape:
                    raise CollectiveError(
                        f"chunk shape mismatch from seat {prv}: "
                        f"{got.shape} != {chunks[recv_i].shape}")
                chunks[recv_i] = chunks[recv_i] + got if phase == 0 else got
        if fmt != FMT_F32:
            # The chunk this seat reduced (never received back) is still
            # raw f32 — roundtrip it so our bytes match what every peer
            # decoded from the wire.
            own = (p + 1) % k
            chunks[own] = _roundtrip(chunks[own], fmt)
        return np.concatenate(chunks) / np.float32(k)

    def _star_exchange(self, seg: np.ndarray, key: str, class_idx: int,
                       ranks: list[int], epoch: int, seq: int,
                       fmt: int) -> np.ndarray:
        """Owner-scoped exchange of one sharded class: members send
        their segment to the class's deterministic owner seat (phase 2),
        the owner f32-accumulates, divides by k, and fans the merged
        segment back (phase 3). The owner applies the same wire
        roundtrip to its own copy, so all seats end bit-identical. Owner
        assignment rotates over the LIVE ranks by class index — every
        seat derives it from the same epoch-pinned snapshot."""
        k = len(ranks)
        owner = ranks[class_idx % k]
        cls = class_label(key)
        deadline = time.monotonic() + self.wait_s
        if self.rank == owner:
            acc = seg.astype(np.float32, copy=True)
            for r in ranks:
                if r == owner:
                    continue
                got = self._recv_part(r, epoch, seq, 2, class_idx, r,
                                      deadline)
                if got.size != seg.size:
                    raise CollectiveError(
                        f"class {key!r} segment size mismatch from seat "
                        f"{r}: {got.size} != {seg.size}")
                acc += got
            merged = acc / np.float32(k)
            for r in ranks:
                if r == owner:
                    continue
                self._send_part(r, epoch, seq, 3, class_idx, r, merged,
                                fmt=fmt, cls=cls)
            return _roundtrip(merged, fmt)
        self._send_part(owner, epoch, seq, 2, class_idx, self.rank, seg,
                        fmt=fmt, cls=cls)
        got = self._recv_part(owner, epoch, seq, 3, class_idx, self.rank,
                              deadline)
        if got.size != seg.size:
            raise CollectiveError(
                f"class {key!r} merged segment size mismatch from owner "
                f"seat {owner}: {got.size} != {seg.size}")
        return got

    # -- async merge plane (learn thread) ----------------------------------

    def push_merge(self, vec: np.ndarray, step: int) -> int:
        """Fire this seat's params vector at every live peer; returns
        how many accepted. Never waits beyond the per-send socket
        timeout — a dead peer is marked and skipped, a NAK (the peer
        dropped us) just doesn't count."""
        vec = np.ascontiguousarray(vec, np.float32)
        hdr = _MERGE_HDR.pack(self.rank, self.membership.epoch, step)
        accepted = 0
        for peer in self.membership.live():
            if peer == self.rank:
                continue
            try:
                status, resp = self._client(peer)._exchange(
                    OP_COLL_MERGE, [hdr, vec.tobytes()])
            except (TransportError, OSError):
                self._note_dead(peer)
                continue
            if status == ST_OK and bytes(resp) == _ACCEPT:
                accepted += 1
                self._bump("merges_sent")
                self._bump("bytes_sent", vec.nbytes)
            else:
                self._bump("merge_naks")
        return accepted

    def take_merges(self, min_step: int) -> dict[int, tuple[int, np.ndarray]]:
        """Latest contribution per live peer at merge-step >= `min_step`
        (the bounded-staleness filter); staler entries are left in place
        (a future push overwrites them) but never returned."""
        live = set(self.membership.live())
        with self._cond:
            return {rank: (step, arr)
                    for rank, (step, arr) in self._merges.items()
                    if rank in live and step >= min_step}

    def close(self) -> None:
        self._endpoint.stop()
        for client in self._clients.values():
            client.close()
        self._clients.clear()
