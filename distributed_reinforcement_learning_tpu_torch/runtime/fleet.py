"""Elastic fleet supervisor: registration, heartbeats, re-promote ladders.

Copy of the JAX package's `runtime/fleet.py` (it imports no jax). Of the
surfaces named below, the port has the shm ring (`runtime/shm_ring.py`),
the weight board (`runtime/weight_board.py`) and the replay shards; its
heartbeats drive the ring's and the board's reattach ladders. The
inference replicas and the sharded weight pull are not ported yet
(ROADMAP items 12d, 12e).

Every fast path this repo shipped fails SAFE but — until this module —
failed PERMANENTLY: the shm ring (PR 3), the weight board (PR 5), the
replay shards (PR 6), the inference replicas (PR 7) and the sharded
weight pull (PR 8) all demote one-way, so a learner restart or a
preempted replica stranded the topology on its slow path forever even
after the fast path came back. TorchBeast (arXiv:1910.03552) and the
Podracer architectures (arXiv:2104.06272) both treat dynamic,
preemption-tolerant actor fleets as table stakes; this module is the
repo's control plane for that:

- **FleetSupervisor** (learner side): a registry served over two new
  control ops on the existing transport (`OP_REGISTER`/`OP_HEARTBEAT`,
  runtime/transport.py). Actors, inference replicas and any other
  member register with (role, rank, pid, attach surfaces, last-seen
  weight version); a sweep thread marks members SUSPECT after a missed
  heartbeat window and DEAD (evicted from the live roster) after a
  longer one, keeps a bounded join/suspect/dead/rejoin event timeline,
  and exposes everything to telemetry (obs_report's "Fleet health"
  section) and to the local-cluster launcher's respawn loop. The
  supervisor also drives LEARNER-side re-promote probes (the replay
  ingest facade) from its sweep cadence.

- **HeartbeatLoop** (member side): one thread per non-learner process
  sending `OP_HEARTBEAT` on its own control connection at a fixed
  cadence (`DRL_FLEET_HB_S`). Each successful reply carries the
  learner's INCARNATION (epoch + pid): an epoch change means the
  learner restarted, so the loop re-registers, resets every watched
  surface's retry ladder (a new incarnation earns a fresh probe
  budget), and hands the learner's pid to the surfaces so a shm
  reattach can prove it found the NEW incarnation's segment, not the
  dead one's corpse. After each reply the loop drives the watched
  surfaces' `reattach()` probes — re-promotion runs on the control
  cadence, never on the data hot path.

- **RetryLadder**: the bounded state machine every re-promote path
  shares — exponential backoff from `DRL_REATTACH_BASE_S` capped at
  `DRL_REATTACH_MAX_S`, at most `DRL_REATTACH_ATTEMPTS` probes per
  outage (reset on success or on a learner epoch change). An exhausted
  ladder logs once and leaves the demotion permanent — the pre-fleet
  behavior, reached only after the budget proves the peer is not
  coming back. Oversize/incompatible-layout latches (the sharded
  board's per-shard latch, a schema change mid-run) are NOT ladders:
  retrying cannot fix a layout, so they stay permanent with their own
  logged reason (runtime/weight_board.py).

`DRL_FLEET=0` disables the whole plane (no registration, no heartbeats,
no probes) — demotions then latch one-way exactly as before this PR.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
from collections import deque
from typing import Any

from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS


def fleet_enabled() -> bool:
    """DRL_FLEET=0 disables registration/heartbeats/re-promotion. The
    supervisor is control-plane (a few tiny json exchanges per member
    per second), not a perf fast path, so unlike the ring/board gates
    it defaults ON, as in the JAX package."""
    return os.environ.get("DRL_FLEET", "").strip().lower() not in (
        "0", "false", "no", "off")


def _env_float(name: str, default: float) -> float:
    env = os.environ.get(name, "").strip()
    if not env:
        return default
    try:
        return float(env)
    except ValueError as e:
        raise ValueError(f"{name} must be a number, got {env!r}") from e


def heartbeat_interval_s() -> float:
    return max(0.05, _env_float("DRL_FLEET_HB_S", 2.0))


class ProbeContext:
    """What a heartbeat reply proved, handed to `reattach()` probes:
    the learner incarnation's pid (None when the learner predates the
    fleet ops — probes then skip creator-pid validation), the pid that
    created the shared weight BOARD (the elected publisher seat in
    learner-tier topologies; the learner itself otherwise), and whether
    this reply revealed a NEW incarnation (epoch change)."""

    __slots__ = ("learner_pid", "board_pid", "restarted")

    def __init__(self, learner_pid: int | None = None,
                 restarted: bool = False,
                 board_pid: int | None = None):
        self.learner_pid = learner_pid
        # board_pid semantics: None (reply carried no field — outside
        # tier mode the learner IS the board creator, inherit its pid);
        # 0 (tier reply, publisher pid UNKNOWN right now — board probes
        # must SKIP pid validation, not validate against this seat's
        # own pid and burn the ladder on a healthy shared board);
        # any other int = the board creator's pid.
        if board_pid is None:
            self.board_pid = learner_pid
        elif board_pid == 0:
            self.board_pid = None
        else:
            self.board_pid = board_pid
        self.restarted = restarted


class RetryLadder:
    """Bounded re-promote budget: at most `max_attempts` probes per
    outage, exponentially spaced (`base_s` doubling to `max_s`).

    Probe sites call `try_acquire()` (False = not due yet, exhausted,
    or a probe is already in flight), then `note_failure()` or
    `note_success()`; success (or `reset()` on a learner epoch change)
    restores the full budget. Exhaustion latches and logs ONCE — the
    demotion is then permanent, the pre-fleet behavior.

    Concurrency map (tools/drlint lock-discipline): probes run on the
    heartbeat/sweep thread while data-path threads reset on success, so
    every state word lives under `_lock`.
    """

    _GUARDED_BY = {
        "_attempts": "_lock",
        "_next_due": "_lock",
        "_inflight": "_lock",
        "_exhausted": "_lock",
    }

    def __init__(self, name: str, base_s: float | None = None,
                 max_s: float | None = None,
                 max_attempts: int | None = None,
                 exhausted_note: str | None = None):
        self.name = name
        # Exhaustion wording: surfaces that burn budget on SUCCESSFUL
        # probes (replay_shard's revive accounting) exhaust while
        # healthy, where "demotion is now permanent" would be a lie.
        self.exhausted_note = (exhausted_note or
                               "demotion is now permanent")
        self.base_s = (_env_float("DRL_REATTACH_BASE_S", 2.0)
                       if base_s is None else base_s)
        self.max_s = (_env_float("DRL_REATTACH_MAX_S", 30.0)
                      if max_s is None else max_s)
        if max_attempts is None:
            max_attempts = int(_env_float("DRL_REATTACH_ATTEMPTS", 8))
        self.max_attempts = max(1, max_attempts)
        self._lock = threading.Lock()
        self._attempts = 0
        self._next_due = 0.0  # first probe is immediately due
        self._inflight = False
        self._exhausted = False

    def try_acquire(self) -> bool:
        """Claim the next probe slot; the caller MUST follow with
        note_failure()/note_success()."""
        with self._lock:
            if self._exhausted or self._inflight \
                    or time.monotonic() < self._next_due:
                return False
            self._inflight = True
            return True

    def note_failure(self) -> None:
        import sys

        with self._lock:
            self._inflight = False
            self._attempts += 1
            exhausted_now = self._attempts >= self.max_attempts \
                and not self._exhausted
            if exhausted_now:
                self._exhausted = True
            else:
                self._next_due = time.monotonic() + min(
                    self.base_s * (2 ** (self._attempts - 1)), self.max_s)
        if exhausted_now:
            print(f"[fleet] reattach ladder {self.name!r} exhausted after "
                  f"{self.max_attempts} probes; {self.exhausted_note}",
                  file=sys.stderr)

    def note_success(self) -> None:
        self.reset()

    def reset(self) -> None:
        """Fresh budget (probe success, or a new learner incarnation)."""
        with self._lock:
            self._attempts = 0
            self._next_due = 0.0
            self._inflight = False
            self._exhausted = False

    @property
    def exhausted(self) -> bool:
        with self._lock:
            return self._exhausted

    @property
    def attempts(self) -> int:
        with self._lock:
            return self._attempts


class ShmReattachMixin:
    """The shared reattach contract for the two shm attach surfaces
    (shm_ring.RingQueue, weight_board.BoardWeights): stale-attach
    flagging, the bounded-ladder probe, and the install-time close
    re-check live HERE, once — a fix to any part of the acquire/settle
    invariant must not need hand-syncing across copies.

    Subclasses provide `_ref_attr` (the attached-object slot name),
    `_probe_attach()` (attach the named segment; may raise),
    `_probe_fresh(obj, expect_pid)` (surface-specific freshness), and
    optionally `_install_extra_locked()` (per-attachment reader state
    reset, called INSIDE the install's locked section), plus the shared
    slots `_lock` / `_ladder` / `_closed` / `_stale` / `_name` and the
    `_bump` stats hook. Lock discipline for the mixin-touched state is
    declared by each concrete class's own `_GUARDED_BY` map (the slots
    live there, not here)."""

    _ref_attr: str  # "_ring" | "_board"

    def _probe_attach(self):
        raise NotImplementedError

    def _probe_fresh(self, obj, expect) -> bool:
        raise NotImplementedError

    def _install_extra_locked(self) -> None:
        pass

    def _on_reattached(self) -> None:
        """After a successful install: the surfaces' re-promotion log
        lines (bench.py's chaos watcher greps "re-attached")."""

    def reattach(self, ctx=None) -> None:
        """Probe the named segment while demoted (bounded ladder; fleet
        control cadence only — the hot path never reconnects). Installs
        only a FRESH attachment per `_probe_fresh`: close latches clear
        and — when the heartbeat reply proved the learner's pid —
        created by that exact incarnation.

        Also the STALE-ATTACH check: a SIGKILLed learner latches
        nothing, so the surface would otherwise keep riding the dead
        incarnation's orphan segment forever (a trajectory black hole /
        a frozen weight version — see the concrete classes). A creator
        pid disproven by the heartbeat reply flags the attachment; the
        owner thread demotes on its next use and the ladder re-attaches
        the respawned learner's segment.

        Which pid a surface validates against is its `_pid_field`: rings
        are created by the seat the member heartbeats (`learner_pid`),
        but the learner-TIER shared weight board is created by the
        elected PUBLISHER seat — the heartbeat reply carries that as
        `board_pid` (falling back to the learner's own pid outside tier
        mode, where learner == board creator), and BoardWeights
        validates against it."""
        expect = getattr(ctx, getattr(self, "_pid_field", "learner_pid"),
                         None)
        with self._lock:
            attached = getattr(self, self._ref_attr)
        if attached is not None:
            try:
                stale = (expect is not None
                         and attached.creator_pid != expect)
            except (TypeError, ValueError):
                stale = False  # raced the owner thread's own demote/close
            if stale:
                # Flag only: the attached object is owner-thread-owned,
                # so the actual demote (close included) happens on that
                # thread's next use.
                with self._lock:
                    self._stale = True
            return
        with self._lock:
            demoted = (getattr(self, self._ref_attr) is None
                       and not self._closed)
        if not demoted or self._name is None or not self._ladder.try_acquire():
            return
        # Ladder contract: every exit below MUST pair the acquire with a
        # note_* — an escape path that skipped both (the close race, an
        # exception outside the caught tuple) would leave the ladder
        # in-flight forever, a silent permanent demotion with no
        # "exhausted" log. The finally guard settles any such path as a
        # failed probe.
        settled = False
        try:
            obj = None
            try:
                obj = self._probe_attach()
                fresh = self._probe_fresh(obj, expect)
            except (FileNotFoundError, ValueError, OSError, struct.error):
                fresh = False  # struct.error: header mid-write/truncated
            if not fresh:
                if obj is not None:
                    obj.close()
                self._ladder.note_failure()
                settled = True
                return
            with self._lock:
                # Re-check the close latch at INSTALL time: close() can
                # race the slow attach above (heartbeat thread still
                # probing while run_role tears down), and installing
                # into a closed surface would resurrect it and leak the
                # mapping.
                if self._closed:
                    installed = False
                else:
                    setattr(self, self._ref_attr, obj)
                    self._stale = False
                    self._install_extra_locked()
                    installed = True
            if not installed:
                obj.close()
                self._ladder.note_failure()
                settled = True
                return
            self._ladder.note_success()
            settled = True
        finally:
            if not settled:
                self._ladder.note_failure()
        self._bump("reattaches")
        self._on_reattached()


class FleetSupervisor:
    """Learner-side roster: registration + heartbeat liveness.

    Members key by (role, rank); a respawned member re-registering
    under the same key with a NEW pid while its predecessor is
    suspect/dead counts as a rejoin (and as a respawn when the old
    state was dead). The sweep thread owns the suspect/dead
    transitions; `roster()`/`counts()`/`events()` are the telemetry
    and launcher surfaces. `watch()`ed objects (the replay ingest
    facade) get their `reattach()` driven from the sweep cadence —
    the learner-side mirror of the members' heartbeat-driven probes.

    Concurrency map (tools/drlint lock-discipline): register/heartbeat
    run on per-connection transport serve threads, the sweep thread
    mutates states, and telemetry providers poll counters from the
    flush thread — all roster state lives under `_lock`. `_watched` is
    appended at wiring time and iterated by the sweep thread.
    """

    _GUARDED_BY = {
        "_members": "_lock",
        "_events": "_lock",
        "_counters": "_lock",
        "_watched": "_lock",
    }
    _NOT_GUARDED = {
        "_sweeper": "start()/stop() lifecycle handle, controlling "
                    "thread only",
    }

    SUSPECT_AFTER = 3.0   # x heartbeat_s without a beat -> suspect
    DEAD_AFTER = 10.0     # x heartbeat_s without a beat -> dead (evicted)

    def __init__(self, heartbeat_s: float | None = None,
                 board_pid_fn=None):
        self.heartbeat_s = (heartbeat_interval_s()
                            if heartbeat_s is None else heartbeat_s)
        # Learner-tier wiring (runtime/learner_tier.py): the pid that
        # owns the SHARED weight board — the elected publisher seat —
        # so members' board reattach probes validate against the right
        # creator even when they heartbeat a non-publisher seat. None
        # (the default) omits the field and ProbeContext falls back to
        # the learner's own pid (learner == board creator).
        self._board_pid_fn = board_pid_fn
        self.suspect_s = _env_float("DRL_FLEET_SUSPECT_S",
                                    self.SUSPECT_AFTER * self.heartbeat_s)
        self.dead_s = _env_float("DRL_FLEET_DEAD_S",
                                 self.DEAD_AFTER * self.heartbeat_s)
        self.pid = os.getpid()
        # Incarnation identity: members detect a learner restart by the
        # epoch changing between heartbeat replies (pid alone could
        # recycle). time_ns is unique enough per host per restart.
        self.epoch = f"{self.pid}:{time.time_ns():x}"
        self._lock = threading.Lock()
        self._members: dict[str, dict] = {}
        self._events: deque = deque(maxlen=512)
        self._counters = {"joins": 0, "rejoins": 0, "respawns": 0,
                          "suspects": 0, "deaths": 0, "heartbeats": 0}
        self._watched: list[Any] = []
        self._stop = threading.Event()
        self._sweeper: threading.Thread | None = None

    # -- transport surface (serve threads) ---------------------------------

    def _board_pid(self) -> int | None:
        """Resolved OUTSIDE `_lock` (the tier's resolver takes its own
        membership lock — no nesting under the roster lock). None =
        not a tier (field omitted, members inherit the learner's pid);
        0 = tier but the publisher's pid is UNKNOWN right now (members
        must SKIP board pid validation — ProbeContext's contract)."""
        if self._board_pid_fn is None:
            return None
        try:
            pid = self._board_pid_fn()
        except Exception:  # noqa: BLE001  # drlint: disable=silent-except(0 = documented "publisher unknown" protocol demotion; members skip board-pid validation per ProbeContext contract)
            return 0
        return int(pid) if pid else 0

    def _reply_locked(self, known: bool = True,
                      board_pid: int | None = None) -> dict:
        reply = {"epoch": self.epoch, "pid": self.pid,
                 "heartbeat_s": self.heartbeat_s, "known": known}
        if board_pid is not None:
            reply["board_pid"] = board_pid
        return reply

    def _event_locked(self, kind: str, key: str, **extra) -> None:
        # Counters surface through register_supervisor_telemetry's
        # providers (sampled from self._counters) — no hot-path emit
        # here, and no misnamed plurals for dead/recover events.
        self._events.append({"t": time.time(), "event": kind,
                             "member": key, **extra})

    def register(self, info: dict) -> dict:
        """OP_REGISTER: admit/readmit a member. Returns the reply dict
        the transport json-encodes."""
        key = f"{info.get('role', '?')}-{info.get('rank', '?')}"
        pid = int(info.get("pid", 0))
        board_pid = self._board_pid()  # resolved before the roster lock
        with self._lock:
            old = self._members.get(key)
            if old is None:
                kind = "join"
                self._counters["joins"] += 1
            elif old["state"] == "dead" or old["pid"] != pid:
                # Same seat, new process (respawn) or a dead member
                # coming back: both are rejoins AND count as a respawn
                # (the launcher's tally surfaces through here).
                kind = "rejoin"
                self._counters["rejoins"] += 1
                self._counters["respawns"] += 1
            else:
                kind = "rejoin"  # re-register after an epoch change
                self._counters["rejoins"] += 1
            self._members[key] = {
                "role": info.get("role", "?"), "rank": info.get("rank", -1),
                "pid": pid, "surfaces": list(info.get("surfaces", ())),
                "version": int(info.get("version", -1)),
                "state": "alive", "last_seen": time.monotonic(),
                "joined_at": time.time(),
            }
            self._event_locked(kind, key, pid=pid)
            return self._reply_locked(board_pid=board_pid)

    def heartbeat(self, info: dict) -> dict:
        """OP_HEARTBEAT: refresh liveness. `known=False` in the reply
        tells an unregistered member (we restarted, or it was evicted)
        to re-register."""
        key = f"{info.get('role', '?')}-{info.get('rank', '?')}"
        board_pid = self._board_pid()  # resolved before the roster lock
        with self._lock:
            self._counters["heartbeats"] += 1
            member = self._members.get(key)
            if member is None or member["pid"] != int(info.get("pid", 0)):
                return self._reply_locked(known=False, board_pid=board_pid)
            if member["state"] == "suspect":
                self._event_locked("recover", key)
            elif member["state"] == "dead":
                # A dead-marked member still beating: late eviction —
                # treat like a rejoin so the tally stays honest.
                self._counters["rejoins"] += 1
                self._event_locked("rejoin", key, pid=member["pid"])
            member["state"] = "alive"
            member["last_seen"] = time.monotonic()
            member["version"] = int(info.get("version", member["version"]))
            return self._reply_locked(board_pid=board_pid)

    # -- sweep (liveness + learner-side re-promotion) ----------------------

    def start(self) -> "FleetSupervisor":
        self._sweeper = threading.Thread(target=self._sweep_loop,
                                         daemon=True, name="fleet-sweep")
        self._sweeper.start()
        return self

    def _sweep_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            self.sweep()

    def sweep(self) -> None:
        """One liveness pass + learner-side reattach probes (split from
        the loop so tests drive it deterministically)."""
        now = time.monotonic()
        with self._lock:
            for key, m in self._members.items():
                idle = now - m["last_seen"]
                if m["state"] == "alive" and idle > self.suspect_s:
                    m["state"] = "suspect"
                    self._counters["suspects"] += 1
                    self._event_locked("suspect", key, idle_s=round(idle, 1))
                if m["state"] == "suspect" and idle > self.dead_s:
                    m["state"] = "dead"
                    self._counters["deaths"] += 1
                    self._event_locked("dead", key, idle_s=round(idle, 1))
            watched = list(self._watched)
        for surface in watched:
            try:
                surface.reattach()
            except Exception as e:  # noqa: BLE001 — a probe must never
                import sys          # take the sweep thread down

                print(f"[fleet] WARNING: learner-side reattach probe "
                      f"failed: {e!r}", file=sys.stderr)

    def stop(self) -> None:
        self._stop.set()
        if self._sweeper is not None:
            self._sweeper.join(timeout=2.0)

    # -- read surfaces ------------------------------------------------------

    def watch(self, surface: Any) -> None:
        """Drive `surface.reattach()` from the sweep cadence (learner-
        side ladders: the replay ingest facade)."""
        with self._lock:
            self._watched.append(surface)

    def roster(self) -> list[dict]:
        with self._lock:
            return [dict(m, member=k) for k, m in self._members.items()]

    def counts(self) -> dict:
        out = {"alive": 0, "suspect": 0, "dead": 0}
        with self._lock:
            for m in self._members.values():
                out[m["state"]] += 1
        return out

    def stat(self, key: str) -> int:
        with self._lock:
            return self._counters[key]

    def snapshot_counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)


def register_supervisor_telemetry(sup: FleetSupervisor) -> None:
    """Roster gauges + event counters on the learner's telemetry shard
    (the obs_report 'Fleet health' section reads these names)."""
    _OBS.sample("fleet/alive", lambda: sup.counts()["alive"])
    _OBS.sample("fleet/suspect", lambda: sup.counts()["suspect"])
    _OBS.sample("fleet/dead", lambda: sup.counts()["dead"])
    for key in sup.snapshot_counters():
        _OBS.sample(f"fleet/{key}", lambda k=key: sup.stat(k),
                    kind="counter")


class HeartbeatLoop:
    """Member-side control loop: register, then heartbeat at the fleet
    cadence on its OWN connection (the data-plane client's lock must
    never see multi-second heartbeat stalls), driving the watched
    surfaces' `reattach()` probes from each reply.

    Degrades gracefully against a pre-fleet learner (OP_REGISTER
    answered ST_UNAVAILABLE/ST_ERROR): heartbeats stop, but the loop
    keeps driving reattach probes on the same cadence with a plain
    OP_PING as the liveness check — re-promotion must not require a
    fleet-aware learner.

    Concurrency map (tools/drlint lock-discipline): `_surfaces` is
    appended by the wiring thread while the loop thread iterates;
    `stats` follows the repo's locked-stats convention (bumped on the
    loop thread, polled by telemetry providers from the flush thread).
    """

    _GUARDED_BY = {
        "_surfaces": "_lock",
        "stats": "_lock",
    }
    _NOT_GUARDED = {
        "_thread": "start()/stop() lifecycle handle, controlling thread "
                   "only",
        "_client": "rebound only by the loop thread; stop() takes one "
                   "racy snapshot purely to abort() — the documented "
                   "lock-free shutdown escape",
        "_fleet_unsupported": "loop-thread-only degradation latch",
        "_unavailable_streak": "loop-thread-only retry counter",
    }

    def __init__(self, host: str, port: int, role: str, rank: int,
                 interval_s: float | None = None,
                 version_fn=None):
        self.host, self.port = host, port
        self.role, self.rank = role, rank
        self.interval_s = (heartbeat_interval_s()
                           if interval_s is None else interval_s)
        self._version_fn = version_fn or (lambda: -1)
        self._lock = threading.Lock()
        self._surfaces: list[Any] = []
        self.stats = {"heartbeats": 0, "heartbeat_failures": 0,
                      "registrations": 0, "learner_restarts": 0,
                      "version_errors": 0}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._client = None       # loop-thread-only after start()
        self._fleet_unsupported = False  # loop-thread-only latch
        self._unavailable_streak = 0     # loop-thread-only

    def watch(self, surface: Any) -> None:
        """Drive `surface.reattach(ctx)` after each successful
        heartbeat; `surface.reset_reattach()` (when present) fires on a
        learner epoch change so a fresh incarnation gets a fresh probe
        budget."""
        if surface is None or not hasattr(surface, "reattach"):
            return
        with self._lock:
            self._surfaces.append(surface)

    def start(self) -> "HeartbeatLoop":
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"fleet-hb-{self.role}-{self.rank}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=2.0)
        client = self._client
        if client is None:
            return
        if thread is not None and thread.is_alive():
            # The loop thread is wedged inside an exchange — a learner
            # outage can hold the client lock for the full 300s socket
            # timeout, and close() would queue teardown behind it.
            # abort() shuts the socket down lock-free so a blocked
            # recv/send raises now; a thread stuck in connect() cannot
            # be interrupted, so past the grace join it is left to die
            # with the process (daemon) rather than stall shutdown.
            client.abort()
            thread.join(timeout=2.0)
            if thread.is_alive():
                return
        try:
            client.close()
        except OSError:
            pass

    def _bump(self, key: str, by: int = 1) -> None:
        with self._lock:
            self.stats[key] += by

    def stat(self, key: str) -> int:
        with self._lock:
            return self.stats[key]

    def snapshot_stats(self) -> dict:
        with self._lock:
            return dict(self.stats)

    def _info(self) -> dict:
        with self._lock:
            surfaces = [getattr(s, "surface_name", type(s).__name__)
                        for s in self._surfaces]
        try:
            version = int(self._version_fn())
        except Exception:  # noqa: BLE001 — version is advisory: -1 tells
            version = -1   # the supervisor "unknown", and the failure is
            with self._lock:  # visible in snapshot_stats()
                self.stats["version_errors"] += 1
        return {"role": self.role, "rank": self.rank, "pid": os.getpid(),
                "surfaces": surfaces, "version": version}

    def _loop(self) -> None:
        from distributed_reinforcement_learning_tpu_torch.runtime.transport import (
            FleetUnavailableError, TransportClient, TransportError)

        self._client = TransportClient(self.host, self.port, connect=False,
                                       connect_retries=1,
                                       retry_interval=0.5)
        registered = False
        epoch: str | None = None
        learner_pid: int | None = None
        board_pid: int | None = None
        first = True
        while True:
            # Beat FIRST, then sleep: the supervisor should learn about
            # this member (and this member should capture the learner's
            # incarnation epoch) immediately on start, not one interval
            # late — a member killed inside that first window would
            # otherwise never know which incarnation it had joined.
            if not first and self._stop.wait(self.interval_s):
                break
            if first and self._stop.is_set():
                break
            first = False
            restarted = False
            t0 = time.perf_counter()
            try:
                if self._fleet_unsupported:
                    # Pre-fleet learner: OP_PING is the liveness probe.
                    if not self._client.ping():
                        raise TransportError("ping failed")
                    reply: dict = {}
                else:
                    with _OBS.span("heartbeat"):
                        if not registered:
                            reply = self._client.fleet_register(self._info())
                            registered = True
                            self._bump("registrations")
                        else:
                            reply = self._client.fleet_heartbeat(self._info())
                    if not reply.get("known", True):
                        reply = self._client.fleet_register(self._info())
                        self._bump("registrations")
            except FleetUnavailableError as e:
                # ST_UNAVAILABLE = the server explicitly has no
                # supervisor: latch to ping mode immediately. ST_ERROR
                # is ambiguous (pre-fleet server answering the unknown
                # op, OR one transient supervisor fault the server's own
                # handler calls non-fatal): latch only when it persists
                # across CONSECUTIVE beats, so a single blip cannot
                # permanently cost the member its epoch tracking and
                # creator-pid validation.
                self._unavailable_streak += 1
                if e.permanent or self._unavailable_streak >= 3:
                    self._fleet_unsupported = True
                    # Ping-mode replies carry no pid, so a kept value
                    # would be the DEAD incarnation's forever — and a
                    # matching stale creator_pid check would aim every
                    # actor at an orphan segment. None = probes skip
                    # pid validation (the documented pre-fleet mode).
                    learner_pid = None
                    board_pid = None
                else:
                    self._bump("heartbeat_failures")
                    registered = False
                continue
            except (TransportError, OSError):
                self._bump("heartbeat_failures")
                registered = False  # the next contact re-registers
                # An outage is not supervisor absence: ST_ERRORs on
                # either side of it were not consecutive, so the latch
                # streak starts over.
                self._unavailable_streak = 0
                continue
            self._unavailable_streak = 0
            self._bump("heartbeats")
            if _OBS.enabled:
                _OBS.gauge("fleet/heartbeat_ms",
                           (time.perf_counter() - t0) * 1e3)
            new_epoch = reply.get("epoch")
            if new_epoch is not None:
                if epoch is not None and new_epoch != epoch:
                    restarted = True
                    self._bump("learner_restarts")
                epoch = new_epoch
                learner_pid = int(reply.get("pid", 0)) or None
                # Tier topologies: the shared board's creator is the
                # elected PUBLISHER seat, not this member's learner.
                # Absent field -> None (inherit learner pid); explicit
                # 0 -> publisher unknown, ProbeContext skips board pid
                # validation (never falls back to the member's seat).
                raw_bp = reply.get("board_pid")
                board_pid = None if raw_bp is None else int(raw_bp)
            ctx = ProbeContext(learner_pid=learner_pid, restarted=restarted,
                               board_pid=board_pid)
            with self._lock:
                surfaces = list(self._surfaces)
            for surface in surfaces:
                try:
                    if restarted and hasattr(surface, "reset_reattach"):
                        surface.reset_reattach()
                    surface.reattach(ctx)
                except Exception as e:  # noqa: BLE001 — a probe must
                    import sys          # never take the loop down

                    print(f"[fleet] WARNING: reattach probe failed "
                          f"on {type(surface).__name__}: {e!r}",
                          file=sys.stderr)


def start_member_loop(rt, role: str, rank: int, surfaces=(),
                      version_fn=None) -> HeartbeatLoop | None:
    """run_role/serving wiring: build + start the heartbeat loop against
    the resolved learner address, watching `surfaces`. None when the
    fleet plane is disabled (`DRL_FLEET=0`)."""
    if not fleet_enabled():
        return None
    from distributed_reinforcement_learning_tpu_torch.runtime.transport import (
        resolve_learner_addr)

    host, port = resolve_learner_addr(rt)
    loop = HeartbeatLoop(host, port, role, rank, version_fn=version_fn)
    for surface in surfaces:
        loop.watch(surface)
    return loop.start()


def register_member_telemetry(loop: HeartbeatLoop) -> None:
    """Heartbeat/registration counters on a member's telemetry shard."""
    for key in loop.snapshot_stats():
        _OBS.sample(f"fleet/{key}", lambda k=key: loop.stat(k),
                    kind="counter")


def pack_fleet_msg(info: dict) -> bytes:
    return json.dumps(info, separators=(",", ":")).encode()


def unpack_fleet_msg(payload) -> dict:
    return json.loads(bytes(payload))
