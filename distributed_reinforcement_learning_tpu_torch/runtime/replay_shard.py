"""Runtime host for the sharded replay service (data/replay_service.py).

Counterpart of the JAX package's `runtime/replay_shard.py`: the GATES
(`DRL_REPLAY_SHARDS`, `DRL_REPLAY_SCORER`, `DRL_REPLAY_SPILL*`), the
ingest FACADE that slots into the `fifo.blob_ingest` seam in place of
the learner's trajectory queue, and the `run_role` builder and
telemetry registration. An unset gate takes the value of the JAX
package's committed verdict file, written here as a constant (the port
reads no file under `benchmarks/`; tests/test_torch_replay_service.py
pins the constants to those files): shards on at 2, spill tier on.

The facade is where "each drainer owns a replay shard" happens without
touching the drainers: the TCP server's per-connection serve threads
each call `blob_ingest(queue)` and then push blobs from their own
thread. `ReplayIngestFifo.ingest_blob` maps each calling thread to a
shard (round-robin over live shards on first contact), so decode,
initial-priority scoring and sum-tree insert run on the TRANSPORT
thread that already holds the bytes, never on the learner thread.
Prioritized replay is a ring that overwrites its oldest items (the
Ape-X semantic), so an ingest never blocks.

Failure containment: an ingest error marks the calling thread's shard
dead and re-routes the thread to a surviving shard; when none survive,
the facade demotes to the real trajectory queue, and the learner's
monolithic ingest loop (still running, normally idle) takes over. The
fleet supervisor's sweep (runtime/fleet.py) drives `reattach()` on a
bounded RetryLadder, which `revive()`s the dead shards under a fresh
epoch and un-latches the facade (the learner's `_active_replay` follows
`service.healthy` back); an exhausted ladder makes the demotion
permanent, logged once.
"""

from __future__ import annotations

import os
import threading
from typing import Any

from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS

# Unset-gate defaults, the JAX package's committed verdicts:
# benchmarks/replay_verdict.json ("auto_enable": true, "shards": 2) and
# benchmarks/replay_spill_verdict.json ("auto_enable": true).
DEFAULT_SHARDS = 2
DEFAULT_SPILL = True


def shard_count() -> int:
    """Resolved shard count: 0 = sharding off.

    `DRL_REPLAY_SHARDS=0` forces off, `=N` (N >= 1) forces N shards;
    unset takes `DEFAULT_SHARDS`."""
    env = os.environ.get("DRL_REPLAY_SHARDS", "").strip()
    if env:
        try:
            return max(0, int(env))
        except ValueError as e:
            raise ValueError(
                f"DRL_REPLAY_SHARDS must be an integer, got {env!r}") from e
    return DEFAULT_SHARDS


_ALGO_MODE = {"apex": "transition", "r2d2": "sequence", "xformer": "sequence"}


def spill_auto_enabled() -> bool:
    """The spill-tier gate: `DRL_REPLAY_SPILL=0` forces off, any other
    value on; unset takes `DEFAULT_SPILL`."""
    env = os.environ.get("DRL_REPLAY_SPILL", "").strip()
    if env:
        return env != "0"
    return DEFAULT_SPILL


def spill_config(spill_dir: str | None = None):
    """-> a `SpillConfig` from the DRL_REPLAY_SPILL* knobs (None when
    the gate resolves off). The directory prefers, in order: the
    `DRL_REPLAY_SPILL_DIR` override, the caller's `spill_dir` (run_role
    passes a checkpoint-dir sibling so a learner RESTART finds and
    recovers the manifested segments), and a fresh tempdir (no recovery
    across restarts, but the tier still works)."""
    if not spill_auto_enabled():
        return None
    from distributed_reinforcement_learning_tpu_torch.data.replay_spill import SpillConfig

    directory = os.environ.get("DRL_REPLAY_SPILL_DIR", "").strip() or spill_dir
    if not directory:
        import tempfile

        directory = tempfile.mkdtemp(prefix="drl_replay_spill_")
    hot_mb = float(os.environ.get("DRL_REPLAY_SPILL_HOT_MB", "") or 256.0)
    seg = int(os.environ.get("DRL_REPLAY_SPILL_SEG", "") or 512)
    return SpillConfig(directory=directory,
                       hot_bytes=int(hot_mb * 1024 * 1024),
                       seg_items=max(1, seg))


def build_service(algo: str, rt, num_shards: int | None = None,
                  seed: int = 0, spill_dir: str | None = None):
    """-> a `ShardedReplayService` for a prioritized-replay learner
    process, or None when sharding is off / the algo has no replay.

    The caller wraps it in a `ReplayIngestFifo(service, queue)` — the
    facade needs the REAL queue as its demotion fallback; run_role
    passes the facade (not the queue) to the TransportServer, while the
    learner keeps draining the real queue."""
    mode = _ALGO_MODE.get(algo)
    if mode is None:
        return None
    n = shard_count() if num_shards is None else num_shards
    if n <= 0:
        return None
    from distributed_reinforcement_learning_tpu_torch.data.replay_service import (
        ShardedReplayService)

    scorer = os.environ.get("DRL_REPLAY_SCORER", "max").strip() or "max"
    return ShardedReplayService(n, rt.replay_capacity, mode=mode,
                                scorer=scorer, seed=seed,
                                spill=spill_config(spill_dir))


class ReplayIngestFifo:
    """Queue facade over the service for the `fifo.blob_ingest` seam.

    `blob_ingest` hands blob-bearing transports `(identity, ingest_blob)`
    when this attribute is present, so the shard sees the RAW wire blob
    (a dedup-packed blob decodes straight to the plain pytree — no
    unpack->re-encode round trip like the blob-native queue path pays).

    Concurrency map (tools/drlint lock-discipline): serve/drain threads
    race on the thread->shard map and the round-robin cursor; `_demoted`
    latches one-way under the same lock. Shard internals lock themselves
    (data/replay_service.py).
    """

    _GUARDED_BY = {
        "_by_thread": "_lock",
        "_next": "_lock",
        "_demoted": "_lock",
        "_plain_threads": "_lock",
        "stamped_blobs": "_lock",
        "scored_blobs": "_lock",
        "folded_mass": "_lock",
        "ingest_bytes": "_lock",
    }

    surface_name = "replay_shards"  # fleet supervisor watch label

    def __init__(self, service, fallback_queue):
        from distributed_reinforcement_learning_tpu_torch.data.admission import DutyMeter
        from distributed_reinforcement_learning_tpu_torch.data.fifo import blob_ingest
        from distributed_reinforcement_learning_tpu_torch.runtime.fleet import RetryLadder

        self.service = service
        self.fallback = fallback_queue
        self._fb_prepare, self._fb_put = blob_ingest(fallback_queue)
        self._lock = threading.Lock()
        self._by_thread: dict[int, Any] = {}
        self._next = 0
        self._demoted = False
        # Sample-at-source (data/admission.py): threads whose connection
        # sent an unstamped / unusable-stamp blob latch to learner-side scoring
        # PERMANENTLY (mixed fleets, rolling upgrades: one sniff per
        # connection, then the plain path with zero per-blob overhead).
        self._plain_threads: set[int] = set()
        self.stamped_blobs = 0
        self.scored_blobs = 0
        self.folded_mass = 0.0  # transformed-domain mass folded from
        #   actor-side admission drops (conservation ledger's far end)
        self.ingest_bytes = 0  # raw wire-blob bytes offered to ingest
        self.duty = DutyMeter()  # ingest busy fraction -> PUT-reply pressure
        # Revive accounting burns a ladder slot on SUCCESS too, so the
        # budget can exhaust while sharded ingest is healthy — the
        # default "demotion is now permanent" would be wrong then.
        self._ladder = RetryLadder(
            "replay-shards",
            exhausted_note="revive budget spent; the next shard death "
                           "(if any) becomes a permanent demotion")

    def reattach(self, ctx=None) -> None:
        """Learner-side re-promotion, driven from the fleet supervisor's
        sweep cadence: while demoted, `revive()` the service's dead
        shards (fresh epoch, empty contents — the Ape-X overwrite
        semantic makes that loss-equivalent) and un-latch the facade so
        ingest threads re-map to live shards. Ladder-bounded: shards
        that keep dying exhaust the budget and the demotion becomes
        permanent again (logged once by the ladder)."""
        del ctx  # learner-local: no peer identity to validate
        with self._lock:
            demoted = self._demoted
        if not demoted or not self._ladder.try_acquire():
            return
        try:
            revived = self.service.revive()
        except Exception:  # noqa: BLE001 — a revive fault = failed probe
            self._ladder.note_failure()
            raise
        with self._lock:
            self._demoted = False
            self._by_thread.clear()
            self._next = 0
        # Every revive CONSUMES a ladder slot (note_failure, never
        # note_success): shard death is process-internal — unlike a
        # respawned peer there is no external signal that the fault is
        # gone, so a repeat offender (shards that keep dying on ingest)
        # must burn down to the permanent latch instead of revive-die
        # looping forever. The budget is the run's total revive count.
        self._ladder.note_failure()
        self._warn(f"replay shards revived ({revived} restarted); "
                   f"sharded ingest re-promoted")
        if _OBS.enabled:
            _OBS.count("replay_shard/revives")

    def _shard_for_thread(self):
        """This thread's shard (round-robin over LIVE shards on first
        contact, re-mapped after its shard dies); None once demoted."""
        ident = threading.get_ident()
        with self._lock:
            if self._demoted:
                return None
            shard = self._by_thread.get(ident)
            if shard is not None and not shard.mass_count()[2]:
                return shard
            live = self.service.live_shards()
            if not live:
                self._demoted = True
                return None
            shard = live[self._next % len(live)]
            self._next += 1
            self._by_thread[ident] = shard
            return shard

    def ingest_blob(self, blob, timeout: float | None = None) -> bool:
        """One wire blob into the calling thread's shard. Never blocks
        (replay overwrites its oldest — the Ape-X ring semantic).

        Failure containment is two-tier, and a bad BLOB never kills a
        shard: a decode failure is a POISON BLOB — dropped and counted
        (at-most-once, like every PUT on this plane; the monolithic
        serve-thread decode would have thrown it away too), while a
        failure INSIDE the shard (scoring/backend) marks that shard
        dead and drops the blob — it is never retried on a survivor,
        so one bad input cannot cascade through the fleet. Once every
        shard is dead, blobs go to the monolithic fallback queue.

        Sample-at-source fast accept: a blob carrying a CURRENT-version
        priority stamp whose scorer/mode match this service skips the
        shard's scoring pass (`ingest_stamped`) — and, for sequence
        shards on opaque-item backends, decode itself is deferred to
        first sample. A malformed stamp frame is poison; an unstamped
        or future-version blob latches this thread's connection to the
        plain scoring path permanently (`_plain_threads`)."""
        import time as _time

        with self._lock:
            self.ingest_bytes += len(blob)
        t0 = _time.perf_counter()
        try:
            return self._ingest_inner(blob, timeout)
        finally:
            self.duty.note(_time.perf_counter() - t0)

    def _ingest_inner(self, blob, timeout: float | None) -> bool:
        shard = self._shard_for_thread()
        if shard is None:  # demoted: the monolithic path owns ingest
            return self._fb_put(self._fb_prepare(blob), timeout=timeout)
        from distributed_reinforcement_learning_tpu_torch.data import codec

        stamp = None
        ident = threading.get_ident()
        with self._lock:
            plain = ident in self._plain_threads
        if not plain and codec.is_stamped(blob):
            try:
                stamp, blob = codec.split_stamp(blob)
            except ValueError:  # corrupt extension frame: poison
                self._warn("corrupt stamp extension dropped (poison PUT?)")
                if _OBS.enabled:
                    _OBS.count("replay_shard/poison_blobs")
                return True
            if stamp is not None:
                stamp = self._usable_stamp(stamp, shard)
        if stamp is None and not plain:
            # Unstamped, future-version, or mismatched-config blob:
            # this connection speaks the plain protocol from now on.
            with self._lock:
                self._plain_threads.add(ident)
        if stamp is not None:
            folded = float(stamp.get("folded", 0.0) or 0.0)
            try:
                if shard.mode == "sequence":
                    n = shard.ingest_stamped(stamp["pri"], blob=blob)
                else:
                    tree = codec.decode(blob, copy=True, cache=True)
                    n = shard.ingest_stamped(stamp["pri"], tree=tree)
            except ValueError:
                # Stamp/tree mismatch (e.g. priority count vs leading
                # axis): distrust the stamp, score learner-side.
                stamp = None
            except Exception:  # noqa: BLE001 — shard-internal failure:
                import traceback  # fail LOUDLY, contain it to THIS shard

                self._warn(
                    f"shard {shard.shard_id} stamped ingest failed; "
                    f"marking dead\n{traceback.format_exc(limit=2)}")
                self.service.note_shard_death(shard)
                return True
            else:
                with self._lock:
                    self.stamped_blobs += 1
                    if folded:
                        self.folded_mass += folded
                if _OBS.enabled:
                    _OBS.count("replay_shard/ingested_items", n)
                    _OBS.count("replay_shard/ingested_blobs")
                    _OBS.count("admission/ingest_stamped")
                    if folded:
                        _OBS.count("admission/folded_mass", folded)
                # Spill-tier maintenance rides the thread that already
                # did the insert (no-op for untiered shards): the learn
                # thread never touches disk.
                shard.tier_step()
                return True
        try:
            # decode(cache=True): shard ingest sees one stable schema
            # per run, so the layout cache is forced like the weight
            # plane's encode cache (data/codec.py decode docstring).
            tree = codec.decode(blob, copy=True, cache=True)
        except Exception:  # noqa: BLE001 — poison blob: drop + count
            self._warn("undecodable blob dropped (poison PUT?)")
            if _OBS.enabled:
                _OBS.count("replay_shard/poison_blobs")
            return True
        try:
            n = shard.ingest(tree)
        except Exception:  # noqa: BLE001 — shard-internal failure:
            import traceback  # fail LOUDLY, contain it to THIS shard

            self._warn(
                f"shard {shard.shard_id} ingest failed; marking dead\n"
                f"{traceback.format_exc(limit=2)}")
            self.service.note_shard_death(shard)
            return True  # blob dropped (at-most-once), never re-routed
        with self._lock:
            self.scored_blobs += 1
        if _OBS.enabled:
            _OBS.count("replay_shard/ingested_items", n)
            _OBS.count("replay_shard/ingested_blobs")
            _OBS.count("admission/ingest_scored")
        shard.tier_step()  # spill-tier maintenance on the insert thread
        return True

    def _usable_stamp(self, stamp: dict, shard) -> dict | None:
        """Validate a parsed stamp against this service's configuration:
        the scorer and shard mode must MATCH for the stamped priorities
        to mean what learner-side scoring would have computed. A
        mismatch (mis-configured actor) is not poison — the blob is
        fine, only the stamp is distrusted."""
        scorer_name = getattr(self.service, "scorer_name", None)
        if (stamp.get("scorer") != scorer_name
                or stamp.get("mode") != shard.mode
                or not isinstance(stamp.get("pri"), list)
                or not stamp["pri"]):
            return None
        return stamp

    def ingest_pressure(self) -> int:
        """Learner ingest pressure, 0..1000 permille, appended to PUT
        replies (`runtime/transport.py`) to drive actor-side admission:
        the ingest threads' busy fraction (`DutyMeter` — sharded ingest
        never blocks, so CPU duty IS the saturation signal), or the
        fallback queue's fill once demoted."""
        p = self.duty.value()
        with self._lock:
            demoted = self._demoted
        if demoted:
            cap = getattr(self.fallback, "capacity", 0)
            if cap:
                p = max(p, min(1.0, self.fallback.size() / cap))
        return int(round(p * 1000))

    def admission_stats(self) -> dict:
        """Stamped-vs-scored tallies + the folded-mass ledger's learner
        end (obs_report 'Ingest admission', tests)."""
        with self._lock:
            return {"stamped_blobs": self.stamped_blobs,
                    "scored_blobs": self.scored_blobs,
                    "folded_mass": self.folded_mass,
                    "ingest_bytes": self.ingest_bytes}

    def _warn(self, msg: str) -> None:
        import sys

        print(f"[replay_shard] WARNING: {msg}", file=sys.stderr)

    def size(self) -> int:
        """Queue-depth poll (OP_QUEUE_SIZE): ingest is immediate, so the
        only depth that can exist is the fallback's after demotion."""
        with self._lock:
            demoted = self._demoted
        return self.fallback.size() if demoted else 0

    @property
    def demoted(self) -> bool:
        with self._lock:
            return self._demoted

    def close(self) -> None:
        self.service.close()


def register_telemetry(service) -> None:
    """Per-shard fill / priority-mass / counter providers (polled from
    the telemetry flush thread; obs_report renders them as the 'Replay
    shards' section, plus 'Tiered replay' when the spill tier is on)."""
    for i, shard in enumerate(service.shards):
        _OBS.sample(f"replay_shard/{i}/fill",
                    lambda s=shard: s.stats()["fill"])
        _OBS.sample(f"replay_shard/{i}/priority_mass",
                    lambda s=shard: s.stats()["priority_mass"])
        _OBS.sample(f"replay_shard/{i}/ingested_items",
                    lambda s=shard: s.stats()["ingested_items"],
                    kind="counter")
        _OBS.sample(f"replay_shard/{i}/updates_applied",
                    lambda s=shard: s.stats()["updates_applied"],
                    kind="counter")
        if shard.tier_stats() is None:
            continue

        def _tier(s=shard, key=""):
            st = s.tier_stats()
            return float(st.get(key, 0)) if st else 0.0

        for key in ("hot_items", "cold_items", "hot_bytes", "disk_bytes",
                    "ram_bytes", "queue_depth"):
            _OBS.sample(f"replay_spill/{i}/{key}",
                        lambda s=shard, k=key: _tier(s, k))
        for key in ("spilled_segments", "promoted_segments", "crc_dropped",
                    "forced_pads"):
            _OBS.sample(f"replay_spill/{i}/{key}_total",
                        lambda s=shard, k=key: _tier(s, k), kind="counter")
