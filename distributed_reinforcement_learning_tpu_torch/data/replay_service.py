"""Sharded replay service with ingest-time prioritization.

Counterpart of the JAX package's `data/replay_service.py`, host numpy
with the same arithmetic: from the same seed and the same blobs in the
same shards, both packages' services return the same packed indices,
contents and IS weights.

Ape-X (arXiv:1803.00933) scales prioritized replay by moving priority
computation off the learner. The monolithic topology funnels every
trajectory through the learner thread's own ingest loop
(`apex_runner.ingest_many`: decode, TD forward, sum-tree insert); this
service computes priorities and stores experience on the TRANSPORT path
instead. N `ReplayShard`s, each owned by one ingest thread (a TCP serve
thread: `runtime/replay_shard.py` wires the thread->shard affinity
through the `fifo.blob_ingest` seam). A shard decodes its blobs,
computes INITIAL priorities at ingest (max-priority by default, or the
host-computable `td_proxy` scorer, with the same per-transition
granularity and `(|err|+eps)^alpha` transform as the learner's scoring),
and inserts into its local prioritized backend. The learner's ingest
stages shrink to a gather-from-shards sample call:

- `sample(n)` allocates the batch across shards PROPORTIONALLY to total
  shard priority mass (largest-remainder rounding, so the marginal
  per-item probability matches the monolithic sampler's p_i/total), each
  shard runs its own stratified pick, and IS weights are computed from
  the GLOBAL total and count, normalized by the global max: the
  `(N * p)^-beta / max` semantics of `data/replay.py`.
- Sample indexes pack (shard id, shard epoch, tree idx) into one int64
  (`pack_index`), so `update_batch` can route each priority update back
  to its owning shard ASYNCHRONOUSLY (a router thread drains a bounded
  deque; under backlog the OLDEST pending batch is dropped: latest
  wins, as re-prioritization is advisory). An update whose epoch no
  longer matches its shard (the shard restarted) is dropped loss-free:
  restarted shards re-ingest at max-priority, so no item can starve.

A shard whose ingest raises is marked dead and excluded from sampling;
when every shard is dead the ingest facade
(`runtime/replay_shard.ReplayIngestFifo`) demotes to the learner's
monolithic queue and replay. Gated by `DRL_REPLAY_SHARDS`
(`runtime/replay_shard.py`).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable

import numpy as np

from distributed_reinforcement_learning_tpu_torch.data.fifo import tree_leaves, tree_map
from distributed_reinforcement_learning_tpu_torch.data.replay import make_replay
from distributed_reinforcement_learning_tpu_torch.data.replay_spill import ColdStoreEmpty
from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS

# -- packed sample indexes ----------------------------------------------------
#
# [tag:1][epoch:8][shard:8][tree_idx:46] in an int64. The tag bit keeps
# packed indexes disjoint from any monolithic tree index (< 2*capacity),
# so a learner that demoted mid-run can never mis-route an update from a
# pre-demotion batch into the monolithic tree.

_IDX_BITS = 46
_SHARD_BITS = 8
_EPOCH_BITS = 8
_TAG = np.int64(1) << np.int64(_IDX_BITS + _SHARD_BITS + _EPOCH_BITS)
_IDX_MASK = (np.int64(1) << np.int64(_IDX_BITS)) - np.int64(1)
_SHARD_MASK = (np.int64(1) << np.int64(_SHARD_BITS)) - np.int64(1)
_EPOCH_MASK = (np.int64(1) << np.int64(_EPOCH_BITS)) - np.int64(1)

MAX_SHARDS = 1 << _SHARD_BITS


def pack_index(shard: int, epoch: int, tree_idx):
    """(shard id, shard epoch, backend tree idx) -> tagged int64 (vectorized)."""
    idx = np.asarray(tree_idx, np.int64)
    return (_TAG
            | (np.int64(epoch & int(_EPOCH_MASK)) << np.int64(_IDX_BITS + _SHARD_BITS))
            | (np.int64(shard & int(_SHARD_MASK)) << np.int64(_IDX_BITS))
            | (idx & _IDX_MASK))


def unpack_index(packed):
    """Tagged int64 -> (shard ids, epochs, tree idxs) as int64 arrays."""
    p = np.asarray(packed, np.int64)
    return ((p >> np.int64(_IDX_BITS)) & _SHARD_MASK,
            (p >> np.int64(_IDX_BITS + _SHARD_BITS)) & _EPOCH_MASK,
            p & _IDX_MASK)


def is_packed_index(packed) -> np.ndarray:
    """Bool mask: which indexes carry the shard tag bit."""
    return (np.asarray(packed, np.int64) & _TAG) != 0


# -- ingest-time scorers ------------------------------------------------------


def _reward_done_of(tree: Any) -> tuple[np.ndarray, np.ndarray]:
    """(reward, done) leaves of a trajectory pytree (namedtuple or dict)."""
    if hasattr(tree, "reward"):
        return np.asarray(tree.reward), np.asarray(tree.done)
    return np.asarray(tree["reward"]), np.asarray(tree["done"])


def td_proxy_scorer(tree: Any, per_transition: bool) -> np.ndarray:
    """Host-computable stand-in for the learner's ingest-time TD score.

    Same granularity and downstream transform as the learner-side
    scoring (one |err| per transition through `(|err|+eps)^alpha`),
    with the network TD error replaced by |clip(r)| + terminal bonus:
    the reward-driven part of the one-step TD target, computable on the
    ingest thread without touching the net. Sequence-mode shards (R2D2:
    one priority per sequence) reduce the per-step proxy by its mean,
    as the learner's |mean TD| sequence priority does.
    """
    reward, done = _reward_done_of(tree)
    per_step = np.abs(np.clip(reward, -1.0, 1.0)) + done.astype(np.float64)
    if per_transition:
        return per_step.astype(np.float64).reshape(-1)
    return np.atleast_1d(np.float64(per_step.mean()))


def make_scorer(name: str) -> Callable[[Any, bool], np.ndarray] | None:
    """'max' -> None (max-priority fill, the Ape-X default for items the
    learner has not yet seen: every new item is sampled at least once);
    'td_proxy' -> `td_proxy_scorer`."""
    if name in ("", "max"):
        return None
    if name == "td_proxy":
        return td_proxy_scorer
    raise ValueError(f"unknown replay scorer {name!r} (one of: max, td_proxy)")


# -- deferred-decode items ----------------------------------------------------


class LazyBlob:
    """A sequence-mode replay item stored as its (owned) wire blob.

    The sample-at-source fast accept (`data/admission.py`): when the stamp already
    carries the sequence priority, an opaque-item backend has no reason
    to decode on the ingest thread at all — the blob is stored as-is and
    decoded ONCE at first materialization (sample gather or snapshot),
    which runs on the learner/checkpoint thread. Bytes are copied at
    construction: wire receive buffers are reused per connection.

    Materialization is deliberately lock-free: `_tree` is published
    before `_blob` is dropped, so a concurrent materializer either sees
    the tree or re-decodes the same bytes to an equal tree — duplicate
    work, never a torn read (decode is pure).
    """

    __slots__ = ("_blob", "_tree")

    def __init__(self, blob):
        self._blob = bytes(memoryview(blob))
        self._tree = None

    def materialize(self):
        tree = self._tree
        if tree is not None:
            return tree
        blob = self._blob
        if blob is None:  # lost a materialize race: the tree is set
            return self._tree
        from distributed_reinforcement_learning_tpu_torch.data import codec

        tree = codec.decode(blob, copy=True, cache=True)
        self._tree = tree
        self._blob = None  # decode owns its arrays; drop the bytes
        return tree


def _materialize(item):
    # Duck-typed: LazyBlob here, and the spill tier's cold-segment
    # snapshot refs (data/replay_spill._SegmentRef) resolve the same way.
    return item.materialize() if hasattr(item, "materialize") else item


# -- one shard ----------------------------------------------------------------


class ReplayShard:
    """One ingest thread's local prioritized store.

    `mode` is "transition" (Ape-X: a decoded unroll's leading axis is
    the item axis — one priority per transition) or "sequence" (R2D2
    family: the whole decoded tree is one item). All backend access and
    the max-priority bookkeeping run under one lock: the owning ingest
    thread inserts, the learner thread gathers samples, and the update
    router re-prioritizes — three threads on one small mutex, which is
    exactly the contention the per-shard split bounds (vs the monolithic
    design's single global tree).
    """

    # Concurrency map (tools/drlint lock-discipline): the backend handle
    # itself is swapped on restart() and read by sample/update paths;
    # counters are bumped by ingest/router threads and read by telemetry
    # providers; `epoch`/`dead` gate the router's stale-update drop.
    _GUARDED_BY = {
        "backend": "_lock",
        "_max_error": "_lock",
        "epoch": "_lock",
        "dead": "_lock",
        "ingested_blobs": "_lock",
        "ingested_items": "_lock",
        "updates_applied": "_lock",
    }
    _NOT_GUARDED = {
        "tier_kick": "set once by the owning service before any "
                     "maintenance runs (None on standalone shards); "
                     "called to wake the router for a pending promote",
    }

    def __init__(self, shard_id: int, capacity: int, mode: str = "transition",
                 scorer: Callable[[Any, bool], np.ndarray] | None = None,
                 backend: str = "auto", seed: int = 0, spill=None):
        if mode not in ("transition", "sequence"):
            raise ValueError(f"unknown shard mode {mode!r}")
        self.shard_id = shard_id
        self.capacity = capacity
        self.mode = mode
        self.scorer = scorer
        self._backend_kind = backend
        self._seed = seed
        self._spill = spill.for_shard(shard_id) if spill is not None else None
        self._lock = threading.Lock()
        # Signaled by tier_step() commits; tiered sampling waits on it
        # (bounded) when a gather draws cold segments still promoting.
        self._tier_cv = threading.Condition(self._lock)
        self.tier_kick: Callable[[], None] | None = None
        self.backend = make_replay(capacity, backend=backend,
                                   seed=seed + 101 * shard_id,
                                   spill=self._spill, mode=mode)
        self.epoch = 0
        self.dead = False
        self._max_error = 1.0  # error-domain running max (transform is monotone)
        self.ingested_blobs = 0
        self.ingested_items = 0
        self.updates_applied = 0

    # -- ingest (owning drainer thread) -----------------------------------

    def ingest_blob(self, blob) -> int:
        """Decode one wire blob and insert it; returns items inserted.

        decode(cache=True) forces the layout cache regardless of the
        trajectory-path codec verdict: shard ingest sees one stable
        schema per run, the same argument that has the weight plane
        force its own encode cache (`runtime/weights.py`).
        """
        from distributed_reinforcement_learning_tpu_torch.data import codec

        return self.ingest(codec.decode(blob, copy=True, cache=True))

    def ingest(self, tree: Any) -> int:
        """Score + insert one decoded trajectory pytree."""
        per_transition = self.mode == "transition"
        if self.scorer is not None:
            errors = np.asarray(self.scorer(tree, per_transition), np.float64)
        else:
            errors = None
        with self._lock:
            if self.dead:
                raise RuntimeError(f"replay shard {self.shard_id} is dead")
            if errors is None:
                n = (int(np.asarray(_first_leaf(tree)).shape[0])
                     if per_transition else 1)
                errors = np.full(n, self._max_error, np.float64)
            else:
                self._max_error = max(self._max_error, float(errors.max()))
            n = self._insert_locked(errors, tree, per_transition)
            self.ingested_blobs += 1
            self.ingested_items += n
        return n

    def ingest_stamped(self, errors, tree: Any = None, blob=None) -> int:
        """Insert with ACTOR-stamped initial priorities
        (data/admission.py), skipping this shard's scorer pass entirely.

        `errors` are error-domain float64 — the stamp's values, which
        are bit-equal to what `self.scorer` would have produced (or
        Horvitz-Thompson-corrected under admission subsampling).
        Transition mode requires the decoded `tree` (array backends
        gather per field) and validates its leading axis against the
        stamp length; sequence mode takes the decoded tree OR the raw
        `blob` — an opaque-item backend stores a `LazyBlob` and defers
        decode to first materialization. Raises ValueError on any
        stamp/tree mismatch so the caller can fall back to the scoring
        path (`ingest`)."""
        per_transition = self.mode == "transition"
        errors = np.asarray(errors, np.float64).reshape(-1)
        if errors.size == 0:
            raise ValueError("stamped ingest: empty priority list")
        if per_transition:
            if tree is None:
                raise ValueError(
                    "stamped ingest: transition mode needs the decoded tree")
            n_tree = int(np.asarray(_first_leaf(tree)).shape[0])
            if n_tree != errors.size:
                raise ValueError(
                    f"stamped ingest: {errors.size} priorities for "
                    f"{n_tree} transitions")
        else:
            if errors.size != 1:
                raise ValueError(
                    "stamped ingest: sequence mode takes ONE priority, "
                    f"got {errors.size}")
            if tree is None:
                if blob is None:
                    raise ValueError("stamped ingest: need a tree or a blob")
                from distributed_reinforcement_learning_tpu_torch.data import codec

                with self._lock:  # backend binding is guarded; the flag
                    stacked = getattr(  # itself is construction-time
                        self.backend, "stacked_samples", False)
                if stacked:
                    # Stacked backends store per-field arrays — no
                    # opaque slot to defer into; decode here (still off
                    # the scorer pass).
                    tree = codec.decode(blob, copy=True, cache=True)
                else:
                    codec.check_blob(blob)  # poison fails HERE, not at
                    tree = LazyBlob(blob)   # sample-time materialization
        with self._lock:
            if self.dead:
                raise RuntimeError(f"replay shard {self.shard_id} is dead")
            self._max_error = max(self._max_error, float(errors.max()))
            n = self._insert_locked(errors, tree, per_transition)
            self.ingested_blobs += 1
            self.ingested_items += n
        return n

    def _insert_locked(self, errors: np.ndarray, tree: Any,
                       per_transition: bool) -> int:
        if per_transition:
            if getattr(self.backend, "stacked_samples", False):
                self.backend.add_batch_stacked(errors, tree)
            else:
                self.backend.add_batch(
                    errors,
                    [tree_map(lambda x: x[i], tree)
                     for i in range(len(errors))])
            return len(errors)
        self.backend.add(float(errors[0]), tree)
        return 1

    # -- gather-side (learner thread) -------------------------------------

    def stats(self) -> dict:
        """Fill / priority-mass / counters snapshot (telemetry providers
        and the obs_report 'Replay shards' section poll this)."""
        with self._lock:
            return {
                "count": len(self.backend),
                "fill": len(self.backend) / self.capacity,
                "priority_mass": float(self.backend.tree.total),
                "ingested_blobs": self.ingested_blobs,
                "ingested_items": self.ingested_items,
                "updates_applied": self.updates_applied,
                "epoch": self.epoch,
                "dead": self.dead,
            }

    def mass_count(self) -> tuple[float, int, bool]:
        with self._lock:
            if self.dead:
                return 0.0, 0, True
            return float(self.backend.tree.total), len(self.backend), False

    def sample_with_priorities(self, n: int, rng) -> tuple[Any, np.ndarray,
                                                           np.ndarray, int]:
        """-> (items_or_stacked, tree_idxs, raw priorities, epoch): this
        shard's slice of a gather. Raw (already-transformed) priorities,
        NOT IS weights — the service computes those globally.

        Tiered backends complete in steps: a draw landing on a cold
        segment queues it and the gather WAITS (bounded, on `_tier_cv`,
        which releases the shard lock) for the router/ingest threads to
        promote — the learn thread itself never touches disk. In steady
        state the draw-ahead prefetch window means promotes already
        overlap the previous train step and the wait is a no-op."""
        with self._lock:
            backend = self.backend
            step = getattr(backend, "sample_step", None)
            if step is None:
                out = backend.sample_with_priorities(n, rng)
                return (*out, self.epoch)
            deadline = time.monotonic() + self._spill.wait_s
            while True:
                out = step(n, rng, force=time.monotonic() >= deadline)
                if out is not None:
                    return (*out, self.epoch)
                kick = self.tier_kick
                if kick is not None:
                    kick()  # shard lock -> service _work; never reversed
                self._tier_cv.wait(timeout=0.05)

    # -- update router side ------------------------------------------------

    def update(self, tree_idxs: np.ndarray, errors: np.ndarray,
               epoch: int) -> int:
        """Apply a routed priority-update batch; stale-epoch batches are
        dropped loss-free (see module docstring). Returns applied count."""
        with self._lock:
            if self.dead or epoch != self.epoch:
                return 0
            self.backend.update_batch(tree_idxs, errors)
            self._max_error = max(self._max_error,
                                  float(np.abs(errors).max()))
            self.updates_applied += len(tree_idxs)
            return len(tree_idxs)

    # -- lifecycle ---------------------------------------------------------

    def mark_dead(self) -> None:
        with self._lock:
            self.dead = True

    def restart(self) -> None:
        """Fresh backend under a new epoch: in-flight updates against the
        old contents are dropped by the epoch check, and everything
        re-ingested starts at max-priority — nothing can be starved. A
        tiered backend's spill directory is wiped (`fresh=True`): restart
        is the post-death clean slate, distinct from process-restart
        RECOVERY, which reattaches the manifest at construction."""
        with self._lock:
            old = self.backend
            if hasattr(old, "close"):
                old.close()  # in-flight tier jobs no-op their commits
            spill = self._spill
            if spill is not None:
                from dataclasses import replace as _dc_replace

                spill = _dc_replace(spill, fresh=True)
            self.backend = make_replay(self.capacity, backend=self._backend_kind,
                                       seed=self._seed + 101 * self.shard_id,
                                       spill=spill, mode=self.mode)
            self.epoch = (self.epoch + 1) & int(_EPOCH_MASK)
            self.dead = False
            self._max_error = 1.0

    def snapshot(self) -> dict:
        with self._lock:
            snap = self.backend.snapshot()
        items = snap.get("items")
        if items is not None:
            # Materialize deferred blobs outside the shard lock — a
            # snapshot must persist decoded trees, not wire bytes.
            snap["items"] = [_materialize(it) for it in items]
        return snap

    def restore_part(self, priorities, items) -> None:
        with self._lock:
            self.backend.restore({"priorities": np.asarray(priorities, np.float64),
                                  "items": list(items),
                                  "beta": float(self.backend.beta)})
            # ingested_blobs stays in BLOB units (unrolls/sequences): a
            # transition-mode snapshot restores per-transition items
            # whose originating blob count is unknown here, and the
            # learner's own restored counter covers its warm gate — so
            # only sequence mode (item == blob) counts toward it.
            if self.mode == "sequence":
                self.ingested_blobs += len(items)
            self.ingested_items += len(items)

    # -- tier maintenance (ingest + router threads) ------------------------

    def tier_step(self) -> bool:
        """Run ONE unit of spill-tier maintenance (promote a sampled-cold
        segment, spill a cold-mass victim, unlink, or sync the manifest).
        Plan and commit bracket the shard lock; the file I/O in between
        holds NO lock — this is the only place replay bytes touch disk,
        and it rides the ingest/router threads, never the learn thread.
        Returns True when a job ran (callers loop while True)."""
        with self._lock:
            backend = self.backend
            plan = getattr(backend, "plan_tier_work", None)
            job = plan() if plan is not None and not self.dead else None
        if job is None:
            return False
        job.run_io()
        manifest = None
        events: list[tuple[str, float]] = []
        with self._lock:
            if self.backend is backend:  # restart() swapped the store:
                manifest = backend.commit_tier_work(job)  # stale job's
                events = backend.take_obs()               # commit no-ops
                self._tier_cv.notify_all()
        if manifest is not None:
            backend.write_manifest(manifest)
        if events and _OBS.enabled:
            sid = self.shard_id
            for name, value in events:
                if name.endswith(("_bytes",)):
                    _OBS.count(f"replay_spill/{sid}/{name}", int(value))
                    _OBS.count(
                        f"replay_spill/{sid}/"
                        f"{name.replace('_bytes', '_segments')}", 1)
                elif name == "promote_wait_ms":
                    _OBS.gauge(f"replay_spill/{sid}/promote_wait_ms", value)
                else:
                    _OBS.count(f"replay_spill/{sid}/{name}", int(value))
        return True

    def tier_pending(self) -> bool:
        with self._lock:
            pending = getattr(self.backend, "tier_pending", None)
            return pending is not None and pending()

    def tier_stats(self) -> dict | None:
        with self._lock:
            stats = getattr(self.backend, "tier_stats", None)
            return stats() if stats is not None else None


def _first_leaf(tree: Any):
    return tree_leaves(tree)[0]


# -- batch allocation ---------------------------------------------------------


def allocate_proportional(n: int, masses: np.ndarray) -> np.ndarray:
    """Split a batch of n across shards proportionally to priority mass,
    by largest remainder: sum(out) == n exactly, every share within 1 of
    n * mass_i / sum(masses), zero-mass shards get zero."""
    masses = np.asarray(masses, np.float64)
    total = masses.sum()
    if n <= 0 or total <= 0:
        return np.zeros(len(masses), np.int64)
    exact = n * masses / total
    out = np.floor(exact).astype(np.int64)
    remainder = n - int(out.sum())
    if remainder > 0:
        frac = exact - out
        frac[masses <= 0] = -1.0  # never round a zero-mass shard up
        for i in np.argsort(-frac)[:remainder]:
            out[i] += 1
    return out


def merge_is_weights(priorities: np.ndarray, global_total: float,
                     global_count: int, beta: float) -> np.ndarray:
    """Monolithic `(N * p / total)^-beta / max` IS semantics over a
    gathered batch: N and total are GLOBAL (summed over shards), the
    normalizing max is the merged batch's max — so a one-shard service
    reproduces `data/replay._is_weights` bit-for-bit."""
    probs = np.asarray(priorities, np.float64) / global_total
    weights = np.power(global_count * probs, -beta)
    weights /= weights.max()
    return weights.astype(np.float32)


# -- the service --------------------------------------------------------------


class ReplayServiceEmpty(RuntimeError):
    """sample() found no live, populated shard. Distinct from a generic
    RuntimeError so the learner's `_train_guarded` can treat it as a
    transient skip (a fleet-sweep `revive()` can empty the shards
    between the caller's len() guard and its sample()) rather than a
    learn-step fault that must propagate."""


class ShardedReplayService:
    """N-shard replay with the monolithic backend's sampling surface.

    Implements the slice of the `data/replay.py` interface the
    prioritized learners use — `sample`, `update_batch`, `__len__`,
    `beta`, `snapshot`/`restore`, `stacked_samples` — so
    `apex_runner`/`r2d2_runner`/`replay_train` swap it in for the
    monolithic backend without touching the train math.
    """

    EPS = 0.001
    ALPHA = 0.6
    BETA_INCREMENT = 0.001

    # Concurrency map (tools/drlint lock-discipline): `_pending` is the
    # async update queue (learner thread appends, router thread pops,
    # flush_updates waits on it); `_applying` marks a popped batch still
    # being applied so flush can't return early; `beta` anneals on the
    # learner thread but is read by checkpoint code; `healthy` latches
    # false on all-shards-dead demotion (facade + learner read it).
    _GUARDED_BY = {
        "_pending": ("_lock", "_work"),
        "_applying": ("_lock", "_work"),
        "_closed": ("_lock", "_work"),
        "_beta": ("_lock", "_work"),
        "_healthy": ("_lock", "_work"),
        "updates_dropped": ("_lock", "_work"),
    }
    _NOT_GUARDED = {
        "shards": "fixed fan-out list assigned once in __init__ and never "
                  "rebound; each ReplayShard synchronizes itself",
        "_tiered": "set once in __init__ (spill tier on/off), never rebound",
    }

    def __init__(self, num_shards: int, capacity: int,
                 mode: str = "transition", scorer: str = "max",
                 backend: str = "auto", beta: float = 0.4, seed: int = 0,
                 max_pending_updates: int = 256, spill=None):
        if not 1 <= num_shards <= MAX_SHARDS:
            raise ValueError(f"num_shards must be in [1, {MAX_SHARDS}]")
        per_shard = max(1, capacity // num_shards)
        score_fn = make_scorer(scorer)
        self.scorer_name = scorer or "max"
        self.shards = [
            ReplayShard(i, per_shard, mode=mode, scorer=score_fn,
                        backend=backend, seed=seed, spill=spill)
            for i in range(num_shards)
        ]
        self._tiered = spill is not None
        if self._tiered:
            for shard in self.shards:
                # Tiered gathers that draw cold segments wake the router
                # immediately instead of riding out its idle tick.
                shard.tier_kick = self._tier_kick
        self.mode = mode
        self.stacked_samples = bool(
            getattr(self.shards[0].backend, "stacked_samples", False))
        self._beta = beta
        self._healthy = True
        self.updates_dropped = 0
        self._np_rng = np.random.RandomState(seed + 7)
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        # Bounded latest-wins backlog: appends on the learner thread,
        # popleft on the router; a full deque drops the OLDEST batch.
        self._pending: deque = deque(maxlen=max_pending_updates)
        self._applying = False
        self._closed = False
        self._router = threading.Thread(target=self._route_loop, daemon=True,
                                        name="replay-update-router")
        self._router.start()

    # -- size / warm-gate accounting ---------------------------------------

    @property
    def beta(self) -> float:
        """Annealed IS exponent; a plain locked attribute so the generic
        learner checkpoint code (`replay.beta = ...`) works unchanged."""
        with self._lock:
            return self._beta

    @beta.setter
    def beta(self, value: float) -> None:
        with self._lock:
            self._beta = float(value)

    @property
    def healthy(self) -> bool:
        """False once every shard died — the learner and the ingest
        facade both demote PERMANENTLY to the monolithic path."""
        with self._lock:
            return self._healthy

    def __len__(self) -> int:
        return sum(s.mass_count()[1] for s in self.shards)

    def ingested_blobs(self) -> int:
        """Total blobs (unrolls / sequences) ingested across shards —
        the learners' warm-up gate unit."""
        return sum(s.stats()["ingested_blobs"] for s in self.shards)

    def live_shards(self) -> list[ReplayShard]:
        return [s for s in self.shards if not s.mass_count()[2]]

    def note_shard_death(self, shard: ReplayShard) -> None:
        """Ingest-side failure path: mark the shard dead; when none are
        left, latch the service unhealthy (the facade and the learner
        both demote to the monolithic path until `revive()` — the fleet
        supervisor's bounded re-promote ladder — restarts the shards)."""
        shard.mark_dead()
        if not self.live_shards():
            with self._lock:
                self._healthy = False

    def revive(self) -> int:
        """Restart every dead shard under a fresh epoch and re-latch the
        service healthy — the learner-side re-promotion the fleet
        supervisor's sweep drives (runtime/replay_shard.py). Contents of
        a restarted shard are gone by design (replay overwrites its
        oldest anyway; everything re-ingested starts at max priority)
        and in-flight priority updates against the old epoch drop
        loss-free. Returns how many shards were restarted."""
        restarted = 0
        for shard in self.shards:
            if shard.mass_count()[2]:
                shard.restart()
                restarted += 1
        with self._lock:
            self._healthy = True
        return restarted

    # -- sampling (learner thread) -----------------------------------------

    def sample(self, n: int, rng=None):
        """Gather a prioritized batch across shards; returns
        (items_or_stacked, packed_idxs, is_weights) with monolithic
        semantics (module docstring)."""
        t0 = time.perf_counter()
        rng = rng or self._np_rng
        # ONE locked pass per shard: liveness rides the same snapshot
        # (this runs once per train step, contending with ingest and
        # router threads for the shard locks).
        stats = [s.mass_count() for s in self.shards]
        masses = np.array([m for m, _, dead in stats], np.float64)
        global_total = float(masses.sum())
        global_count = sum(c for _, c, _ in stats)
        if all(dead for _, _, dead in stats) or global_count == 0 \
                or global_total <= 0:
            raise ReplayServiceEmpty("sharded replay is empty or dead")
        with self._lock:
            self._beta = min(1.0, self._beta + self.BETA_INCREMENT)
            beta = self._beta
        alloc = allocate_proportional(n, masses)
        parts: list[Any] = []
        idx_parts: list[np.ndarray] = []
        prio_parts: list[np.ndarray] = []
        shortfall = 0
        served: list[tuple[ReplayShard, float]] = []
        for shard, k, mass in zip(self.shards, alloc, masses):
            if k == 0:
                continue
            try:
                items, idxs, prios, epoch = shard.sample_with_priorities(
                    int(k), rng)
            except ColdStoreEmpty:
                # All-cold tiered shard (restart recovery, promotes still
                # in flight): redistribute its slice below rather than
                # failing the whole gather.
                shortfall += int(k)
                continue
            served.append((shard, float(mass)))
            parts.append(items)
            idx_parts.append(pack_index(shard.shard_id, epoch, idxs))
            prio_parts.append(prios)
        if shortfall and served:
            shard = max(served, key=lambda sm: sm[1])[0]
            try:
                items, idxs, prios, epoch = shard.sample_with_priorities(
                    shortfall, rng)
            except ColdStoreEmpty:
                shard = None
            if shard is not None:
                shortfall = 0
                parts.append(items)
                idx_parts.append(pack_index(shard.shard_id, epoch, idxs))
                prio_parts.append(prios)
        if not parts or shortfall:
            # A short batch would change train-step shapes; a transient
            # skip is the contract the learners already honor.
            raise ReplayServiceEmpty(
                "cold-only tiered shards (promotes in flight)")
        priorities = np.concatenate(prio_parts)
        packed = np.concatenate(idx_parts)
        weights = merge_is_weights(priorities, global_total, global_count, beta)
        if self.stacked_samples:
            batch = (parts[0] if len(parts) == 1 else
                     tree_map(lambda *xs: np.concatenate(xs), *parts))
        else:
            # Deferred-decode items (stamped sequence ingest) decode
            # here, on the learner thread, outside every shard lock.
            batch = [_materialize(item) for part in parts for item in part]
        if _OBS.enabled:
            _OBS.gauge("replay_shard/sample_ms",
                       (time.perf_counter() - t0) * 1e3)
            _OBS.count("replay_shard/samples", n)
        return batch, packed, weights

    # -- async priority updates --------------------------------------------

    def update_batch(self, packed_idxs, errors) -> None:
        """Enqueue a priority-update batch for the router thread; returns
        immediately (the learner thread never walks a sum tree here).
        Non-tagged indexes (a batch sampled from the monolithic fallback
        after demotion) are ignored — the caller routes those itself."""
        packed = np.asarray(packed_idxs, np.int64)
        errs = np.asarray(errors, np.float64)
        mask = is_packed_index(packed)
        if not mask.all():
            packed, errs = packed[mask], errs[mask]
            if packed.size == 0:
                return
        with self._work:
            if self._closed:
                return
            if len(self._pending) == self._pending.maxlen:
                self.updates_dropped += 1  # latest-wins: oldest falls out
            self._pending.append((packed, errs))
            self._work.notify()

    def _route_loop(self) -> None:
        tier_busy = False
        while True:
            with self._work:
                if not self._pending and not self._closed and not tier_busy:
                    # Bounded wait (drlint blocking-under-lock): the
                    # predicate is re-checked each iteration, so a notify
                    # lost to a close/enqueue race delays the router by
                    # at most one tick instead of parking it forever.
                    # Tiered services also ride this tick for spill-tier
                    # maintenance, so sampling kicks `_work` directly.
                    self._work.wait(timeout=0.05 if self._tiered else 0.5)
                if self._closed and not self._pending:
                    return
                batch = self._pending.popleft() if self._pending else None
                if batch is not None:
                    self._applying = True
            if batch is not None:
                try:
                    self._apply_update(*batch)
                finally:
                    with self._work:
                        self._applying = False
                        self._work.notify_all()
            tier_busy = bool(self._tier_tick()) if self._tiered else False

    def _tier_kick(self) -> None:
        with self._work:
            self._work.notify()

    def _tier_tick(self) -> int:
        """Run up to a few spill/promote/manifest jobs per shard (each
        shard's plan picks its own priority order); returns jobs done so
        the router skips its idle wait while a backlog remains."""
        done = 0
        for shard in self.shards:
            for _ in range(4):
                if not shard.tier_step():
                    break
                done += 1
        return done

    def flush_tier(self, timeout: float | None = 10.0) -> bool:
        """Drive spill-tier maintenance to quiescence on the CALLING
        thread (tests / benches / checkpoint barriers): safe alongside
        the router — every job is planned and committed under its
        shard's lock, so two maintenance threads interleave cleanly."""
        if not self._tiered:
            return True
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            busy = self._tier_tick()
            if not busy and not any(s.tier_pending() for s in self.shards):
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            if not busy:
                time.sleep(0.005)  # a router-held job is finishing its IO

    def _apply_update(self, packed: np.ndarray, errs: np.ndarray) -> None:
        shard_ids, epochs, idxs = unpack_index(packed)
        applied = 0
        for sid in np.unique(shard_ids):
            if not 0 <= sid < len(self.shards):
                continue
            pick = shard_ids == sid
            for epoch in np.unique(epochs[pick]):
                sel = pick & (epochs == epoch)
                applied += self.shards[int(sid)].update(
                    idxs[sel], errs[sel], int(epoch))
        if _OBS.enabled and applied:
            _OBS.count("replay_shard/updates_applied", applied)

    def flush_updates(self, timeout: float | None = 5.0) -> bool:
        """Block until every enqueued update batch has been applied (or
        dropped); tests and checkpoint snapshots use this barrier."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._work:
            while self._pending or self._applying:
                wait = (None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
                if wait is not None and wait <= 0:
                    return False
                self._work.wait(timeout=wait)
            return True

    # -- checkpoint round trip ---------------------------------------------

    def snapshot(self) -> dict:
        """Merged shard snapshots in the list-backend format
        (`utils/checkpoint.encode_replay_snapshot` consumes it as-is).
        Pending updates are flushed first so priorities are current."""
        from distributed_reinforcement_learning_tpu_torch.data.replay import _snapshot_items

        self.flush_updates()
        prios: list[np.ndarray] = []
        items: list[Any] = []
        for shard in self.shards:
            snap = shard.snapshot()
            prios.append(np.asarray(snap["priorities"], np.float64))
            items.extend(_snapshot_items(snap))
        with self._lock:
            beta = self._beta
        return {"priorities": (np.concatenate(prios) if prios
                               else np.zeros(0, np.float64)),
                "items": items, "beta": beta}

    def restore(self, snap: dict) -> None:
        """Round-robin a (possibly monolithic) snapshot across live
        shards; raw priorities are exact, shard placement is not part of
        replay semantics (sampling is proportional either way)."""
        from distributed_reinforcement_learning_tpu_torch.data.replay import _snapshot_items

        live = self.live_shards() or self.shards
        items = _snapshot_items(snap)
        prios = np.asarray(snap["priorities"], np.float64)
        k = len(live)
        for i, shard in enumerate(live):
            sel = slice(i, len(items), k)
            if prios[sel].size:
                shard.restore_part(prios[sel], items[sel])
        with self._lock:
            self._beta = float(snap["beta"])

    def approx_snapshot_nbytes(self) -> int:
        """Sum of per-shard estimates when every backend can price its
        snapshot (the SoA backends); 0 = unknown, let the encoder measure."""
        total = 0
        for shard in self.shards:
            est = getattr(shard.backend, "approx_snapshot_nbytes", None)
            if est is None:
                return 0
            total += est()
        return total

    # -- telemetry / lifecycle ---------------------------------------------

    def shard_stats(self) -> list[dict]:
        return [s.stats() for s in self.shards]

    def tier_stats(self) -> list[dict] | None:
        """Per-shard spill-tier stats, or None when the tier is off."""
        if not self._tiered:
            return None
        return [s.tier_stats() or {} for s in self.shards]

    def close(self) -> None:
        with self._work:
            self._closed = True
            self._work.notify_all()
        self._router.join(timeout=2.0)
        for shard in self.shards:
            with shard._lock:
                backend = shard.backend
            backend_close = getattr(backend, "close", None)
            if backend_close is not None:
                backend_close()
