"""Actor-side prioritization + priority-mass admission (sample-at-source).

Counterpart of the JAX package's `data/admission.py`: the same stamp
frames, byte for byte, for the same unroll and scorer. At large actor
counts the learner's ingest CPU is spent scoring and decoding
transitions it will mostly never sample (in-network experience
sampling, arXiv:2110.13506, moves the sampling decision off the learner
box). This module moves the INITIAL prioritization to the PUT side of
the wire:

- **Actor-side scoring**: the actor computes the exact ingest-time
  scorer the learner would run (`data/replay_service.td_proxy_scorer`,
  selected by the same `DRL_REPLAY_SCORER` knob) and stamps the
  per-transition priorities into a versioned extension frame in front
  of the codec blob (`data/codec.stamp_frame`). Stamped values are in
  the scorer's ERROR domain and round-trip json bit-exactly (float64
  repr), so a stamped ingest is bit-equal to a learner-scored one —
  pinned by tests/test_torch_admission.py. The 'max' scorer cannot be
  stamped (its fill value is learner-side `_max_error` state), so
  stamping silently stays off under it.

- **Priority-mass admission**: under learner backpressure (an ingest
  duty-cycle pressure signal fed back on PUT replies,
  `runtime/transport.py`), low-priority unrolls are thinned at the
  actor. High-priority unrolls (unroll mean transformed priority >= the
  running fleet mean) always ride in full. Below the mean, each
  transition keeps a Bernoulli survival probability
  `q_i = clip(f * p_i / mu, floor, 1)` (Horvitz-Thompson: kept
  transitions' priorities are inflated by `1/q_i` in the TRANSFORMED
  domain, so expected priority mass — and therefore the proportional
  sampling distribution — is unchanged; chi-square pinned). `q_i == 1`
  transitions pass through bitwise untouched. An unroll whose every
  transition loses its coin flip is dropped whole and its transformed
  priority mass folded into a ledger drained onto the NEXT stamp
  (`"folded"`), so no priority mass is ever silently lost — the
  zero-lost-mass conservation pin.

Gates: `DRL_ACTOR_PRIORITY` / `DRL_ADMISSION` force on/off; unset takes
the defaults below, the values of the JAX package's committed
`benchmarks/admission_verdict.json` (both off). The port reads no file
under `benchmarks/`; tests/test_torch_admission.py pins the constants
to that file.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any

import numpy as np

from distributed_reinforcement_learning_tpu_torch.data.fifo import tree_map
from distributed_reinforcement_learning_tpu_torch.data.replay import PrioritizedReplay
from distributed_reinforcement_learning_tpu_torch.data.replay_service import make_scorer
from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS

# Priority transform constants — THE backend transform
# (data/replay.py): p = (|e| + EPS) ** ALPHA. Admission corrections are
# applied in the transformed domain and mapped back through the exact
# inverse so the learner's own transform reproduces them.
EPS = PrioritizedReplay.EPS
ALPHA = PrioritizedReplay.ALPHA

# Mirror of runtime/replay_shard._ALGO_MODE (layering: data/ must not
# import runtime/). tests/test_torch_admission.py pins the two maps equal.
ALGO_MODES = {"apex": "transition", "r2d2": "sequence", "xformer": "sequence"}

# Unset-gate defaults: the JAX package's committed
# benchmarks/admission_verdict.json (`actor_priority_auto_enable`,
# `admission_auto_enable`).
DEFAULTS = {"actor_priority_auto_enable": False, "admission_auto_enable": False}

_flag_lock = threading.Lock()
_flags: dict[str, bool | None] = {"priority": None, "admission": None}


def _resolve_flag(name: str, env_key: str, verdict_key: str) -> bool:
    with _flag_lock:
        cached = _flags[name]
    if cached is not None:
        return cached
    env = os.environ.get(env_key, "").strip().lower()
    if env in ("1", "true", "yes", "on"):
        value = True
    elif env in ("0", "false", "no", "off"):
        value = False
    else:
        value = DEFAULTS[verdict_key]
    with _flag_lock:
        _flags[name] = value
    return value


def actor_priority_enabled() -> bool:
    """DRL_ACTOR_PRIORITY=1 forces actor-side scoring + stamping on, =0
    off; unset takes `DEFAULTS` (off). Resolved once per process;
    `refresh_flags()` re-reads."""
    return _resolve_flag("priority", "DRL_ACTOR_PRIORITY",
                         "actor_priority_auto_enable")


def admission_enabled() -> bool:
    """DRL_ADMISSION=1 forces priority-mass admission (backpressure
    thinning) on, =0 off; unset defers to the committed verdict
    (`admission_auto_enable`). Admission rides the stamp, so it is
    inert unless `actor_priority_enabled()` too."""
    return _resolve_flag("admission", "DRL_ADMISSION", "admission_auto_enable")


def refresh_flags() -> None:
    """Re-resolve the env/verdict gates (after monkeypatching env)."""
    with _flag_lock:
        _flags["priority"] = None
        _flags["admission"] = None


def _env_float(key: str, default: float) -> float:
    try:
        raw = os.environ.get(key, "").strip()
        return float(raw) if raw else default
    except ValueError:
        return default


def transform(errors: np.ndarray) -> np.ndarray:
    """Error domain -> transformed priority domain (the backend's own
    monotone map)."""
    return (np.abs(np.asarray(errors, np.float64)) + EPS) ** ALPHA


def inverse_transform(priorities: np.ndarray) -> np.ndarray:
    """Transformed domain -> the non-negative error whose transform is
    exactly `priorities` (used to stamp Horvitz-Thompson-corrected
    priorities in the error domain the stamp carries)."""
    return np.asarray(priorities, np.float64) ** (1.0 / ALPHA) - EPS


class DutyMeter:
    """Windowed busy-fraction meter: the learner's ingest pressure.

    The sharded ingest facade never blocks (that is its point), so
    queue depth is useless as a pressure signal there — what saturates
    is the ingest thread's CPU. Each `note(busy_s)` adds one ingest
    call's busy time; `value()` is an EWMA of busy/wall over ~half-second
    windows, 0.0 (idle) to 1.0 (the thread never sleeps).
    """

    # Concurrency map (tools/drlint lock-discipline): noted by transport
    # serve / drainer threads, read by reply builders on the same
    # threads and telemetry pollers.
    _GUARDED_BY = {
        "_busy": "_lock",
        "_t0": "_lock",
        "_ewma": "_lock",
        "_total": "_lock",
    }

    WINDOW_S = 0.5
    DECAY = 0.5  # per-window EWMA retention

    def __init__(self):
        self._lock = threading.Lock()
        self._busy = 0.0
        self._t0 = time.monotonic()
        self._ewma = 0.0
        self._total = 0.0

    def note(self, busy_s: float) -> None:
        now = time.monotonic()
        with self._lock:
            self._total += max(0.0, busy_s)
            self._busy += max(0.0, busy_s)
            window = now - self._t0
            if window >= self.WINDOW_S:
                duty = min(1.0, self._busy / window)
                self._ewma = self.DECAY * self._ewma + (1 - self.DECAY) * duty
                self._busy = 0.0
                self._t0 = now

    def value(self) -> float:
        now = time.monotonic()
        with self._lock:
            window = now - self._t0
            if window >= self.WINDOW_S:
                # Fold the straggling partial window so an idle meter
                # decays toward 0 even with no note() traffic.
                duty = min(1.0, self._busy / window)
                self._ewma = self.DECAY * self._ewma + (1 - self.DECAY) * duty
                self._busy = 0.0
                self._t0 = now
            return self._ewma

    def total(self) -> float:
        """Cumulative busy seconds since construction."""
        with self._lock:
            return self._total


class Decision:
    """One `admit()` outcome. `send` False means the unroll was dropped
    whole (mass folded into the ledger); otherwise `stamp` is the
    summary dict to frame in front of the blob and `tree` the thinned
    pytree to encode — None meaning "send the caller's original tree
    unchanged" (the full-admission fast path avoids re-touching it).
    `orig_t` is the pre-thinning transition count (`note_wire`'s
    bytes-saved estimate)."""

    __slots__ = ("send", "tree", "stamp", "orig_t")

    def __init__(self, send: bool, tree: Any = None, stamp: dict | None = None,
                 orig_t: int = 0):
        self.send = send
        self.tree = tree
        self.stamp = stamp
        self.orig_t = orig_t


class AdmissionController:
    """Per-queue actor-side scorer + admission ladder.

    One controller per PUT endpoint (`TransportClient`),
    attached by the actor runner via `configure(queue, algo)`. `admit`
    runs on the actor's publish thread; `observe_pressure` on whatever
    thread parses PUT replies (the same publish thread for the TCP
    client); stats/telemetry polls come from anywhere.
    """

    # Concurrency map (tools/drlint lock-discipline): every mutable
    # word — the pressure EWMA, the running unroll-mean, the folded-mass
    # ledger, the RNG, and the stats counters — lives under `_lock`.
    _GUARDED_BY = {
        "_pressure": "_lock",
        "_mu": "_lock",
        "_mu_n": "_lock",
        "_folded": "_lock",
        "_rng": "_lock",
        "_blob_ewma": "_lock",
        "stats": "_lock",
    }

    MU_DECAY = 0.98       # running fleet-mean priority EWMA retention
    PRESSURE_DECAY = 0.7  # per-reply pressure EWMA retention

    def __init__(self, mode: str, scorer_name: str = "td_proxy",
                 seed: int | None = None):
        if mode not in ("transition", "sequence"):
            raise ValueError(f"unknown admission mode {mode!r}")
        scorer = make_scorer(scorer_name)
        if scorer is None:
            raise ValueError(
                f"scorer {scorer_name!r} has no actor-computable value "
                "(max-priority fill is learner-side state)")
        self.mode = mode
        self.scorer_name = scorer_name
        self._scorer = scorer
        self.lo = _env_float("DRL_ADMISSION_LO", 0.5)
        self.hi = max(_env_float("DRL_ADMISSION_HI", 0.9), self.lo + 1e-6)
        self.floor = min(max(_env_float("DRL_ADMISSION_FLOOR", 0.1), 1e-3), 1.0)
        self._lock = threading.Lock()
        self._pressure = 0.0
        self._mu = 0.0
        self._mu_n = 0
        self._folded = 0.0
        self._rng = np.random.default_rng(seed)
        self._blob_ewma = 0.0  # full-unroll wire bytes (drop estimates)
        self.stats = {"stamped_puts": 0, "full_puts": 0, "subsampled_puts": 0,
                      "dropped_unrolls": 0, "sent_transitions": 0,
                      "subsample_dropped_transitions": 0,
                      "dropped_mass": 0.0, "folded_mass_sent": 0.0,
                      "wire_bytes_sent": 0, "wire_bytes_saved": 0}

    # -- pressure feedback (PUT-reply thread) ------------------------------

    def observe_pressure(self, permille: int) -> None:
        """Fold one learner pressure sample (0..1000, from a PUT reply)
        into the EWMA."""
        p = min(max(permille / 1000.0, 0.0), 1.0)
        with self._lock:
            self._pressure = (self.PRESSURE_DECAY * self._pressure
                              + (1 - self.PRESSURE_DECAY) * p)
            snap = self._pressure
        if _OBS.enabled:
            _OBS.gauge("admission/pressure", snap)

    def pressure(self) -> float:
        """Effective pressure 0..1: `DRL_ADMISSION_PRESSURE` override
        (tests/bench drive the ladder without a loaded learner) or the
        reply-fed EWMA."""
        override = _env_float("DRL_ADMISSION_PRESSURE", -1.0)
        if override >= 0.0:
            return min(override, 1.0)
        with self._lock:
            return self._pressure

    # -- the ladder (actor publish thread) ---------------------------------

    def admit(self, tree: Any) -> Decision:
        """Score one unroll, apply the admission ladder, and return what
        to send. See the module docstring for the ladder semantics."""
        per_transition = self.mode == "transition"
        errors = np.asarray(self._scorer(tree, per_transition), np.float64)
        pri = transform(errors)
        mean_p = float(pri.mean())
        with self._lock:
            # Running mean of unroll mean priorities — the "fleet mean"
            # this actor has observed; seeds from the first unroll.
            if self._mu_n == 0:
                self._mu = mean_p
            else:
                self._mu = self.MU_DECAY * self._mu + (1 - self.MU_DECAY) * mean_p
            self._mu_n += 1
            mu = self._mu
        p = self.pressure() if admission_enabled() else 0.0
        if p < self.lo or mean_p >= mu or mu <= 0.0:
            return self._full(errors)
        s = min(1.0, (p - self.lo) / (self.hi - self.lo))
        f = 1.0 - s * (1.0 - self.floor)
        q = np.minimum(np.maximum(f * pri / mu, self.floor), 1.0)
        with self._lock:
            coins = self._rng.random(q.shape)
        keep = coins < q
        if not keep.any():
            mass = float(pri.sum())
            with self._lock:
                self._folded += mass
                self.stats["dropped_unrolls"] += 1
                self.stats["dropped_mass"] += mass
                # A whole-dropped unroll never reaches encode: estimate
                # its wire cost from the running full-unroll size.
                saved = int(self._blob_ewma)
                self.stats["wire_bytes_saved"] += saved
            if _OBS.enabled:
                _OBS.count("admission/dropped_unrolls")
                _OBS.count("admission/dropped_mass", mass)
                if saved:
                    _OBS.count("admission/wire_bytes_saved", saved)
            return Decision(False)
        if bool(keep.all()):
            return self._full(errors)
        # Horvitz-Thompson: inflate kept priorities by 1/q in the
        # transformed domain; q==1 entries pass through BITWISE (the
        # inverse transform is exact only in expectation of float
        # rounding, and untouched entries must stay bit-equal).
        kept_q = q[keep]
        corrected = errors[keep].copy()
        adjust = kept_q < 1.0
        if adjust.any():
            corrected[adjust] = inverse_transform(pri[keep][adjust] / kept_q[adjust])
        if per_transition:
            idx = np.flatnonzero(keep)
            sent_tree = tree_map(lambda x: np.asarray(x)[idx], tree)
        else:
            sent_tree = tree  # sequence mode: keep is a single coin
        dropped = int(keep.size - keep.sum())
        with self._lock:
            self.stats["subsampled_puts"] += 1
            self.stats["subsample_dropped_transitions"] += dropped
        if _OBS.enabled:
            _OBS.count("admission/subsampled_puts")
            _OBS.count("admission/subsample_dropped_transitions", dropped)
        return self._sent(corrected, sent_tree, int(keep.size))

    def _full(self, errors: np.ndarray) -> Decision:
        with self._lock:
            self.stats["full_puts"] += 1
        return self._sent(errors, None, int(errors.size))

    def _sent(self, errors: np.ndarray, tree: Any, orig_t: int) -> Decision:
        stamp = {"scorer": self.scorer_name, "mode": self.mode,
                 "pri": [float(e) for e in errors], "t": int(errors.size)}
        with self._lock:
            folded, self._folded = self._folded, 0.0
            if folded:
                self.stats["folded_mass_sent"] += folded
            self.stats["stamped_puts"] += 1
            self.stats["sent_transitions"] += int(errors.size)
        if folded:
            stamp["folded"] = folded
        if _OBS.enabled:
            _OBS.count("admission/stamped_puts")
        return Decision(True, tree, stamp, orig_t)

    def note_wire(self, nbytes: int, decision: Decision) -> None:
        """Account one SENT blob's wire bytes (called by the PUT
        endpoint after encode). Payload bytes scale linearly with
        transitions, so a subsampled blob's saving is estimated
        proportionally: est_full = nbytes * orig_t / sent_t."""
        sent_t = max(int(decision.stamp["t"]), 1)
        orig_t = max(int(decision.orig_t), sent_t)
        est_full = nbytes * orig_t / sent_t
        saved = int(est_full) - nbytes
        with self._lock:
            # EWMA of FULL-unroll wire size seeds whole-drop estimates.
            self._blob_ewma = (0.9 * self._blob_ewma + 0.1 * est_full
                               if self._blob_ewma else est_full)
            self.stats["wire_bytes_sent"] += nbytes
            if saved:
                self.stats["wire_bytes_saved"] += saved
        if _OBS.enabled:
            _OBS.count("admission/wire_bytes_sent", nbytes)
            if saved:
                _OBS.count("admission/wire_bytes_saved", saved)

    def pending_folded_mass(self) -> float:
        """Transformed-domain mass dropped but not yet drained onto a
        stamp (conservation accounting: `dropped_mass ==
        folded_mass_sent + pending`)."""
        with self._lock:
            return self._folded

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.stats)


def maybe_controller(algo: str, seed: int | None = None) -> AdmissionController | None:
    """Controller for an actor runner's PUT endpoint, or None when
    stamping is off: the gate resolves off, the algo has no shard mode,
    or the fleet's `DRL_REPLAY_SCORER` has no actor-computable scorer
    ('max'). The scorer knob is shared with the learner
    (runtime/replay_shard.build_service) so both sides agree by
    construction; the learner still validates each stamp's scorer/mode
    and falls back to scoring on mismatch."""
    if not actor_priority_enabled():
        return None
    mode = ALGO_MODES.get(algo)
    if mode is None:
        return None
    scorer_name = os.environ.get("DRL_REPLAY_SCORER", "max").strip() or "max"
    if make_scorer(scorer_name) is None:
        return None
    return AdmissionController(mode, scorer_name, seed=seed)


def configure(queue: Any, algo: str, seed: int | None = None) -> AdmissionController | None:
    """Attach an admission controller to a PUT endpoint that supports
    one (`set_admission`: TransportClient, RemoteQueue). In-process queues
    have no wire to save — stamping is skipped there."""
    set_admission = getattr(queue, "set_admission", None)
    if set_admission is None:
        return None
    ctrl = maybe_controller(algo, seed=seed)
    if ctrl is not None:
        set_admission(ctrl)
    return ctrl
