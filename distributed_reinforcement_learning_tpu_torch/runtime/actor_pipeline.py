"""Pipelined actor data plane: double-buffered sampling + async publication.

Copy of the JAX package's `runtime/actor_pipeline.py` (it imports no
jax). One change: an unset `DRL_ACTOR_PIPE` takes the default from a
constant, not from a file under `benchmarks/`. The families' slice
protocol lives in the port's runners.

Every actor runner in this repo stepped the reference's strictly serial
per-timestep loop: jitted act -> numpy `env.step` -> (at unroll end) a
blocking encode+PUT. The XLA act dispatch releases the GIL and the PUT
is wire time, yet neither ever overlapped the pure-host env stepping —
the overlap TorchBeast (arXiv:1910.03552) and the Podracer
architectures (arXiv:2104.06272) identify as where single-host actor
throughput lives. This module adds both overlaps without touching the
recorded trajectory semantics:

- **Double-buffered sampling** (`ActorPipeline`): the actor's N
  vectorized envs split into two slices, each an independent "virtual
  actor" with its own RNG stream (`slice_seed`), env subset, LSTM/
  window carry, episode accounting and accumulator
  (`data/structures.SlicedAccumulators`). A single act worker thread
  keeps exactly one slice's act in flight while the main thread steps
  the OTHER slice's envs, so XLA compute (and a `RemoteActService`
  RPC, which otherwise blocks all N envs) hides behind host stepping.
  Because a slice runs exactly the sequential loop's per-step math
  over its own envs/seed, a pipelined slice's trajectories are
  BIT-IDENTICAL to a plain actor constructed over that slice
  (frozen weights; pinned by tests/test_actor_pipeline.py).

- **Asynchronous unroll publication** (`UnrollPublisher`): completed
  unroll rounds leave the step loop through a bounded background
  publisher thread running the existing `actor_put` path (encode,
  dedup, `put_round`, ring or TCP), with backpressure by depth
  (`DRL_ACTOR_PUB_DEPTH`) so stepping never blocks behind a 10ms TCP
  PUT yet can never run unboundedly ahead of a stalled transport.

- **Demotion** follows the PR-9 conventions: a publisher death or a
  mid-round slice error demotes to the sequential (non-overlapped)
  per-slice loop with the publisher's pending rounds carried over and
  replayed inline — zero lost unrolls — and a bounded
  `fleet.RetryLadder` re-promotes after transient causes clear
  (exhaustion latches the demotion permanent with one log line).

Gate: `DRL_ACTOR_PIPE=1/0` forces; unset takes
`PIPELINE_DEFAULT` (off).
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable

import numpy as np

from distributed_reinforcement_learning_tpu_torch.data.fifo import put_round
from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS

# Per-slice RNG stream separation: slice 0 keeps the actor's own seed
# (a 1-slice pipeline is exactly the plain actor), later slices stride
# far enough that no launcher's seed+1+task layout can collide.
_SLICE_SEED_STRIDE = 1_000_003

# Unset-gate default. The JAX package reads it from
# `benchmarks/actor_pipeline_verdict.json` (`auto_enable`), a TPU-era
# adjudication this package does not read; false there today.
PIPELINE_DEFAULT = False


def slice_seed(base_seed: int, index: int) -> int:
    """The per-slice RNG seed: deterministic and documented, so the
    bit-identity pin can construct the matching plain actor."""
    return int(base_seed) + _SLICE_SEED_STRIDE * int(index)


def slice_bounds(num_envs: int, k: int) -> list[tuple[int, int]]:
    """Split [0, num_envs) into k contiguous slices (first slices take
    the remainder, so sizes differ by at most one)."""
    if k <= 0 or num_envs < k:
        raise ValueError(f"cannot cut {num_envs} envs into {k} slices")
    base, rem = divmod(num_envs, k)
    bounds, lo = [], 0
    for i in range(k):
        hi = lo + base + (1 if i < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def split_batched_env(env: Any, k: int) -> list[Any]:
    """Per-slice views over a BatchedEnv's underlying env objects.

    The view is a real BatchedEnv over the SAME env instances (the
    factories return them as-is; nothing is re-created or re-reset), so
    a slice's `step` is byte-for-byte what a plain actor over those
    envs would see. Episode accounting carries over from the parent."""
    from distributed_reinforcement_learning_tpu_torch.envs.batched import BatchedEnv

    views = []
    for lo, hi in slice_bounds(env.num_envs, k):
        sub = BatchedEnv([(lambda e=e: e) for e in env.envs[lo:hi]])
        sub._returns[:] = env._returns[lo:hi]
        sub._lengths[:] = env._lengths[lo:hi]
        views.append(sub)
    return views


def sync_slices_params(actor: Any, slices: list) -> None:
    """Shared `pipeline_sync_weights` body for the pull-every-round
    families (impala/r2d2/xformer/ximpala): ONE weights RPC per round,
    adopted by every slice — k independent per-slice pulls were k
    version checks (and k full-blob transfers per version bump) for
    identical bytes. Runs on the main thread before any slice's round
    begins, so the lockstep handoff is untouched. A remote-act actor pulls
    no weights."""
    if getattr(actor, "remote_act", None) is not None:
        return
    actor._sync_params()
    if actor._params is None:
        raise RuntimeError("no weights published yet")
    for sl in slices:
        if sl.version < actor._version:
            sl.params, sl.version = actor._params, actor._version


def shape_life_loss(prev_lives: np.ndarray, reward: np.ndarray,
                    done: np.ndarray, infos: dict):
    """Life-loss shaping (`train_impala.py:149-154`), the single
    definition shared by the sequential loops and the slice paths: a
    lost life is recorded as r=-1, done=True while the env keeps
    running. Returns (rec_reward, rec_done, new_prev_lives)."""
    rec_reward, rec_done = reward.astype(np.float32), done.copy()
    lives = infos.get("lives")
    lost = (lives != prev_lives) & (prev_lives >= 0) & ~done
    rec_reward = np.where(lost, -1.0, rec_reward)
    rec_done = rec_done | lost
    return rec_reward, rec_done, np.where(done, -1, lives)


def shape_timeout(done: np.ndarray, infos: dict,
                  timeout_nonterminal: bool) -> np.ndarray:
    """Stable-mode truncation recording shared by the R2D2/Xformer
    sequential loops and slice paths: a time-limit truncation is
    recorded as non-terminal (see R2D2Actor.__init__)."""
    if not timeout_nonterminal:
        return done
    trunc = np.asarray(infos.get("truncated", np.zeros_like(done)))
    return done & ~trunc


def push_window(win_obs: np.ndarray, win_pa: np.ndarray,
                win_done: np.ndarray, obs: np.ndarray,
                prev_action: np.ndarray) -> None:
    """Slide a transformer actor's rolling window and append the CURRENT
    step (done not yet known — False placeholder); shared by the
    sequential loops and slice paths of the xformer/ximpala families."""
    for arr, val in ((win_obs, obs), (win_pa, prev_action), (win_done, False)):
        arr[:, :-1] = arr[:, 1:]
        arr[:, -1] = val


def unpush_window(win_obs: np.ndarray, win_pa: np.ndarray,
                  win_done: np.ndarray, evicted: tuple) -> None:
    """Inverse of push_window given the columns it evicted: restores the
    window to its pre-push bytes. Needed when a settled act's output is
    DISCARDED (a mid-round error elsewhere aborted the round): the
    xformer family's window persists across rounds, so an un-undone
    push would leave a duplicated timestep conditioning every later
    act of that slice."""
    for arr, col in zip((win_obs, win_pa, win_done), evicted):
        arr[:, 1:] = arr[:, :-1]
        arr[:, 0] = col


class PipelineSlice:
    """Mutable per-slice actor state. The common fields live here; each
    actor family's `pipeline_make_slices` attaches its own extras
    (carry, windows, local buffer, epsilon schedule, ...). A slice is
    only ever touched by one thread at a time: the act worker while its
    act is in flight, the main thread between acts (lockstep handoff —
    see ActorPipeline)."""

    def __init__(self, index: int, env: Any, seed: int, **fields: Any):
        self.index = index
        self.env = env
        self.seed = seed
        self.params = None
        self.version = -1
        self.episode_returns: list[float] = []
        self.__dict__.update(fields)


# Publisher payload kinds, mirroring the two sequential put shapes so
# the wire ops cannot drift from the non-pipelined loops:
#   ("round", items) -> put_round(queue, items)   (unroll-family rounds)
#   ("put",   item)  -> queue.put(item)           (Ape-X per-step puts)
def _payload_unrolls(payload) -> int:
    kind, items = payload
    return len(items) if kind == "round" else 1


class UnrollPublisher:
    """Bounded background publisher for completed unroll rounds.

    `submit` blocks while `depth` rounds are unpublished — the one in
    flight included (backpressure: the step loop can hide a PUT, not a
    stalled transport); the worker runs the exact sequential
    `actor_put` path. The in-flight payload stays at the FRONT of the
    deque until its put SUCCEEDED (peek-then-pop), so a put failure or
    a `drain()` that times out joining a wedged worker always hands it
    back for inline replay — at-least-once against a transport that
    partially accepted a round (or completes a put after the drain
    deadline): duplicate unrolls are benign training data, losing them
    is not.
    """

    # Concurrency map (tools/drlint lock-discipline): submitters run on
    # the actor's step thread, the worker on its own thread, drain() on
    # whoever demotes — every state word lives under `_cond`'s lock.
    _GUARDED_BY = {
        "_pending": "_cond",
        "_dead": "_cond",
        "_closed": "_cond",
        "_error": "_cond",
    }
    _NOT_GUARDED = {
        "_thread": "start()/drain() lifecycle handle, controlling actor "
                   "thread only",
        "stuck": "written by drain() and read by the same controlling "
                 "actor thread's health checks",
    }

    _JOIN_S = 10.0  # drain()'s worker-join deadline

    def __init__(self, queue: Any, depth: int):
        self._queue = queue
        self.depth = max(1, int(depth))
        self._cond = threading.Condition()
        self._pending: deque = deque()
        self._dead = False
        self._closed = False
        self._error: BaseException | None = None
        self._thread: threading.Thread | None = None
        self.stuck = False  # drain() timed out with the worker still
        #   inside a put — see drain()

    def start(self) -> "UnrollPublisher":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="actor-publisher")
        self._thread.start()
        return self

    @property
    def error(self) -> BaseException | None:
        with self._cond:
            return self._error

    @property
    def alive(self) -> bool:
        with self._cond:
            return (not self._dead and not self._closed
                    and self._thread is not None and self._thread.is_alive())

    def pending_rounds(self) -> int:
        with self._cond:
            return len(self._pending)

    def submit(self, payload, timeout: float | None = None) -> bool:
        """Enqueue one payload; blocks while the publisher is `depth`
        rounds behind (the in-flight one counts). False = the publisher
        is dead/closed (the caller owns inline publication from
        here)."""
        t0 = time.perf_counter()
        with self._cond:
            full = len(self._pending) >= self.depth \
                and not self._dead and not self._closed
            if not self._cond.wait_for(
                    lambda: len(self._pending) < self.depth
                    or self._dead or self._closed, timeout):
                return False
            if self._dead or self._closed:
                return False
            self._pending.append(payload)
            depth_now = len(self._pending)
            self._cond.notify_all()
        if _OBS.enabled:
            _OBS.gauge("pipe/publisher_depth", depth_now)
            if full:
                _OBS.count("pipe/publisher_full_waits")
                _OBS.gauge("pipe/publisher_full_wait_ms",
                           (time.perf_counter() - t0) * 1e3)
        return True

    def publish_one(self, payload) -> None:
        """The sequential actor_put path, payload-shaped (also the
        inline replay path after a demotion)."""
        kind, items = payload
        with _OBS.span("actor_put"):
            if kind == "put":
                self._queue.put(items)
            else:
                put_round(self._queue, items)

    def _run(self) -> None:
        while True:
            with self._cond:
                # Bounded wait (drlint blocking-under-lock): re-arm on
                # timeout instead of parking forever behind a lost
                # notify; a False return means neither pending work nor
                # close, so just go around.
                if not self._cond.wait_for(
                        lambda: self._pending or self._closed,
                        timeout=0.5):
                    continue
                if not self._pending:
                    return  # closed and empty: drain() owns nothing more
                payload = self._pending[0]  # peek: a failure (or a drain
                #   racing a wedged put) still finds it at the front
            try:
                self.publish_one(payload)
            except BaseException as e:  # noqa: BLE001 — latch; the front
                with self._cond:  #      payload is handed back by drain()
                    self._error = e
                    self._dead = True
                    self._cond.notify_all()
                return
            with self._cond:
                # Pop only after success; drain() may have reclaimed the
                # deque while the put was in flight (then the caller
                # replays this payload inline — a benign duplicate).
                if self._pending and self._pending[0] is payload:
                    self._pending.popleft()
                last = self._closed and not self._pending
                self._cond.notify_all()
            if _OBS.enabled:
                _OBS.count("pipe/published_rounds")
                _OBS.count("pipe/published_unrolls", _payload_unrolls(payload))
            if last:
                return

    def drain(self) -> list:
        """Stop the worker and hand back every unpublished payload. The
        in-flight one is still at the front (popped only on success), so
        a join timeout against a wedged put hands it back too. After a
        join timeout `stuck` is True: the worker is STILL inside a put,
        and the owner must NOT replay inline on the same queue (the shm
        ring is single-producer — a second put_blob caller would tear
        records) — it latches the pipeline dead-visible instead."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=self._JOIN_S)
            self.stuck = self._thread.is_alive()
        with self._cond:
            out = list(self._pending)
            self._pending.clear()
        return out


class ActorPipeline:
    """Drives a slice-capable actor with double-buffered sampling and
    async publication; presents the actor's own surface (`run_unroll`/
    `run_steps`, `episode_returns`, `_version`) so run_role and the
    launchers need no topology changes.

    Concurrency map (tools/drlint lock-discipline): documentation form,
    like ShmRing — no lock. Slice state is handed between the main
    thread and the single act worker in LOCKSTEP (exactly one act in
    flight; a slice's next act is only submitted after its previous
    step completed on the main thread), so no two threads ever touch a
    slice concurrently. The publisher owns its own lock above.
    """

    _GUARDED_BY: dict = {}  # lockstep handoff; see class docstring

    def __init__(self, actor: Any, num_slices: int = 2,
                 publisher_depth: int | None = None,
                 publisher_queue: Any = None):
        from distributed_reinforcement_learning_tpu_torch.runtime.fleet import RetryLadder

        if not hasattr(actor, "pipeline_make_slices"):
            raise TypeError(f"{type(actor).__name__} has no slice support")
        self._actor = actor
        # publisher_queue: a DEDICATED put lane (own TransportClient) —
        # on the TCP plane the shared client serializes request/reply
        # exchanges, so a publisher PUT would hold the lock a remote
        # act or the per-round weight pull needs, re-introducing the
        # blocking the pipeline hides. Caller owns its lifecycle.
        self._queue = publisher_queue if publisher_queue is not None \
            else actor.queue
        self._slices = actor.pipeline_make_slices(max(2, int(num_slices)))
        self._depth = (int(os.environ.get("DRL_ACTOR_PUB_DEPTH", "2"))
                       if publisher_depth is None else int(publisher_depth))
        self._publisher = UnrollPublisher(self._queue, self._depth).start()
        # One act worker: submission order == execution order, and the
        # worker materializes act outputs to host numpy so the main
        # thread's step never blocks on XLA.
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="actor-act")
        self._demoted = False
        self._wedged = False  # in-flight act never settled; see run_round
        self._probe_open = False
        self._ladder = RetryLadder("actor_pipeline")
        self._backlog: list = []  # payloads carried over by a demotion
        self.demotions = 0
        self.rounds = 0
        # Bounded overlap samples (ms) for bench/obs introspection.
        self.stage_samples: dict[str, deque] = {
            "act_wait_ms": deque(maxlen=4096),
            "env_step_ms": deque(maxlen=4096),
            "put_wait_ms": deque(maxlen=4096),
        }

    # -- actor-compatible surface -------------------------------------
    @property
    def episode_returns(self) -> list[float]:
        return [r for sl in self._slices for r in sl.episode_returns]

    @property
    def _version(self) -> int:
        versions = [sl.version for sl in self._slices]
        return max(versions) if versions else -1

    def __getattr__(self, name: str):
        # Telemetry/launch shims read through to the wrapped actor
        # (agent, env, weights, ...). Only called for missing attrs.
        actor = self.__dict__.get("_actor")
        if actor is None:
            raise AttributeError(name)
        return getattr(actor, name)

    def run_unroll(self) -> int:
        return self.run_round(self._actor.pipeline_round_steps())

    def run_steps(self, num_steps: int) -> int:
        return self.run_round(num_steps)

    # -- core ----------------------------------------------------------
    def run_round(self, steps: int) -> int:
        if steps is None or steps <= 0:
            raise ValueError(f"run_round needs a positive step count, got {steps}")
        if self._wedged:
            # The act worker never settled and is STILL RUNNING with
            # ownership of one slice's state: the demoted sequential
            # loop would race it (torn window/carry bytes) and the
            # 1-worker pool is queued behind it anyway. Die visibly
            # (run_actor_thread logs + counts `actor/deaths`) instead
            # of corrupting.
            raise RuntimeError(
                "actor pipeline wedged: an in-flight act never settled; "
                "the actor process must be restarted")
        if self._demoted and not self._try_repromote():
            return self._sequential_round(steps)
        try:
            self._flush_backlog()
            self._actor.pipeline_sync_weights(self._slices)
            for sl in self._slices:
                self._actor.slice_begin_round(sl, steps)
            frames = self._pipelined_round(steps)
        except Exception:
            self._demote("slice error mid-round: "
                         + repr(sys.exc_info()[1]))
            raise
        if self._probe_open and not self._demoted:
            self._probe_open = False
            self._ladder.note_success()
            if _OBS.enabled:
                _OBS.count("pipe/repromotions")
        self.rounds += 1
        return frames

    def _pipelined_round(self, steps: int) -> int:
        slices = self._slices
        k = len(slices)
        act = self._actor.slice_act
        note = self.stage_samples
        total = steps * k
        fut, fut_idx = self._pool.submit(act, slices[0]), 0
        try:
            for j in range(total):
                sl = slices[j % k]
                t0 = time.perf_counter()
                with _OBS.span("pipe_act_wait"):
                    out = fut.result()
                note["act_wait_ms"].append((time.perf_counter() - t0) * 1e3)
                if j + 1 < total:
                    fut, fut_idx = (self._pool.submit(act, slices[(j + 1) % k]),
                                    (j + 1) % k)
                else:
                    fut = None
                t0 = time.perf_counter()
                with _OBS.span("pipe_env_step"):
                    payloads = self._actor.slice_step(sl, out)
                note["env_step_ms"].append((time.perf_counter() - t0) * 1e3)
                for p in payloads:
                    self._submit(p)
        finally:
            if fut is not None:
                # A step/submit error left one act in flight: settle it
                # before anyone else (the demoted sequential loop, the
                # next round) touches that slice's state. A SUCCESSFUL
                # settle is then discarded — let the family undo any
                # act-time mutation of persistent slice state (the
                # xformer window push).
                undo = getattr(self._actor, "slice_discard_act", None)
                try:
                    discarded = fut.result(timeout=30.0)
                except Exception:  # noqa: BLE001  # drlint: disable=silent-except(settle error is secondary: the primary step/submit exception is already propagating past this finally, and the wedged latch demotes with its own log)
                    # Classify by fut.done(), NOT by exception type: on
                    # py3.10+ socket.timeout IS builtin TimeoutError, so
                    # an act that SETTLED with a socket timeout would
                    # otherwise be indistinguishable from the 30s settle
                    # deadline expiring with the worker still running.
                    if not fut.done():
                        self._wedged = True  # worker still owns that slice
                    elif undo is not None:
                        # The act RAISED after its act-time slice
                        # mutation (the xformer push precedes anything
                        # that can raise, by the hook's contract): undo
                        # it, with out=None since there is no output.
                        undo(slices[fut_idx], None)
                else:
                    if undo is not None:
                        undo(slices[fut_idx], discarded)
        for sl in slices:
            for p in self._actor.slice_end_round(sl):
                self._submit(p)
        if _OBS.enabled:
            for sl in slices:
                _OBS.count(f"pipe/slice{sl.index}_frames",
                           sl.env.num_envs * steps)
        return sum(sl.env.num_envs for sl in slices) * steps

    def _sequential_round(self, steps: int) -> int:
        """The demoted loop: same per-slice math, no overlap, inline
        puts — trajectory bytes identical to the pipelined path."""
        self._flush_backlog()
        self._actor.pipeline_sync_weights(self._slices)
        for sl in self._slices:
            self._actor.slice_begin_round(sl, steps)
        for _ in range(steps):
            for sl in self._slices:
                out = self._actor.slice_act(sl)
                for p in self._actor.slice_step(sl, out):
                    self._publish_inline(p)
        for sl in self._slices:
            for p in self._actor.slice_end_round(sl):
                self._publish_inline(p)
        self.rounds += 1
        return sum(sl.env.num_envs for sl in self._slices) * steps

    def _submit(self, payload) -> None:
        if not self._demoted:
            t0 = time.perf_counter()
            if self._publisher.submit(payload):
                self.stage_samples["put_wait_ms"].append(
                    (time.perf_counter() - t0) * 1e3)
                return
            self._demote("publisher thread died: "
                         + repr(self._publisher.error))
        # Demoted (possibly just now, mid-round): nothing is lost — the
        # backlog replays first, then this payload, inline.
        self._publish_inline(payload)

    def _publish_inline(self, payload) -> None:
        """Inline publication that can never drop the payload: it joins
        the backlog FIRST, so if the transport is still down the raise
        leaves it (and everything ahead of it, in order) in `_backlog`
        for the next round's replay — at-least-once, like the
        publisher's own peek-then-pop."""
        self._backlog.append(payload)
        if self._wedged:
            # The abandoned worker is still inside a put on this queue:
            # publishing concurrently would double-produce on an SPSC
            # ring. The payload stays in the backlog; run_round raises
            # the visible wedge error from here on.
            raise RuntimeError(
                "actor pipeline wedged: publisher still inside a put; "
                "cannot replay inline")
        self._flush_backlog()

    def _flush_backlog(self) -> None:
        while self._backlog:
            payload = self._backlog[0]
            self._publisher.publish_one(payload)
            self._backlog.pop(0)

    def _demote(self, reason: str) -> None:
        if self._demoted:
            return
        self._demoted = True
        self.demotions += 1
        if self._probe_open:
            self._probe_open = False
            self._ladder.note_failure()
        self._backlog.extend(self._publisher.drain())
        if self._publisher.stuck:
            self._wedged = True  # see _publish_inline: no inline replay
            #   while the abandoned worker still owns the queue's
            #   producer side
        print(f"[actor-pipe] demoted to the sequential per-slice loop: "
              f"{reason} ({len(self._backlog)} pending round(s) carried "
              f"over for inline replay)"
              + (" — publisher STUCK inside a put; pipeline latched "
                 "dead-visible" if self._wedged else ""), file=sys.stderr)
        if _OBS.enabled:
            _OBS.count("pipe/demotions")

    def _try_repromote(self) -> bool:
        if not self._ladder.try_acquire():
            return False
        self._publisher = UnrollPublisher(self._queue, self._depth).start()
        self._demoted = False
        self._probe_open = True  # success/failure noted at round end
        print("[actor-pipe] re-promoting: publisher restarted, overlapped "
              "stepping resumes", file=sys.stderr)
        return True

    def stage_stats(self) -> dict:
        """p50/p99 of the bounded overlap samples (bench.actor_compare's
        act/step/put overlap columns)."""
        out: dict = {}
        for name, samples in self.stage_samples.items():
            if not samples:
                continue
            vals = sorted(samples)
            out[name] = {
                "p50": round(vals[len(vals) // 2], 3),
                "p99": round(vals[min(int(0.99 * (len(vals) - 1) + 0.5),
                                      len(vals) - 1)], 3),
                "n": len(vals),
            }
        return out

    def close(self) -> None:
        """Drain the publisher and flush what it still held; best-effort
        (the transport may already be gone on the exit path)."""
        self._backlog.extend(self._publisher.drain())
        if self._publisher.stuck:
            self._wedged = True  # no inline flush over the worker's put
        try:
            if not self._wedged:
                self._flush_backlog()
        except Exception as e:  # noqa: BLE001 — exit path
            pass_reason = f"{type(e).__name__}: {e}"
        else:
            pass_reason = "publisher wedged inside a put" \
                if self._wedged else None
        if self._backlog and pass_reason:
            print(f"[actor-pipe] close: {len(self._backlog)} pending "
                  f"round(s) undeliverable ({pass_reason})",
                  file=sys.stderr)
        self._pool.shutdown(wait=not self._wedged)  # a wedged act never
        #   returns; don't hang the exit path behind it


# -- gate ---------------------------------------------------------------------

def pipeline_enabled() -> bool:
    """DRL_ACTOR_PIPE=1 forces the pipeline on, =0 off; unset takes
    `PIPELINE_DEFAULT`."""
    forced = os.environ.get("DRL_ACTOR_PIPE", "").strip()
    if forced == "1":
        return True
    if forced == "0":
        return False
    return PIPELINE_DEFAULT


def maybe_wrap(actor: Any, label: str = "actor",
               publisher_queue: Any = None) -> Any:
    """run_role's wiring point: wrap a slice-capable actor when the gate
    resolves on; otherwise (or when the env cannot slice) return the
    actor unchanged with a one-line reason."""
    if not pipeline_enabled():
        return actor
    env = getattr(actor, "env", None)
    if not hasattr(actor, "pipeline_make_slices") \
            or getattr(env, "envs", None) is None or env.num_envs < 2:
        print(f"[{label}] actor pipeline unavailable (needs a sliceable "
              f">=2-env BatchedEnv); keeping the sequential loop",
              file=sys.stderr)
        return actor
    pipe = ActorPipeline(actor, publisher_queue=publisher_queue)
    print(f"[{label}] pipelined data plane: {len(pipe._slices)} slices, "
          f"publisher depth {pipe._depth}"
          + (", dedicated put lane" if publisher_queue is not None else ""),
          file=sys.stderr)
    return pipe


# -- free-running actor threads (run_async) ----------------------------------

def run_actor_thread(actor: Any, stop: threading.Event,
                     round_fn: Callable[[], int] | None = None) -> None:
    """The shared run_async actor-thread body. Pre-PR-10 every runner's
    loop swallowed RuntimeError and returned — a dead actor thread was
    invisible until someone noticed the throughput dip. A death now
    logs the traceback and bumps the `actor/deaths` counter (visible in
    obs_report's throughput table); shutdown races (the queue closing
    under a blocked put once `stop` is set) stay quiet."""
    fn = round_fn or actor.run_unroll
    while not stop.is_set():
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — log, count, die visibly
            if stop.is_set():
                return  # shutdown race, not a death
            print(f"[actor] thread died: {type(e).__name__}: {e}",
                  file=sys.stderr)
            traceback.print_exc()
            _OBS.count("actor/deaths")
            return


def run_async_loop(learner: Any, actors: list, num_updates: int, queue: Any,
                   ingest_fn: Callable[[Any], bool],
                   round_fn: Callable[[Any], int] | None = None) -> dict:
    """The shared `run_async` skeleton (free-running actor threads + the
    ingest/train learner loop — run_role's learner loop collapsed to one
    process), parameterized the same way the runners differ:
    `ingest_fn(learner) -> bool` (anything ingested this tick?) and an
    optional per-actor `round_fn`. One copy of the stop/spawn/train/
    shutdown-ordering discipline for every family. Once every actor
    thread has died the learner raises (the JAX package's loop waits for
    data forever)."""
    stop = threading.Event()
    threads = [
        threading.Thread(
            target=run_actor_thread, args=(a, stop),
            kwargs={"round_fn": (None if round_fn is None
                                 else (lambda a=a: round_fn(a)))},
            daemon=True)
        for a in actors
    ]
    for t in threads:
        t.start()
    try:
        while learner.train_steps < num_updates:
            got = ingest_fn(learner)
            if learner.train() is None and not got:
                if not any(t.is_alive() for t in threads):
                    raise RuntimeError("run_async: every actor thread died")
                time.sleep(0.05)
    finally:
        stop.set()
        learner.close()
        queue.close()
        for t in threads:
            t.join(timeout=5.0)
    returns = [r for a in actors for r in a.episode_returns]
    return {"last_metrics": {}, "episode_returns": returns}
