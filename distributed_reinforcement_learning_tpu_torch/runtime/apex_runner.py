"""Ape-X actor/learner loops.

Counterpart of the JAX package's `runtime/apex_runner.py`:

- `ApexActor`: N batched envs, epsilon-greedy acts with a per-env
  epsilon `1 / (0.05 * episodes + 1)`, life-loss shaping for Atari
  names, a local uniform buffer of 10,000 transitions; once it holds
  more than 3 unrolls, every env step puts one `unroll_size`
  re-sample of it (or `DRL_PUT_BATCH` of them in one exchange). It has
  the pipelined actor's slice protocol (`runtime/actor_pipeline.py`).
  With `remote_act` its acts go to a service as rows (its epsilon
  schedule with them) and it pulls no weights.
- `ApexLearner`: drains unrolls (K of them in one `[K * 32]` TD
  forward, `DRL_APEX_INGEST_UNROLLS`), inserts each transition into the
  prioritized replay with its |TD|, trains with IS weights once
  `train_start_unrolls` unrolls arrived, re-prioritises every sampled
  index, and syncs the target every `target_sync_interval` steps
  (`runtime/replay_train.py`). With a `replay_service` (the sharded
  replay `run_role` builds by default) the transport's threads ingest
  into its shards and the learner samples from it while it is healthy;
  the monolithic replay is always built, as the demotion target.
  `updates_per_call` K > 1 runs K updates a call
  (`replay_train.prioritized_train_call`). On CUDA the ingest is pipelined one
  deep: unroll k's H2D copy and TD forward are enqueued, then k-1's TD
  is read back and added to the replay. Stage timings, a profiler
  window, checkpoints with a replay snapshot.
- `run_sync`: deterministic interleaved stepping (tests, single-process
  training); `run_async`: actor threads and the learner loop in one
  process. A free-running learner (`run_async`, `--mode learner`) makes
  at most `DRAIN_CAP` ingest calls between train calls, where the JAX
  package's solo learner drains until the queue is empty.

Not ported: the mesh (ROADMAP item 13).
"""

from __future__ import annotations

import os
import sys
from typing import Any

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexAgent, ApexBatch
from distributed_reinforcement_learning_tpu_torch.agents.common import batch_to_device
from distributed_reinforcement_learning_tpu_torch.data.fifo import (
    TrajectoryQueue, put_batch_size, put_round, stack_pytrees, tree_map)
from distributed_reinforcement_learning_tpu_torch.data.replay import (
    UniformBuffer, describe_replay, make_replay)
from distributed_reinforcement_learning_tpu_torch.envs.batched import completed_returns
from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS
from distributed_reinforcement_learning_tpu_torch.runtime.actor_pipeline import (
    PipelineSlice, run_async_loop, shape_life_loss, slice_seed, split_batched_env)
from distributed_reinforcement_learning_tpu_torch.runtime.publishing import PublishCadenceMixin
from distributed_reinforcement_learning_tpu_torch.runtime.replay_train import (
    ReplayTrainMixin, device_train_call, prioritized_train_call)
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore
from distributed_reinforcement_learning_tpu_torch.utils.logger import MetricsLogger
from distributed_reinforcement_learning_tpu_torch.utils.profiling import (
    ProfilerSession, StageTimer)


class ApexActor:
    def __init__(
        self,
        agent: ApexAgent,
        env,  # VectorEnv-like: reset() -> [N, ...], step([N]) -> obs, r, done, infos
        queue: TrajectoryQueue,
        weights: WeightStore,
        seed: int = 0,
        unroll_size: int = 32,  # "trajectory" in the apex section
        local_capacity: int = 10_000,
        warmup_factor: int = 3,  # puts start once len > 3 * unroll_size
        epsilon_decay: float = 0.05,
        sync_every_steps: int = 100,
        life_loss_shaping: bool = False,
        remote_act=None,  # a served act: row dict -> reply dict; no weight pulls
    ):
        self.agent = agent
        self.env = env
        self.queue = queue
        self.weights = weights
        self.remote_act = remote_act
        self.unroll_size = unroll_size
        self.warmup = warmup_factor * unroll_size
        self.epsilon_decay = epsilon_decay
        self.sync_every_steps = sync_every_steps
        self.life_loss_shaping = life_loss_shaping

        self._seed = seed  # slice seeds derive from it (actor_pipeline)
        self._local_capacity = local_capacity
        self._generator = torch.Generator(device=agent.device).manual_seed(seed)
        self._buffer = UniformBuffer(local_capacity, seed=seed)
        self._obs = env.reset()
        n = self._obs.shape[0]
        self._prev_action = np.zeros(n, np.int32)
        self._episodes = np.zeros(n, np.int64)
        self._lives = np.full(n, -1)
        self._params = None
        self._version = -1
        self._steps = 0
        self.episode_returns: list[float] = []

    @property
    def epsilon(self) -> np.ndarray:
        """Per-env epsilon from per-env episode counts."""
        return 1.0 / (self.epsilon_decay * self._episodes + 1.0)

    def _sync_params(self) -> None:
        got = self.weights.get_if_newer(self._version)
        if got is not None:
            self._params, self._version = got

    def _act(self, params, obs: np.ndarray, prev_action: np.ndarray, epsilon: np.ndarray,
             generator: torch.Generator) -> np.ndarray:
        if self.remote_act is not None:
            # The epsilon schedule stays with the actor: it rides the rows.
            r = self.remote_act({"obs": obs, "prev_action": prev_action,
                                 "epsilon": np.asarray(epsilon, np.float32)})
            return np.asarray(r["action"], np.int32)
        device = self.agent.device
        action, _ = self.agent.act(
            params, torch.as_tensor(obs, device=device),
            torch.as_tensor(prev_action, device=device),
            torch.as_tensor(epsilon, dtype=torch.float32, device=device), generator)
        return action.cpu().numpy().astype(np.int32)

    def _record(self, buffer: UniformBuffer, obs, next_obs, prev_action, actions, reward,
                done, infos, lives):
        """Append the step's transitions to `buffer` (life-loss shaped
        where asked) -> the envs' lives for the next step."""
        rec_reward, rec_done = reward.astype(np.float32), done.copy()
        if self.life_loss_shaping:
            rec_reward, rec_done, lives = shape_life_loss(lives, reward, done, infos)
        for i in range(obs.shape[0]):
            buffer.append(ApexBatch(state=obs[i], next_state=next_obs[i],
                                    previous_action=prev_action[i], action=actions[i],
                                    reward=rec_reward[i], done=rec_done[i]))
        return lives

    def run_steps(self, num_steps: int) -> int:
        """Step the envs `num_steps` times, putting buffer re-samples once
        warm; -> env frames. `DRL_PUT_BATCH=k` gathers k re-sampled
        unrolls into one batched exchange; unset puts one a step.
        Pending unrolls are put before a normal return; an error mid-round
        drops them (they are re-samples, not the only copy)."""
        if self.remote_act is None:
            if self._steps % self.sync_every_steps == 0 or self._params is None:
                self._sync_params()
            if self._params is None:
                raise RuntimeError("no weights published yet")
        put_batch = max(1, put_batch_size())
        pending: list = []

        for _ in range(num_steps):
            actions = self._act(self._params, self._obs, self._prev_action, self.epsilon,
                                self._generator)
            next_obs, reward, done, infos = self.env.step(actions)
            self._lives = self._record(self._buffer, self._obs, next_obs, self._prev_action,
                                       actions, reward, done, infos, self._lives)
            self._episodes += done
            for ret in completed_returns(infos, done):
                self.episode_returns.append(float(ret))
            self._prev_action = np.where(done, 0, actions).astype(np.int32)
            self._obs = next_obs
            self._steps += 1

            if len(self._buffer) > self.warmup:
                unroll = stack_pytrees(self._buffer.sample(self.unroll_size))
                if put_batch <= 1:
                    with _OBS.span("actor_put"):
                        self.queue.put(unroll)
                else:
                    pending.append(unroll)
                    if len(pending) >= put_batch:
                        with _OBS.span("actor_put"):
                            put_round(self.queue, pending)
                        pending.clear()
        if pending:
            with _OBS.span("actor_put"):
                put_round(self.queue, pending)
        return num_steps * self._obs.shape[0]

    # -- slice protocol (runtime/actor_pipeline.py) --------------------
    # A slice mirrors run_steps over its own envs, generator, local
    # buffer (with its own re-sample stream) and epsilon schedule; the
    # unit of publication is the per-step re-sample (or the
    # DRL_PUT_BATCH round), the sequential shapes.

    def pipeline_round_steps(self) -> None:
        return None  # step-driven family: the caller passes run_steps(n)

    def pipeline_make_slices(self, k: int) -> list[PipelineSlice]:
        total = self.env.num_envs
        slices = []
        lo = 0
        for i, env in enumerate(split_batched_env(self.env, k)):
            hi = lo + env.num_envs
            seed = slice_seed(self._seed, i)
            # Warm-up and capacity scale by the slice's share of the envs
            # (rounded up), so a slice starts putting when the whole actor
            # would and keeps the same window.
            frac_w = -(-self.warmup * env.num_envs // total)
            frac_cap = max(self.unroll_size, -(-self._local_capacity * env.num_envs // total))
            slices.append(PipelineSlice(
                i, env, seed,
                generator=torch.Generator(device=self.agent.device).manual_seed(seed),
                buffer=UniformBuffer(frac_cap, seed=seed),
                warmup=frac_w,
                obs=self._obs[lo:hi].copy(),
                prev_action=np.zeros(env.num_envs, np.int32),
                episodes=np.zeros(env.num_envs, np.int64),
                lives=np.full(env.num_envs, -1),
                steps=0,
                pending=[],
            ))
            lo = hi
        return slices

    def pipeline_sync_weights(self, slices: list) -> None:
        """One weights pull a round for every due slice, on the
        sequential loop's `sync_every_steps` cadence (slices step in
        lockstep, so they are due together); none with `remote_act`."""
        if self.remote_act is not None:
            return
        due = [sl for sl in slices
               if sl.steps % self.sync_every_steps == 0 or sl.params is None]
        if not due:
            return
        self._sync_params()
        if self._params is None:
            raise RuntimeError("no weights published yet")
        for sl in due:
            if sl.version < self._version:
                sl.params, sl.version = self._params, self._version

    def slice_begin_round(self, sl: PipelineSlice, steps: int) -> None:
        if self.remote_act is None and sl.params is None:
            raise RuntimeError("no weights published yet")
        sl.put_batch = max(1, put_batch_size())
        sl.pending = []

    def slice_act(self, sl: PipelineSlice) -> np.ndarray:
        epsilon = 1.0 / (self.epsilon_decay * sl.episodes + 1.0)
        return self._act(sl.params, sl.obs, sl.prev_action, epsilon, sl.generator)

    def slice_step(self, sl: PipelineSlice, actions: np.ndarray) -> tuple:
        next_obs, reward, done, infos = sl.env.step(actions)
        sl.lives = self._record(sl.buffer, sl.obs, next_obs, sl.prev_action, actions, reward,
                                done, infos, sl.lives)
        sl.episodes += done
        for ret in completed_returns(infos, done):
            sl.episode_returns.append(float(ret))
        sl.prev_action = np.where(done, 0, actions).astype(np.int32)
        sl.obs = next_obs
        sl.steps += 1
        if len(sl.buffer) > sl.warmup:
            unroll = stack_pytrees(sl.buffer.sample(self.unroll_size))
            if sl.put_batch <= 1:
                return (("put", unroll),)
            sl.pending.append(unroll)
            if len(sl.pending) >= sl.put_batch:
                payload = ("round", sl.pending)
                sl.pending = []
                return (payload,)
        return ()

    def slice_end_round(self, sl: PipelineSlice) -> tuple:
        if sl.pending:
            payload = ("round", sl.pending)
            sl.pending = []
            return (payload,)
        return ()


class ApexLearner(PublishCadenceMixin, ReplayTrainMixin):
    def __init__(
        self,
        agent: ApexAgent,
        queue: TrajectoryQueue,
        weights: WeightStore,
        batch_size: int = 32,
        replay_capacity: int = 100_000,
        target_sync_interval: int = 100,
        train_start_unrolls: int = 10,
        logger: MetricsLogger | None = None,
        seed: int = 0,
        publish_interval: int = 1,
        updates_per_call: int = 1,
        replay_service=None,
        init_seed: int = 0,
    ):
        """`init_seed` seeds the initial parameters (the JAX learner's
        `rng`, default `PRNGKey(0)`); `seed` seeds only the replay's
        sampling stream `RandomState(seed)`, as the JAX learner's does."""
        self.agent = agent
        self.queue = queue
        self.weights = weights
        self.batch_size = batch_size
        # The monolithic replay is always built: the normal path without
        # shards, and the demotion target when the service loses them all.
        self.replay = make_replay(replay_capacity)
        self.replay_service = replay_service
        print(f"[apex learner] replay: {describe_replay(self.replay)}", file=sys.stderr,
              flush=True)
        self.target_sync_interval = target_sync_interval
        self._init_stride(updates_per_call)
        self.train_start_unrolls = train_start_unrolls
        self.logger = logger or MetricsLogger(None)
        self.init_seed, self.replay_seed = init_seed, seed  # logged by the runs
        self.state = agent.sync_target(agent.init_state(init_seed))
        self._np_rng = np.random.RandomState(seed)
        self.publish_interval = max(1, publish_interval)
        self.ingested_unrolls = 0
        self.train_steps = 0
        # One-deep ingest pipeline: None = on where there is a transfer to
        # hide (CUDA), off on the CPU; tests force it either way.
        self.ingest_pipeline: bool | None = None
        # Unrolls scored in one TD forward (DRL_APEX_INGEST_UNROLLS, the
        # JAX package's knob and default), read once here so that a bad
        # value fails at construction.
        self.ingest_unrolls = int(os.environ.get("DRL_APEX_INGEST_UNROLLS", "1"))
        if self.ingest_unrolls < 1:
            raise ValueError(f"DRL_APEX_INGEST_UNROLLS must be >= 1, got {self.ingest_unrolls}")
        self._pending_ingest: tuple[torch.Tensor, Any, int] | None = None
        self.timer = StageTimer(self.logger)
        self._profiler = ProfilerSession.from_env()
        weights.publish(self.state.params, 0)

    def _warm_unrolls(self) -> int:
        """Unrolls counted by the warm-up gate: the shards' ingest while
        the service is healthy, or this learner's own queue-path ingest
        (both feed training after a demotion)."""
        svc = self.replay_service
        shard_blobs = svc.ingested_blobs() if svc is not None and svc.healthy else 0
        return max(self.ingested_unrolls, shard_blobs)

    def save_checkpoint(self, ckpt) -> None:
        """Persist the train state, the host counters (the sampling
        stream's state among them) and a replay snapshot (gated by
        `DRL_CKPT_REPLAY*`, utils/checkpoint.py): the active replay's,
        which for the service is its merged shard state with the pending
        priority updates applied. Unrolls still in the ingest pipeline
        enter the replay first."""
        from distributed_reinforcement_learning_tpu_torch.utils.checkpoint import (
            encode_replay_snapshot)

        self._flush_pending_ingest()
        replay = self._active_replay()
        blob = encode_replay_snapshot(replay)
        ckpt.save(self.train_steps, self.state, {
            "train_steps": self.train_steps,
            "replay_beta": float(replay.beta),
            "ingested_unrolls": self._warm_unrolls(),
            **self._cadence_extra(),
        }, blobs={"replay": blob} if blob is not None else None)

    def restore_checkpoint(self, ckpt) -> bool:
        """Resume from the latest checkpoint (the replay too, when its
        snapshot was kept); republishes the restored weights."""
        from distributed_reinforcement_learning_tpu_torch.utils.checkpoint import (
            decode_replay_snapshot)

        got = ckpt.restore(self.state)
        if got is None:
            return False
        self.state, extra, step = got
        self.train_steps = int(extra.get("train_steps", 0))
        replay = self._active_replay()
        blob = ckpt.load_blob(step, "replay")
        if blob is not None:
            replay.restore(decode_replay_snapshot(blob))
            self.ingested_unrolls = int(extra.get("ingested_unrolls", 0))
        else:
            self.ingested_unrolls = 0  # the warm-up gate restarts; the replay refills
        replay.beta = float(extra.get("replay_beta", replay.beta))
        self.weights.publish(self.state.params, self.train_steps)
        self._restore_cadence(extra)
        return True

    def ingest(self, timeout: float | None = 0.0) -> bool:
        """Drain one unroll, score its transitions, insert them."""
        return self.ingest_many(max_unrolls=1, timeout=timeout) > 0

    def ingest_many(self, max_unrolls: int | None = None,
                    timeout: float | None = 0.0) -> int:
        """Drain up to `max_unrolls` unrolls (default
        `DRL_APEX_INGEST_UNROLLS`, 1) and score them in ONE TD forward over
        `[K * unroll]` transitions; -> the unrolls that entered the replay.
        K snaps down to a power of two, so the forward sees few shapes.

        Pipelined, the call loops until it can report a completed unroll
        or the queue is empty, so a 0 return always means nothing is left
        (the first call may pop two chunks)."""
        if max_unrolls is None:
            max_unrolls = self.ingest_unrolls
        pipeline = self.ingest_pipeline
        if pipeline is None:
            pipeline = self.agent.device.type == "cuda"
        done = 0
        while True:
            with self.timer.stage("ingest_dequeue"):
                k = 1
                while k * 2 <= min(self.queue.size(), max_unrolls):
                    k *= 2
                stacked = self.queue.get_batch(k, timeout=timeout)
            if stacked is None:
                return done + self._flush_pending_ingest()
            with self.timer.stage("ingest_td"):
                # [K, U, ...] -> [K * U, ...]: one forward for all of them.
                flat = tree_map(lambda x: np.asarray(x).reshape(-1, *np.shape(x)[2:]), stacked)
                if pipeline:
                    # Enqueue k's H2D copy and TD forward (against the
                    # state as it is now: a later in-place step is ordered
                    # after it on the stream), then complete k-1.
                    td_dev = self.agent.td_error(
                        self.state, batch_to_device(flat, self.agent.device))
                    done += self._flush_pending_ingest()
                    self._pending_ingest = (td_dev, flat, k)
                    if done:
                        return done
                    continue
                # Deliberate sync: the priorities go into the host sum tree.
                td = self.agent.td_error(self.state, flat).cpu().numpy()
            self._replay_add(td, flat)
            self.ingested_unrolls += k
            return done + k

    def _replay_add(self, td: np.ndarray, flat) -> None:
        with self.timer.stage("ingest_replay_add"):
            if getattr(self.replay, "stacked_samples", False):
                self.replay.add_batch_stacked(td, flat)
            else:
                self.replay.add_batch(
                    td, [tree_map(lambda x: x[i], flat) for i in range(len(td))])

    def _flush_pending_ingest(self) -> int:
        """Read back the TD in flight and add its unrolls to the replay;
        -> the unrolls completed (0 if none was pending)."""
        if self._pending_ingest is None:
            return 0
        td_dev, flat, k = self._pending_ingest
        self._pending_ingest = None
        with self.timer.stage("ingest_td_sync"):
            td = td_dev.cpu().numpy()
        self._replay_add(td, flat)
        self.ingested_unrolls += k
        return k

    def train(self) -> dict | None:
        """One prioritized train call (K updates with `updates_per_call`
        K) once `train_start_unrolls` unrolls arrived; -> the last
        step's metrics (host floats, or device tensors the metrics pump
        owns), or None before warm-up and when the service lost its last
        shard mid-call (the next call takes the monolithic path)."""
        if self._warm_unrolls() < self.train_start_unrolls:
            return None
        replay = self._active_replay()
        if len(replay) == 0:
            # A demotion raced the warm gate: the monolithic replay is
            # still empty and refills through the demoted facade.
            return None
        metrics = self._train_guarded(replay)
        if metrics is None:
            return None
        self._finish_train_call()
        self.timer.step_done(self.train_steps)
        self._profiler.on_step(self.train_steps)
        return self.log_step_metrics(metrics)

    def _train_once(self, replay) -> dict | None:
        """Sample -> learn -> re-prioritise, against `replay`."""
        path = self._device_path_for(replay)
        if path is not None:
            # The fused device path: the gather, the stack and the H2D
            # copy ran on its thread, beside the previous call's learn.
            return device_train_call(self, path, replay)
        if self.updates_per_call > 1:
            return prioritized_train_call(self, self.updates_per_call, replay)
        with self.timer.stage("replay_sample"):
            items, idxs, is_weight = replay.sample(self.batch_size, self._np_rng)
            batch = items if getattr(replay, "stacked_samples", False) else stack_pytrees(items)
        with self.timer.stage("learn"):
            self.state, td, metrics = self._learn(self.state, batch, is_weight)
        with self.timer.stage("replay_update"):
            # Deliberate sync: re-prioritisation targets the host sum tree
            # (the service only enqueues; its router thread applies it).
            replay.update_batch(idxs, td.cpu().numpy())
        return metrics

    def close(self) -> None:
        self.flush_publish()
        self.close_metrics()
        self._close_device_path()  # join the gather thread
        self._profiler.close()
        self.logger.close()


# Ingest calls a free-running learner makes between two train calls (the
# JAX learner tier's bound, its `drain_cap`). Draining until the queue is
# empty, as the JAX package's solo learner does, starves training when the
# actors put faster than the learner ingests: a bounded queue under
# backpressure then never empties.
DRAIN_CAP = 8


def drain_ingest(learner: ApexLearner, timeout: float = 0.05) -> bool:
    """Up to `DRAIN_CAP` ingest calls, stopping early once the queue is
    empty; -> whether anything was ingested."""
    drained = False
    for _ in range(DRAIN_CAP):
        if not learner.ingest_many(timeout=timeout):
            break
        drained = True
    return drained


def run_sync(learner: ApexLearner, actors: list[ApexActor], num_updates: int,
             actor_steps_per_round: int = 8, close_learner: bool = True) -> dict:
    """Rounds of: every actor steps `actor_steps_per_round` times, the
    learner drains the queue, then trains once; until `num_updates`."""
    metrics: dict = {}
    frames = 0
    learner.sync_publish = True  # deterministic staleness in the sync loop
    try:
        while learner.train_steps < num_updates:
            for actor in actors:
                frames += actor.run_steps(actor_steps_per_round)
            while learner.ingest_many(timeout=0.0):
                pass
            m = learner.train()
            if m is not None:
                metrics = m
    finally:
        if close_learner:
            learner.close()
    returns = [r for a in actors for r in a.episode_returns]
    metrics = {k: float(v) for k, v in metrics.items()}
    return {"frames": frames, "last_metrics": metrics, "episode_returns": returns}


def run_async(learner: ApexLearner, actors: list[ApexActor], num_updates: int,
              queue: TrajectoryQueue, actor_steps_per_round: int = 8) -> dict:
    """Free-running actor threads + the ingest/train learner loop in one
    process (`actor_pipeline.run_async_loop`; `drain_ingest` between train
    calls)."""
    return run_async_loop(learner, actors, num_updates, queue, ingest_fn=drain_ingest,
                          round_fn=lambda a: a.run_steps(actor_steps_per_round))
