"""IMPALA actor/learner loops.

Counterpart of the JAX package's `runtime/impala_runner.py`:

- `ImpalaActor`: N batched envs, one act call per timestep for all of
  them, a weight pull per unroll, life-loss shaping, T-step unroll
  accumulation, trajectory put with backpressure; and the slice
  protocol of the pipelined actor (`runtime/actor_pipeline.py`). With
  `remote_act` the acts go to a service (`runtime/inference.py`) as
  rows, the LSTM state stays here, and no weights are pulled.
- `ImpalaLearner`: drains a batch from the queue (through the device
  prefetcher when `prefetch`), runs one learn step, publishes versioned
  weights; stage timings, a profiler window, checkpoints. With
  `updates_per_call` K > 1 a call drains K batches and runs them as one
  `learn_many` (a partial drain trains its batches one by one).
- `run_sync`: deterministic interleaved actor/learner stepping (tests,
  single-process training). `run_async`: free-running actor threads and
  the learner loop in one process; the multi-process topology goes
  through `runtime/transport.py`.

Not ported: the mesh (ROADMAP item 13).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.agents.impala import ActOutput, ImpalaAgent
from distributed_reinforcement_learning_tpu_torch.data.fifo import (
    TrajectoryQueue, put_round, stack_pytrees, tree_map)
from distributed_reinforcement_learning_tpu_torch.data.structures import (
    ImpalaTrajectoryAccumulator, SlicedAccumulators)
from distributed_reinforcement_learning_tpu_torch.envs.batched import completed_returns
from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS
from distributed_reinforcement_learning_tpu_torch.runtime.actor_pipeline import (
    PipelineSlice, run_actor_thread, shape_life_loss, slice_seed, split_batched_env,
    sync_slices_params)
from distributed_reinforcement_learning_tpu_torch.runtime.publishing import PublishCadenceMixin
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore
from distributed_reinforcement_learning_tpu_torch.utils.logger import MetricsLogger
from distributed_reinforcement_learning_tpu_torch.utils.profiling import (
    ProfilerSession, StageTimer)


class ImpalaActor:
    def __init__(
        self,
        agent: ImpalaAgent,
        env,  # VectorEnv-like: reset() -> [N, ...], step([N]) -> obs, r, done, infos
        queue: TrajectoryQueue,
        weights: WeightStore,
        seed: int = 0,
        available_action: int | None = None,
        life_loss_shaping: bool = False,
        remote_act=None,  # a served act: row dict -> reply dict; no weight pulls
    ):
        self.agent = agent
        self.env = env
        self.queue = queue
        self.weights = weights
        self.available_action = available_action
        self.life_loss_shaping = life_loss_shaping
        self.remote_act = remote_act

        self._seed = seed  # slice seeds derive from it (actor_pipeline)
        self._generator = torch.Generator(device=agent.device).manual_seed(seed)
        self._obs = env.reset()
        n = self._obs.shape[0]
        self._prev_action = np.zeros(n, np.int32)
        self._h = np.zeros((n, agent.cfg.lstm_size), np.float32)
        self._c = np.zeros((n, agent.cfg.lstm_size), np.float32)
        self._params = None
        self._version = -1
        self._lives = np.full(n, -1)
        self.episode_returns: list[float] = []

    def _sync_params(self) -> None:
        """Per-unroll weight pull."""
        got = self.weights.get_if_newer(self._version)
        if got is not None:
            self._params, self._version = got

    def _act(self, params, obs, prev_action, h, c, generator) -> ActOutput:
        """One batched act -> host arrays: through the service when
        `remote_act` is set (the rows go, the actions and the advanced
        LSTM state come back), else the agent's act on its device."""
        if self.remote_act is not None:
            r = self.remote_act({"obs": obs, "prev_action": prev_action, "h": h, "c": c})
            return ActOutput(np.asarray(r["action"], np.int32), np.asarray(r["policy"]),
                             np.asarray(r["h"]), np.asarray(r["c"]))
        device = self.agent.device
        out = self.agent.act(
            params, torch.as_tensor(obs, device=device),
            torch.as_tensor(prev_action, device=device), torch.as_tensor(h, device=device),
            torch.as_tensor(c, device=device), generator)
        return ActOutput(out.action.cpu().numpy().astype(np.int32), out.policy.cpu().numpy(),
                         out.h.cpu().numpy(), out.c.cpu().numpy())

    def run_unroll(self) -> int:
        """Collect one T-step unroll from all N envs; enqueue N trajectories.

        Returns the number of env frames generated (N * T).
        """
        cfg = self.agent.cfg
        if self.remote_act is None:
            self._sync_params()
            if self._params is None:
                raise RuntimeError("no weights published yet")
        acc = ImpalaTrajectoryAccumulator()
        n = self._obs.shape[0]

        for _ in range(cfg.trajectory):
            out = self._act(self._params, self._obs, self._prev_action, self._h, self._c,
                            self._generator)
            actions = out.action
            env_actions = actions % self.available_action if self.available_action else actions
            next_obs, reward, done, infos = self.env.step(env_actions)

            rec_reward, rec_done = reward.astype(np.float32), done.copy()
            if self.life_loss_shaping:
                rec_reward, rec_done, self._lives = shape_life_loss(
                    self._lives, reward, done, infos)

            acc.append(
                state=self._obs,
                reward=rec_reward,
                done=rec_done,
                action=actions,
                behavior_policy=out.policy,
                previous_action=self._prev_action,
                initial_h=self._h,
                initial_c=self._c,
            )

            keep = (~done).astype(np.float32)[:, None]
            self._h = out.h * keep
            self._c = out.c * keep
            self._prev_action = np.where(done, 0, actions).astype(np.int32)
            self._obs = next_obs
            for ret in completed_returns(infos, done):
                self.episode_returns.append(float(ret))

        with _OBS.span("actor_put"):
            put_round(self.queue, acc.extract())
        return n * cfg.trajectory

    # -- slice protocol (runtime/actor_pipeline.py) --------------------
    # Each slice runs the sequential loop's per-step math over its own
    # env subset, generator, carry and accumulator.

    def pipeline_round_steps(self) -> int:
        return self.agent.cfg.trajectory

    def pipeline_make_slices(self, k: int) -> list[PipelineSlice]:
        self._slice_accs = SlicedAccumulators(ImpalaTrajectoryAccumulator, k)
        slices = []
        lo = 0
        for i, env in enumerate(split_batched_env(self.env, k)):
            hi = lo + env.num_envs
            seed = slice_seed(self._seed, i)
            slices.append(PipelineSlice(
                i, env, seed,
                generator=torch.Generator(device=self.agent.device).manual_seed(seed),
                obs=self._obs[lo:hi].copy(),
                prev_action=np.zeros(env.num_envs, np.int32),
                h=np.zeros((env.num_envs, self.agent.cfg.lstm_size), np.float32),
                c=np.zeros((env.num_envs, self.agent.cfg.lstm_size), np.float32),
                lives=np.full(env.num_envs, -1),
            ))
            lo = hi
        return slices

    # One weights pull per round, shared by all slices.
    pipeline_sync_weights = sync_slices_params

    def slice_begin_round(self, sl: PipelineSlice, steps: int) -> None:
        if self.remote_act is None and sl.params is None:
            raise RuntimeError("no weights published yet")
        self._slice_accs.reset_slice(sl.index)

    def slice_act(self, sl: PipelineSlice) -> ActOutput:
        """Runs on the pipeline's act worker; returns host arrays."""
        return self._act(sl.params, sl.obs, sl.prev_action, sl.h, sl.c, sl.generator)

    def slice_step(self, sl: PipelineSlice, out: ActOutput) -> tuple:
        actions = out.action
        env_actions = actions % self.available_action if self.available_action else actions
        next_obs, reward, done, infos = sl.env.step(env_actions)
        rec_reward, rec_done = reward.astype(np.float32), done.copy()
        if self.life_loss_shaping:
            rec_reward, rec_done, sl.lives = shape_life_loss(sl.lives, reward, done, infos)
        self._slice_accs.append_slice(
            sl.index, state=sl.obs, reward=rec_reward, done=rec_done, action=actions,
            behavior_policy=out.policy, previous_action=sl.prev_action,
            initial_h=sl.h, initial_c=sl.c)
        keep = (~done).astype(np.float32)[:, None]
        sl.h = out.h * keep
        sl.c = out.c * keep
        sl.prev_action = np.where(done, 0, actions).astype(np.int32)
        sl.obs = next_obs
        for ret in completed_returns(infos, done):
            sl.episode_returns.append(float(ret))
        return ()

    def slice_end_round(self, sl: PipelineSlice) -> tuple:
        return (("round", self._slice_accs.extract_slice(sl.index)),)


class ImpalaLearner(PublishCadenceMixin):
    def __init__(
        self,
        agent: ImpalaAgent,
        queue: TrajectoryQueue,
        weights: WeightStore,
        batch_size: int,
        logger: MetricsLogger | None = None,
        seed: int = 0,
        publish_interval: int = 1,
        prefetch: bool = False,
        updates_per_call: int = 1,
    ):
        """`seed` seeds the initial parameters (the JAX learner's `rng`;
        this learner has no replay). `updates_per_call` K > 1 runs K
        optimizer steps a call, with weights published at K-step
        granularity."""
        self.agent = agent
        self.queue = queue
        self.weights = weights
        self.batch_size = batch_size
        self.updates_per_call = max(1, int(updates_per_call))
        self.logger = logger or MetricsLogger(None)
        self.publish_interval = max(1, publish_interval)
        # Double-buffered host->device pipeline: batch k+1 is dequeued,
        # stacked and copied while batch k trains (with K > 1 the K
        # batches of the next call, as one stack). Off in run_sync (a
        # background consumer would race the deterministic interleave).
        self.prefetcher = None
        if prefetch:
            from distributed_reinforcement_learning_tpu_torch.data.prefetch import (
                DevicePrefetcher)

            self.prefetcher = DevicePrefetcher(queue, batch_size, agent.device,
                                               stack_calls=self.updates_per_call)
        self.state = agent.init_state(seed)
        self.train_steps = 0
        self.frames_learned = 0
        self.timer = StageTimer(self.logger)
        self._profiler = ProfilerSession.from_env()
        weights.publish(self.state.params, 0)

    def _learn(self, state, batch):
        """The seam every K = 1 learn step goes through (the agent's
        `learn`); the learner tier rebinds it, and `_learn_many`, on the
        instance (`runtime/learner_tier.LearnerTier.attach`)."""
        return self.agent.learn(state, batch)

    def _learn_many(self, state, batch):
        return self.agent.learn_many(state, batch)

    def save_checkpoint(self, ckpt) -> None:
        """Persist the train state and the host counters."""
        ckpt.save(self.train_steps, self.state,
                  {"train_steps": self.train_steps, "frames_learned": self.frames_learned})

    def restore_checkpoint(self, ckpt) -> bool:
        """Resume from the latest checkpoint; republishes the restored
        weights."""
        got = ckpt.restore(self.state)
        if got is None:
            return False
        self.state, extra, _ = got
        self.train_steps = int(extra.get("train_steps", 0))
        self.frames_learned = int(extra.get("frames_learned", 0))
        self.weights.publish(self.state.params, self.train_steps)
        self._last_publish_step = self.train_steps  # the line above IS a publish
        return True

    def step(self, timeout: float | None = None) -> dict | None:
        """One train call: drain a batch (K batches with `updates_per_call`
        K), learn, publish. -> the last step's metrics (host floats on
        publish steps unless the metrics pump owns them, device tensors
        otherwise), or None when no batch arrived within `timeout`.

        With K > 1 one deadline bounds the K dequeues; a full drain runs
        as one `learn_many`, a partial one trains its batches one by one
        (never dropped), and `train_steps` counts the steps taken."""
        k = self.updates_per_call
        parts: list = []
        with self.timer.stage("dequeue"):
            if self.prefetcher is not None:
                batch = self.prefetcher.get_batch(timeout=timeout)
            elif k > 1:
                deadline = None if timeout is None else time.monotonic() + timeout
                while len(parts) < k:
                    left = None if deadline is None else max(0.0, deadline - time.monotonic())
                    b = self.queue.get_batch(self.batch_size, timeout=left)
                    if b is None:
                        break
                    parts.append(b)
                batch = stack_pytrees(parts) if len(parts) == k else None
            else:
                batch = self.queue.get_batch(self.batch_size, timeout=timeout)
        if batch is None and not parts:
            return None
        steps_done = k if batch is not None else len(parts)
        with self.timer.stage("learn"):
            if k > 1 and batch is not None:
                self.state, stacked = self._learn_many(self.state, batch)
                metrics = tree_map(lambda x: x[-1], stacked)
            elif k > 1:
                for b in parts:
                    self.state, metrics = self._learn(self.state, b)
            else:
                self.state, metrics = self._learn(self.state, batch)
        frames = steps_done * self.batch_size * self.agent.cfg.trajectory
        self.train_steps += steps_done
        self.frames_learned += frames
        if _OBS.enabled:
            _OBS.count("learner/train_steps", steps_done)
            _OBS.count("learner/frames_learned", frames)
        if self.maybe_publish():
            metrics = self.log_step_metrics(metrics)
        self.timer.step_done(self.train_steps)
        self._profiler.on_step(self.train_steps)
        return metrics

    def close(self) -> None:
        """Flush publication and metrics, stop the prefetch thread, close
        an open profiler window. Called by every run path on exit."""
        self.flush_publish()
        self.close_metrics()
        if self.prefetcher is not None:
            self.prefetcher.close()
        self._profiler.close()
        self.logger.close()


def run_sync(
    learner: ImpalaLearner,
    actors: list[ImpalaActor],
    num_updates: int,
    close_learner: bool = True,
) -> dict:
    """Deterministic interleaving: actors fill the queue, learner drains it.

    The queue must absorb one full actor round past the batch size, or
    puts would block with no consumer running.
    """
    learner.sync_publish = True  # deterministic staleness in the sync loop
    production_per_round = sum(a.env.num_envs for a in actors)
    # A learner draining K batches a call (`updates_per_call`) needs K
    # full batches queued before its step can complete.
    need = learner.batch_size * learner.updates_per_call
    if learner.queue.capacity < need + production_per_round:
        raise ValueError(
            "sync mode needs queue capacity >= batch_size*updates_per_call "
            f"+ one actor round ({need} + {production_per_round})"
        )
    frames = 0
    metrics: dict = {}
    try:
        while learner.train_steps < num_updates:
            while learner.queue.size() < need:
                for actor in actors:
                    frames += actor.run_unroll()
            m = learner.step(timeout=10.0)
            if m is not None:
                metrics = m
    finally:
        if close_learner:
            learner.close()
    returns = [r for a in actors for r in a.episode_returns]
    metrics = {k: float(v) for k, v in metrics.items()}
    return {"frames": frames, "last_metrics": metrics, "episode_returns": returns}


def run_async(learner: ImpalaLearner, actors: list[ImpalaActor], num_updates: int,
              queue: TrajectoryQueue) -> dict:
    """Free-running actor threads + the learner loop in one process. A
    dying actor thread logs its traceback (`run_actor_thread`); once every
    one has died, the learner raises instead of waiting for data forever."""
    stop = threading.Event()
    threads = [threading.Thread(target=run_actor_thread, args=(a, stop), daemon=True)
               for a in actors]
    for t in threads:
        t.start()
    try:
        while learner.train_steps < num_updates:
            if (learner.step(timeout=5.0) is None
                    and not any(t.is_alive() for t in threads)):
                raise RuntimeError("run_async: every actor thread died")
    finally:
        stop.set()
        learner.close()
        queue.close()
        for t in threads:
            t.join(timeout=5.0)
    returns = [r for a in actors for r in a.episode_returns]
    return {"last_metrics": {}, "episode_returns": returns}
