"""R2D2 actor/learner loops.

Counterpart of the JAX package's `runtime/r2d2_runner.py`, sequential
path only:

- `R2D2Actor`: N batched envs (CartPole-POMDP through `obs_transform`),
  per-env epsilon `max(1/(0.1*episode+1), floor)`, seq_len unrolls that
  carry the sequence-start LSTM state, a weight pull per unroll.
- `R2D2Learner`: family-neutral over the sequence-replay agents (the
  R2D2 agent, and the transformer agent through
  `runtime/xformer_runner.py`): it only calls the agent's `init_state`,
  `td_error`, `learn`, `learn_many` and `sync_target` and stacks
  whatever sequence tuples arrive. It drains sequences and scores their
  priorities in one `td_error` call (padded to a power of two), inserts
  them into the replay of `make_replay(backend="auto")` (the array
  backend over the native sum tree wherever it builds, as the JAX
  learner), trains with
  IS weights once 2 x batch sequences have arrived, re-prioritises
  every sampled index, and syncs the target every
  `target_sync_interval` steps (`runtime/replay_train.py`). With a
  `replay_service` (the sharded replay `run_role` builds by default)
  the transport's threads ingest into its shards, scored there, and the
  learner samples from it while it is healthy; the monolithic replay
  is always built, as the demotion target. `updates_per_call` K > 1
  runs K updates a call (`replay_train.prioritized_train_call`).
- `run_sync`: deterministic interleaved stepping (tests, single-process
  training). `run_async`: free-running actor threads and the
  ingest/train learner loop in one process.

The actor has the pipeline's slice protocol and `timeout_nonterminal`;
the learner has stage timings, a profiler window, checkpoints (with a
replay snapshot) and the opt-in recent mix (`DRL_R2D2_RECENT_FRACTION`,
`DRL_R2D2_RECENT_WINDOW`). With `remote_act` the actor's acts go to a
service as rows (its LSTM state and epsilon with them; the advanced
state comes back) and it pulls no weights. With `mesh=` the learner is
one rank of a sharded learner (`parallel/learner.py`;
`ReplayTrainMixin._init_mesh`): it samples its own `batch_size / data`
rows, one update a call, and writes back its rows of the global
priorities.
"""

from __future__ import annotations

import collections
import os
import sys

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Agent
from distributed_reinforcement_learning_tpu_torch.data.fifo import (
    TrajectoryQueue, put_round, stack_pytrees, tree_map)
from distributed_reinforcement_learning_tpu_torch.data.replay import describe_replay, make_replay
from distributed_reinforcement_learning_tpu_torch.data.structures import (
    R2D2SequenceAccumulator, SlicedAccumulators)
from distributed_reinforcement_learning_tpu_torch.envs.batched import completed_returns
from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS
from distributed_reinforcement_learning_tpu_torch.runtime.actor_pipeline import (
    PipelineSlice, run_async_loop, shape_timeout, slice_seed, split_batched_env,
    sync_slices_params)
from distributed_reinforcement_learning_tpu_torch.runtime.publishing import PublishCadenceMixin
from distributed_reinforcement_learning_tpu_torch.runtime.replay_train import (
    ReplayTrainMixin, device_train_call, prioritized_train_call)
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore
from distributed_reinforcement_learning_tpu_torch.utils.logger import MetricsLogger
from distributed_reinforcement_learning_tpu_torch.utils.profiling import (
    ProfilerSession, StageTimer)


class R2D2Actor:
    def __init__(
        self,
        agent: R2D2Agent,
        env,  # VectorEnv over full observations
        queue: TrajectoryQueue,
        weights: WeightStore,
        seed: int = 0,
        epsilon_decay: float = 0.1,
        epsilon_floor: float = 0.0,  # 0 = reference parity
        # Record a time-limit truncation (env info `truncated`) as
        # non-terminal: done stays False in the recorded stream and the
        # LSTM carry and previous action continue across the env's reset.
        # False = reference parity.
        timeout_nonterminal: bool = False,
        obs_transform=None,  # e.g. envs.cartpole.pomdp_project
        remote_act=None,  # a served act: row dict -> reply dict; no weight pulls
    ):
        self.agent = agent
        self.env = env
        self.queue = queue
        self.weights = weights
        self.remote_act = remote_act
        self.epsilon_decay = epsilon_decay
        self.epsilon_floor = epsilon_floor
        self.timeout_nonterminal = timeout_nonterminal
        self.obs_transform = obs_transform or (lambda x: x)

        self._seed = seed  # slice seeds derive from it (actor_pipeline)
        self._generator = torch.Generator(device=agent.device).manual_seed(seed)
        self._obs = self.obs_transform(env.reset())
        n = self._obs.shape[0]
        self._prev_action = np.zeros(n, np.int32)
        self._h = np.zeros((n, agent.cfg.lstm_size), np.float32)
        self._c = np.zeros((n, agent.cfg.lstm_size), np.float32)
        self._episodes = np.zeros(n, np.int64)
        self._params = None
        self._version = -1
        self.episode_returns: list[float] = []

    @property
    def epsilon(self) -> np.ndarray:
        return np.maximum(1.0 / (self.epsilon_decay * self._episodes + 1.0), self.epsilon_floor)

    def _sync_params(self) -> None:
        got = self.weights.get_if_newer(self._version)
        if got is not None:
            self._params, self._version = got

    def _act(self, params, obs, h, c, prev_action, epsilon, generator) -> tuple:
        """One batched epsilon-greedy act -> host (action, h', c'): through
        the service when `remote_act` is set, else the agent's act."""
        if self.remote_act is not None:
            r = self.remote_act({"obs": obs, "h": h, "c": c, "prev_action": prev_action,
                                 "epsilon": np.asarray(epsilon, np.float32)})
            return np.asarray(r["action"], np.int32), np.asarray(r["h"]), np.asarray(r["c"])
        device = self.agent.device
        action, _, h, c = self.agent.act(
            params, torch.as_tensor(obs, device=device), torch.as_tensor(h, device=device),
            torch.as_tensor(c, device=device), torch.as_tensor(prev_action, device=device),
            torch.as_tensor(epsilon, dtype=torch.float32, device=device), generator)
        return action.cpu().numpy().astype(np.int32), h.cpu().numpy(), c.cpu().numpy()

    def run_unroll(self) -> int:
        """One seq_len unroll from all envs -> N sequences into the queue.
        Returns the number of env frames generated (N * seq_len)."""
        cfg = self.agent.cfg
        if self.remote_act is None:
            self._sync_params()
            if self._params is None:
                raise RuntimeError("no weights published yet")
        acc = R2D2SequenceAccumulator()
        acc.reset(self._h, self._c)
        n = self._obs.shape[0]

        for _ in range(cfg.seq_len):
            action, h, c = self._act(self._params, self._obs, self._h, self._c,
                                     self._prev_action, self.epsilon, self._generator)
            next_obs_raw, reward, done, infos = self.env.step(action)
            rec_done = shape_timeout(done, infos, self.timeout_nonterminal)

            acc.append(state=self._obs, previous_action=self._prev_action, action=action,
                       reward=reward.astype(np.float32), done=rec_done)

            keep = (~rec_done).astype(np.float32)[:, None]
            self._h = h * keep
            self._c = c * keep
            self._prev_action = np.where(rec_done, 0, action).astype(np.int32)
            self._obs = self.obs_transform(next_obs_raw)
            # Exploration anneals per recorded episode.
            self._episodes += rec_done
            for ret in completed_returns(infos, done):
                self.episode_returns.append(float(ret))

        with _OBS.span("actor_put"):
            put_round(self.queue, acc.extract())
        return n * cfg.seq_len

    # -- slice protocol (runtime/actor_pipeline.py) --------------------
    # The sequence-start LSTM state and the per-slice epsilon schedule
    # mirror run_unroll over the slice's own envs and generator.

    def pipeline_round_steps(self) -> int:
        return self.agent.cfg.seq_len

    def pipeline_make_slices(self, k: int) -> list[PipelineSlice]:
        self._slice_accs = SlicedAccumulators(R2D2SequenceAccumulator, k)
        h_size = self.agent.cfg.lstm_size
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
                h=np.zeros((env.num_envs, h_size), np.float32),
                c=np.zeros((env.num_envs, h_size), np.float32),
                episodes=np.zeros(env.num_envs, np.int64),
            ))
            lo = hi
        return slices

    pipeline_sync_weights = sync_slices_params

    def slice_begin_round(self, sl: PipelineSlice, steps: int) -> None:
        if self.remote_act is None and sl.params is None:
            raise RuntimeError("no weights published yet")
        self._slice_accs.reset_slice(sl.index, sl.h, sl.c)

    def slice_act(self, sl: PipelineSlice) -> tuple:
        epsilon = np.maximum(1.0 / (self.epsilon_decay * sl.episodes + 1.0), self.epsilon_floor)
        return self._act(sl.params, sl.obs, sl.h, sl.c, sl.prev_action, epsilon, sl.generator)

    def slice_step(self, sl: PipelineSlice, out: tuple) -> tuple:
        action, h, c = out
        next_obs_raw, reward, done, infos = sl.env.step(action)
        rec_done = shape_timeout(done, infos, self.timeout_nonterminal)
        self._slice_accs.append_slice(
            sl.index, state=sl.obs, previous_action=sl.prev_action, action=action,
            reward=reward.astype(np.float32), done=rec_done)
        keep = (~rec_done).astype(np.float32)[:, None]
        sl.h = h * keep
        sl.c = c * keep
        sl.prev_action = np.where(rec_done, 0, action).astype(np.int32)
        sl.obs = self.obs_transform(next_obs_raw)
        sl.episodes += rec_done
        for ret in completed_returns(infos, done):
            sl.episode_returns.append(float(ret))
        return ()

    def slice_end_round(self, sl: PipelineSlice) -> tuple:
        return (("round", self._slice_accs.extract_slice(sl.index)),)


class R2D2Learner(PublishCadenceMixin, ReplayTrainMixin):
    def __init__(
        self,
        agent,  # R2D2Agent or XformerAgent
        queue: TrajectoryQueue,
        weights: WeightStore,
        batch_size: int = 32,
        replay_capacity: int = 100_000,
        target_sync_interval: int = 100,
        logger: MetricsLogger | None = None,
        seed: int = 0,
        publish_interval: int = 1,
        updates_per_call: int = 1,
        replay_service=None,
        init_seed: int = 0,
        mesh=None,
    ):
        """`init_seed` seeds the initial parameters (the JAX learner's
        `rng`, default `PRNGKey(0)`); `seed` seeds only the replay's
        sampling stream `RandomState(seed)`, as the JAX learner's does.
        `mesh` (a `parallel/mesh.RankMesh` splitting the data) makes this
        one rank of a sharded learner (`ReplayTrainMixin._init_mesh`),
        one update a call."""
        self.agent = agent
        self.queue = queue
        self.weights = weights
        self.batch_size = batch_size
        # Recency-mixed sampling (opt-in, as in the JAX learner):
        # DRL_R2D2_RECENT_FRACTION=r replaces the last round(r*B) rows of
        # every prioritized batch with sequences drawn uniformly from the
        # most recent DRL_R2D2_RECENT_WINDOW ingests, at IS weight 1 (a
        # deliberate bias). It forces the list-backed replay, whose rows
        # are replaceable before stacking. The window is clamped to the
        # capacity, so a cached tree index is never a recycled slot.
        self.recent_fraction = float(os.environ.get("DRL_R2D2_RECENT_FRACTION", "0"))
        self._recent: collections.deque = collections.deque(maxlen=min(
            int(os.environ.get("DRL_R2D2_RECENT_WINDOW", str(8 * batch_size))),
            replay_capacity))
        # The monolithic replay is always built: the normal path without
        # shards, and the demotion target when the service loses them all.
        self.replay = make_replay(
            replay_capacity, backend="python" if self.recent_fraction > 0 else "auto")
        self.replay_service = replay_service
        if self.recent_fraction > 0 and updates_per_call > 1:
            raise ValueError("DRL_R2D2_RECENT_FRACTION does not compose with "
                             "updates_per_call > 1 (a K-update call samples its K batches "
                             "at once)")
        if self.recent_fraction > 0 and replay_service is not None:
            raise ValueError("DRL_R2D2_RECENT_FRACTION does not compose with "
                             "DRL_REPLAY_SHARDS (shard ingest bypasses the recent deque)")
        print(f"[r2d2 learner] replay: {describe_replay(self.replay)}", file=sys.stderr,
              flush=True)
        self.target_sync_interval = target_sync_interval
        self._init_stride(updates_per_call, mesh)
        self.logger = logger or MetricsLogger(None)
        self.init_seed, self.replay_seed = init_seed, seed  # logged by the runs
        self.state = self._init_mesh(mesh, init_seed)
        self._np_rng = np.random.RandomState(seed)
        self.publish_interval = max(1, publish_interval)
        self.ingested_sequences = 0
        self.train_steps = 0
        self.timer = StageTimer(self.logger)
        self._profiler = ProfilerSession.from_env()
        weights.publish(self.published_params(), 0)

    def _warm_sequences(self) -> int:
        """Sequences counted by the warm-up gate: the shards' ingest while
        the service is healthy, or this learner's own queue-path ingest."""
        svc = self.replay_service
        shard_blobs = svc.ingested_blobs() if svc is not None and svc.healthy else 0
        return max(self.ingested_sequences, shard_blobs)

    def save_checkpoint(self, ckpt) -> None:
        """Persist the train state, the host counters (the sampling
        stream's state among them) and a replay snapshot (gated by
        `DRL_CKPT_REPLAY*`, utils/checkpoint.py): the active replay's,
        which for the service is its merged shard state with the pending
        priority updates applied."""
        from distributed_reinforcement_learning_tpu_torch.utils.checkpoint import (
            encode_replay_snapshot)

        replay = self._active_replay()
        blob = encode_replay_snapshot(replay)
        ckpt.save(self.train_steps, self.state, {
            "train_steps": self.train_steps,
            "replay_beta": float(replay.beta),
            "ingested_sequences": self._warm_sequences(),
            **self._cadence_extra(),
        }, blobs={"replay": blob} if blob is not None else None, sharded=self._sharded)

    def restore_checkpoint(self, ckpt) -> bool:
        """Resume from the latest checkpoint (the replay too, when its
        snapshot was kept); republishes the restored weights."""
        from distributed_reinforcement_learning_tpu_torch.utils.checkpoint import (
            decode_replay_snapshot)

        got = ckpt.restore(self.state, sharded=self._sharded)
        if got is None:
            return False
        self.state, extra, step = got
        self._refresh_whole(self.state)
        self.train_steps = int(extra.get("train_steps", 0))
        replay = self._active_replay()
        blob = ckpt.load_blob(step, "replay")
        if blob is not None:
            replay.restore(decode_replay_snapshot(blob))
            self.ingested_sequences = int(extra.get("ingested_sequences", 0))
        else:
            self.ingested_sequences = 0  # the replay refills from live traffic
        replay.beta = float(extra.get("replay_beta", replay.beta))
        self.weights.publish(self.published_params(), self.train_steps)
        self._restore_cadence(extra)
        return True

    def ingest_batch(self, timeout: float | None = 0.0) -> int:
        """Drain up to batch_size sequences and score them in ONE batched
        td_error call; -> how many were ingested."""
        with self.timer.stage("ingest_dequeue"):
            seqs = []
            for _ in range(self.batch_size):
                seq = self.queue.get(timeout=timeout)
                if seq is None:
                    break
                seqs.append(seq)
        if not seqs:
            return 0
        # Pad the stack to the next power of two, capped at batch_size, so
        # the scoring call sees few distinct shapes. Padding rows copy row
        # 0; per-sequence math is batch-independent, so the real rows'
        # priorities do not depend on the padding.
        n = len(seqs)
        k = 1
        while k < n:
            k *= 2
        k = min(k, self.batch_size)
        with self.timer.stage("ingest_td"):
            batch = stack_pytrees(seqs + [seqs[0]] * (k - n))
            # Deliberate sync: the priorities go into the host sum tree.
            td = self.agent.td_error(self._scoring_state(), batch).cpu().numpy()[:n]
            if getattr(self.replay, "stacked_samples", False):
                # One slice assignment per field.
                self.replay.add_batch_stacked(td, tree_map(lambda x: x[:n], batch))
            else:
                new_idxs = self.replay.add_batch(td, seqs)
                if self.recent_fraction > 0:
                    self._recent.extend(zip(new_idxs, seqs))
        self.ingested_sequences += n
        return n

    def _mix_recent(self, items, idxs, is_weight):
        """Swap the tail of a prioritized sample for uniform-recent rows
        (the recent mix, see __init__). Their tree indices come along, so
        the step's priority refresh covers them too."""
        k = int(round(self.recent_fraction * len(items)))
        if k == 0 or len(self._recent) < k:
            return items, idxs, is_weight
        pick = self._np_rng.choice(len(self._recent), size=k, replace=False)
        idxs = np.asarray(idxs).copy()
        is_weight = np.asarray(is_weight).copy()
        for j, slot in enumerate(pick):
            ridx, rseq = self._recent[int(slot)]
            items[len(items) - k + j] = rseq
            idxs[len(items) - k + j] = ridx
            is_weight[len(items) - k + j] = 1.0
        return items, idxs, is_weight

    def train(self) -> dict | None:
        """One prioritized train call over sequences (K updates with
        `updates_per_call` K) once warm; -> the last step's metrics (host
        floats, or device tensors the metrics pump owns), or None before
        warm-up and when the service lost its last shard mid-call."""
        if self._warm_sequences() < 2 * self.batch_size:
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
        metrics = self.log_step_metrics(metrics)
        self.timer.step_done(self.train_steps)
        self._profiler.on_step(self.train_steps)
        return metrics

    def _train_once(self, replay) -> dict | None:
        """Sample -> learn -> re-prioritise, against `replay`."""
        path = self._device_path_for(replay)
        if path is not None:
            # The fused device path: the gather, the stack and the H2D
            # copy ran on its thread, beside the previous call's learn.
            return device_train_call(self, path, replay)
        if self.updates_per_call > 1:
            return prioritized_train_call(self, self.updates_per_call, replay)
        with self.timer.stage("sample"):
            items, idxs, is_weight = replay.sample(self.batch_size, self._np_rng)
            if self.recent_fraction > 0:
                items, idxs, is_weight = self._mix_recent(items, idxs, is_weight)
            batch = items if getattr(replay, "stacked_samples", False) else stack_pytrees(items)
        with self.timer.stage("learn"):
            self.state, priorities, metrics = self._learn(self.state, batch, is_weight)
            self._write_back(replay, idxs, priorities)
        return metrics

    def close(self) -> None:
        self.flush_publish()
        self.close_metrics()
        self._close_device_path()  # join the gather thread
        self._profiler.close()
        self.logger.close()


def run_sync(learner: R2D2Learner, actors: list, num_updates: int,
             close_learner: bool = True) -> dict:
    """Rounds of: every actor unrolls once, the learner ingests, then
    trains once it is warm; until `num_updates` train steps."""
    metrics: dict = {}
    frames = 0
    learner.sync_publish = True  # deterministic staleness in the sync loop
    try:
        while learner.train_steps < num_updates:
            for actor in actors:
                frames += actor.run_unroll()
            learner.ingest_batch(timeout=0.0)
            m = learner.train()
            if m is not None:
                metrics = m
    finally:
        if close_learner:
            learner.close()
    returns = [r for a in actors for r in a.episode_returns]
    metrics = {k: float(v) for k, v in metrics.items()}
    return {"frames": frames, "last_metrics": metrics, "episode_returns": returns}


def run_async(learner: R2D2Learner, actors: list, num_updates: int,
              queue: TrajectoryQueue) -> dict:
    """Free-running actor threads + the ingest/train learner loop in one
    process (`actor_pipeline.run_async_loop`)."""
    return run_async_loop(learner, actors, num_updates, queue,
                          ingest_fn=lambda ln: ln.ingest_batch(timeout=0.05))
