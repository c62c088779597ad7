"""R2D2 actor/learner loops.

Counterpart of the JAX package's `runtime/r2d2_runner.py`, sequential
path only:

- `R2D2Actor`: N batched envs (CartPole-POMDP through `obs_transform`),
  per-env epsilon `max(1/(0.1*episode+1), floor)`, seq_len unrolls that
  carry the sequence-start LSTM state, a weight pull per unroll.
- `R2D2Learner`: drains sequences and scores their priorities in one
  `td_error` call (padded to a power of two), trains with IS weights
  once 2 x batch sequences have arrived, re-prioritises every sampled
  index, syncs the target every `target_sync_interval` steps.
- `run_sync`: deterministic interleaved stepping (tests, single-process
  training).

Not ported: the actor pipeline slices, `run_async`, `remote_act`,
checkpoints, the recent-mix knob and the mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Agent
from distributed_reinforcement_learning_tpu_torch.data.fifo import (
    TrajectoryQueue, put_round, stack_pytrees)
from distributed_reinforcement_learning_tpu_torch.data.replay import PrioritizedReplay
from distributed_reinforcement_learning_tpu_torch.data.structures import R2D2SequenceAccumulator
from distributed_reinforcement_learning_tpu_torch.envs.batched import completed_returns
from distributed_reinforcement_learning_tpu_torch.runtime.publishing import PublishCadenceMixin
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore
from distributed_reinforcement_learning_tpu_torch.utils.logger import MetricsLogger


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
        obs_transform=None,  # e.g. envs.cartpole.pomdp_project
    ):
        self.agent = agent
        self.env = env
        self.queue = queue
        self.weights = weights
        self.epsilon_decay = epsilon_decay
        self.epsilon_floor = epsilon_floor
        self.obs_transform = obs_transform or (lambda x: x)

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

    def run_unroll(self) -> int:
        """One seq_len unroll from all envs -> N sequences into the queue.
        Returns the number of env frames generated (N * seq_len)."""
        cfg = self.agent.cfg
        device = self.agent.device
        self._sync_params()
        if self._params is None:
            raise RuntimeError("no weights published yet")
        acc = R2D2SequenceAccumulator()
        acc.reset(self._h, self._c)
        n = self._obs.shape[0]

        for _ in range(cfg.seq_len):
            action, _, h, c = self.agent.act(
                self._params, torch.as_tensor(self._obs, device=device),
                torch.as_tensor(self._h, device=device), torch.as_tensor(self._c, device=device),
                torch.as_tensor(self._prev_action, device=device),
                torch.as_tensor(self.epsilon, dtype=torch.float32, device=device),
                self._generator)
            action = action.cpu().numpy().astype(np.int32)
            next_obs_raw, reward, done, infos = self.env.step(action)

            acc.append(state=self._obs, previous_action=self._prev_action, action=action,
                       reward=reward.astype(np.float32), done=done)

            keep = (~done).astype(np.float32)[:, None]
            self._h = h.cpu().numpy() * keep
            self._c = c.cpu().numpy() * keep
            self._prev_action = np.where(done, 0, action).astype(np.int32)
            self._obs = self.obs_transform(next_obs_raw)
            # Exploration anneals per episode.
            self._episodes += done
            for ret in completed_returns(infos, done):
                self.episode_returns.append(float(ret))

        put_round(self.queue, acc.extract())
        return n * cfg.seq_len


class R2D2Learner(PublishCadenceMixin):
    def __init__(
        self,
        agent: R2D2Agent,
        queue: TrajectoryQueue,
        weights: WeightStore,
        batch_size: int = 32,
        replay_capacity: int = 100_000,
        target_sync_interval: int = 100,
        logger: MetricsLogger | None = None,
        seed: int = 0,
        publish_interval: int = 1,
    ):
        self.agent = agent
        self.queue = queue
        self.weights = weights
        self.batch_size = batch_size
        self.replay = PrioritizedReplay(replay_capacity)
        self.target_sync_interval = target_sync_interval
        self._last_target_sync = 0
        self.logger = logger or MetricsLogger(None)
        self.state = agent.sync_target(agent.init_state(seed))
        self._np_rng = np.random.RandomState(seed)
        self.publish_interval = max(1, publish_interval)
        self.ingested_sequences = 0
        self.train_steps = 0
        weights.publish(self.state.params, 0)

    def ingest_batch(self, timeout: float | None = 0.0) -> int:
        """Drain up to batch_size sequences and score them in ONE batched
        td_error call; -> how many were ingested."""
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
        batch = stack_pytrees(seqs + [seqs[0]] * (k - n))
        # Deliberate sync: the priorities go into the host sum tree.
        td = self.agent.td_error(self.state, batch).cpu().numpy()[:n]
        self.replay.add_batch(td, seqs)
        self.ingested_sequences += n
        return n

    def train(self) -> dict | None:
        """One prioritized train step over sequences once warm; -> host
        float metrics, or None before warm-up."""
        if self.ingested_sequences < 2 * self.batch_size:
            return None
        metrics = self._train_once()
        self.train_steps += 1
        self.maybe_publish()
        if self.train_steps - self._last_target_sync >= self.target_sync_interval:
            self._last_target_sync = self.train_steps
            self.state = self.agent.sync_target(self.state)
        return self.log_step_metrics(metrics)

    def _train_once(self) -> dict:
        """Sample -> learn -> re-prioritise."""
        items, idxs, is_weight = self.replay.sample(self.batch_size, self._np_rng)
        self.state, priorities, metrics = self.agent.learn(
            self.state, stack_pytrees(items), is_weight)
        # Deliberate sync: re-prioritisation targets the host sum tree.
        self.replay.update_batch(idxs, priorities.cpu().numpy())
        return metrics

    def close(self) -> None:
        self.flush_publish()
        self.logger.close()


def run_sync(learner: R2D2Learner, actors: list[R2D2Actor], num_updates: int,
             close_learner: bool = True) -> dict:
    """Rounds of: every actor unrolls once, the learner ingests, then
    trains once it is warm; until `num_updates` train steps."""
    metrics: dict = {}
    frames = 0
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
    return {"frames": frames, "last_metrics": metrics, "episode_returns": returns}
