"""Anakin Ape-X: prioritized DQN trained on the device.

Counterpart of the JAX package's `runtime/anakin_apex.py`: the
reference's `train_apex.py` stack (epsilon-ladder actors pushing
TD-scored transitions into prioritized replay, a double-DQN learner with
IS weights and target syncs) over a device env, with the transition ring
(uint8 frame stacks for the pixel envs) in device memory
(`data/device_replay.py`).

- Actors: per-episode epsilon `1 / (0.05 * episodes + 1)` (the
  reference's `train_apex.py:69`) with an optional floor; the pixel
  envs' life-loss boundaries arrive as `done`.
- Transitions: (s, prev_a, a, r, s', done), flattened time-major into a
  write of W = num_envs x steps_per_collect; the auto-reset observation
  standing in for a terminal s' is harmless (its discount is 0).
- Ingest scored by `agent.td_error` under the current parameters;
  `updates_per_collect` prioritized learns an update, each writing its
  fresh priorities back; the target syncs on a steps-since-last cadence.

Over a mesh of ranks (`mesh=`, the data axis alone) each rank runs this
loop on its `num_envs / data` envs and its shard of the ring; the
gradients and the IS weights' maximum cross between ranks
(`runtime/anakin_mesh.py`).

Ape-X launches no port kernel: its networks have no LSTM or V-trace.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from distributed_reinforcement_learning_tpu_torch.agents import common
from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexAgent, ApexBatch
from distributed_reinforcement_learning_tpu_torch.data import device_replay
from distributed_reinforcement_learning_tpu_torch.data.device_replay import DeviceReplay
from distributed_reinforcement_learning_tpu_torch.envs import cartpole_device
from distributed_reinforcement_learning_tpu_torch.models.functional import functional_call
from distributed_reinforcement_learning_tpu_torch.runtime.anakin import (
    check_env, env_action, episode_stats)
from distributed_reinforcement_learning_tpu_torch.runtime.anakin_mesh import (
    DataMeshReplayMixin, rank_generator)


@dataclasses.dataclass
class AnakinApexState:
    train: common.TargetTrainState
    replay: DeviceReplay
    env: Any
    obs: torch.Tensor
    prev_action: torch.Tensor  # [B] int64
    episodes: torch.Tensor  # [B] int32 (the epsilon schedule)
    last_sync: int  # train step of the last target sync
    generator: torch.Generator


class AnakinApex(DataMeshReplayMixin):
    """Ape-X over a device env with a prioritized ring on the device.

    Each update collects `steps_per_collect` transitions from all
    `num_envs` envs (write width W = num_envs * steps_per_collect;
    `capacity` must be a multiple of W), then runs `updates_per_collect`
    prioritized batches.
    """

    def __init__(self, agent: ApexAgent, num_envs: int, batch_size: int = 32,
                 capacity: int = 8192, steps_per_collect: int = 16,
                 target_sync_interval: int = 100, updates_per_collect: int = 1,
                 epsilon_decay: float = 0.05, epsilon_floor: float = 0.0,
                 env=None, obs_transform=None, mesh=None):
        self.env = env if env is not None else cartpole_device
        self.agent = agent
        self.num_envs = num_envs
        self.batch_size = batch_size
        self.steps_per_collect = steps_per_collect
        self.write_width = num_envs * steps_per_collect
        if capacity % self.write_width != 0:
            raise ValueError(f"capacity ({capacity}) must be a multiple of num_envs * "
                             f"steps_per_collect ({self.write_width})")
        self.capacity = capacity
        self.target_sync_interval = target_sync_interval
        if updates_per_collect > target_sync_interval:
            raise ValueError(f"updates_per_collect ({updates_per_collect}) must not "
                             f"exceed target_sync_interval ({target_sync_interval})")
        self.updates_per_collect = updates_per_collect
        self.epsilon_decay = epsilon_decay
        self.epsilon_floor = epsilon_floor
        self.obs_transform = obs_transform or (lambda x: x)
        check_env(self.env, agent.cfg.obs_shape, agent.cfg.num_actions, "Q head",
                  exact_obs=False)
        # Over a mesh the data axis alone, with per-rank ring shards
        # (`runtime/anakin_mesh.py`): a rank collects from its own envs
        # and writes `write_width_local` transitions a collect.
        self._setup_mesh(mesh, num_envs=num_envs, batch_size=batch_size, capacity=capacity)
        self.write_width_local = self.write_width // self.dshard

    def init(self, seed: int = 0) -> AnakinApexState:
        """Parameters from `seed` (over a mesh rank 0's), fresh envs, an
        empty ring (shard) and one generator on the agent's device seeded
        from `seed` (and the rank's data coordinate)."""
        agent, n = self.agent, self.num_envs_local
        generator = rank_generator(seed, agent.device, self.mesh)
        env, obs = self.env.reset(n, generator)
        obs = self.obs_transform(obs)
        return AnakinApexState(
            train=self._init_train(seed), replay=device_replay.make(self._zero_transitions(obs)),
            env=env, obs=obs,
            prev_action=torch.zeros(n, dtype=torch.long, device=agent.device),
            episodes=torch.zeros(n, dtype=torch.int32, device=agent.device),
            last_sync=0, generator=generator)

    def _zero_transitions(self, obs: torch.Tensor) -> ApexBatch:
        C, dev = self.capacity_local, obs.device
        return ApexBatch(
            state=torch.zeros((C, *obs.shape[1:]), dtype=obs.dtype, device=dev),
            next_state=torch.zeros((C, *obs.shape[1:]), dtype=obs.dtype, device=dev),
            previous_action=torch.zeros(C, dtype=torch.long, device=dev),
            action=torch.zeros(C, dtype=torch.long, device=dev),
            reward=torch.zeros(C, device=dev),
            done=torch.zeros(C, dtype=torch.bool, device=dev))

    # -- collection --------------------------------------------------------
    def collect(self, state: AnakinApexState, actions: torch.Tensor | None = None,
                env_draws: list | None = None):
        """`steps_per_collect` env steps (state advanced in place) ->
        (flat ApexBatch `[W_local]`, time-major and contiguous; episode
        stats).
        `actions [S, B]` and `env_draws` replace the loop's own draws."""
        agent, env, gen = self.agent, self.env, state.generator
        params = state.train.params
        names = ApexBatch._fields
        rec = {k: [] for k in names}
        ep_returns, completed = [], []
        for t in range(self.steps_per_collect):
            if actions is None:
                action, _q = agent.act(params, state.obs, state.prev_action,
                                       self._epsilon(state.episodes), gen)
            else:
                action = actions[t].to(state.prev_action)
            draws = env.draws(gen, self.num_envs_local) if env_draws is None else env_draws[t]
            env_state, next_obs, reward, done, ep_ret = env.step(
                state.env, env_action(action, agent.cfg.num_actions, env), draws)
            next_obs = self.obs_transform(next_obs)
            for k, v in zip(names, (state.obs, next_obs, state.prev_action, action, reward, done)):
                rec[k].append(v)
            ep_returns.append(ep_ret)
            completed.append(env.completed_episode_mask(done, env_state))
            state.env, state.obs = env_state, next_obs
            state.prev_action = torch.where(done, 0, action)
            state.episodes = state.episodes + done.to(torch.int32)
        flat = lambda v: torch.stack(v).reshape((self.write_width_local,) + tuple(v[0].shape[1:]))
        batch = ApexBatch(**{k: flat(v) for k, v in rec.items()})
        return batch, episode_stats(ep_returns, rec["done"], completed)

    def ingest(self, state: AnakinApexState, batch: ApexBatch) -> torch.Tensor:
        """Score `batch` with the current networks and write it into the
        ring at `ptr` -> the raw TD errors `[W]`."""
        errs = self.agent.td_error(state.train, batch)
        device_replay.ingest(state.replay, batch, errs)
        return errs

    def _collect_and_ingest(self, state: AnakinApexState) -> dict:
        batch, stats = self.collect(state)
        self.ingest(state, batch)
        return stats

    # -- greedy evaluation -------------------------------------------------
    @torch.no_grad()
    def greedy_eval(self, params, num_envs: int, num_steps: int, seed: int = 0) -> dict:
        """The argmax-Q policy's score on fresh envs -> {"mean_return",
        "episodes"} (AnakinImpala.greedy_eval's contract)."""
        agent, env = self.agent, self.env
        gen = torch.Generator(device=agent.device).manual_seed(seed)
        env_state, obs = env.reset(num_envs, gen)
        obs = self.obs_transform(obs)
        pa = torch.zeros(num_envs, dtype=torch.long, device=agent.device)
        total = torch.zeros((), device=agent.device)
        episodes = torch.zeros((), dtype=torch.long, device=agent.device)
        for _ in range(num_steps):
            q = functional_call(agent.model, params, (agent._prep_obs(obs), pa))
            action = torch.argmax(q, dim=-1)
            env_state, obs, _r, done, ep = env.step(
                env_state, env_action(action, agent.cfg.num_actions, env), env.draws(gen, num_envs))
            obs = self.obs_transform(obs)
            pa = torch.where(done, 0, action)
            mask = env.completed_episode_mask(done, env_state)
            total = total + (ep * mask).sum()
            episodes = episodes + mask.sum()
        n = int(episodes)
        return {"mean_return": float(total) / max(n, 1), "episodes": n}
