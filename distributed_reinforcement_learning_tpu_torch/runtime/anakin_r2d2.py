"""Anakin R2D2: recurrent replay trained on the device.

Counterpart of the JAX package's `runtime/anakin_r2d2.py`. The host
topology's queue, sum tree and learner loop (`runtime/r2d2_runner.py`,
`data/replay.py`) become a fixed-capacity ring of sequences in device
memory (`data/device_replay.py`), sampled on the device.

Replay as `data/replay.py`: priority `(|err| + 0.001) ** 0.6`, stratified
sampling, IS weights normalised by the batch max, beta annealed 0.4 ->
1.0 by 0.001 a sample; new sequences scored by `agent.td_error` under the
current parameters (the host learner's ingest, `r2d2_runner.py`); every
sampled priority refreshed after its learn step.

Actors as `R2D2Actor`: per-episode epsilon `1 / (0.1 * episodes + 1)`
with an optional floor, the sequence-start stored LSTM state, done-masked
carries, `prev_action` reset at `done`.

On CUDA the LSTM kernels run over every sequence: K2a twice an ingest
(main and target over the `num_envs` new sequences) and twice a learn,
K2b once a learn. The acts are single LSTM-cell steps on the plain path.

Over a mesh of ranks (`mesh=`, the data axis alone) each rank runs this
loop on its `num_envs / data` envs and its shard of the ring, so the
kernels run at the local widths; the gradients and the IS weights'
maximum cross between ranks (`runtime/anakin_mesh.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from distributed_reinforcement_learning_tpu_torch.agents import common
from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Agent, R2D2Batch
from distributed_reinforcement_learning_tpu_torch.data import device_replay
from distributed_reinforcement_learning_tpu_torch.data.device_replay import DeviceReplay
from distributed_reinforcement_learning_tpu_torch.envs import cartpole_device
from distributed_reinforcement_learning_tpu_torch.models.functional import functional_call
from distributed_reinforcement_learning_tpu_torch.runtime.anakin import (
    check_env, env_action, episode_stats)
from distributed_reinforcement_learning_tpu_torch.runtime.anakin_mesh import (
    DataMeshReplayMixin, rank_generator)

@dataclasses.dataclass
class AnakinR2D2State:
    train: common.TargetTrainState
    replay: DeviceReplay
    env: Any
    obs: torch.Tensor
    prev_action: torch.Tensor  # [B] int64
    h: torch.Tensor
    c: torch.Tensor
    episodes: torch.Tensor  # [B] int32 (the epsilon schedule)
    last_sync: int  # train step of the last target sync
    generator: torch.Generator


class AnakinR2D2(DataMeshReplayMixin):
    """R2D2 over a device env with a prioritized sequence ring.

    `num_envs` envs collect one `seq_len` sequence each an update;
    `updates_per_collect` prioritized batches of `batch_size` train a
    collect. `capacity` must be a multiple of `num_envs` (ring writes stay
    aligned and never wrap).
    """

    def __init__(self, agent: R2D2Agent, num_envs: int, batch_size: int = 32,
                 capacity: int = 4096, target_sync_interval: int = 100,
                 updates_per_collect: int = 1, epsilon_decay: float = 0.1,
                 epsilon_floor: float = 0.0, env=None, obs_transform=None, mesh=None):
        self.env = env if env is not None else cartpole_device
        self.agent = agent
        self.num_envs = num_envs
        self.batch_size = batch_size
        if capacity % num_envs != 0:
            raise ValueError(f"capacity ({capacity}) must be a multiple of "
                             f"num_envs ({num_envs})")
        self.capacity = capacity
        self.target_sync_interval = target_sync_interval
        if updates_per_collect > target_sync_interval:
            # The K learns cannot sync mid-update, so K must not swallow
            # whole intervals (`replay_train`'s stride check).
            raise ValueError(f"updates_per_collect ({updates_per_collect}) must not "
                             f"exceed target_sync_interval ({target_sync_interval})")
        self.updates_per_collect = updates_per_collect
        self.epsilon_decay = epsilon_decay
        self.epsilon_floor = epsilon_floor
        self.obs_transform = obs_transform or (lambda x: x)
        check_env(self.env, agent.cfg.obs_shape, agent.cfg.num_actions, "Q head",
                  exact_obs=False)
        # Over a mesh the data axis alone, with per-rank ring shards
        # (`runtime/anakin_mesh.py`): a rank collects from `num_envs_local`.
        self._setup_mesh(mesh, num_envs=num_envs, batch_size=batch_size, capacity=capacity)

    def init(self, seed: int = 0) -> AnakinR2D2State:
        """Parameters from `seed` (over a mesh rank 0's), fresh envs and
        LSTM state, an empty ring (shard) and one generator on the agent's
        device seeded from `seed` (and the rank's data coordinate)."""
        agent, n = self.agent, self.num_envs_local
        generator = rank_generator(seed, agent.device, self.mesh)
        env, obs = self.env.reset(n, generator)
        h, c = agent.initial_lstm_state(n)
        return AnakinR2D2State(
            train=self._init_train(seed), replay=device_replay.make(self._zero_sequences()),
            env=env, obs=self.obs_transform(obs),
            prev_action=torch.zeros(n, dtype=torch.long, device=agent.device),
            h=h, c=c, episodes=torch.zeros(n, dtype=torch.int32, device=agent.device),
            last_sync=0, generator=generator)

    def _zero_sequences(self) -> R2D2Batch:
        cfg, dev = self.agent.cfg, self.agent.device
        pixel = len(self.env.OBS_SHAPE) == 3
        obs0 = self.obs_transform(torch.zeros(
            (1, *self.env.OBS_SHAPE), dtype=torch.uint8 if pixel else torch.float32, device=dev))
        C, T = self.capacity_local, cfg.seq_len
        return R2D2Batch(
            state=torch.zeros((C, T, *obs0.shape[1:]), dtype=obs0.dtype, device=dev),
            previous_action=torch.zeros((C, T), dtype=torch.long, device=dev),
            action=torch.zeros((C, T), dtype=torch.long, device=dev),
            reward=torch.zeros((C, T), device=dev),
            done=torch.zeros((C, T), dtype=torch.bool, device=dev),
            initial_h=torch.zeros((C, cfg.lstm_size), device=dev),
            initial_c=torch.zeros((C, cfg.lstm_size), device=dev))

    @torch.no_grad()
    def _q(self, params, obs, h, c, prev_action):
        """The act's forward without its epsilon draw -> (q, h', c')."""
        agent = self.agent
        return functional_call(agent.model, params, (agent._prep_obs(obs), prev_action, h, c))

    # -- collection --------------------------------------------------------
    def collect(self, state: AnakinR2D2State, actions: torch.Tensor | None = None,
                env_draws: list | None = None):
        """One `seq_len` unroll from every env (state advanced in place) ->
        (R2D2Batch of contiguous `[B, T, ...]` tensors with the
        sequence-start (h, c), episode stats). `actions [T, B]` and
        `env_draws` replace the loop's own draws."""
        agent, env, gen = self.agent, self.env, state.generator
        params = state.train.params
        h0, c0 = state.h, state.c
        names = ("state", "previous_action", "action", "reward", "done")
        rec = {k: [] for k in names}
        ep_returns, completed = [], []
        for t in range(agent.cfg.seq_len):
            if actions is None:
                action, _q, h, c = agent.act(params, state.obs, state.h, state.c,
                                             state.prev_action, self._epsilon(state.episodes), gen)
            else:
                _q, h, c = self._q(params, state.obs, state.h, state.c, state.prev_action)
                action = actions[t].to(state.prev_action)
            draws = env.draws(gen, self.num_envs_local) if env_draws is None else env_draws[t]
            env_state, next_obs, reward, done, ep_ret = env.step(
                state.env, env_action(action, agent.cfg.num_actions, env), draws)
            for k, v in zip(names, (state.obs, state.prev_action, action, reward, done)):
                rec[k].append(v)
            ep_returns.append(ep_ret)
            completed.append(env.completed_episode_mask(done, env_state))
            keep = (~done).to(h.dtype)[:, None]
            state.env, state.obs = env_state, self.obs_transform(next_obs)
            state.prev_action = torch.where(done, 0, action)
            state.h, state.c = h * keep, c * keep
            state.episodes = state.episodes + done.to(torch.int32)
        batch = R2D2Batch(**{k: torch.stack(v, dim=1) for k, v in rec.items()},
                          initial_h=h0, initial_c=c0)
        return batch, episode_stats(ep_returns, rec["done"], completed)

    def ingest(self, state: AnakinR2D2State, batch: R2D2Batch) -> torch.Tensor:
        """Score the `num_envs` new sequences and write them into the ring
        at `ptr` -> their priorities' raw errors `[B]`."""
        errs = self.agent.td_error(state.train, batch)
        device_replay.ingest(state.replay, batch, errs)
        return errs

    def _collect_and_ingest(self, state: AnakinR2D2State) -> dict:
        batch, stats = self.collect(state)
        self.ingest(state, batch)
        return stats

    # -- greedy evaluation -------------------------------------------------
    @torch.no_grad()
    def greedy_eval(self, params, num_envs: int, num_steps: int, seed: int = 0) -> dict:
        """The argmax-Q policy's score on fresh envs, the recurrent state
        carried across steps (AnakinImpala.greedy_eval's contract)."""
        agent, env = self.agent, self.env
        gen = torch.Generator(device=agent.device).manual_seed(seed)
        env_state, obs = env.reset(num_envs, gen)
        obs = self.obs_transform(obs)
        h, c = agent.initial_lstm_state(num_envs)
        pa = torch.zeros(num_envs, dtype=torch.long, device=agent.device)
        total = torch.zeros((), device=agent.device)
        episodes = torch.zeros((), dtype=torch.long, device=agent.device)
        for _ in range(num_steps):
            q, h, c = self._q(params, obs, h, c, pa)
            action = torch.argmax(q, dim=-1)
            env_state, obs, _r, done, ep = env.step(
                env_state, env_action(action, agent.cfg.num_actions, env), env.draws(gen, num_envs))
            obs = self.obs_transform(obs)
            keep = (~done).to(h.dtype)[:, None]
            pa = torch.where(done, 0, action)
            h, c = h * keep, c * keep
            mask = env.completed_episode_mask(done, env_state)
            total = total + (ep * mask).sum()
            episodes = episodes + mask.sum()
        n = int(episodes)
        return {"mean_return": float(total) / max(n, 1), "episodes": n}
