"""Anakin IMPALA: collect and learn on one device, no host in between.

Counterpart of the JAX package's `runtime/anakin.py`. The runner topology
moves trajectories from host actors through a queue to the learner; the
"Anakin" pattern of the Podracer architectures (arXiv:2104.06272) keeps
the env step, the act, the trajectory and the update on the device:
`train_chunk` runs U updates of T env steps over B envs with no
trajectory crossing the bus. It is for the envs that are tensor
functions (`envs/*_device.py`); the socket topology stays for the rest.

Per update, as `runtime/impala_runner.py`:
- on-policy collection with the current parameters (behaviour = target
  policy, so V-trace's importance ratios are exactly 1);
- the stored-state LSTM: each step records its pre-act (h, c), which the
  learner re-applies; (h, c) zeroed and `prev_action` reset at `done`;
- a policy head wider than the env's action set is aliased onto it with
  `action % NUM_ACTIONS` (the reference's `train_impala.py:145`).

JAX's `lax.scan` over T steps and U updates becomes Python loops over
device tensors. Nothing in a chunk reads a device value on the host: the
frameskip's break is a mask in the envs, the metrics come back as device
tensors stacked over the chunk, and the step count is the host int the
train state keeps. Randomness is one `torch.Generator` on the loop's
device (JAX splits a key chain): each step draws the act's sample, then
the env's draws. `collect` takes actions and env draws to use in place of
its own, so a test can replay a rollout step for step.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from distributed_reinforcement_learning_tpu_torch.agents import common
from distributed_reinforcement_learning_tpu_torch.agents.impala import ImpalaAgent, ImpalaBatch
from distributed_reinforcement_learning_tpu_torch.envs import cartpole_device
from distributed_reinforcement_learning_tpu_torch.models.functional import functional_call
from distributed_reinforcement_learning_tpu_torch.parallel.learner import ShardedLearner
from distributed_reinforcement_learning_tpu_torch.runtime.anakin_mesh import (
    check_rank_mesh, data_size, psum, rank_generator, stack_metrics)


@dataclasses.dataclass
class AnakinState:
    train: common.TrainState
    env: Any  # the env module's own state NamedTuple
    obs: torch.Tensor  # [B, *obs_shape]
    prev_action: torch.Tensor  # [B] int64
    h: torch.Tensor  # [B, H]
    c: torch.Tensor  # [B, H]
    generator: torch.Generator


def check_env(env, obs_shape, num_actions: int, head: str, exact_obs: bool = True) -> None:
    """The loops' guards: the config observes the env's frames and the
    head covers the env's action set."""
    if exact_obs and tuple(obs_shape) != tuple(env.OBS_SHAPE):
        raise ValueError(f"env obs shape {env.OBS_SHAPE} != config obs_shape={tuple(obs_shape)}")
    if num_actions < env.NUM_ACTIONS:
        raise ValueError(f"{head} ({num_actions}) narrower than the env's action set "
                         f"({env.NUM_ACTIONS})")


def env_action(action: torch.Tensor, num_actions: int, env) -> torch.Tensor:
    """Alias a wider head onto the env's action set (`action % available`)."""
    return action % env.NUM_ACTIONS if num_actions != env.NUM_ACTIONS else action


def episode_stats(ep_returns: list, dones: list, completed: list) -> dict[str, torch.Tensor]:
    """The chunk metrics over one collect's steps: the summed completed
    returns, the games completed and every `done` (life losses too)."""
    return {
        "episode_return_sum": torch.stack(ep_returns).sum(),
        "episodes_done": torch.stack(completed).sum().to(torch.float32),
        "boundaries_done": torch.stack(dones).sum().to(torch.float32),
    }


class AnakinImpala:
    """IMPALA over a device env, everything on the agent's device.

    `env` is a module with the cartpole_device contract (`OBS_SHAPE`,
    `NUM_ACTIONS`, `reset(n, generator)`, `draws(generator, n)`,
    `step(state, actions, draws)`, `completed_episode_mask`):
    `envs.cartpole_device` by default, or a pixel env. `num_envs` is the
    batch B, `agent.cfg.trajectory` the unroll T.

    `mesh` (a `parallel/mesh.RankMesh`; JAX `runtime/anakin.py:77-109`):
    this loop is one rank of it. Its envs, observations, LSTM state and
    previous actions are its `num_envs / data` rows; the train state is
    placed by `parallel/learner.train_state_sharding` (a model axis holds
    slices of the large kernels and their moments), and the learn step
    goes through `ShardedLearner` with IMPALA's sum, so the gradient is
    the union batch's. The act uses the whole parameters, gathered once
    an update before the collect. The episode stats are summed across
    `data`. A world of one is the plain loop.
    """

    def __init__(self, agent: ImpalaAgent, num_envs: int, mesh=None, env=None):
        check_rank_mesh(mesh)
        self.env = env if env is not None else cartpole_device
        check_env(self.env, agent.cfg.obs_shape, agent.cfg.num_actions, "policy head")
        self.agent = agent
        self.num_envs = num_envs
        self.mesh = mesh
        d = data_size(mesh)
        if num_envs % d != 0:
            raise ValueError(f"num_envs ({num_envs}) must divide over the data axis ({d})")
        self.num_envs_local = num_envs // d
        self._sharded = None if mesh is None else ShardedLearner(agent, mesh)

    def init(self, seed: int = 0) -> AnakinState:
        """Parameters from `seed` (`agent.init_state`; over a mesh rank
        0's, placed), fresh envs and one generator on the agent's device
        seeded from `seed` (and the rank's data coordinate,
        `anakin_mesh.rank_generator`)."""
        agent, n = self.agent, self.num_envs_local
        generator = rank_generator(seed, agent.device, self.mesh)
        env, obs = self.env.reset(n, generator)
        h, c = agent.initial_lstm_state(n)
        train = agent.init_state(seed) if self._sharded is None else self._sharded.init_state(seed)
        return AnakinState(
            train=train, env=env, obs=obs,
            prev_action=torch.zeros(n, dtype=torch.long, device=agent.device),
            h=h, c=c, generator=generator)

    def act_params(self, train) -> dict[str, torch.Tensor]:
        """The parameters the act uses: the whole tensors (over a model
        axis gathered, a collective along `model`)."""
        return train.params if self._sharded is None else self._sharded.gather_params(
            train.params)

    @torch.no_grad()
    def _policy(self, params, obs, prev_action, h, c):
        """The act's forward without its sample -> (policy, h', c')."""
        agent = self.agent
        out = functional_call(agent.model, params, (agent._prep_obs(obs), prev_action, h, c))
        return out.policy, out.h, out.c

    # -- one collect: T env steps ------------------------------------------
    def collect(self, state: AnakinState, actions: torch.Tensor | None = None,
                env_draws: list | None = None):
        """T env steps from `state` (advanced in place) -> (ImpalaBatch of
        contiguous `[B, T, ...]` tensors, episode stats). `actions [T, B]`
        and `env_draws` (T of the env's `draws`) replace the loop's own."""
        agent, env, gen, n = self.agent, self.env, state.generator, self.num_envs_local
        params = self.act_params(state.train)
        names = ("state", "reward", "done", "action", "behavior_policy", "previous_action",
                 "initial_h", "initial_c")
        rec = {k: [] for k in names}
        ep_returns, completed = [], []
        for t in range(agent.cfg.trajectory):
            if actions is None:
                out = agent.act(params, state.obs, state.prev_action, state.h, state.c, gen)
                action, policy, h, c = out.action, out.policy, out.h, out.c
            else:
                policy, h, c = self._policy(params, state.obs, state.prev_action, state.h,
                                            state.c)
                action = actions[t].to(state.prev_action)
            draws = env.draws(gen, n) if env_draws is None else env_draws[t]
            env_state, next_obs, reward, done, ep_ret = env.step(
                state.env, env_action(action, agent.cfg.num_actions, env), draws)
            for k, v in zip(names, (state.obs, reward, done, action, policy, state.prev_action,
                                    state.h, state.c)):
                rec[k].append(v)
            ep_returns.append(ep_ret)
            completed.append(env.completed_episode_mask(done, env_state))
            keep = (~done).to(h.dtype)[:, None]
            state.env, state.obs = env_state, next_obs
            state.prev_action = torch.where(done, 0, action)
            state.h, state.c = h * keep, c * keep
        # Stacked on dim 1: the learner's [B, T] layout, contiguous.
        batch = ImpalaBatch(**{k: torch.stack(v, dim=1) for k, v in rec.items()})
        return batch, episode_stats(ep_returns, rec["done"], completed)

    # -- updates -----------------------------------------------------------
    def update(self, state: AnakinState, actions: torch.Tensor | None = None,
               env_draws: list | None = None) -> dict[str, torch.Tensor]:
        """One T-step collect (`actions`, `env_draws` as `collect`'s), then
        one learn step on it -> metrics, the episode stats summed across
        `data`."""
        batch, stats = self.collect(state, actions, env_draws)
        if self._sharded is None:
            state.train, metrics = self.agent.learn(state.train, batch)
        else:
            state.train, metrics = self._sharded.learn(state.train, batch)
        metrics.update(psum(self.mesh, stats))
        return metrics

    def train_chunk(self, state: AnakinState, num_updates: int):
        """`num_updates` updates -> (state, metrics stacked `[U]` on the
        device); the state advances in place."""
        metrics = [self.update(state) for _ in range(num_updates)]
        return state, stack_metrics(metrics, self.agent.device)

    # -- greedy evaluation -------------------------------------------------
    @torch.no_grad()
    def greedy_rollout(self, params, num_envs: int, num_steps: int, seed: int = 0,
                       env_draws: list | None = None, start: tuple | None = None):
        """The argmax policy on fresh envs -> (per-step policies `[S, N, A]`,
        actions `[S, N]`, completed returns `[S, N]`, completed masks).
        `env_draws` (S of the env's `draws`) and `start` (an env state and
        its observation) replace the rollout's own draws and reset."""
        agent, env = self.agent, self.env
        gen = torch.Generator(device=agent.device).manual_seed(seed)
        env_state, obs = env.reset(num_envs, gen) if start is None else start
        h, c = agent.initial_lstm_state(num_envs)
        pa = torch.zeros(num_envs, dtype=torch.long, device=agent.device)
        policies, actions, eps, done_games = [], [], [], []
        for t in range(num_steps):
            policy, h, c = self._policy(params, obs, pa, h, c)
            action = torch.argmax(policy, dim=-1)
            draws = env.draws(gen, num_envs) if env_draws is None else env_draws[t]
            env_state, obs, _r, done, ep = env.step(
                env_state, env_action(action, agent.cfg.num_actions, env), draws)
            keep = (~done).to(h.dtype)[:, None]
            pa = torch.where(done, 0, action)
            h, c = h * keep, c * keep
            policies.append(policy)
            actions.append(action)
            eps.append(ep)
            done_games.append(env.completed_episode_mask(done, env_state))
        return (torch.stack(policies), torch.stack(actions), torch.stack(eps),
                torch.stack(done_games))

    def greedy_eval(self, params, num_envs: int, num_steps: int, seed: int = 0) -> dict:
        """The deterministic (argmax) policy's score on fresh envs ->
        {"mean_return", "episodes"}: the mean completed-game return over a
        `num_steps` rollout of `num_envs` games."""
        _, _, eps, completed = self.greedy_rollout(params, num_envs, num_steps, seed)
        episodes = int(completed.sum())
        total = float((eps * completed.to(eps.dtype)).sum())
        return {"mean_return": total / max(episodes, 1), "episodes": episodes}
