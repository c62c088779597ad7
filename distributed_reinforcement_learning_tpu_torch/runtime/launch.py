"""Build-and-run helpers for single-process training.

Counterpart of `build_local` / `train_local` in the JAX package's
`runtime/launch.py`, IMPALA and R2D2: resolve envs from the registry,
build agent, queue, weight store, learner and actors from a config
section (the agent config's type picks the family), and run the
synchronous loop. Everything runs on CUDA unless the caller passes
another `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.agents.impala import ImpalaAgent, ImpalaConfig
from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Agent, R2D2Config
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
from distributed_reinforcement_learning_tpu_torch.envs.batched import BatchedEnv
from distributed_reinforcement_learning_tpu_torch.envs.cartpole import pomdp_project
from distributed_reinforcement_learning_tpu_torch.envs.registry import make_env
from distributed_reinforcement_learning_tpu_torch.runtime import impala_runner, r2d2_runner
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore
from distributed_reinforcement_learning_tpu_torch.utils.config import RuntimeConfig, load_config
from distributed_reinforcement_learning_tpu_torch.utils.logger import MetricsLogger


def _make_batched_env(rt: RuntimeConfig, actor_index: int) -> BatchedEnv:
    name = rt.envs[actor_index % len(rt.envs)]
    n = rt.envs_per_actor
    return BatchedEnv([
        (lambda s=seed: make_env(name, seed=s))
        for seed in range(actor_index * n, actor_index * n + n)
    ])


def _is_atari(rt: RuntimeConfig) -> bool:
    return any("v4" in e for e in rt.envs)


def build_local(agent_cfg: ImpalaConfig | R2D2Config, rt: RuntimeConfig,
                run_dir: str | None = None, seed: int = 0,
                device: str | torch.device | None = None):
    """-> (learner, actors, run_sync) for single-process training."""
    queue = TrajectoryQueue(rt.queue_size)
    weights = WeightStore()
    if isinstance(agent_cfg, R2D2Config):
        return _build_r2d2(agent_cfg, rt, queue, weights, run_dir, seed, device)
    agent = ImpalaAgent(agent_cfg, device=device)
    learner = impala_runner.ImpalaLearner(
        agent, queue, weights, rt.batch_size, logger=MetricsLogger(run_dir), seed=seed,
        publish_interval=rt.publish_interval)
    actors = [
        impala_runner.ImpalaActor(
            agent, _make_batched_env(rt, i), queue, weights, seed=seed + 1 + i,
            available_action=rt.available_action[i % len(rt.available_action)],
            life_loss_shaping=_is_atari(rt))
        for i in range(rt.num_actors)
    ]
    return learner, actors, impala_runner.run_sync


def _build_r2d2(agent_cfg: R2D2Config, rt: RuntimeConfig, queue, weights, run_dir, seed,
                device):
    agent = R2D2Agent(agent_cfg, device=device)
    learner = r2d2_runner.R2D2Learner(
        agent, queue, weights, rt.batch_size, replay_capacity=rt.replay_capacity,
        target_sync_interval=rt.target_sync_interval, logger=MetricsLogger(run_dir),
        seed=seed, publish_interval=rt.publish_interval)
    # The 2-feature agent observes the CartPole POMDP view.
    transform = pomdp_project if agent_cfg.obs_shape == (2,) else None
    floor = {} if rt.epsilon_floor is None else {"epsilon_floor": rt.epsilon_floor}
    actors = [
        r2d2_runner.R2D2Actor(
            agent, _make_batched_env(rt, i), queue, weights, seed=seed + 1 + i,
            obs_transform=transform, **floor)
        for i in range(rt.num_actors)
    ]
    return learner, actors, r2d2_runner.run_sync


def train_local(config_path: str, section: str, num_updates: int,
                run_dir: str | None = None, seed: int = 0,
                device: str | torch.device | None = None) -> dict:
    """Train one config section for `num_updates` learner steps in one
    process; -> frames, last metrics, episode returns."""
    agent_cfg, rt = load_config(config_path, section)
    learner, actors, run_fn = build_local(agent_cfg, rt, run_dir=run_dir, seed=seed,
                                          device=device)
    try:
        result = run_fn(learner, actors, num_updates, close_learner=False)
    finally:
        learner.close()
    returns = result["episode_returns"]
    if returns:
        result["mean_return_last20"] = float(np.mean(returns[-20:]))
    return result
