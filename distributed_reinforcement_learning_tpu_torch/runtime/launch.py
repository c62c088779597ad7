"""Build-and-run helpers.

Counterpart of `make_learner` / `make_actor` / `build_local` /
`train_local` in the JAX package's `runtime/launch.py`, for IMPALA, Ape-X,
R2D2, Transformer-R2D2 and Transformer-IMPALA: resolve envs from the
registry, build agent, queue, weight store, learner and actors from a
config section (the agent config's type picks the family). `make_learner` and `make_actor`
take any queue and weight store, the learner's own objects in one
process or the transport's adapters across processes
(`runtime/transport.py:run_role`). Everything runs on CUDA unless the
caller passes another `device`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexAgent, ApexConfig
from distributed_reinforcement_learning_tpu_torch.agents.impala import ImpalaAgent, ImpalaConfig
from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Agent, R2D2Config
from distributed_reinforcement_learning_tpu_torch.agents.xformer import (
    XformerAgent, XformerConfig)
from distributed_reinforcement_learning_tpu_torch.agents.ximpala import (
    XImpalaAgent, XImpalaConfig)
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
from distributed_reinforcement_learning_tpu_torch.envs.batched import BatchedEnv
from distributed_reinforcement_learning_tpu_torch.envs.cartpole import pomdp_project
from distributed_reinforcement_learning_tpu_torch.envs.registry import make_env
from distributed_reinforcement_learning_tpu_torch.runtime import (
    apex_runner, impala_runner, r2d2_runner, xformer_runner, ximpala_runner)
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore
from distributed_reinforcement_learning_tpu_torch.utils.config import RuntimeConfig, load_config
from distributed_reinforcement_learning_tpu_torch.utils.logger import MetricsLogger

_AGENT_CLS = {"impala": ImpalaAgent, "apex": ApexAgent, "r2d2": R2D2Agent,
              "xformer": XformerAgent, "ximpala": XImpalaAgent}
_RUNNER = {"impala": impala_runner, "apex": apex_runner, "r2d2": r2d2_runner,
           "xformer": xformer_runner, "ximpala": ximpala_runner}
# The prioritized sequence-replay families: the R2D2 learner and its loop.
SEQUENCE_REPLAY = ("r2d2", "xformer")


def algo_of(agent_cfg: ImpalaConfig | ApexConfig | R2D2Config | XformerConfig
            | XImpalaConfig) -> str:
    """The family a loaded agent config belongs to."""
    if isinstance(agent_cfg, ApexConfig):
        return "apex"
    if isinstance(agent_cfg, R2D2Config):
        return "r2d2"
    if isinstance(agent_cfg, XformerConfig):
        return "xformer"
    if isinstance(agent_cfg, XImpalaConfig):
        return "ximpala"
    return "impala"


def _make_batched_env(rt: RuntimeConfig, actor_index: int, num_actions: int) -> BatchedEnv:
    name = rt.envs[actor_index % len(rt.envs)]
    n = rt.envs_per_actor
    return BatchedEnv([
        (lambda s=seed: make_env(name, seed=s, num_actions=num_actions))
        for seed in range(actor_index * n, actor_index * n + n)
    ])


def _is_atari(rt: RuntimeConfig) -> bool:
    return any("v4" in e for e in rt.envs)


def make_agent(algo: str, agent_cfg: Any, device: str | torch.device | None = None):
    """The agent of family `algo` on `device` (an act-serving replica's)."""
    return _AGENT_CLS[algo](agent_cfg, device=device)


def make_learner(algo: str, agent_cfg: Any, rt: RuntimeConfig, queue, weights,
                 logger: MetricsLogger | None = None, seed: int = 0,
                 device: str | torch.device | None = None, agent=None,
                 prefetch: bool = False, replay_service=None):
    """The learner of family `algo` over any queue and weight store.
    `prefetch` (IMPALA families) overlaps batch k+1's H2D copy with step k;
    `replay_service` (replay families) is the sharded replay the learner
    samples while it is healthy (`runtime/replay_shard.build_service`).
    `seed` seeds the initial parameters, as the JAX launcher's
    `rng=PRNGKey(seed)` does; the replay learners keep their sampling
    stream at `RandomState(0)`, the JAX learners' default."""
    agent = agent or _AGENT_CLS[algo](agent_cfg, device=device)
    if algo in ("apex", *SEQUENCE_REPLAY) and prefetch:
        raise ValueError(f"the {algo} learner samples its batches from the replay; "
                         "it has no queue prefetch")
    if algo == "apex":
        return apex_runner.ApexLearner(
            agent, queue, weights, rt.batch_size, replay_capacity=rt.replay_capacity,
            target_sync_interval=rt.target_sync_interval, logger=logger, init_seed=seed,
            publish_interval=rt.publish_interval, updates_per_call=rt.updates_per_call,
            replay_service=replay_service)
    if algo in SEQUENCE_REPLAY:
        cls = xformer_runner.XformerLearner if algo == "xformer" else r2d2_runner.R2D2Learner
        return cls(
            agent, queue, weights, rt.batch_size, replay_capacity=rt.replay_capacity,
            target_sync_interval=rt.target_sync_interval, logger=logger, init_seed=seed,
            publish_interval=rt.publish_interval, updates_per_call=rt.updates_per_call,
            replay_service=replay_service)
    cls = (ximpala_runner.XImpalaLearner if algo == "ximpala"
           else impala_runner.ImpalaLearner)
    return cls(agent, queue, weights, rt.batch_size, logger=logger, seed=seed,
               publish_interval=rt.publish_interval, prefetch=prefetch,
               updates_per_call=rt.updates_per_call)


def make_actor(algo: str, agent_cfg: Any, rt: RuntimeConfig, task: int, queue, weights,
               seed: int = 0, device: str | torch.device | None = None, agent=None,
               remote_act=None):
    """Actor `task` of the topology over any queue and weight store. Pass
    `agent` to share one agent between runners in a process. `remote_act`
    (any family; a `transport.RemoteInference` or `RemoteActService`, or
    an `InferenceServer.submit`) makes the actor act through a service:
    it then pulls no weights."""
    agent = agent or _AGENT_CLS[algo](agent_cfg, device=device)
    env = _make_batched_env(rt, task, agent_cfg.num_actions)
    if algo == "apex":
        return apex_runner.ApexActor(agent, env, queue, weights, seed=seed,
                                     life_loss_shaping=_is_atari(rt), remote_act=remote_act)
    # The 2-feature agents observe the CartPole POMDP view.
    transform = pomdp_project if agent_cfg.obs_shape == (2,) else None
    if algo in SEQUENCE_REPLAY:
        # None keeps the actor's own floor (r2d2 0.0, xformer 0.15).
        floor = {} if rt.epsilon_floor is None else {"epsilon_floor": rt.epsilon_floor}
        cls = xformer_runner.XformerActor if algo == "xformer" else r2d2_runner.R2D2Actor
        return cls(agent, env, queue, weights, seed=seed, obs_transform=transform,
                   timeout_nonterminal=rt.timeout_nonterminal, remote_act=remote_act, **floor)
    available = rt.available_action[task % len(rt.available_action)]
    if algo == "ximpala":
        return ximpala_runner.XImpalaActor(
            agent, env, queue, weights, seed=seed, available_action=available,
            life_loss_shaping=_is_atari(rt), obs_transform=transform, remote_act=remote_act)
    return impala_runner.ImpalaActor(agent, env, queue, weights, seed=seed,
                                     available_action=available,
                                     life_loss_shaping=_is_atari(rt), remote_act=remote_act)


def build_local(agent_cfg: ImpalaConfig | ApexConfig | R2D2Config | XformerConfig
                | XImpalaConfig, rt: RuntimeConfig, run_dir: str | None = None, seed: int = 0,
                device: str | torch.device | None = None):
    """-> (learner, actors, run_sync) for single-process training; one
    agent is shared by the learner and every actor."""
    algo = algo_of(agent_cfg)
    queue = TrajectoryQueue(rt.queue_size)
    weights = WeightStore()
    agent = _AGENT_CLS[algo](agent_cfg, device=device)
    learner = make_learner(algo, agent_cfg, rt, queue, weights, logger=MetricsLogger(run_dir),
                           seed=seed, agent=agent)
    actors = [make_actor(algo, agent_cfg, rt, i, queue, weights, seed=seed + 1 + i, agent=agent)
              for i in range(rt.num_actors)]
    return learner, actors, _RUNNER[algo].run_sync


def train_local(config_path: str, section: str, num_updates: int,
                run_dir: str | None = None, seed: int = 0,
                device: str | torch.device | None = None,
                checkpoint_dir: str | None = None, checkpoint_interval: int = 500) -> dict:
    """Train one config section for `num_updates` learner steps in one
    process; -> frames, last metrics, episode returns.

    With `checkpoint_dir`, resumes from the latest checkpoint and saves
    every `checkpoint_interval` updates, running the sync loop in chunks
    (the loop targets absolute `learner.train_steps`, so chunks
    compose)."""
    agent_cfg, rt = load_config(config_path, section)
    learner, actors, run_fn = build_local(agent_cfg, rt, run_dir=run_dir, seed=seed,
                                          device=device)
    checkpoint_interval = max(1, int(checkpoint_interval))
    ckpt = None
    if checkpoint_dir:
        from distributed_reinforcement_learning_tpu_torch.utils.checkpoint import Checkpointer

        ckpt = Checkpointer(checkpoint_dir)
        learner.restore_checkpoint(ckpt)
    frames = 0
    result: dict = {"frames": 0, "last_metrics": {}, "episode_returns": []}
    if learner.train_steps >= num_updates:
        result["skipped"] = (
            f"checkpoint already at step {learner.train_steps} >= {num_updates}")
    try:
        while learner.train_steps < num_updates:
            target = (num_updates if ckpt is None
                      else min(learner.train_steps + checkpoint_interval, num_updates))
            result = run_fn(learner, actors, target, close_learner=False)
            frames += result["frames"]
            if ckpt is not None:
                learner.save_checkpoint(ckpt)
    finally:
        learner.close()
    result["frames"] = frames
    returns = result["episode_returns"]
    if returns:
        result["mean_return_last20"] = float(np.mean(returns[-20:]))
    return result
