"""Build-and-run helpers.

Counterpart of `make_learner` / `make_actor` / `build_local` /
`train_local` in the JAX package's `runtime/launch.py`, for IMPALA, Ape-X,
R2D2, Transformer-R2D2 and Transformer-IMPALA: resolve envs from the
registry, build agent, queue, weight store, learner and actors from a
config section (the agent config's type picks the family). `make_learner` and `make_actor`
take any queue and weight store, the learner's own objects in one
process or the transport's adapters across processes
(`runtime/transport.py:run_role`). `train_anakin`, `train_anakin_apex`
and `train_anakin_r2d2` run the on-device loops (`--mode anakin`).
Everything runs on CUDA unless the caller passes another `device`.
"""

from __future__ import annotations

import dataclasses
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


# Families whose learn step can shard beyond data parallelism (ring,
# pipeline, expert): the JAX package's transformer families.
_TRANSFORMER_ALGOS = ("xformer", "ximpala")


def mesh_axes_for(agent_cfg: Any, rt: RuntimeConfig) -> tuple[int, int, int]:
    """(seq, pipe, expert) axis sizes the learner mesh should carve for
    this config, the JAX package's rule: a pipeline forces the seq axis
    to 1 and takes `pipeline_stages` (else `num_layers`) stages; the
    expert axis counts only with experts."""
    pipelined = getattr(agent_cfg, "pipeline", False)
    return (
        1 if pipelined else rt.seq_parallel,
        (getattr(agent_cfg, "pipeline_stages", 0)
         or getattr(agent_cfg, "num_layers", 1)) if pipelined else 1,
        rt.expert_parallel if getattr(agent_cfg, "num_experts", 0) else 1,
    )


def needs_sharded_learner(algo: str, agent_cfg: Any, rt: RuntimeConfig) -> bool:
    """True when the learn step is sharded beyond data parallelism
    (sequence-parallel attention, a pipeline, experts over an expert
    axis), and actors therefore need a plain-apply twin."""
    return algo in _TRANSFORMER_ALGOS and (
        agent_cfg.attention != "dense"
        or agent_cfg.pipeline
        or (agent_cfg.num_experts > 0 and rt.expert_parallel > 1)
    )


def make_agent(algo: str, agent_cfg: Any, device: str | torch.device | None = None,
               rt: RuntimeConfig | None = None, mesh=None, actor: bool = False):
    """The agent of family `algo` on `device`, the JAX package's rule.

    A transformer config whose learn step is sharded (`needs_sharded_learner`)
    gets, for an `actor`, the plain-apply twin's agent (dense attention,
    no pipeline, the stacked layout a pipelined learner publishes); for a
    learner, the agent over `mesh`, or over a mesh of the world's ranks
    carved by `mesh_axes_for` when `mesh` is None (a world too small for
    the axes is refused, as JAX refuses one device). A transformer
    learner given a `mesh` takes it whatever its config (an MoE routes the
    mesh's union batch)."""
    cls = _AGENT_CLS[algo]
    if rt is not None and needs_sharded_learner(algo, agent_cfg, rt):
        if actor:
            return cls(dataclasses.replace(
                agent_cfg, attention="dense", pipeline=False,
                stacked=agent_cfg.pipeline or agent_cfg.stacked), device=device)
        if mesh is None:
            from distributed_reinforcement_learning_tpu_torch.parallel.mesh import make_mesh

            seq, pipe, expert = mesh_axes_for(agent_cfg, rt)
            mesh = make_mesh(seq_parallel=seq, pipe_parallel=pipe, expert_parallel=expert,
                             device=device)
        return cls(agent_cfg, device=device, mesh=mesh)
    if algo in _TRANSFORMER_ALGOS and mesh is not None and not actor:
        return cls(agent_cfg, device=device, mesh=mesh)
    return cls(agent_cfg, device=device)


def make_learner(algo: str, agent_cfg: Any, rt: RuntimeConfig, queue, weights,
                 logger: MetricsLogger | None = None, seed: int = 0,
                 device: str | torch.device | None = None, agent=None,
                 prefetch: bool = False, replay_service=None, mesh=None):
    """The learner of family `algo` over any queue and weight store.
    `prefetch` (IMPALA families) overlaps batch k+1's H2D copy with step k;
    `replay_service` (replay families) is the sharded replay the learner
    samples while it is healthy (`runtime/replay_shard.build_service`);
    `mesh` (a `parallel/mesh.RankMesh` over the data) makes the learner
    one rank of a sharded learner (`parallel/learner.py`).
    `seed` seeds the initial parameters, as the JAX launcher's
    `rng=PRNGKey(seed)` does; the replay learners keep their sampling
    stream at `RandomState(0)`, the JAX learners' default."""
    agent = agent or make_agent(algo, agent_cfg, device=device, rt=rt, mesh=mesh)
    if algo in ("apex", *SEQUENCE_REPLAY) and prefetch:
        raise ValueError(f"the {algo} learner samples its batches from the replay; "
                         "it has no queue prefetch")
    if algo == "apex":
        return apex_runner.ApexLearner(
            agent, queue, weights, rt.batch_size, replay_capacity=rt.replay_capacity,
            target_sync_interval=rt.target_sync_interval, logger=logger, init_seed=seed,
            publish_interval=rt.publish_interval, updates_per_call=rt.updates_per_call,
            replay_service=replay_service, mesh=mesh)
    if algo in SEQUENCE_REPLAY:
        cls = xformer_runner.XformerLearner if algo == "xformer" else r2d2_runner.R2D2Learner
        return cls(
            agent, queue, weights, rt.batch_size, replay_capacity=rt.replay_capacity,
            target_sync_interval=rt.target_sync_interval, logger=logger, init_seed=seed,
            publish_interval=rt.publish_interval, updates_per_call=rt.updates_per_call,
            replay_service=replay_service, mesh=mesh)
    cls = (ximpala_runner.XImpalaLearner if algo == "ximpala"
           else impala_runner.ImpalaLearner)
    return cls(agent, queue, weights, rt.batch_size, logger=logger, seed=seed,
               publish_interval=rt.publish_interval, prefetch=prefetch,
               updates_per_call=rt.updates_per_call, mesh=mesh)


def make_actor(algo: str, agent_cfg: Any, rt: RuntimeConfig, task: int, queue, weights,
               seed: int = 0, device: str | torch.device | None = None, agent=None,
               remote_act=None):
    """Actor `task` of the topology over any queue and weight store. Pass
    `agent` to share one agent between runners in a process. `remote_act`
    (any family; a `transport.RemoteInference` or `RemoteActService`, or
    an `InferenceServer.submit`) makes the actor act through a service:
    it then pulls no weights."""
    agent = agent or make_agent(algo, agent_cfg, device=device, rt=rt, actor=True)
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
    agent is shared by the learner and every actor, except a sharded
    learner's (`needs_sharded_learner`), whose actors share its twin's."""
    algo = algo_of(agent_cfg)
    queue = TrajectoryQueue(rt.queue_size)
    weights = WeightStore()
    agent = make_agent(algo, agent_cfg, device=device, rt=rt)
    actor_agent = (make_agent(algo, agent_cfg, device=device, rt=rt, actor=True)
                   if needs_sharded_learner(algo, agent_cfg, rt) else agent)
    learner = make_learner(algo, agent_cfg, rt, queue, weights, logger=MetricsLogger(run_dir),
                           seed=seed, agent=agent)
    actors = [make_actor(algo, agent_cfg, rt, i, queue, weights, seed=seed + 1 + i,
                         agent=actor_agent)
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


# -- the on-device (Anakin) loops ---------------------------------------------


def _device_env_for(agent_cfg, rt: RuntimeConfig):
    """-> (env module | None, obs transform | None) for `--mode anakin`.

    Pixel sections route by their first env's name to the device games;
    vector sections take the device CartPole (None, the loops' default),
    with the POMDP projection where the agent observes the 2-feature
    view."""
    from distributed_reinforcement_learning_tpu_torch.envs import cartpole_device

    env_name = rt.envs[0] if rt.envs else ""
    if env_name.startswith("Breakout"):
        from distributed_reinforcement_learning_tpu_torch.envs import breakout_device

        return breakout_device, None
    if env_name.startswith("SpaceInvaders"):
        from distributed_reinforcement_learning_tpu_torch.envs import invaders_device

        return invaders_device, None
    if env_name.startswith("Pong"):
        from distributed_reinforcement_learning_tpu_torch.envs import pong_device

        return pong_device, None
    if tuple(agent_cfg.obs_shape) == (2,):
        return None, cartpole_device.pomdp_project
    return None, None


def _restore_train(checkpoint_dir: str | None, train):
    """-> (Checkpointer | None, train) with the latest checkpoint loaded
    into `train`'s own tensors."""
    if not checkpoint_dir:
        return None, train
    from distributed_reinforcement_learning_tpu_torch.utils.checkpoint import Checkpointer

    ckpt = Checkpointer(checkpoint_dir)
    got = ckpt.restore(train)
    if got is not None:
        train = got[0]
    return ckpt, train


def _check_family(agent_cfg, want: str, message: str) -> None:
    if algo_of(agent_cfg) != want:
        raise ValueError(message)


def _report_chunk(updates: int, frames: int, dt: float) -> None:
    from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY

    if TELEMETRY.enabled:
        TELEMETRY.count("anakin/updates", updates)
        TELEMETRY.gauge("anakin/device_chunk_s", dt)
        TELEMETRY.gauge("anakin/steps_per_s", updates / dt)
        TELEMETRY.gauge("anakin/frames_per_s", frames / dt)


def _chunk_return(m: dict) -> tuple[float, float]:
    """-> (mean completed return, games completed) of a chunk's metrics:
    the chunk's one read of device values on the host."""
    eps = float(m["episodes_done"].sum())
    return float(m["episode_return_sum"].sum()) / max(eps, 1.0), eps


def train_anakin(config_path: str, section: str, num_updates: int, chunk: int = 50,
                 seed: int = 0, num_envs: int | None = None,
                 checkpoint_dir: str | None = None, run_dir: str | None = None,
                 device: str | torch.device | None = None) -> dict:
    """IMPALA on one device (`runtime/anakin.py`), for the sections whose
    env has a device twin. Collect and learn run in chunks of `chunk`
    updates; each chunk's mean completed return goes to stdout.
    `checkpoint_dir` saves and restores the train state a chunk (env and
    LSTM state are not kept: a resume starts fresh episodes, as an actor
    restart does)."""
    import time

    from distributed_reinforcement_learning_tpu_torch.observability import maybe_configure
    from distributed_reinforcement_learning_tpu_torch.runtime.anakin import AnakinImpala

    agent_cfg, rt = load_config(config_path, section)
    _check_family(agent_cfg, "impala", "anakin mode currently runs the IMPALA family")
    env_mod, _ = _device_env_for(agent_cfg, rt)
    anakin = AnakinImpala(ImpalaAgent(agent_cfg, device=device),
                          num_envs or rt.num_actors * rt.envs_per_actor, env=env_mod)
    state = anakin.init(seed)
    ckpt, state.train = _restore_train(checkpoint_dir, state.train)
    chunk = max(1, min(chunk, num_updates))
    returns = []
    maybe_configure("anakin", 0, run_dir)  # env-gated run-wide telemetry
    frames_per_update = anakin.num_envs * agent_cfg.trajectory
    while state.train.step < num_updates:
        u = min(chunk, num_updates - state.train.step)
        t0 = time.perf_counter()
        state, m = anakin.train_chunk(state, u)
        mean_ret, eps = _chunk_return(m)
        dt = time.perf_counter() - t0  # the reads above synchronise the chunk
        _report_chunk(u, u * frames_per_update, dt)
        returns.append(mean_ret)
        print(f"[anakin] step {state.train.step}: mean_return {mean_ret:.1f} "
              f"({eps:.0f} episodes, loss {float(m['total_loss'][-1]):.2f})")
        if ckpt is not None:
            ckpt.save(state.train.step, state.train, {})
    return {
        "frames": state.train.step * frames_per_update,
        "chunk_mean_returns": [round(r, 2) for r in returns],
        "mean_return_last_chunk": round(returns[-1], 2) if returns else None,
    }


def _replay_chunk_loop(anakin, state, num_updates: int, chunk: int, ckpt, label: str,
                       frames_per_collect: int, warm: int, run_dir: str | None = None) -> dict:
    """The warm-up and chunked train loop of the replay loops (`AnakinApex`,
    `AnakinR2D2`). `num_updates` counts optimizer steps; a chunk's update
    is one collect and K learns (K = `updates_per_collect`), so the last
    chunk may overshoot by up to K - 1 steps."""
    import time

    from distributed_reinforcement_learning_tpu_torch.observability import maybe_configure

    state, _ = anakin.collect_chunk(state, warm)
    K = anakin.updates_per_collect
    collects = warm
    returns = []
    maybe_configure(label, 0, run_dir)  # env-gated run-wide telemetry
    while state.train.step < num_updates:
        u = max(1, min(chunk, -(-(num_updates - state.train.step) // K)))
        t0 = time.perf_counter()
        state, m = anakin.train_chunk(state, u)
        collects += u
        mean_ret, eps = _chunk_return(m)
        dt = time.perf_counter() - t0  # the reads above synchronise the chunk
        _report_chunk(u * K, u * frames_per_collect, dt)
        returns.append(mean_ret)
        print(f"[{label}] step {state.train.step}: mean_return {mean_ret:.1f} "
              f"({eps:.0f} episodes, loss {float(m['loss'][-1]):.4f}, "
              f"eps {float(m['epsilon_mean'][-1]):.3f})")
        if ckpt is not None:
            ckpt.save(state.train.step, state.train, {})
    return {
        "frames": collects * frames_per_collect,
        "chunk_mean_returns": [round(r, 2) for r in returns],
        "mean_return_last_chunk": round(returns[-1], 2) if returns else None,
    }


def train_anakin_apex(config_path: str, section: str, num_updates: int, chunk: int = 50,
                      seed: int = 0, num_envs: int | None = None, capacity: int | None = None,
                      checkpoint_dir: str | None = None, run_dir: str | None = None,
                      device: str | torch.device | None = None) -> dict:
    """Ape-X on one device (`runtime/anakin_apex.py`): collection, the
    prioritized ring, double-DQN training and target syncs.

    `capacity` defaults to min(replay_capacity, 32768) transitions, cut to
    a multiple of the write width: a pixel transition holds two 84x84x4
    uint8 stacks (56 KB), so the default ring takes ~1.8 GB of device
    memory."""
    from distributed_reinforcement_learning_tpu_torch.runtime.anakin_apex import AnakinApex

    agent_cfg, rt = load_config(config_path, section)
    _check_family(agent_cfg, "apex", "anakin-apex mode runs the Ape-X family")
    env_mod, obs_transform = _device_env_for(agent_cfg, rt)
    n = num_envs or rt.num_actors * rt.envs_per_actor
    steps = 16
    width = n * steps
    cap = capacity or min(rt.replay_capacity, 32768)
    cap = max(width, cap - cap % width)  # ring writes stay width-aligned
    anakin = AnakinApex(
        ApexAgent(agent_cfg, device=device), num_envs=n, batch_size=rt.batch_size,
        capacity=cap, steps_per_collect=steps, target_sync_interval=rt.target_sync_interval,
        updates_per_collect=rt.updates_per_call, epsilon_floor=rt.epsilon_floor or 0.0,
        env=env_mod, obs_transform=obs_transform)
    state = anakin.init(seed)
    ckpt, state.train = _restore_train(checkpoint_dir, state.train)
    warm = -(-rt.train_start_factor * rt.batch_size // width)
    return _replay_chunk_loop(anakin, state, num_updates, chunk, ckpt, "anakin-apex", width,
                              warm, run_dir=run_dir)


def train_anakin_r2d2(config_path: str, section: str, num_updates: int, chunk: int = 50,
                      seed: int = 0, num_envs: int | None = None, capacity: int | None = None,
                      checkpoint_dir: str | None = None, run_dir: str | None = None,
                      device: str | torch.device | None = None) -> dict:
    """R2D2 on one device (`runtime/anakin_r2d2.py`): collection, the
    prioritized sequence ring and training. `capacity` defaults to
    min(replay_capacity, 4096) sequences, cut to a multiple of the env
    count: the ring lives in device memory."""
    from distributed_reinforcement_learning_tpu_torch.runtime.anakin_r2d2 import AnakinR2D2

    agent_cfg, rt = load_config(config_path, section)
    _check_family(agent_cfg, "r2d2", "anakin-r2d2 mode runs the R2D2 family")
    env_mod, obs_transform = _device_env_for(agent_cfg, rt)
    n = num_envs or rt.num_actors * rt.envs_per_actor
    cap = capacity or min(rt.replay_capacity, 4096)
    cap = max(n, cap - cap % n)  # ring writes stay n-aligned
    anakin = AnakinR2D2(
        R2D2Agent(agent_cfg, device=device), num_envs=n, batch_size=rt.batch_size,
        capacity=cap, target_sync_interval=rt.target_sync_interval,
        updates_per_collect=rt.updates_per_call, epsilon_floor=rt.epsilon_floor or 0.0,
        env=env_mod, obs_transform=obs_transform)
    state = anakin.init(seed)
    ckpt, state.train = _restore_train(checkpoint_dir, state.train)
    # Warm-up: the host learner's train-start gate (more than factor x
    # batch sequences) as collect-only updates.
    warm = -(-rt.train_start_factor * rt.batch_size // n)
    return _replay_chunk_loop(anakin, state, num_updates, chunk, ckpt, "anakin-r2d2",
                              n * agent_cfg.seq_len, warm, run_dir=run_dir)
