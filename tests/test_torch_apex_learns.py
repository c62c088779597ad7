"""The Ape-X learning bar of the JAX package (`tests/test_e2e.py`,
`test_apex_trains_cartpole`) against the port, on the CPU: the same
configuration (`SimpleQNetwork`, lr 1e-3, batch 32, replay 10,000,
target sync 25, 1 actor x 8 CartPole envs, unrolls of 32 from a local
buffer of 5,000, 400 updates) must reach a late mean return above 60 and
above the early one.

The packages' random streams differ (torch's generator against JAX's
PRNG), so the seeds are the port's own: learner seed 0 (parameters and
sampling stream), env seed 0, actor seed 1, as in the JAX test. On this
seed the run reached early 16.5 / late 116.5; seeds 1 and 2 reached
late 169.1 and 156.0. One run takes ~12 s of CPU time on one thread.
"""

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexAgent, ApexConfig
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
from distributed_reinforcement_learning_tpu_torch.envs.cartpole import VectorCartPole
from distributed_reinforcement_learning_tpu_torch.runtime import apex_runner
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore


def test_apex_learns_cartpole():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = ApexConfig(obs_shape=(4,), num_actions=2, start_learning_rate=1e-3,
                         reward_clipping="abs_one")
        agent = ApexAgent(cfg, device="cpu")
        queue, weights = TrajectoryQueue(capacity=64), WeightStore()
        learner = apex_runner.ApexLearner(agent, queue, weights, batch_size=32,
                                          replay_capacity=10_000, target_sync_interval=25,
                                          seed=0)
        actor = apex_runner.ApexActor(agent, VectorCartPole(num_envs=8, seed=0), queue, weights,
                                      seed=1, unroll_size=32, local_capacity=5_000)
        result = apex_runner.run_sync(learner, [actor], num_updates=400)
    finally:
        torch.set_num_threads(threads)

    assert learner.train_steps == 400
    assert type(learner.replay).__name__ == "ArrayPrioritizedReplay"
    assert len(learner.replay) > 100
    assert np.isfinite(result["last_metrics"]["loss"])
    returns = result["episode_returns"]
    late, early = np.mean(returns[-20:]), np.mean(returns[:20])
    assert late > 60, f"late mean return {late} (early {early})"
    assert late > early
