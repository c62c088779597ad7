"""Twin of `tests/test_e2e.py::test_xformer_trains_cartpole_pomdp` on the
PyTorch port, on the CPU.

The causal transformer solves the CartPole POMDP (position and angle
only) that the LSTM solves: attention over the window integrates
velocity. The JAX test's configuration (d_model 32, 2 heads, 2 layers,
seq_len 10, burn-in 5, Adam 2e-3, batch 16, 8 envs, target sync every
20) and bar: 600 updates for each of seeds 0, 1 and 2, each seed's
late-20 mean return above 25 (a random policy scores ~20), the seed mean
above 60. Wired as the JAX test is: the seed goes to the learner's
parameters (`init_seed`, the JAX test's `rng=PRNGKey(seed)`) and the
replay samples from the learner's default `RandomState(0)`. One torch
thread, so each run is deterministic. A file of its own, so that
`--dist loadfile` gives it a worker of its own.
"""

import numpy as np
import pytest
import torch

from distributed_reinforcement_learning_tpu_torch.agents.xformer import (
    XformerAgent, XformerConfig)
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
from distributed_reinforcement_learning_tpu_torch.envs.cartpole import (
    VectorCartPole, pomdp_project)
from distributed_reinforcement_learning_tpu_torch.runtime import xformer_runner
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_xformer_learns_cartpole_pomdp():
    cfg = XformerConfig(obs_shape=(2,), num_actions=2, seq_len=10, burn_in=5, d_model=32,
                        num_heads=2, num_layers=2, learning_rate=2e-3)
    agent = XformerAgent(cfg, device="cpu")

    def run_seed(seed: int) -> float:
        queue = TrajectoryQueue(capacity=128)
        weights = WeightStore()
        learner = xformer_runner.XformerLearner(
            agent, queue, weights, batch_size=16, replay_capacity=5_000,
            target_sync_interval=20, init_seed=seed)
        actor = xformer_runner.XformerActor(
            agent, VectorCartPole(num_envs=8, seed=seed), queue, weights, seed=seed + 1,
            obs_transform=pomdp_project)
        result = xformer_runner.run_sync(learner, [actor], num_updates=600)
        assert learner.train_steps == 600
        assert np.isfinite(result["last_metrics"]["loss"])
        return float(np.mean(result["episode_returns"][-20:]))

    lates = [run_seed(s) for s in (0, 1, 2)]
    assert all(late > 25 for late in lates), lates  # each seed beats random
    assert np.mean(lates) > 60, lates  # the seed-averaged learning bar
