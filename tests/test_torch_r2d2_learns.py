"""Twin of `tests/test_e2e.py::test_r2d2_trains_cartpole_pomdp` on the
PyTorch port, on the CPU (the plain versions of the LSTM kernels).

The POMDP view (position and angle only) needs the LSTM to integrate
velocity; a feedforward Q cannot solve it. Same bar as the JAX test:
late-20 mean return above 60 and above the early-20 mean. A file of its
own, so that `--dist loadfile` gives it a worker of its own.
"""

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Agent, R2D2Config
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
from distributed_reinforcement_learning_tpu_torch.envs.cartpole import (
    VectorCartPole, pomdp_project)
from distributed_reinforcement_learning_tpu_torch.runtime import r2d2_runner
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore


def test_r2d2_learns_cartpole_pomdp():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = R2D2Config(obs_shape=(2,), num_actions=2, seq_len=10, burn_in=5,
                         lstm_size=64, learning_rate=1e-3)
        agent = R2D2Agent(cfg, device="cpu")
        queue = TrajectoryQueue(capacity=128)
        weights = WeightStore()
        learner = r2d2_runner.R2D2Learner(agent, queue, weights, batch_size=16,
                                          replay_capacity=5_000, target_sync_interval=20,
                                          seed=0)
        actor = r2d2_runner.R2D2Actor(agent, VectorCartPole(num_envs=8, seed=0), queue,
                                      weights, seed=1, obs_transform=pomdp_project)
        result = r2d2_runner.run_sync(learner, [actor], num_updates=400)
    finally:
        torch.set_num_threads(threads)

    assert learner.train_steps == 400
    assert np.isfinite(result["last_metrics"]["loss"])
    assert len(learner.replay) >= 32
    returns = result["episode_returns"]
    late = np.mean(returns[-20:])
    early = np.mean(returns[:20])
    assert late > 60, f"late mean return {late} (early {early})"
    assert late > early
