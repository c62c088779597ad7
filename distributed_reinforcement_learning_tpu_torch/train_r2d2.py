"""R2D2 training with the PyTorch port.

    python -m distributed_reinforcement_learning_tpu_torch.train_r2d2 \\
        --section r2d2 --updates 100 [--device cpu] [--run_dir runs/x]

The modes and options of `train_impala.py`: `--mode local` (default,
one process; prints the result as JSON), `--mode learner`, `--mode actor
--task k`, and `--mode anakin` (`runtime/anakin_r2d2.py`: one sequence
from every device env a collect, scored into a prioritized sequence ring
on the device; `--anakin_capacity`, default min(replay_capacity, 4096)
sequences). Every mode runs on CUDA unless `--device` names another
device; served acts and the opt-in planes (`DRL_WEIGHTS_SHARDED`,
`DRL_DEVICE_PATH`) as in `train_impala.py`; what `train_impala.py`
refuses (`--mode anakin` under `DRL_COORDINATOR`, ROADMAP F14), this
refuses.
"""

from __future__ import annotations

from distributed_reinforcement_learning_tpu_torch.train_impala import run_cli


def main(argv: list[str] | None = None) -> dict:
    return run_cli(__doc__, "r2d2", "r2d2", argv)


if __name__ == "__main__":
    main()
