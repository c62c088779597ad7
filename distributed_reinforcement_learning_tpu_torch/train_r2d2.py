"""R2D2 training with the PyTorch port.

    python -m distributed_reinforcement_learning_tpu_torch.train_r2d2 \\
        --section r2d2 --updates 100 [--device cpu] [--run_dir runs/x]

The modes and options of `train_impala.py`: `--mode local` (default,
one process; prints the result as JSON), `--mode learner`, `--mode actor
--task k`. Every mode runs on CUDA unless `--device` names another
device; what `train_impala.py` refuses (serving, item 12d; sharded
weights, 12e; the learner tier, 13; `--mode anakin`, 14;
`DRL_DEVICE_PATH`, 16), this refuses.
"""

from __future__ import annotations

from distributed_reinforcement_learning_tpu_torch.train_impala import run_cli


def main(argv: list[str] | None = None) -> dict:
    return run_cli(__doc__, "r2d2", "r2d2", argv)


if __name__ == "__main__":
    main()
