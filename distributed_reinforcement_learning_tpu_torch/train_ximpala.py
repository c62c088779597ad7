"""Single-process Transformer-IMPALA training with the PyTorch port.

    python -m distributed_reinforcement_learning_tpu_torch.train_ximpala \\
        --section ximpala --updates 400 [--device cpu] [--run_dir runs/x]

Runs on CUDA unless `--device` names another device. Prints the result
(frames, last metrics, mean return of the last 20 episodes) as JSON.
"""

from __future__ import annotations

from distributed_reinforcement_learning_tpu_torch.train_impala import run_cli


def main(argv: list[str] | None = None) -> dict:
    return run_cli(__doc__, "ximpala", argv)


if __name__ == "__main__":
    main()
