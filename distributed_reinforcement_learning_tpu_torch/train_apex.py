"""Ape-X training with the PyTorch port.

    python -m distributed_reinforcement_learning_tpu_torch.train_apex \\
        --section apex --updates 100 [--device cpu] [--run_dir runs/x]

The modes and options of `train_impala.py`: `--mode local` (default,
one process; prints the result as JSON), `--mode learner`, `--mode actor
--task k` (64 env steps a round, one re-sampled unroll put a step once
warm). Every mode runs on CUDA unless `--device` names another device.
`--mode anakin` (ROADMAP item 14), `--mode inference`,
`--serve_inference` and `--remote_act` (item 12) are not ported and
raise.
"""

from __future__ import annotations

from distributed_reinforcement_learning_tpu_torch.train_impala import run_cli


def main(argv: list[str] | None = None) -> dict:
    return run_cli(__doc__, "apex", "apex", argv)


if __name__ == "__main__":
    main()
