"""Ape-X training with the PyTorch port.

    python -m distributed_reinforcement_learning_tpu_torch.train_apex \\
        --section apex --updates 100 [--device cpu] [--run_dir runs/x]

The modes and options of `train_impala.py`: `--mode local` (default,
one process; prints the result as JSON), `--mode learner`, `--mode actor
--task k` (64 env steps a round, one re-sampled unroll put a step once
warm). `--mode anakin` runs `runtime/anakin_apex.py`: 16 steps from every
device env a collect, TD-scored into a prioritized transition ring on
the device (`--anakin_capacity`, default min(replay_capacity, 32768)
cut to a multiple of the write width), `updates_per_call` learns a
collect. Every mode runs on CUDA unless `--device` names another device.
Served acts as in `train_impala.py` (`--serve_inference`, `--remote_act`,
`--mode inference`), and the opt-in planes `DRL_WEIGHTS_SHARDED` and
`DRL_DEVICE_PATH`, and the multi-process learner (item 13b), which
ignores a section's `seq_parallel` and `expert_parallel` (they shard the
transformer families alone), as the JAX package does. What
`train_impala.py` refuses, this refuses: `--mode anakin` under
`DRL_COORDINATOR` (ROADMAP F14).
"""

from __future__ import annotations

from distributed_reinforcement_learning_tpu_torch.train_impala import run_cli


def main(argv: list[str] | None = None) -> dict:
    return run_cli(__doc__, "apex", "apex", argv)


if __name__ == "__main__":
    main()
