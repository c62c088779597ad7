"""Transformer-IMPALA training with the PyTorch port.

    python -m distributed_reinforcement_learning_tpu_torch.train_ximpala \\
        --section ximpala --updates 400 [--device cpu] [--run_dir runs/x]

The modes and options of `train_impala.py`: `--mode local` (default,
one process; prints the result as JSON), `--mode learner`, `--mode actor
--task k`. Every mode runs on CUDA unless `--device` names another
device; served acts and sharded publication (`DRL_WEIGHTS_SHARDED`) as
in `train_impala.py`; what `train_impala.py` refuses (the learner tier,
13), this refuses, and `--mode anakin` too: the JAX package has no
on-device loop for this family (ROADMAP item 14 ported IMPALA's, Ape-X's
and R2D2's). A learner group (`--learners N` of `launch_local_cluster`,
`DRL_COORDINATOR`) runs the section's sequence (`attention`,
`seq_parallel`), pipeline (`pipeline`, `pipeline_stages`,
`pipeline_microbatches`) and expert (`expert_parallel`) axes; actors
act on the plain-apply twin.
"""

from __future__ import annotations

from distributed_reinforcement_learning_tpu_torch.train_impala import run_cli


def main(argv: list[str] | None = None) -> dict:
    return run_cli(__doc__, "ximpala", "ximpala", argv)


if __name__ == "__main__":
    main()
