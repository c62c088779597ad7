"""Parallel learners: the mesh of ranks, the sharded learner, sequence
and pipeline parallelism, the multi-process join, and the partition
rules of the weight plane.

Exports what the JAX package's `parallel/__init__.py` exports, and the
port's own pieces that a caller builds a mesh run from: `RankMesh`,
`Placement`, `MeshReducer` and `runner_learner` (the Anakin loops and
the tier's mesh seats take them)."""

from distributed_reinforcement_learning_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    Placement,
    RankMesh,
    data_sharding,
    make_mesh,
    model_kernel_sharding,
    place_local_batch,
    replicated,
)
from distributed_reinforcement_learning_tpu_torch.parallel.learner import (
    MeshReducer,
    ShardedLearner,
    runner_learner,
    train_state_sharding,
)
from distributed_reinforcement_learning_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    stack_stage_params,
)
from distributed_reinforcement_learning_tpu_torch.parallel.sequence import (
    ring_attention,
    ulysses_attention,
)
from distributed_reinforcement_learning_tpu_torch.parallel import distributed

__all__ = [
    "DATA_AXIS",
    "EXPERT_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "SEQ_AXIS",
    "distributed",
    "MeshReducer",
    "Placement",
    "RankMesh",
    "ShardedLearner",
    "data_sharding",
    "make_mesh",
    "model_kernel_sharding",
    "pipeline_apply",
    "place_local_batch",
    "replicated",
    "ring_attention",
    "runner_learner",
    "stack_stage_params",
    "train_state_sharding",
    "ulysses_attention",
]
