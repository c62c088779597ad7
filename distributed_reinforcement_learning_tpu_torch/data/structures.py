"""Client-side trajectory accumulators.

Counterpart of the IMPALA, R2D2 and Transformer-IMPALA parts of the JAX package's
`data/structures.py`: one accumulator holds a whole vectorized actor's
unroll as a `[T]`-list of `[N, ...]` numpy arrays and emits one
trajectory (or sequence) per env; `SlicedAccumulators` keeps one per
env slice of the pipelined actor.
"""

from __future__ import annotations

import numpy as np

from distributed_reinforcement_learning_tpu_torch.agents.impala import ImpalaBatch
from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Batch
from distributed_reinforcement_learning_tpu_torch.agents.ximpala import XImpalaBatch


class _StackedUnrollAccumulator:
    """Collect T steps of `[N, ...]` fields; emit one `[T, ...]` batch
    tuple per env slot (the queue stacks them into `[B, T, ...]`).
    Subclasses name the batch class."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._steps: list[dict] = []

    def append(self, **step_fields: np.ndarray) -> None:
        self._steps.append(step_fields)

    def __len__(self) -> int:
        return len(self._steps)

    def _batch_cls(self):
        raise NotImplementedError

    def extract(self) -> list:
        cls = self._batch_cls()
        fields = {
            k: np.stack([s[k] for s in self._steps], axis=1)  # [N, T, ...]
            for k in self._steps[0]
        }
        n = next(iter(fields.values())).shape[0]
        return [cls(**{k: v[i] for k, v in fields.items()}) for i in range(n)]


class SlicedAccumulators:
    """k independent accumulators, one per env slice of the pipelined
    actor (`runtime/actor_pipeline.py`), so a slice accumulates its own
    unroll while another slice's act is in flight. Copy of the JAX
    package's `SlicedAccumulators`."""

    def __init__(self, make_accumulator, num_slices: int):
        self._accs = [make_accumulator() for _ in range(num_slices)]

    def reset_slice(self, index: int, *args) -> None:
        self._accs[index].reset(*args)

    def append_slice(self, index: int, **step_fields: np.ndarray) -> None:
        self._accs[index].append(**step_fields)

    def extract_slice(self, index: int) -> list:
        return self._accs[index].extract()


class ImpalaTrajectoryAccumulator(_StackedUnrollAccumulator):
    """T steps of an `[N]`-env actor -> N `ImpalaBatch`es with a leading
    `[T]` axis (no batch axis: the queue stacks them)."""

    def _batch_cls(self):
        return ImpalaBatch


class XImpalaTrajectoryAccumulator(_StackedUnrollAccumulator):
    """T steps of an `[N]`-env actor -> N `XImpalaBatch`es: the IMPALA
    payload minus the stored (h, c), since the transformer re-attends
    over the unroll."""

    def _batch_cls(self):
        return XImpalaBatch


class R2D2SequenceAccumulator(_StackedUnrollAccumulator):
    """seq_len steps of an `[N]`-env actor plus the sequence-start LSTM
    state -> N `R2D2Batch`es (`[T, ...]` fields, `[H]` start state). The
    learner seeds each unroll from that state alone."""

    def reset(self, initial_h: np.ndarray | None = None,
              initial_c: np.ndarray | None = None) -> None:
        super().reset()
        self._initial_h = None if initial_h is None else np.asarray(initial_h).copy()
        self._initial_c = None if initial_c is None else np.asarray(initial_c).copy()

    def extract(self) -> list[R2D2Batch]:
        fields = {k: np.stack([s[k] for s in self._steps], axis=1) for k in self._steps[0]}
        return [R2D2Batch(**{k: v[i] for k, v in fields.items()},
                          initial_h=self._initial_h[i], initial_c=self._initial_c[i])
                for i in range(self._initial_h.shape[0])]
