"""Client-side trajectory accumulators.

Counterpart of the IMPALA and R2D2 parts of the JAX package's
`data/structures.py`: one accumulator holds a whole vectorized actor's
unroll as a `[T]`-list of `[N, ...]` numpy arrays and emits one
trajectory (or sequence) per env.
"""

from __future__ import annotations

import numpy as np

from distributed_reinforcement_learning_tpu_torch.agents.impala import ImpalaBatch
from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Batch


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


class ImpalaTrajectoryAccumulator(_StackedUnrollAccumulator):
    """T steps of an `[N]`-env actor -> N `ImpalaBatch`es with a leading
    `[T]` axis (no batch axis: the queue stacks them)."""

    def _batch_cls(self):
        return ImpalaBatch


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
