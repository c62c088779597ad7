"""Prioritized experience replay: SumTree + PrioritizedReplay.

Counterpart of the python backend of the JAX package's `data/replay.py`,
host numpy with the same arithmetic, so that one seed gives both
packages the same tree indices and IS weights. Priority
`(|err| + 0.001) ** 0.6`; stratified sampling over `total / n` segments;
IS weights `(N * p) ** -beta` normalised by the batch max; beta annealed
0.4 -> 1.0 by 0.001 per `sample()`; `update_batch` re-prioritises every
sampled index.

Not ported: the C++ sum tree (`native`, `array`), the disk spill tier,
snapshots and the telemetry counters.
"""

from __future__ import annotations

from typing import Any

import numpy as np


class SumTree:
    """Array-backed binary sum tree over `capacity` leaf priorities."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._tree = np.zeros(2 * capacity - 1, np.float64)
        self._data: list[Any] = [None] * capacity
        self._write = 0
        self._count = 0

    def __len__(self) -> int:
        return self._count

    @property
    def total(self) -> float:
        return float(self._tree[0])

    def add(self, priority: float, data: Any) -> int:
        idx = self._write + self.capacity - 1
        self._data[self._write] = data
        self.set_priority(idx, priority)
        self._write = (self._write + 1) % self.capacity
        self._count = min(self._count + 1, self.capacity)
        return idx

    def set_priority(self, idx: int, priority: float) -> None:
        delta = priority - self._tree[idx]
        while True:
            self._tree[idx] += delta
            if idx == 0:
                break
            idx = (idx - 1) // 2

    def get(self, value: float) -> tuple[int, float, Any]:
        """The leaf whose cumulative-priority interval contains `value`."""
        idx = 0
        while True:
            left = 2 * idx + 1
            if left >= len(self._tree):
                break
            if value <= self._tree[left]:
                idx = left
            else:
                value -= self._tree[left]
                idx = left + 1
        return idx, float(self._tree[idx]), self._data[idx - (self.capacity - 1)]


def priority_transform(errors) -> np.ndarray:
    """TD error -> sum-tree leaf priority, `(|err| + EPS) ** ALPHA`."""
    return (np.abs(np.asarray(errors, np.float64))
            + PrioritizedReplay.EPS) ** PrioritizedReplay.ALPHA


class PrioritizedReplay:
    """add_batch / sample / update_batch over a sum tree. Single-thread by contract:
    the learner thread both ingests and samples."""

    EPS = 0.001
    ALPHA = 0.6
    BETA_INCREMENT = 0.001

    def __init__(self, capacity: int, beta: float = 0.4, seed: int = 0):
        self.tree = SumTree(capacity)
        self.beta = beta
        self._default_rng = np.random.RandomState(seed)  # owned sampling stream

    def __len__(self) -> int:
        return len(self.tree)

    def _priority(self, error: float) -> float:
        return (abs(error) + self.EPS) ** self.ALPHA

    def add_batch(self, errors: np.ndarray, samples: list[Any]) -> list[int]:
        return [self.tree.add(self._priority(e), s) for e, s in zip(errors, samples)]

    def _pick(self, n: int, rng) -> tuple[list, np.ndarray, np.ndarray]:
        """Stratified pick -> (items, tree_idxs, raw priorities)."""
        segment = self.tree.total / n
        idxs = np.empty(n, np.int64)
        priorities = np.empty(n, np.float64)
        items = []
        for i in range(n):
            # Retry guards against float64 rounding in the subtractive
            # descent landing on an unwritten zero-priority leaf while the
            # tree is partially filled.
            for _ in range(4):
                value = rng.uniform(segment * i, segment * (i + 1))
                idx, p, data = self.tree.get(value)
                if data is not None:
                    break
            if data is None:  # final fallback: a uniformly random filled leaf
                leaf = int(rng.randint(0, len(self.tree)))
                idx = leaf + self.tree.capacity - 1
                p = float(self.tree._tree[idx])
                data = self.tree._data[leaf]
            idxs[i] = idx
            priorities[i] = p
            items.append(data)
        return items, idxs, priorities

    def sample(self, n: int, rng: np.random.RandomState | None = None):
        """-> (items, tree_idxs, IS weights float32)."""
        rng = rng or self._default_rng
        self.beta = min(1.0, self.beta + self.BETA_INCREMENT)
        items, idxs, priorities = self._pick(n, rng)
        probs = priorities / self.tree.total
        weights = np.power(len(self.tree) * probs, -self.beta)
        weights /= weights.max()
        return items, idxs, weights.astype(np.float32)

    def update(self, idx: int, error: float) -> None:
        self.tree.set_priority(int(idx), self._priority(error))

    def update_batch(self, idxs: np.ndarray, errors: np.ndarray) -> None:
        """Re-prioritise every sampled index."""
        for idx, err in zip(idxs, errors):
            self.update(int(idx), float(err))
