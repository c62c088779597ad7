"""Prioritized experience replay: the sum-tree backends, `make_replay`,
and the actor's local `UniformBuffer`.

Counterpart of the JAX package's `data/replay.py`, host numpy with the
same arithmetic, so that one seed gives both packages the same tree
indices and IS weights. Priority `(|err| + 0.001) ** 0.6`; stratified
sampling over `total / n` segments; IS weights `(N * p) ** -beta`
normalised by the batch max; beta annealed 0.4 -> 1.0 by 0.001 per
`sample()`; `update_batch` re-prioritises every sampled index.

Backends (`make_replay`):

- `python`: `PrioritizedReplay`, a numpy sum tree and a payload list,
  one draw per sample;
- `native`: `NativePrioritizedReplay`, the C++ tree (`data/native.py`)
  with a payload list;
- `array`: `ArrayPrioritizedReplay`, the C++ tree with the payloads in
  preallocated per-field numpy rings (`stacked_samples`: `sample`
  returns the stacked batch);
- `auto`: `array` where the native library builds, else `python`.

The two native backends draw through `_stratified_pick`: one batched
`uniform(0, segment, size=n)` per round. `snapshot`/`restore` carry
the contents and priorities through a checkpoint (`utils/checkpoint.py`);
each backend's snapshot keeps the whole tree (inner sums included), so
a restore samples bit for bit as the saved replay would, and `restore`
also takes the JAX package's forms (`priorities` with `items` or
`stacked`), which it rebuilds leaf by leaf. `sample_with_priorities`
draws a shard's slice for the sharded service (`data/replay_service.py`),
and `make_replay(spill=...)` builds the tiered hot/cold store
(`data/replay_spill.py`). Not ported: the telemetry counters.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np

from distributed_reinforcement_learning_tpu_torch.data.fifo import (
    stack_pytrees, tree_leaves, tree_map)


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

    def add(self, error: float, sample: Any) -> int:
        return self.tree.add(self._priority(error), sample)

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

    def sample_with_priorities(self, n: int, rng=None):
        """(items, tree_idxs, RAW priorities): no IS weights, no beta
        annealing. The sharded service (data/replay_service.py) gathers
        slices from several backends and computes global IS weights with
        its own annealed beta."""
        return self._pick(n, rng or self._default_rng)

    def update(self, idx: int, error: float) -> None:
        self.tree.set_priority(int(idx), self._priority(error))

    def update_batch(self, idxs: np.ndarray, errors: np.ndarray) -> None:
        """Re-prioritise every sampled index."""
        for idx, err in zip(idxs, errors):
            self.update(int(idx), float(err))

    def snapshot(self) -> dict:
        """Serializable state: the whole sum tree (inner sums included),
        the filled payload slots, the write cursor, beta. `restore` of it
        gives a replay that samples exactly as this one would."""
        t = self.tree
        return {"tree": t._tree.copy(), "items": t._data[:t._count], "write": t._write,
                "count": t._count, "beta": float(self.beta)}

    def restore(self, snap: dict) -> None:
        """Rebuild from the `snapshot()` of any backend of the same
        capacity: exactly where it keeps the tree, else leaf by leaf."""
        t = self.tree
        items = _snapshot_items(snap)
        if snap.get("tree") is not None:
            _check_tree(snap["tree"], t.capacity)
            t._tree[:] = snap["tree"]
            t._data = list(items) + [None] * (t.capacity - int(snap["count"]))
            t._write, t._count = int(snap["write"]), int(snap["count"])
        else:
            for p, item in zip(snap["priorities"], items):
                t.add(float(p), item)  # already |err|^alpha-transformed
        self.beta = float(snap["beta"])


def _check_tree(tree: np.ndarray, capacity: int) -> None:
    if tree.shape != (2 * capacity - 1,):
        raise ValueError(f"replay snapshot of capacity {(len(tree) + 1) // 2}, "
                         f"this replay holds {capacity}")


def _snapshot_items(snap: dict) -> list:
    """Per-item view of any backend's snapshot (`items`, or the array
    backend's `stacked` batch)."""
    if snap.get("items") is not None:
        return list(snap["items"])
    stacked = snap.get("stacked")
    if stacked is None:
        return []
    return [tree_map(lambda x: x[i], stacked) for i in range(len(snap["priorities"]))]


def _snapshot_stacked(snap: dict):
    """Stacked view of any backend's snapshot, or None when empty."""
    if snap.get("stacked") is not None:
        return snap["stacked"]
    items = snap.get("items")
    return stack_pytrees(list(items)) if items else None


def _stratified_pick(tree, count: int, n: int, rng, is_written) -> tuple[np.ndarray, np.ndarray]:
    """The native backends' stratified sampling: one segment per sample,
    one batched draw per round, 4 rounds of retries for descents that
    land on unwritten leaves (float64 rounding while partially filled),
    then a uniformly random written leaf. -> (tree indices, priorities)."""
    cap = tree.capacity
    segment = tree.total / n
    lo = segment * np.arange(n)
    idxs = np.empty(n, np.int64)
    priorities = np.empty(n, np.float64)
    filled = np.zeros(n, bool)
    for _ in range(4):
        todo = np.flatnonzero(~filled)
        if todo.size == 0:
            break
        values = lo[todo] + rng.uniform(0.0, segment, size=todo.size)
        got_idx, got_p = tree.get_batch(values)
        ok = is_written(got_idx - (cap - 1))
        hit = todo[ok]
        idxs[hit] = got_idx[ok]
        priorities[hit] = got_p[ok]
        filled[hit] = True
    for i in np.flatnonzero(~filled):
        leaf = int(rng.randint(0, count))
        idxs[i] = leaf + cap - 1
        priorities[i] = tree.leaf_priority(int(idxs[i]))
    return idxs, priorities


def _is_weights(priorities: np.ndarray, total: float, count: int, beta: float) -> np.ndarray:
    """`(N * p) ** -beta`, normalised by the batch max, as float32."""
    probs = priorities / total
    weights = np.power(count * probs, -beta)
    weights /= weights.max()
    return weights.astype(np.float32)


class NativePrioritizedReplay:
    """The `PrioritizedReplay` surface over the C++ sum tree: tree walks
    and priority propagation in one native call per batch; payloads in a
    Python slot list aligned with the native write cursor. `_lock` makes
    the slot reservation and the payload write one step for a concurrent
    `sample` (the tree locks itself)."""

    BETA_INCREMENT = PrioritizedReplay.BETA_INCREMENT

    def __init__(self, capacity: int, beta: float = 0.4, seed: int = 0):
        from distributed_reinforcement_learning_tpu_torch.data.native import NativeSumTree

        self.tree = NativeSumTree(capacity)
        self.beta = beta
        self._default_rng = np.random.RandomState(seed)  # owned sampling stream
        self._data: list[Any] = [None] * capacity
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.tree)

    def add(self, error: float, sample: Any) -> int:
        return self.add_batch(np.array([error]), [sample])[0]

    def add_batch(self, errors: np.ndarray, samples: list[Any]) -> list[int]:
        with self._lock:
            slots = self.tree.add_batch(priority_transform(errors))
            for slot, item in zip(slots, samples):
                self._data[slot] = item
            return [int(slot) + self.tree.capacity - 1 for slot in slots]

    def _pick_locked(self, n: int, rng) -> tuple[list, np.ndarray, np.ndarray]:
        cap = self.tree.capacity
        idxs, priorities = _stratified_pick(
            self.tree, len(self.tree), n, rng,
            is_written=lambda slots: np.array([self._data[int(s)] is not None for s in slots]))
        return [self._data[int(i) - (cap - 1)] for i in idxs], idxs, priorities

    def sample(self, n: int, rng: np.random.RandomState | None = None):
        """-> (items, tree_idxs, IS weights float32)."""
        rng = rng or self._default_rng
        with self._lock:
            self.beta = min(1.0, self.beta + self.BETA_INCREMENT)
            items, idxs, priorities = self._pick_locked(n, rng)
            return items, idxs, _is_weights(priorities, self.tree.total, len(self.tree),
                                            self.beta)

    def sample_with_priorities(self, n: int, rng=None):
        """See `PrioritizedReplay.sample_with_priorities`."""
        with self._lock:
            return self._pick_locked(n, rng or self._default_rng)

    def update_batch(self, idxs: np.ndarray, errors: np.ndarray) -> None:
        self.tree.update_batch(np.asarray(idxs, np.int64), priority_transform(errors))

    def snapshot(self) -> dict:
        """Payloads, leaf priorities and the whole tree."""
        with self._lock:
            tree, write, count = self.tree.export()
            cap = self.tree.capacity
            return {"priorities": tree[cap - 1:cap - 1 + count].copy(),
                    "items": self._data[:count], "beta": float(self.beta),
                    "tree": tree, "write": write, "count": count}

    def restore(self, snap: dict) -> None:
        """Rebuild from the `snapshot()` of any backend of the same
        capacity: exactly where it keeps the tree, else leaf by leaf."""
        items = _snapshot_items(snap)
        with self._lock:
            if snap.get("tree") is not None:
                self.tree.import_(snap["tree"], int(snap["write"]), int(snap["count"]))
                self._data[:len(items)] = items
            else:
                slots = self.tree.add_batch(np.asarray(snap["priorities"], np.float64))
                for slot, item in zip(slots, items):
                    self._data[slot] = item
            self.beta = float(snap["beta"])


class ArrayPrioritizedReplay:
    """Structure-of-arrays prioritized replay over the C++ sum tree.

    Payloads live in preallocated per-field numpy rings indexed by the
    tree's write slots: `add_batch_stacked(errors, batch)` is one slice
    assignment per field, and `sample(n)` returns the batch already
    stacked, one fancy-index gather per field (`stacked_samples = True`
    tells the learners to skip `stack_pytrees`). The priority and IS
    math is `PrioritizedReplay`'s. `np.empty` maps pages lazily, so a
    capacity-1e5 Atari ring costs memory only as slots are written.
    `_lock` guards the rings and beta against a concurrent ingest (the
    tree locks itself)."""

    stacked_samples = True
    BETA_INCREMENT = PrioritizedReplay.BETA_INCREMENT

    def __init__(self, capacity: int, beta: float = 0.4, seed: int = 0):
        from distributed_reinforcement_learning_tpu_torch.data.native import NativeSumTree

        self.tree = NativeSumTree(capacity)
        self.beta = beta
        self._default_rng = np.random.RandomState(seed)  # owned sampling stream
        self._store = None  # the batch's structure over [capacity, ...] rings, lazy
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.tree)

    def _ensure_store_locked(self, batch: Any) -> None:
        if self._store is None:
            cap = self.tree.capacity
            self._store = tree_map(
                lambda x: np.empty((cap, *np.shape(x)[1:]), np.asarray(x).dtype), batch)

    def _write_locked(self, slots: np.ndarray, batch: Any) -> None:
        tree_map(lambda store, x: store.__setitem__(slots, np.asarray(x)), self._store, batch)

    def add_batch_stacked(self, errors: np.ndarray, batch: Any) -> np.ndarray:
        """Insert a `[N, ...]`-stacked batch of transitions or sequences;
        -> their tree indices."""
        with self._lock:
            self._ensure_store_locked(batch)
            slots = self.tree.add_batch(priority_transform(errors))
            self._write_locked(slots, batch)
            return slots + self.tree.capacity - 1

    def add_batch(self, errors: np.ndarray, samples: list[Any]) -> list[int]:
        return list(self.add_batch_stacked(errors, stack_pytrees(samples)))

    def add(self, error: float, sample: Any) -> int:
        return int(self.add_batch_stacked(
            np.array([error]), tree_map(lambda x: np.asarray(x)[None], sample))[0])

    def _pick_locked(self, n: int, rng) -> tuple[Any, np.ndarray, np.ndarray]:
        count = len(self.tree)
        idxs, priorities = _stratified_pick(self.tree, count, n, rng,
                                            is_written=lambda slots: slots < count)
        slots = idxs - (self.tree.capacity - 1)
        return tree_map(lambda store: store[slots], self._store), idxs, priorities

    def sample(self, n: int, rng: np.random.RandomState | None = None):
        """-> (stacked batch, tree_idxs, IS weights float32)."""
        rng = rng or self._default_rng
        with self._lock:
            self.beta = min(1.0, self.beta + self.BETA_INCREMENT)
            batch, idxs, priorities = self._pick_locked(n, rng)
            return batch, idxs, _is_weights(priorities, self.tree.total, len(self.tree),
                                            self.beta)

    def sample_with_priorities(self, n: int, rng=None):
        """See `PrioritizedReplay.sample_with_priorities` (the stacked
        batch in place of an item list, as `sample`)."""
        with self._lock:
            return self._pick_locked(n, rng or self._default_rng)

    def update_batch(self, idxs: np.ndarray, errors: np.ndarray) -> None:
        self.tree.update_batch(np.asarray(idxs, np.int64), priority_transform(errors))

    def approx_snapshot_nbytes(self) -> int:
        """The snapshot's size from the rings' dtypes and shapes, without
        copying them (the checkpoint's size cap asks first)."""
        with self._lock:
            n = len(self.tree)
            if self._store is None or n == 0:
                return 0
            per_item = sum(int(np.prod(leaf.shape[1:], dtype=np.int64)) * leaf.dtype.itemsize
                           for leaf in tree_leaves(self._store))
        return n * per_item + n * 8 + (2 * self.tree.capacity - 1) * 8

    def snapshot(self) -> dict:
        """`stacked` (the filled slots of each ring) in place of the list
        backends' `items`, the leaf priorities and the whole tree."""
        with self._lock:
            tree, write, count = self.tree.export()
            cap = self.tree.capacity
            stacked = (None if self._store is None
                       else tree_map(lambda store: store[:count].copy(), self._store))
            return {"priorities": tree[cap - 1:cap - 1 + count].copy(), "stacked": stacked,
                    "beta": float(self.beta), "tree": tree, "write": write, "count": count}

    def restore(self, snap: dict) -> None:
        """Rebuild from the `snapshot()` of any backend of the same
        capacity: exactly where it keeps the tree, else leaf by leaf."""
        batch = _snapshot_stacked(snap)
        with self._lock:
            if snap.get("tree") is not None:
                self.tree.import_(snap["tree"], int(snap["write"]), int(snap["count"]))
                if batch is not None:
                    self._ensure_store_locked(batch)
                    self._write_locked(np.arange(int(snap["count"])), batch)
            elif batch is not None:
                self._ensure_store_locked(batch)
                slots = self.tree.add_batch(np.asarray(snap["priorities"], np.float64))
                self._write_locked(slots, batch)
            self.beta = float(snap["beta"])


def make_replay(capacity: int, beta: float = 0.4, backend: str = "auto", seed: int = 0,
                spill=None, mode: str = "transition"):
    """The replay backend: `python`, `native`, `array`, or `auto` (the
    array backend where the native library builds, else `python`, as in
    the JAX package). `seed` fixes the backend's own sampling stream. A
    `spill` (a `replay_spill.SpillConfig`) overrides `backend` with the
    tiered hot/cold store of items of `mode` (`transition` or
    `sequence`): the disk tier is a storage property, orthogonal to the
    sum-tree implementation."""
    if spill is not None:
        from distributed_reinforcement_learning_tpu_torch.data.replay_spill import TieredStore

        return TieredStore(capacity, spill, mode=mode, beta=beta, seed=seed)
    if backend == "python":
        return PrioritizedReplay(capacity, beta, seed=seed)
    if backend == "native":
        return NativePrioritizedReplay(capacity, beta, seed=seed)
    if backend in ("array", "auto"):
        from distributed_reinforcement_learning_tpu_torch.data.native import native_available

        if native_available():
            return ArrayPrioritizedReplay(capacity, beta, seed=seed)
        if backend == "array":
            raise RuntimeError("the array replay backend needs the native library")
        return PrioritizedReplay(capacity, beta, seed=seed)
    raise ValueError(f"unknown replay backend {backend!r}")


def describe_replay(replay) -> str:
    """The backend's class name and, for a native backend, the library
    file it runs on (the learners log it)."""
    name = type(replay).__name__
    if isinstance(replay, PrioritizedReplay):
        return name
    from distributed_reinforcement_learning_tpu_torch.data import native

    return f"{name} over {native.loaded_path()}"


class UniformBuffer:
    """Actor-local uniform-random transition store: a ring of `capacity`
    items, `sample(batch_size)` draws with replacement from its own
    seeded stream."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._items: list[Any] = []
        self._write = 0
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self._items)

    def append(self, item: Any) -> None:
        if len(self._items) < self.capacity:
            self._items.append(item)
        else:
            self._items[self._write] = item
        self._write = (self._write + 1) % self.capacity

    def sample(self, batch_size: int) -> list[Any]:
        idx = self._rng.randint(0, len(self._items), size=batch_size)
        return [self._items[i] for i in idx]
