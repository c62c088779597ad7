"""Prioritized replay as a ring in device memory (the on-device loops').

Counterpart of the JAX package's `data/device_replay.py`. The host
topology keeps replay on the host (`data/replay.py`); the Anakin loops
keep it on the card, so sampling needs no copy across the bus. `storage`
is a NamedTuple of `[capacity, ...]` tensors, one per field (transitions
for `runtime/anakin_apex.py`, sequences for `runtime/anakin_r2d2.py`),
allocated once at their dtypes (uint8 frames stay uint8).

The math of `data/replay.py`: priority `(|err| + 0.001) ** 0.6`,
stratified sampling over `total / n` segments, IS weights
`(N * p) ** -beta` normalised by the batch max, beta annealed from 0.4 to
1.0 by 0.001 a sample. Writes are `W` wide at `ptr` and capacity is a
multiple of `W`, so a write is one slice assignment that never wraps; the
ring overwrites its oldest entries first.

The write pointer, the fill count and beta advance the same way whatever
the data, so they are host numbers (beta a float32, as the JAX ring's);
nothing here reads a device value on the host. The sample takes its `[n]`
uniforms as an input, so a test can feed in JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

PER_EPS = 0.001
PER_ALPHA = 0.6
BETA0 = 0.4
BETA_INCREMENT = 0.001


@dataclasses.dataclass
class DeviceReplay:
    storage: Any  # NamedTuple of [capacity, ...] tensors
    priorities: torch.Tensor  # [capacity] f32, alpha-transformed; 0 = empty
    ptr: int = 0  # next write slot (write-width aligned)
    size: int = 0  # filled count
    beta: np.float32 = np.float32(BETA0)  # annealed IS exponent

    @property
    def capacity(self) -> int:
        return self.priorities.shape[0]

    def nbytes(self) -> int:
        """Device bytes of the ring: every storage field and the priorities."""
        return self.priorities.nbytes + sum(t.nbytes for t in self.storage)


def priority(err: torch.Tensor) -> torch.Tensor:
    """`(|err| + eps) ** alpha` (`data/replay.py`'s PrioritizedReplay)."""
    return torch.pow(err.abs() + PER_EPS, PER_ALPHA)


def make(storage_zeros: Any) -> DeviceReplay:
    """An empty ring over `storage_zeros` (its leading dim is the capacity)."""
    capacity = storage_zeros[0].shape[0]
    return DeviceReplay(storage=storage_zeros,
                        priorities=torch.zeros(capacity, device=storage_zeros[0].device))


def ingest(replay: DeviceReplay, batch: Any, errs: torch.Tensor) -> DeviceReplay:
    """Write the `W` entries of `batch` (its leaves' leading dim) at `ptr`,
    in place, with priorities from the raw errors `errs [W]`."""
    width = errs.shape[0]
    capacity = replay.capacity
    if capacity % width:
        raise ValueError(f"capacity ({capacity}) must be a multiple of the write width ({width})")
    at = slice(replay.ptr, replay.ptr + width)
    for ring, new in zip(replay.storage, batch):
        ring[at] = new
    replay.priorities[at] = priority(errs)
    replay.ptr = (replay.ptr + width) % capacity
    replay.size = min(replay.size + width, capacity)
    return replay


def sample(replay: DeviceReplay, uniforms: torch.Tensor, mesh=None):
    """-> (batch, idx `[n]`, IS weights `[n]`) for the `[n]` uniforms in
    [0, 1), one per stratum of `total / n`; anneals beta. Empty slots have
    zero priority and are never drawn (the ring must hold an entry).

    `mesh` (a `parallel/mesh.RankMesh`): `replay` is this rank's shard of
    a ring split over the `data` axis (the Anakin mesh,
    `runtime/anakin_mesh.py`). Indices, probabilities and weights stay
    the shard's own, with its own size N, the right IS weight for the
    per-shard sampler; only the normalising maximum is the global
    batch's (JAX's `pmax`), one scalar all-reduce. Without a mesh, or on
    a data axis of one, nothing changes."""
    n = uniforms.shape[0]
    p = replay.priorities
    cum = torch.cumsum(p, 0)
    total = cum[-1]
    seg = total / n
    u = (torch.arange(n, dtype=torch.float32, device=p.device) + uniforms) * seg
    idx = torch.clamp(torch.searchsorted(cum, u, right=True), 0, replay.capacity - 1)
    probs = p[idx] / total
    weights = torch.pow(replay.size * probs, -float(replay.beta))
    wmax = weights.max()
    if mesh is not None:
        from distributed_reinforcement_learning_tpu_torch.parallel.mesh import DATA_AXIS

        wmax = mesh.all_reduce(wmax.reshape(1), DATA_AXIS, "max")[0]
    weights = weights / wmax
    batch = type(replay.storage)(*(ring[idx] for ring in replay.storage))
    replay.beta = np.minimum(np.float32(1.0), replay.beta + np.float32(BETA_INCREMENT))
    return batch, idx, weights


def update_priorities(replay: DeviceReplay, idx: torch.Tensor, errs: torch.Tensor) -> DeviceReplay:
    """Refresh every sampled priority, in place (the `update_batch` fix of
    the reference's `train_r2d2.py:159`)."""
    replay.priorities[idx] = priority(errs)
    return replay
