"""The K-update gather shared by the prioritized learners' train calls.

Counterpart of `gather_scan_batch` in the JAX package's
`data/device_path.py`, and of nothing else there: the fused device
sample path (`DeviceSamplePath`, its gather thread and its
`DRL_DEVICE_PATH*` gates) is not ported, and `run_role` refuses
`DRL_DEVICE_PATH` by name.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from distributed_reinforcement_learning_tpu_torch.data.fifo import stack_pytrees, tree_map


def gather_scan_batch(replay, batch_size: int, k: int, rng
                      ) -> tuple[Any, np.ndarray, list[np.ndarray]]:
    """Sample `k` prioritized batches and assemble them on the host:
    -> (stacked `[k, B, ...]` batch, IS weights `[k, B]` float32, the
    per-batch index arrays). All k batches are drawn before any of their
    priority updates lands."""
    sampled = [replay.sample(batch_size, rng) for _ in range(k)]
    if getattr(replay, "stacked_samples", False):
        # The array backend hands back already-stacked [B, ...] batches.
        stacked = stack_pytrees([items for items, _, _ in sampled])
    else:
        # Item lists: stack all k*B items once, view as [k, B, ...].
        flat = stack_pytrees([it for items, _, _ in sampled for it in items])
        stacked = tree_map(lambda x: x.reshape((k, -1) + x.shape[1:]), flat)
    weights = np.stack([np.asarray(w, np.float32) for _, _, w in sampled])
    return stacked, weights, [idxs for _, idxs, _ in sampled]
