"""Synthetic batch constructors for benchmarks, chip checks and tests.

Counterpart of the JAX package's `utils/synthetic.py`: one constructor
per batch type, with the same signatures and the same numpy draws in the
same order from `np.random.default_rng(seed)`, so that every field equals
the JAX package's bit for bit, at the same dtype. The batches are the
port's own NamedTuples (`agents/*.py`), imported lazily as in the JAX
package; their fields are numpy arrays, as a learner's queue or replay
hands them over, or tensors on `device` where one is given.
"""

from __future__ import annotations

import numpy as np
import torch


def _placed(out, device):
    """`out` (a batch, or a batch and its IS weights) as is where `device`
    is None, else as tensors on `device` (`agents/common.batch_to_device`:
    the action fields int64, as the agents index with them)."""
    if device is None:
        return out
    from distributed_reinforcement_learning_tpu_torch.agents.common import batch_to_device

    if hasattr(out, "_fields"):
        return batch_to_device(out, device)
    batch, weights = out
    return batch_to_device(batch, device), torch.as_tensor(weights, device=device)


def synthetic_impala_batch(
    B: int,
    T: int,
    obs_shape: tuple[int, ...],
    num_actions: int,
    lstm_size: int,
    seed: int = 0,
    obs_dtype=np.uint8,
    uniform_behavior: bool = True,
    device=None,
):
    """Random ImpalaBatch ([B, T] unrolls with actor-recorded LSTM state)."""
    from distributed_reinforcement_learning_tpu_torch.agents.impala import ImpalaBatch

    rng = np.random.default_rng(seed)
    if np.issubdtype(obs_dtype, np.integer):
        state = rng.integers(0, 255, (B, T, *obs_shape)).astype(obs_dtype)
    else:
        state = rng.random((B, T, *obs_shape), dtype=np.float32)
    if uniform_behavior:
        behavior = np.full((B, T, num_actions), 1.0 / num_actions, np.float32)
    else:
        behavior = rng.dirichlet(np.ones(num_actions), (B, T)).astype(np.float32)
    return _placed(ImpalaBatch(
        state=state,
        reward=rng.random((B, T), dtype=np.float32),
        action=rng.integers(0, num_actions, (B, T)).astype(np.int32),
        done=rng.random((B, T)) < 0.05,
        behavior_policy=behavior,
        previous_action=rng.integers(0, num_actions, (B, T)).astype(np.int32),
        initial_h=(rng.standard_normal((B, T, lstm_size)) * 0.1).astype(np.float32),
        initial_c=(rng.standard_normal((B, T, lstm_size)) * 0.1).astype(np.float32),
    ), device)


def synthetic_apex_batch(
    B: int,
    obs_shape: tuple[int, ...],
    num_actions: int,
    seed: int = 0,
    obs_dtype=np.float32,
    device=None,
):
    """Random ApexBatch (flat transitions) + IS weights."""
    from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexBatch

    rng = np.random.default_rng(seed)

    def obs():
        if np.issubdtype(obs_dtype, np.integer):
            return rng.integers(0, 255, (B, *obs_shape)).astype(obs_dtype)
        return rng.random((B, *obs_shape), dtype=np.float32)

    batch = ApexBatch(
        state=obs(),
        next_state=obs(),
        previous_action=rng.integers(0, num_actions, (B,)).astype(np.int32),
        action=rng.integers(0, num_actions, (B,)).astype(np.int32),
        reward=rng.random((B,), dtype=np.float32),
        done=rng.random((B,)) < 0.1,
    )
    return _placed((batch, rng.random((B,), dtype=np.float32)), device)


def synthetic_r2d2_batch(
    B: int,
    T: int,
    obs_shape: tuple[int, ...],
    num_actions: int,
    lstm_size: int,
    seed: int = 0,
    device=None,
):
    """Random R2D2Batch (sequences with stored start state) + IS weights."""
    from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Batch

    rng = np.random.default_rng(seed)
    batch = R2D2Batch(
        state=rng.integers(0, 255, (B, T, *obs_shape)).astype(np.int32),
        previous_action=rng.integers(0, num_actions, (B, T)).astype(np.int32),
        action=rng.integers(0, num_actions, (B, T)).astype(np.int32),
        reward=rng.random((B, T), dtype=np.float32),
        done=rng.random((B, T)) < 0.1,
        initial_h=(rng.standard_normal((B, lstm_size)) * 0.1).astype(np.float32),
        initial_c=(rng.standard_normal((B, lstm_size)) * 0.1).astype(np.float32),
    )
    return _placed((batch, rng.random((B,), dtype=np.float32)), device)


def synthetic_xformer_batch(
    B: int,
    T: int,
    obs_shape: tuple[int, ...],
    num_actions: int,
    seed: int = 0,
    device=None,
):
    """Random XformerBatch (sequences, no stored state) + IS weights."""
    from distributed_reinforcement_learning_tpu_torch.agents.xformer import XformerBatch

    rng = np.random.default_rng(seed)
    batch = XformerBatch(
        state=rng.integers(0, 255, (B, T, *obs_shape)).astype(np.int32),
        previous_action=rng.integers(0, num_actions, (B, T)).astype(np.int32),
        action=rng.integers(0, num_actions, (B, T)).astype(np.int32),
        reward=rng.random((B, T), dtype=np.float32),
        done=rng.random((B, T)) < 0.1,
    )
    return _placed((batch, rng.random((B,), dtype=np.float32)), device)


def synthetic_ximpala_batch(
    B: int,
    T: int,
    obs_shape: tuple[int, ...],
    num_actions: int,
    seed: int = 0,
    uniform_behavior: bool = True,
    device=None,
):
    """Random XImpalaBatch (IMPALA unrolls, no stored state)."""
    from distributed_reinforcement_learning_tpu_torch.agents.ximpala import XImpalaBatch

    rng = np.random.default_rng(seed)
    logits = rng.random((B, T, num_actions)).astype(np.float32)
    behavior = (
        np.full((B, T, num_actions), 1.0 / num_actions, np.float32)
        if uniform_behavior
        else np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    )
    done = rng.random((B, T)) < 0.1
    return _placed(XImpalaBatch(
        state=rng.random((B, T, *obs_shape), dtype=np.float32),
        reward=rng.random((B, T), dtype=np.float32),
        action=rng.integers(0, num_actions, (B, T)).astype(np.int32),
        done=done,
        env_done=done.copy(),  # no shaping in synthetic data
        behavior_policy=behavior,
        previous_action=rng.integers(0, num_actions, (B, T)).astype(np.int32),
    ), device)
