"""The port's codec against the JAX package's: the same bytes.

For each family's trajectory (built by each package's own accumulator
from the same seeded steps), a flat weights dict and a frame-stacked
Atari unroll encoded with dedup, `codec.encode` of the port must give
exactly the JAX codec's blob, and each side must decode the other's blob
bit for bit (namedtuples come back by name and fields). A decoded blob
must also stack and move to a device like the port's own batches.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.data import codec as jax_codec
from distributed_reinforcement_learning_tpu.data import structures as jax_structures
from distributed_reinforcement_learning_tpu_torch.agents.common import batch_to_device
from distributed_reinforcement_learning_tpu_torch.data import codec
from distributed_reinforcement_learning_tpu_torch.data import structures
from distributed_reinforcement_learning_tpu_torch.data.fifo import stack_pytrees


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # One thread for torch and for numpy's BLAS pool, as the parity files
    # pin them: several test workers share the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)

N, T, A, H = 3, 5, 4, 8


def _steps(family: str, seed: int, obs_shape=(6,), obs_dtype=np.float32) -> list[dict]:
    rng = np.random.RandomState(seed)
    steps = []
    for _ in range(T):
        obs = (rng.randint(0, 256, (N, *obs_shape)).astype(obs_dtype)
               if obs_dtype == np.uint8 else rng.randn(N, *obs_shape).astype(obs_dtype))
        step = {"state": obs, "reward": rng.randn(N).astype(np.float32),
                "action": rng.randint(0, A, N).astype(np.int32),
                "done": rng.rand(N) < 0.2,
                "previous_action": rng.randint(0, A, N).astype(np.int32)}
        if family in ("impala", "ximpala"):
            logits = rng.randn(N, A)
            step["behavior_policy"] = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
                                       ).astype(np.float32)
        if family == "impala":
            step["initial_h"] = rng.randn(N, H).astype(np.float32)
            step["initial_c"] = rng.randn(N, H).astype(np.float32)
        if family == "ximpala":
            step["env_done"] = rng.rand(N) < 0.1
        steps.append(step)
    return steps


_ACCUMULATORS = {
    "impala": ("ImpalaTrajectoryAccumulator", ()),
    "ximpala": ("XImpalaTrajectoryAccumulator", ()),
    "r2d2": ("R2D2SequenceAccumulator", (np.ones((N, H), np.float32),
                                         np.full((N, H), -0.5, np.float32))),
    "xformer": ("XformerSequenceAccumulator", ()),
}


def _trajectories(module, family: str, steps: list[dict]) -> list:
    name, start = _ACCUMULATORS[family]
    acc = getattr(module, name)()
    if start:
        acc.reset(*start)
    for step in steps:
        acc.append(**step)
    return acc.extract()


def _assert_same_tree(a, b):
    assert type(a).__name__ == type(b).__name__
    assert a._fields == b._fields
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("family", ["impala", "ximpala", "r2d2", "xformer"])
def test_trajectory_blobs_are_byte_identical_and_cross_decode(family):
    steps = _steps(family, seed=3)
    ours = _trajectories(structures, family, steps)
    theirs = _trajectories(jax_structures, family, steps)
    assert len(ours) == len(theirs) == N
    for mine, ref in zip(ours, theirs):
        blob, ref_blob = codec.encode(mine), jax_codec.encode(ref)
        assert bytes(blob) == bytes(ref_blob)
        _assert_same_tree(codec.decode(ref_blob, copy=True), mine)
        _assert_same_tree(jax_codec.decode(blob, copy=True), ref)


@pytest.mark.parametrize("family", ["impala", "r2d2"])
def test_schema_cache_gives_the_cold_bytes(family):
    tree = _trajectories(structures, family, _steps(family, seed=4))[0]
    cold = bytes(codec.encode(tree, cache=False))
    assert bytes(codec.encode(tree, cache=True)) == cold
    assert bytes(codec.encode(tree, cache=True)) == cold  # the warm hit
    assert bytes(jax_codec.encode(tree, cache=True)) == cold


def test_weight_dict_blobs_are_byte_identical():
    rng = np.random.RandomState(5)
    params = {"torso.fc0.weight": rng.randn(16, 6).astype(np.float32),
              "torso.fc0.bias": rng.randn(16).astype(np.float32),
              "lstm.kernel": rng.randn(24, 32).astype(np.float32),
              "head.policy.weight": rng.randn(A, 8).astype(np.float32)}
    blob = codec.encode(params, cache=True)
    assert bytes(blob) == bytes(jax_codec.encode(params))
    back = jax_codec.decode(blob, copy=True)
    assert sorted(back) == sorted(params)
    for k, v in params.items():
        assert back[k].tobytes() == v.tobytes()


def test_dedup_packed_atari_unrolls_are_byte_identical():
    """Frame-stacked uint8 observations (each step shifts the stack by one
    plane), packed by both codecs' dedup and unpacked bit for bit."""
    rng = np.random.RandomState(6)
    frames = rng.randint(0, 256, (T + 3, 84, 84)).astype(np.uint8)
    state = np.stack([np.stack([frames[t + k] for k in range(4)], -1) for t in range(T)])
    tree = {"state": state, "reward": rng.randn(T).astype(np.float32)}
    blob = codec.encode(tree, dedup=True)
    assert codec.is_packed(blob)
    assert bytes(blob) == bytes(jax_codec.encode(tree, dedup=True))
    assert len(blob) < len(codec.encode(tree))
    for back in (codec.decode(blob, copy=True), jax_codec.decode(blob, copy=True)):
        assert back["state"].tobytes() == state.tobytes()


def test_decoded_namedtuples_stack_and_move_to_the_device():
    """What the learner's queue holds after the wire: namedtuples rebuilt
    by `codec.decode` (not the port's classes) stack into one batch that
    `batch_to_device` takes, equal to the batch of the originals."""
    ours = _trajectories(structures, "impala", _steps("impala", seed=7))
    wired = [codec.decode(codec.encode(t), copy=True) for t in ours]
    assert type(wired[0]) is not type(ours[0])
    got = batch_to_device(stack_pytrees(wired), torch.device("cpu"))
    want = batch_to_device(stack_pytrees(ours), torch.device("cpu"))
    assert got._fields == want._fields
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert got.action.dtype == torch.int64
