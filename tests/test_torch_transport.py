"""The port's socket data plane (`runtime/transport.py`).

The cases of tests/test_transport.py against the port: round trips,
batched puts with a partial accept, backpressure, weight versions,
reconnect after a server restart, an unreachable learner. Then the two
packages against each other over TCP: a JAX client feeds a port server
whose learner steps on what arrives (equal to a step on the same
trajectories in process), a port client feeds a JAX server, and the
weight plane's fallbacks (a JAX actor's sharded pull demotes to whole
blobs against a port learner; a port actor refuses a JAX learner's flax
weights). Every server binds a free port.
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from distributed_reinforcement_learning_tpu.data import structures as jax_structures
from distributed_reinforcement_learning_tpu.data.fifo import TrajectoryQueue as JaxQueue
from distributed_reinforcement_learning_tpu.runtime import transport as jax_transport
from distributed_reinforcement_learning_tpu.runtime.weights import WeightStore as JaxStore
from distributed_reinforcement_learning_tpu_torch.agents.impala import ImpalaAgent, ImpalaConfig
from distributed_reinforcement_learning_tpu_torch.data import structures
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue, stack_pytrees
from distributed_reinforcement_learning_tpu_torch.runtime.impala_runner import ImpalaLearner
from distributed_reinforcement_learning_tpu_torch.runtime.transport import (
    RemoteQueue, RemoteWeights, ShardedRemoteWeights, TransportClient, TransportError,
    TransportServer)
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def served():
    queue = TrajectoryQueue(capacity=8)
    weights = WeightStore()
    port = _free_port()
    server = TransportServer(queue, weights, host="127.0.0.1", port=port).start()
    yield queue, weights, port
    server.stop()


class TestProtocol:
    def test_put_trajectory_roundtrip(self, served):
        queue, _, port = served
        client = TransportClient("127.0.0.1", port)
        traj = {"obs": np.arange(12, dtype=np.uint8).reshape(3, 4), "r": np.ones(3, np.float32)}
        assert client.put_trajectory(traj)
        assert client.queue_size() == 1
        got = queue.get(timeout=1.0)
        np.testing.assert_array_equal(got["obs"], traj["obs"])
        client.close()

    def test_weights_versioning(self, served):
        _, weights, port = served
        client = TransportClient("127.0.0.1", port)
        assert client.get_weights_if_newer(-1) is None  # nothing published
        weights.publish({"w": torch.full((2, 2), 3.0)}, version=5)
        params, version = client.get_weights_if_newer(-1)
        assert version == 5
        np.testing.assert_array_equal(params["w"], np.full((2, 2), 3.0, np.float32))
        assert client.get_weights_if_newer(5) is None  # already newest
        weights.publish({"w": torch.zeros(2, 2)}, version=6)
        _, v2 = client.get_weights_if_newer(5)
        assert v2 == 6
        client.close()

    def test_ping(self, served):
        _, _, port = served
        client = TransportClient("127.0.0.1", port)
        assert client.ping()
        client.close()

    def test_backpressure_over_wire(self, served):
        queue, _, port = served
        client = TransportClient("127.0.0.1", port)
        for i in range(8):  # fill to capacity
            client.put_trajectory({"x": np.array([i])})
        done = threading.Event()

        def put_ninth():
            client.put_trajectory({"x": np.array([8])})
            done.set()

        t = threading.Thread(target=put_ninth, daemon=True)
        t.start()
        time.sleep(0.2)
        assert not done.is_set()  # blocked: queue full, reply withheld
        queue.get(timeout=1.0)  # free one slot
        assert done.wait(timeout=5.0)
        client.close()

    def test_adapters(self, served):
        queue, weights, port = served
        client = TransportClient("127.0.0.1", port)
        rq, rw = RemoteQueue(client), RemoteWeights(client, "cpu")
        assert rq.put({"a": np.ones(2)})
        assert rq.size() == 1
        weights.publish({"b": torch.arange(3.0)}, version=1)
        params, v = rw.get_if_newer(0)
        assert v == 1 and torch.equal(params["b"], torch.arange(3.0))
        assert rw.get_if_newer(1) is None
        client.close()

    def test_put_trajectories_batched_roundtrip(self, served):
        queue, _, port = served
        client = TransportClient("127.0.0.1", port)
        trees = [{"obs": np.full((3, 4), i, np.uint8), "r": np.full(3, float(i), np.float32)}
                 for i in range(5)]
        assert client.put_trajectories(trees) == 5
        assert client.queue_size() == 5
        for i in range(5):
            got = queue.get(timeout=1.0)
            np.testing.assert_array_equal(got["obs"], trees[i]["obs"])
            np.testing.assert_array_equal(got["r"], trees[i]["r"])
        client.close()

    def test_put_trajectories_partial_accept_retries_tail(self, served):
        """A full queue accepts part of the batch; the client delivers the
        rest, exactly once and in order, as the consumer frees slots."""
        queue, _, port = served  # capacity 8
        client = TransportClient("127.0.0.1", port, busy_timeout=30.0)
        trees = [{"x": np.array([i])} for i in range(12)]
        got: list[int] = []

        def drain():
            deadline = time.monotonic() + 20.0
            while len(got) < 12 and time.monotonic() < deadline:
                item = queue.get(timeout=0.5)
                if item is not None:
                    got.append(int(item["x"][0]))

        t = threading.Thread(target=drain, daemon=True)
        t.start()
        assert client.put_trajectories(trees) == 12
        t.join(timeout=20.0)
        assert not t.is_alive()
        assert got == list(range(12))
        client.close()

    def test_server_refuses_the_tail_past_its_wait(self):
        """The batched busy reply: blobs past a full queue's bounded wait
        are not enqueued, and the count says how many were."""
        from distributed_reinforcement_learning_tpu_torch.data import codec

        queue = TrajectoryQueue(2)
        server = TransportServer(queue, WeightStore(), host="127.0.0.1", port=_free_port())
        blobs = [codec.encode({"x": np.array([i])}) for i in range(3)]
        assert server._enqueue_many(blobs, total_wait=0.3) == 2
        assert [int(queue.get(timeout=1.0)["x"][0]) for _ in range(2)] == [0, 1]

    def test_remote_queue_put_many(self, served):
        queue, _, port = served
        client = TransportClient("127.0.0.1", port)
        assert RemoteQueue(client).put_many([{"a": np.ones(2)}, {"a": np.zeros(2)}]) == 2
        assert queue.size() == 2
        client.close()

    def test_client_reconnects_after_server_restart(self):
        queue, weights = TrajectoryQueue(8), WeightStore()
        port = _free_port()
        server = TransportServer(queue, weights, host="127.0.0.1", port=port).start()
        client = TransportClient("127.0.0.1", port, connect_retries=20, retry_interval=0.1)
        assert client.ping()
        server.stop()
        server2 = TransportServer(queue, weights, host="127.0.0.1", port=port).start()
        # At most once: the first put may be dropped (False) when the client
        # notices the dead connection mid-request; it is never duplicated.
        for _ in range(5):
            if client.put_trajectory({"x": np.ones(1)}):
                break
        assert queue.size() == 1
        server2.stop()
        client.close()

    def test_unreachable_raises(self):
        with pytest.raises(TransportError, match="cannot reach"):
            TransportClient("127.0.0.1", _free_port(), connect_retries=2, retry_interval=0.05)

    def test_closed_queue_answers_closed(self, served):
        queue, _, port = served
        client = TransportClient("127.0.0.1", port)
        queue.close()
        with pytest.raises(TransportError, match="closed the data plane"):
            client.put_trajectories([{"x": np.ones(1)}])
        client.close()


# -- the two packages against each other -------------------------------------

_CFG = ImpalaConfig(obs_shape=(4,), num_actions=2, trajectory=6, lstm_size=8,
                    start_learning_rate=1e-2, end_learning_rate=1e-2)
_N = 4


def _steps(seed: int) -> list[dict]:
    rng = np.random.RandomState(seed)
    steps = []
    for _ in range(_CFG.trajectory):
        logits = rng.randn(_N, 2)
        steps.append({
            "state": rng.randn(_N, 4).astype(np.float32),
            "reward": rng.randn(_N).astype(np.float32),
            "done": rng.rand(_N) < 0.2,
            "action": rng.randint(0, 2, _N).astype(np.int32),
            "behavior_policy": (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
                                ).astype(np.float32),
            "previous_action": rng.randint(0, 2, _N).astype(np.int32),
            "initial_h": (rng.randn(_N, 8) * 0.1).astype(np.float32),
            "initial_c": (rng.randn(_N, 8) * 0.1).astype(np.float32),
        })
    return steps


def _unrolls(module, seed: int) -> list:
    acc = module.ImpalaTrajectoryAccumulator()
    for step in _steps(seed):
        acc.append(**step)
    return acc.extract()


def test_jax_client_feeds_the_port_learner():
    agent = ImpalaAgent(_CFG, device="cpu")
    queue, weights = TrajectoryQueue(16), WeightStore()
    learner = ImpalaLearner(agent, queue, weights, batch_size=_N, seed=3)
    port = _free_port()
    server = TransportServer(queue, weights, host="127.0.0.1", port=port).start()
    client = jax_transport.TransportClient("127.0.0.1", port)
    try:
        assert client.put_trajectories(_unrolls(jax_structures, seed=1)) == _N
        metrics = learner.step(timeout=5.0)
    finally:
        client.close()
        server.stop()
    assert learner.train_steps == 1
    metrics = {k: float(v) for k, v in metrics.items()}
    assert all(np.isfinite(v) for v in metrics.values())

    # The same trajectories in process: the same step, bit for bit.
    twin = ImpalaLearner(agent, TrajectoryQueue(16), WeightStore(), batch_size=_N, seed=3)
    _, want = agent.learn(twin.state, stack_pytrees(_unrolls(structures, seed=1)))
    assert metrics == {k: float(v) for k, v in want.items()}
    for k, p in learner.state.params.items():
        assert torch.equal(p, twin.state.params[k])


def test_port_client_feeds_a_jax_server():
    queue = JaxQueue(16)
    port = _free_port()
    server = jax_transport.TransportServer(queue, JaxStore(), host="127.0.0.1",
                                           port=port).start()
    client = TransportClient("127.0.0.1", port)
    try:
        assert RemoteQueue(client).put_many(_unrolls(structures, seed=2)) == _N
        got = [queue.get(timeout=5.0) for _ in range(_N)]
    finally:
        client.close()
        server.stop()
    for item, want in zip(got, _unrolls(jax_structures, seed=2)):
        assert type(item).__name__ == "ImpalaBatch" and item._fields == want._fields
        for x, y in zip(item, want):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_jax_sharded_pull_falls_back_to_whole_blobs_against_a_port_learner():
    weights = WeightStore()
    params = {"torso.weight": torch.randn(3, 4), "torso.bias": torch.randn(3)}
    weights.publish(params, 2)
    port = _free_port()
    server = TransportServer(TrajectoryQueue(4), weights, host="127.0.0.1", port=port).start()
    client = jax_transport.TransportClient("127.0.0.1", port)
    try:
        pulled, version = jax_transport.ShardedRemoteWeights(client).get_if_newer(-1)
    finally:
        client.close()
        server.stop()
    assert version == 2 and sorted(pulled) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(pulled[k], v.numpy())


def test_port_actor_refuses_a_jax_learners_weights():
    """Weight blobs do not cross packages: a flax tree is not the port's
    flat parameter dict. The sharded probe demotes first."""
    store = JaxStore()
    store.publish({"params": {"Dense_0": {"kernel": np.ones((2, 2), np.float32)}}}, 1)
    port = _free_port()
    server = jax_transport.TransportServer(JaxQueue(4), store, host="127.0.0.1",
                                           port=port).start()
    client = TransportClient("127.0.0.1", port)
    try:
        with pytest.raises(TypeError, match="do not cross"):
            ShardedRemoteWeights(client, "cpu").get_if_newer(-1)
    finally:
        client.close()
        server.stop()
