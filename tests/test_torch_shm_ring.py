"""The port's shm ring (`runtime/shm_ring.py`) against the JAX package's.

A ring one package creates is attached by the other, both ways round,
and every blob comes back byte-identical: records that wrap the buffer
(the wrap marker and the implicit skip), and the largest blob that fits
(half the ring, the progress guarantee); a blob larger than half is
refused alike by both packages and goes over TCP instead. A segment
whose creator is dead is reclaimed by its creator-pid word; a live one
is not. Codec trajectory blobs a JAX `RingQueue` puts reach a port
`RingDrainer`'s `TrajectoryQueue` equal to the same puts over TCP into
a port `TransportServer`. The gate constant holds the JAX package's
committed verdict. Segments are named per test and unlinked.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
from collections import namedtuple
from pathlib import Path

import numpy as np
import pytest

from distributed_reinforcement_learning_tpu.runtime import shm_ring as jax_ring
from distributed_reinforcement_learning_tpu.runtime import transport as jax_transport
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue, tree_leaves
from distributed_reinforcement_learning_tpu_torch.runtime import shm_ring
from distributed_reinforcement_learning_tpu_torch.runtime.transport import TransportServer
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

REPO = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": jax_ring, "port": shm_ring}
Unroll = namedtuple("Unroll", ["state", "reward", "done", "action", "initial_h"])


def _name(tag: str) -> str:
    return f"drltest-{tag}-{os.getpid()}-{time.monotonic_ns()}"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# Record sizes that land on every framing case of a 16 KiB ring over
# many laps: contiguous records, the wrap marker (4 <= bytes left <
# record) and the implicit skip (bytes left < 4).
_SIZES = [1, 2, 3, 700, 3000, 3500, 8, 4090, 4084, 4085, 2, 3999, 5, 4091, 4086, 13]


@pytest.mark.parametrize("creator, attacher", [("jax", "port"), ("port", "jax")])
def test_ring_is_shared_byte_for_byte_across_the_packages(creator, attacher):
    """Each side of a ring keeps its own cursor, so each direction gets
    its own pair of mappings: the attacher's package produces into the
    creator's, then a fresh mapping of the creator's package produces
    into a fresh one of the attacher's."""
    name = _name(f"{creator}2{attacher}")
    owner = PACKAGES[creator].ShmRing.create(name, 16384)
    views = [PACKAGES[attacher].ShmRing.attach(name)]
    try:
        assert views[0].capacity == owner.capacity == 16384
        assert views[0].creator_pid == owner.creator_pid == os.getpid()
        rng = np.random.RandomState(0)
        largest = owner.capacity // 2 - 4  # the record is exactly half the ring
        blobs = [rng.bytes(n) for n in _SIZES] * 6 + [rng.bytes(largest)] * 3
        for direction in range(2):
            if direction == 0:
                producer, consumer = views[0], owner
            else:
                views += [PACKAGES[creator].ShmRing.attach(name),
                          PACKAGES[attacher].ShmRing.attach(name)]
                producer, consumer = views[1], views[2]
            got = []

            def consume(consumer=consumer, got=got):
                for _ in blobs:
                    got.append(consumer.get_blob(timeout=10.0))

            t = threading.Thread(target=consume)
            t.start()
            for b in blobs:
                assert producer.put_blob(b, timeout=10.0)
            t.join(timeout=30.0)
            assert got == blobs
        assert views[1]._head > 10 * owner.capacity  # many laps
        for ring in (owner, views[0]):  # one blob larger than half: refused alike
            with pytest.raises(ValueError, match="cannot fit"):
                ring.put_blob(bytes(owner.capacity // 2 + 1))
        assert owner.used_bytes() == 0
    finally:
        for view in views:
            view.close()
        owner.close()
        owner.unlink()


def test_ring_queue_sends_a_blob_larger_than_half_the_ring_over_tcp():
    """The port's RingQueue demotes to the TCP client on an oversize
    blob, as the JAX one does; the item arrives unchanged."""
    name = _name("oversize")
    ring = jax_ring.ShmRing.create(name, 4096)
    sent = []

    class Client:
        def put_trajectory(self, item):
            sent.append(item)
            return True

    queue = shm_ring.RingQueue(shm_ring.ShmRing.attach(name), Client())
    try:
        small, big = {"x": np.arange(8, dtype=np.int32)}, {"x": np.arange(1024, dtype=np.int32)}
        assert queue.put(small)
        assert queue.put(big)
        assert sent == [big] and queue.stat("tcp_fallbacks") == 1 and not queue.attached
        assert len(queue.demoted_at) == 1
        assert ring.get_blob(timeout=1.0) is not None and ring.get_blob(timeout=0.05) is None
    finally:
        queue.close()
        ring.close()
        ring.unlink()


# A segment as a SIGKILLed creator leaves it: the creator-pid word at
# offset 24 names a process that is gone, nothing unlinked it, and no
# resource tracker does so when the process ends.
_DEAD_CREATOR = """
import os, struct
from multiprocessing import resource_tracker, shared_memory
seg = shared_memory.SharedMemory(name={name!r}, create=True, size=4352)
struct.pack_into("<Q", seg.buf, 24, os.getpid())
resource_tracker.unregister(seg._name, "shared_memory")
os._exit(0)
"""


def test_stale_segment_is_reclaimed_by_creator_pid():
    name = _name("stale")
    proc = subprocess.run([sys.executable, "-c", _DEAD_CREATOR.format(name=name)],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-2000:]
    dead = shm_ring.segment_owner_pid(name)
    assert dead > 0 and not shm_ring.pid_alive(dead)
    ring = shm_ring.ShmRing.create(name, 8192)  # reclaims the dead creator's segment
    try:
        assert ring.creator_pid == os.getpid() and ring.capacity == 8192
        with pytest.raises(FileExistsError):  # a live creator keeps its name
            shm_ring.ShmRing.create(name, 8192)
        with pytest.raises(FileExistsError):
            jax_ring.ShmRing.create(name, 8192)
        assert jax_ring.segment_owner_pid(name) == os.getpid()
    finally:
        ring.close()
        ring.unlink()


def _unrolls(n: int, seed: int) -> list:
    rng = np.random.RandomState(seed)
    return [Unroll(state=rng.randn(6, 4).astype(np.float32),
                   reward=rng.randn(6).astype(np.float32), done=rng.rand(6) < 0.2,
                   action=rng.randint(0, 2, 6).astype(np.int32),
                   initial_h=rng.randn(8).astype(np.float32)) for _ in range(n)]


def test_jax_ring_queue_feeds_a_port_drainer_as_tcp_feeds_a_port_server():
    items = _unrolls(7, seed=3)
    name = _name("drain")
    ring_q = TrajectoryQueue(capacity=16)
    drainer = shm_ring.serve_rings([name], ring_q)
    assert drainer is not None
    producer = jax_ring.RingQueue(jax_ring.ShmRing.attach(name), client=None)
    try:
        assert producer.put(items[0])
        assert producer.put_many(items[1:]) == len(items) - 1
        ring_items = [ring_q.get(timeout=10.0) for _ in items]
    finally:
        producer.close()
        drainer.stop()  # closes and unlinks the segment
    assert drainer.snapshot_stats()["unrolls_drained"] == len(items)
    assert not os.path.exists(f"/dev/shm/{name}")

    tcp_q = TrajectoryQueue(capacity=16)
    port = _free_port()
    server = TransportServer(tcp_q, WeightStore(), host="127.0.0.1", port=port).start()
    client = jax_transport.TransportClient("127.0.0.1", port)
    try:
        assert client.put_trajectories(items) == len(items)
        tcp_items = [tcp_q.get(timeout=10.0) for _ in items]
    finally:
        client.close()
        server.stop()
    for got, want, sent in zip(ring_items, tcp_items, items):
        assert type(got).__name__ == type(want).__name__ == "Unroll"
        assert got._fields == want._fields == sent._fields
        for a, b, c in zip(tree_leaves(got), tree_leaves(want), tree_leaves(sent)):
            assert a.dtype == b.dtype == c.dtype and a.shape == b.shape == c.shape
            assert a.tobytes() == b.tobytes() == c.tobytes()


def test_gate_constant_is_the_committed_verdict(monkeypatch):
    verdict = json.loads((REPO / "benchmarks" / "transport_verdict.json").read_text())
    assert shm_ring.RING_AUTO_ENABLE is bool(verdict["auto_enable"])
    monkeypatch.delenv("DRL_SHM_RING", raising=False)
    assert shm_ring.ring_enabled() is jax_ring.ring_enabled()
    for value, want in (("1", True), ("0", False)):
        monkeypatch.setenv("DRL_SHM_RING", value)
        assert shm_ring.ring_enabled() is want is jax_ring.ring_enabled()
