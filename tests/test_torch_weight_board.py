"""The port's weight board (`runtime/weight_board.py`) against the JAX
package's, and the port's `WeightStore` writing it.

A board one package writes is read by the other at the same versions
(a rollback's backward version included) with the same bytes, both ways
round. The port's store, with a board attached, lands every version on
the board under `publish` and `publish_async`, a rollback submitted
last included, and under `publish_async` its learn thread neither
copies nor encodes. `BoardWeights` demotes to TCP pulls when the writer
closes, and refuses a segmented board by name. The gate constant holds
the JAX package's committed verdict. Segments are named per test and
unlinked.
"""

import json
import os
import socket
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.data import codec as jax_codec
from distributed_reinforcement_learning_tpu.runtime import weight_board as jax_board
from distributed_reinforcement_learning_tpu_torch.data import codec
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
from distributed_reinforcement_learning_tpu_torch.runtime import weight_board
from distributed_reinforcement_learning_tpu_torch.runtime import weights as weights_mod
from distributed_reinforcement_learning_tpu_torch.runtime.transport import (
    ShardedRemoteWeights, TransportClient, TransportServer)
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # One thread for torch and for numpy's BLAS pool, as the parity files
    # pin them: several test workers share the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)

REPO = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": jax_board, "port": weight_board}


def _name(tag: str) -> str:
    return f"drltest-wb-{tag}-{os.getpid()}-{time.monotonic_ns()}"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _params(seed: int) -> dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    return {"torso.weight": torch.randn(16, 8, generator=g), "torso.bias": torch.randn(16, generator=g),
            "head.weight": torch.randn(2, 16, generator=g)}


def _blob_params(blob) -> dict[str, np.ndarray]:
    return codec.decode(np.asarray(blob))


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
def test_board_is_shared_at_the_same_versions_and_bytes(writer, reader):
    name = _name(f"{writer}2{reader}")
    board = PACKAGES[writer].WeightBoard.create(name, 1 << 16)
    view = PACKAGES[reader].WeightBoard.attach(name)
    try:
        assert view.slot_bytes == board.slot_bytes and view.creator_pid == os.getpid()
        assert view.read_blob(-2) is None and view.version() == -1
        have = -2
        for version, seed in ((0, 0), (3, 1), (7, 2), (2, 3)):  # (2: a rollback)
            params = {k: v.numpy() for k, v in _params(seed).items()}
            blob = codec.encode(params)
            assert bytes(jax_codec.encode(params)) == bytes(blob)
            board.publish_blob(blob, version)
            assert view.version() == version
            got, got_version = view.read_blob(have)
            assert got_version == version and got.tobytes() == bytes(blob)
            assert view.read_blob(version) is None  # version identity: nothing new
            have = version
        board.close_writer()
        assert view.writer_closed
    finally:
        view.close()
        board.close()
        board.unlink()


def _board_for(store: WeightStore, tag: str):
    board = weight_board.WeightBoard.create(_name(tag), 1 << 16)
    store.attach_board(board)
    return board, jax_board.WeightBoard.attach(board.name)


def test_store_lands_every_version_on_the_board_under_publish_and_publish_async():
    store = WeightStore()
    store.publish(_params(0), 0)  # before the attach: replayed onto the board
    board, view = _board_for(store, "store")
    try:
        blob, version = view.read_blob(-2)
        assert version == 0 and blob.tobytes() == bytes(store.get_blob()[0])
        store.publish(_params(1), 1)
        blob, version = view.read_blob(0)
        assert version == 1 and blob.tobytes() == bytes(store.get_blob()[0])
        for k, v in _blob_params(blob).items():
            assert np.array_equal(v, _params(1)[k].numpy())
        for version, seed in ((2, 2), (5, 3)):
            store.publish_async(_params(seed), version)
            assert store.flush_async()
            blob, got = view.read_blob(version - 1)
            assert got == version and blob.tobytes() == bytes(store.get_blob()[0])
        # A rollback submitted last lands last: its version is the
        # store's and the board's, though lower than the one before.
        store.publish_async(_params(9), 9)
        store.publish_async(_params(4), 4)
        assert store.flush_async()
        blob, got = view.read_blob(-2)
        assert got == 4 == store.version
        for k, v in _blob_params(blob).items():
            assert np.array_equal(v, _params(4)[k].numpy())
        stats = store.board_stats()
        assert stats["attached"] and stats["writes"] >= 5
    finally:
        store.close()
        view.close()
        board.close()
        board.unlink()


def test_publish_async_copies_and_encodes_off_the_learn_thread(monkeypatch):
    store = WeightStore()
    board, view = _board_for(store, "thread")
    encode = codec.encode
    threads = []

    def recording_encode(*args, **kwargs):
        threads.append(threading.current_thread().name)
        return encode(*args, **kwargs)

    monkeypatch.setattr(weights_mod.codec, "encode", recording_encode)
    try:
        for version in range(1, 4):
            store.publish_async(_params(version), version)
        assert store.flush_async()
        assert view.read_blob(-2)[1] == 3
        assert threads and set(threads) == {"weights-publish"}, threads
        threads.clear()
        store.publish(_params(7), 7)  # synchronous: encoded on the caller's thread
        assert threads == [threading.current_thread().name]
        assert view.read_blob(3)[1] == 7
    finally:
        store.close()
        view.close()
        board.close()
        board.unlink()


def test_board_weights_demote_to_tcp_when_the_writer_closes():
    store = WeightStore()
    store.publish(_params(0), 0)
    board = weight_board.serve_board(_name("demote"))
    assert board is not None
    store.attach_board(board)
    port = _free_port()
    server = TransportServer(TrajectoryQueue(4), store, host="127.0.0.1", port=port).start()
    client = TransportClient("127.0.0.1", port)
    bw = weight_board.attach_board_weights(board.name, client,
                                           fallback=ShardedRemoteWeights(client, "cpu"))
    try:
        assert bw is not None and bw.attached
        params, version = bw.get_if_newer(-1)
        assert version == 0 and bw.stat("board_pulls") == 1
        assert all(torch.equal(params[k], v) for k, v in _params(0).items())
        assert bw.get_if_newer(0) is None and bw.stat("board_checks") == 2
        store.publish(_params(1), 1)
        board.close_writer()  # the learner's shutdown latch
        params, version = bw.get_if_newer(0)  # now over TCP
        assert version == 1 and all(torch.equal(params[k], v) for k, v in _params(1).items())
        assert not bw.attached and bw.stat("tcp_fallbacks") == 1 and len(bw.demoted_at) == 1
        assert server.stat("weight_sends") == 1
    finally:
        bw.close()
        client.close()
        server.stop()
        board.close()
        board.unlink()


def test_board_weights_pull_over_tcp_until_the_board_has_a_version():
    """A learner tier's shared board is written by the publishing seat,
    which may still be building its learner when an actor's own seat
    already serves (ROADMAP F16: the actor raised "no weights published
    yet", its seat starved and the other seat waited in its first round).
    An actor holding no weights that finds the board empty pulls its own
    seat's over TCP; once the board has a version, it reads the board."""
    own = WeightStore()  # the actor's seat: it publishes before it serves
    own.publish(_params(0), 0)
    board = weight_board.serve_board(_name("empty"))
    assert board is not None
    port = _free_port()
    server = TransportServer(TrajectoryQueue(4), own, host="127.0.0.1", port=port).start()
    client = TransportClient("127.0.0.1", port)
    bw = weight_board.attach_board_weights(board.name, client,
                                           fallback=ShardedRemoteWeights(client, "cpu"))
    publisher = WeightStore()  # the publishing seat, still building its learner
    try:
        assert bw is not None and bw.attached
        got = bw.get_if_newer(-1)
        assert got is not None, "an empty board left the actor with no weights"
        params, version = got
        assert version == 0 and all(torch.equal(params[k], v) for k, v in _params(0).items())
        assert server.stat("weight_sends") == 1 and bw.stat("board_pulls") == 0 and bw.attached
        publisher.attach_board(board)
        publisher.publish(_params(1), 1)
        params, version = bw.get_if_newer(0)
        assert version == 1 and all(torch.equal(params[k], v) for k, v in _params(1).items())
        assert bw.stat("board_pulls") == 1 and server.stat("weight_sends") == 1
        assert bw.stat("tcp_fallbacks") == 0 and bw.attached
    finally:
        publisher.close()
        bw.close()
        client.close()
        server.stop()
        board.close()
        board.unlink()


def test_a_segmented_board_is_refused_by_name():
    name = _name("sharded")
    sharded = jax_board.ShardedWeightBoard.create(name, 1 << 16)
    try:
        view = weight_board.attach_any(name)
        assert isinstance(view, weight_board.ShardedWeightBoard)
        assert view.arena_bytes == sharded.arena_bytes and view.mslot_bytes == sharded.mslot_bytes
        assert view.version() == -1 and view.creator_pid == os.getpid()
        sharded.publish_shards(7, {"shards": [{"key": "torso", "nbytes": 64}]},
                               {"torso": np.zeros(64, np.uint8)})
        assert view.version() == 7 and not view.writer_closed
        view.close()
        # The port makes the segment the JAX package attaches.
        twin_name = _name("sharded-port")
        twin = weight_board.ShardedWeightBoard.create(twin_name, 1 << 16)
        try:
            jax_view = jax_board.ShardedWeightBoard.attach(twin_name)
            assert (jax_view.arena_bytes, jax_view.mslot_bytes) == (twin.arena_bytes,
                                                                  twin.mslot_bytes)
            assert jax_view.version() == -1 and twin.creator_pid == jax_view.creator_pid
            jax_view.close()
        finally:
            twin.close()
            twin.unlink()
        # Sharded publication is ported: a port reader takes the segmented
        # board a JAX learner's sharded store writes.
        from distributed_reinforcement_learning_tpu.runtime.weights import WeightStore as JaxStore

        published = jax_board.ShardedWeightBoard.create(_name("sharded-jax"), 1 << 20)
        try:
            jstore = JaxStore(sharded=True, quant="")
            jstore.attach_board(published)
            jstore.publish({k: v.numpy() for k, v in _params(3).items()}, 9)
            bw = weight_board.BoardWeights(weight_board.attach_any(published.name), client=None)
            params, version = bw.get_if_newer(-1)
            assert version == 9 and bw.stat("shard_pulls") == 1
            assert all(torch.equal(params[k], v) for k, v in _params(3).items())
            bw.close()
            bw = weight_board.attach_board_weights(published.name, client=None, deadline_s=0.5)
            assert bw.attached and bw.get_if_newer(9) is None
            bw.close()
        finally:
            published.close()
            published.unlink()
        with pytest.raises(ValueError, match="not an initialized"):
            weight_board.WeightBoard.attach(name)  # the classic board's attach refuses it
    finally:
        sharded.close()
        sharded.unlink()


def test_gate_constant_is_the_committed_verdict(monkeypatch):
    verdict = json.loads((REPO / "benchmarks" / "weights_verdict.json").read_text())
    assert weight_board.BOARD_AUTO_ENABLE is bool(verdict["auto_enable"])
    monkeypatch.delenv("DRL_SHM_WEIGHTS", raising=False)
    assert weight_board.board_enabled() is jax_board.board_enabled()
    for value, want in (("1", True), ("0", False)):
        monkeypatch.setenv("DRL_SHM_WEIGHTS", value)
        assert weight_board.board_enabled() is want is jax_board.board_enabled()
