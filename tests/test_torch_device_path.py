"""The fused device sample path (`data/device_path.py`,
`runtime/replay_train.device_train_call`) against the JAX package's.

Mirrors tests/test_device_path.py without its two-process drill (chip
phase 42 runs the path on the card against the default 2-shard service):

- the port's `gather_scan_batch` and `gather_single_batch` give the JAX
  gathers' indices, rows and IS weights over services built and fed
  alike, at the same seed, and the gather also runs over a monolithic
  backend;
- the path's bounded depth over many rounds, a copy that overlaps the
  consumer's work (a slow-copy stub), `reconfigure` dropping entries of
  the old K;
- the oversize latch and the learner's demotion to the host loop; a
  service demotion closing (joining) the path before host sampling;
- the gate (`DRL_DEVICE_PATH`, then the verdict constant, which holds
  the JAX package's committed file);
- a surviving shard applying every update across a shard death mid-K;
- a device-path train call leaving the parameters and priorities a
  host-path call leaves on the same sampled batches (K = 1 through the
  agent's `learn`, K > 1 through `learn_many`; Ape-X, R2D2 and
  Transformer-R2D2), at the learn step's rtol 1e-4;
- a checkpoint taken while the path runs ahead: the saved sampling
  stream is where the trained calls left it, so the restored learner
  samples the indices, and takes the step, the saved one takes next.
"""

import json
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.data import device_path as jax_dp
from distributed_reinforcement_learning_tpu.data import replay_service as jax_rs
from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexAgent, ApexConfig
from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Agent, R2D2Config
from distributed_reinforcement_learning_tpu_torch.agents.xformer import XformerAgent, XformerConfig
from distributed_reinforcement_learning_tpu_torch.data import codec
from distributed_reinforcement_learning_tpu_torch.data import device_path, replay_service
from distributed_reinforcement_learning_tpu_torch.data.device_path import (
    DeviceSamplePath, device_path_enabled, gather_scan_batch, gather_single_batch, path_depth,
    path_max_bytes)
from distributed_reinforcement_learning_tpu_torch.data.fifo import (
    TrajectoryQueue, stack_pytrees, tree_leaves)
from distributed_reinforcement_learning_tpu_torch.data.replay import _snapshot_items, make_replay
from distributed_reinforcement_learning_tpu_torch.data.replay_service import unpack_index
from distributed_reinforcement_learning_tpu_torch.data.structures import (
    XformerSequenceAccumulator)
from distributed_reinforcement_learning_tpu_torch.runtime import (
    apex_runner, r2d2_runner, xformer_runner)
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore
from distributed_reinforcement_learning_tpu_torch.utils.checkpoint import Checkpointer
from test_torch_replay_service import blobs_of

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # One thread for torch and for numpy's BLAS pool: OpenBLAS spreads the
    # Atari resize's small matmuls over every core, which costs far more
    # than the matmuls once several test workers share the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _service(module, mode="transition", num_shards=2, count=8, seed=0, **shape):
    """A sharded service of `module` (the port's or JAX's), fed the same
    blobs shard by shard."""
    svc = module.ShardedReplayService(num_shards, 2048, mode=mode, scorer="max", seed=seed)
    for i, blob in enumerate(blobs_of(mode, seed, count, **shape)):
        svc.shards[i % num_shards].ingest_blob(blob)
    return svc


def _assert_same_gather(got, want):
    for a, b in zip(tree_leaves(got[0]), jax.tree.leaves(want[0])):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(got[1], want[1])
    assert len(got[2]) == len(want[2])
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode,shape", [("transition", {}), ("sequence", dict(t=10, h=32))])
def test_gathers_match_jax_at_a_fixed_seed(mode, shape):
    mine, ref = _service(replay_service, mode, **shape), _service(jax_rs, mode, **shape)
    try:
        _assert_same_gather(gather_scan_batch(mine, 8, 3, np.random.RandomState(123)),
                            jax_dp.gather_scan_batch(ref, 8, 3, np.random.RandomState(123)))
        _assert_same_gather(gather_single_batch(mine, 8, np.random.RandomState(7)),
                            jax_dp.gather_single_batch(ref, 8, np.random.RandomState(7)))
    finally:
        mine.close()
        ref.close()


def test_scan_gather_is_the_host_sample_and_runs_over_monolithic_backends():
    ref_svc = _service(replay_service)
    rng = np.random.RandomState(5)
    ref = [ref_svc.sample(8, rng) for _ in range(2)]
    ref_svc.close()
    svc = _service(replay_service)
    stacked, w, idxs = gather_scan_batch(svc, 8, 2, np.random.RandomState(5))
    svc.close()
    want = stack_pytrees([items for items, _, _ in ref])
    for a, b in zip(stacked, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(w, np.stack([np.asarray(x, np.float32) for _, _, x in ref]))
    replay = make_replay(256, backend="python", seed=0)
    from distributed_reinforcement_learning_tpu_torch.data import codec

    for blob in blobs_of("transition", 0, 2):
        tree = codec.decode(blob, copy=True)
        for i in range(len(tree.reward)):
            replay.add(1.0, type(tree)(*(x[i] for x in tree)))
    stacked, w, idx = gather_scan_batch(replay, 4, 2, np.random.RandomState(0))
    assert w.shape == (2, 4) and len(idx) == 2 and stacked.state.shape[:2] == (2, 4)


def test_path_entries_flow_at_bounded_depth():
    svc = _service(replay_service)
    path = DeviceSamplePath(svc, 4, 2, np.random.RandomState(0), depth=2)
    try:
        for _ in range(12):
            entry = path.next_entry(timeout=10.0)
            assert entry is not None
            k, batch, weights, idxs = entry
            assert k == 2 and len(idxs) == 2 and np.asarray(weights).shape == (2, 4)
            assert batch.state.shape[:2] == (2, 4)
            assert path._out.qsize() <= 2
        assert not path.dead and path.entries_out >= 12 and path.h2d_ms() == []
        assert path.stats()["gather_rounds"] >= 12
    finally:
        assert path.close()
        svc.close()


def test_the_copy_overlaps_the_consumer():
    """With a slow-copy stub, N copies and N 'learn' sleeps take well
    under their serial sum: the copy for entry k+1 runs on the gather
    thread while the consumer works on entry k."""
    svc = _service(replay_service)
    copy_s = 0.05

    def slow_transfer(batch, weights):
        time.sleep(copy_s)
        return batch, weights, None

    path = DeviceSamplePath(svc, 4, 1, np.random.RandomState(0), depth=1,
                            transfer=slow_transfer)
    try:
        n = 6
        assert path.next_entry(timeout=10.0) is not None  # the pipeline primed
        t0 = time.monotonic()
        for _ in range(n):
            assert path.next_entry(timeout=10.0) is not None
            time.sleep(copy_s)  # the consumer's learn
        elapsed = time.monotonic() - t0
        assert elapsed < n * 2 * copy_s * 0.85, f"no overlap: {elapsed:.3f} s"
    finally:
        path.close()
        svc.close()


def test_reconfigure_drops_entries_of_the_old_k():
    svc = _service(replay_service)
    path = DeviceSamplePath(svc, 4, 3, np.random.RandomState(0), depth=1)
    try:
        entry = path.next_entry(timeout=10.0)
        assert entry is not None and entry[0] == 3
        path.reconfigure(1)
        deadline = time.monotonic() + 30.0
        while True:
            entry = path.next_entry(timeout=10.0)
            assert entry is not None
            assert entry[2].shape == ((entry[0], 4) if entry[0] > 1 else (4,))
            if entry[0] == 1:
                break  # never a stale K = 3 stack after the switch
            assert time.monotonic() < deadline
        assert path.k == 1 and path.stats()["k"] == 1
    finally:
        path.close()
        svc.close()


def _apex_learner(svc, k=1, seed=0, force=True):
    agent = ApexAgent(ApexConfig(obs_shape=(4,), num_actions=2, start_learning_rate=1e-3),
                      device="cpu")
    learner = apex_runner.ApexLearner(
        agent, TrajectoryQueue(16), WeightStore(), batch_size=8, replay_capacity=2048,
        replay_service=svc, updates_per_call=k, train_start_unrolls=1, seed=seed,
        target_sync_interval=10)
    learner.device_path_force = force
    return learner


def _r2d2_learner(svc, k=2, seed=0, force=True):
    agent = R2D2Agent(R2D2Config(obs_shape=(2,), num_actions=2, seq_len=10, burn_in=5,
                                 lstm_size=32, learning_rate=1e-3), device="cpu")
    learner = r2d2_runner.R2D2Learner(
        agent, TrajectoryQueue(16), WeightStore(), batch_size=8, replay_capacity=2048,
        replay_service=svc, updates_per_call=k, seed=seed, target_sync_interval=10)
    learner.device_path_force = force
    return learner


def _xformer_service(count=16, num_shards=2):
    """A sharded service fed `count` Transformer-R2D2 sequences (no
    stored LSTM state), from a seed."""
    svc = replay_service.ShardedReplayService(num_shards, 2048, mode="sequence", scorer="max",
                                              seed=0)
    rng = np.random.RandomState(0)
    blobs = []
    while len(blobs) < count:
        acc = XformerSequenceAccumulator()
        for _ in range(10):
            acc.append(state=rng.randn(4, 2).astype(np.float32),
                       previous_action=rng.randint(0, 2, 4).astype(np.int32),
                       action=rng.randint(0, 2, 4).astype(np.int32),
                       reward=rng.randn(4).astype(np.float32), done=rng.rand(4) < 0.1)
        blobs += [bytes(codec.encode(seq)) for seq in acc.extract()]
    for i, blob in enumerate(blobs[:count]):
        svc.shards[i % num_shards].ingest_blob(blob)
    return svc


def _xformer_learner(svc, k=2, seed=0, force=True):
    agent = XformerAgent(XformerConfig(obs_shape=(2,), num_actions=2, seq_len=10, burn_in=5,
                                       d_model=16, num_heads=2, num_layers=1,
                                       learning_rate=1e-3), device="cpu")
    learner = xformer_runner.XformerLearner(
        agent, TrajectoryQueue(16), WeightStore(), batch_size=8, replay_capacity=2048,
        replay_service=svc, updates_per_call=k, seed=seed, target_sync_interval=10)
    learner.device_path_force = force
    return learner


def _train_until(learner, steps, budget_s=60.0):
    deadline = time.monotonic() + budget_s
    last = None
    while learner.train_steps < steps:
        m = learner.train()
        last = m if m is not None else last
        assert time.monotonic() < deadline, "train never progressed"
    return last


def test_oversize_entry_latches_dead_and_the_learner_trains_on_the_host():
    svc = _service(replay_service)
    learner = _apex_learner(svc)
    learner._device_path = DeviceSamplePath(svc, learner.batch_size, 1, learner._np_rng,
                                            max_bytes=8)
    deadline = time.monotonic() + 20.0
    while not learner._device_path.dead:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert "oversize" in learner._device_path.dead_reason
    assert _train_until(learner, 1) is not None  # demoted, trained on the host path
    assert learner._device_path is None and learner._device_path_demoted
    learner.close()
    svc.close()


def test_service_demotion_closes_the_path_before_host_sampling():
    svc = _service(replay_service)
    learner = _apex_learner(svc)
    _train_until(learner, 1)
    path = learner._device_path
    assert path is not None
    for shard in svc.shards:
        svc.note_shard_death(shard)
    assert not svc.healthy and learner._active_replay() is learner.replay
    assert learner._device_path_for(learner.replay) is None
    assert learner._device_path is None and learner._device_path_demoted
    assert not path._thread.is_alive()  # the RNG is the host loop's again
    learner.close()
    svc.close()


def test_gate_and_knobs(monkeypatch):
    committed = json.loads((REPO / "benchmarks" / "device_path_verdict.json").read_text())
    assert device_path.DEVICE_PATH_VERDICT["auto_enable"] is committed["auto_enable"]
    monkeypatch.delenv("DRL_DEVICE_PATH", raising=False)
    assert device_path_enabled() is committed["auto_enable"] is False
    monkeypatch.setenv("DRL_DEVICE_PATH", "1")
    assert device_path_enabled()
    monkeypatch.setenv("DRL_DEVICE_PATH", "0")
    assert not device_path_enabled()
    assert path_depth() == 1 and path_max_bytes() == 256 * 1024 * 1024
    monkeypatch.setenv("DRL_DEVICE_PATH_DEPTH", "3")
    monkeypatch.setenv("DRL_DEVICE_PATH_MAX_MB", "0.5")
    assert path_depth() == 3 and path_max_bytes() == 512 * 1024
    monkeypatch.setenv("DRL_DEVICE_PATH_DEPTH", "bogus")
    with pytest.raises(ValueError):
        path_depth()
    # Unforced and unset, a learner resolves the gate once and stays on
    # the host path.
    monkeypatch.delenv("DRL_DEVICE_PATH")
    svc = _service(replay_service)
    learner = _apex_learner(svc, force=None)
    _train_until(learner, 1)
    assert learner._device_path is None and learner._device_path_demoted
    learner.close()
    svc.close()


def test_a_surviving_shard_loses_no_update_mid_k():
    svc = _service(replay_service, count=16)
    _, _, idx_list = gather_scan_batch(svc, 8, 3, np.random.RandomState(0))
    victim = svc.shards[0]
    applied0 = [s.stats()["updates_applied"] for s in svc.shards]
    victim.mark_dead()
    victim.restart()  # a new epoch: the in-flight updates are stale now
    for idxs in idx_list:
        svc.update_batch(idxs, np.full(len(idxs), 0.5))
    assert svc.flush_updates(timeout=10.0)
    counts = {0: 0, 1: 0}
    for idxs in idx_list:
        for s in unpack_index(idxs)[0]:
            counts[int(s)] += 1
    stats = [s.stats() for s in svc.shards]
    assert stats[1]["updates_applied"] - applied0[1] == counts[1] > 0
    assert stats[0]["updates_applied"] == 0
    svc.close()


def _family_learner(family, k, force, seed=0, empty=False):
    """-> (learner, its service) over 16 stored unrolls or sequences, or
    over an empty service."""
    if empty:
        svc = replay_service.ShardedReplayService(
            2, 2048, mode="transition" if family == "apex" else "sequence", scorer="max", seed=0)
        make = {"apex": _apex_learner, "r2d2": _r2d2_learner}[family]
        return make(svc, k=k, seed=seed, force=force), svc
    if family == "xformer":
        svc = _xformer_service()
        learner = _xformer_learner(svc, k=k, seed=seed, force=force)
    elif family == "r2d2":
        svc = _service(replay_service, "sequence", count=16, t=10, h=32)
        learner = _r2d2_learner(svc, k=k, seed=seed, force=force)
    else:
        svc = _service(replay_service, "transition", count=16)
        learner = _apex_learner(svc, k=k, seed=seed, force=force)
    if family != "apex":
        learner.ingested_sequences = 16
    return learner, svc


@pytest.mark.parametrize("family,k", [("apex", 1), ("apex", 3), ("r2d2", 2), ("xformer", 2)])
def test_a_device_path_call_leaves_the_host_path_parameters(family, k):
    """The same service contents and sampling seed: the path's first
    entry is the host path's first gather, and the call leaves the same
    parameters and written-back priorities."""
    learners, services = [], []
    for force in (True, False):
        learner, svc = _family_learner(family, k, force)
        services.append(svc)
        learners.append(learner)
    dev, host = learners
    host.state = host.agent.state_from_params(
        {n: t.detach() for n, t in dev.state.params.items()})
    try:
        _train_until(dev, k)
        assert dev._device_path is not None and not dev._device_path.dead
        dev._close_device_path()  # stop sampling ahead before the priorities are read
        assert host.train() is not None and host.train_steps == dev.train_steps == k
        assert host._device_path is None and host._device_path_demoted
        for key, want in host.state.params.items():
            np.testing.assert_allclose(dev.state.params[key].detach().numpy(),
                                       want.detach().numpy(), rtol=1e-4, atol=0, err_msg=key)
        for svc in services:
            assert svc.flush_updates(timeout=10.0)
        got, want = (svc.snapshot()["priorities"] for svc in services)
        np.testing.assert_allclose(got, want, rtol=1e-4)
    finally:
        for learner, svc in zip(learners, services):
            learner.close()
            svc.close()


@pytest.mark.parametrize("family,k", [("apex", 1), ("r2d2", 2)])
def test_a_checkpoint_beside_a_live_path_saves_the_trained_stream(family, k, tmp_path,
                                                                 monkeypatch):
    """The path samples ahead of the learn on the learner's stream. A
    checkpoint closes it first, which rewinds the stream to where the
    first call that no train call took began: the saved stream is a host
    -path twin's after the same calls, and the saved learner, going on,
    and the restored one sample the same indices next and leave the same
    parameters bit for bit."""
    # The service's own snapshot round-robins items over the shards; each
    # shard is copied in place below instead, so that indices compare.
    monkeypatch.setenv("DRL_CKPT_REPLAY", "0")
    saved, svc_a = _family_learner(family, k, force=True)
    twin, svc_t = _family_learner(family, k, force=False)
    restored, svc_b = _family_learner(family, k, force=True, seed=1, empty=True)
    sampled = {id(svc_a): [], id(svc_b): []}
    for svc in (svc_a, svc_b):
        update = svc.update_batch

        def record(idxs, errors, svc=svc, update=update):
            sampled[id(svc)].append(np.array(idxs))
            update(idxs, errors)
        svc.update_batch = record
    try:
        _train_until(saved, 3 * k)
        _train_until(twin, 3 * k)
        path = saved._device_path
        deadline = time.monotonic() + 20.0
        while path._out.qsize() < 1:
            assert time.monotonic() < deadline  # an entry sampled ahead, waiting
            time.sleep(0.01)
        saved.save_checkpoint(Checkpointer(tmp_path))
        assert saved._device_path is None and not path._thread.is_alive()
        assert not saved._device_path_demoted  # the next train call builds a new path
        for a, b in zip(saved._np_rng.get_state(), twin._np_rng.get_state()):
            np.testing.assert_array_equal(a, b)
        assert restored.restore_checkpoint(Checkpointer(tmp_path))
        assert restored.train_steps == saved.train_steps == 3 * k
        assert svc_a.flush_updates(timeout=10.0)
        for mine, theirs in zip(svc_b.shards, svc_a.shards):
            snap = theirs.snapshot()
            mine.restore_part(snap["priorities"], _snapshot_items(snap))
        np.testing.assert_array_equal(svc_b.snapshot()["priorities"],
                                      svc_a.snapshot()["priorities"])
        # The warm-up counters ride with the replay snapshot, left out here.
        if family == "apex":
            restored.ingested_unrolls = saved._warm_unrolls()
        else:
            restored.ingested_sequences = saved.ingested_sequences
        before = len(sampled[id(svc_a)])
        _train_until(saved, 4 * k)
        _train_until(restored, 4 * k)
        assert saved._device_path is not None and restored._device_path is not None
        got, want = sampled[id(svc_b)][:k], sampled[id(svc_a)][before:before + k]
        assert len(got) == len(want) == k
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        for key, want in saved.state.params.items():
            assert torch.equal(restored.state.params[key], want), key
    finally:
        for learner, svc in ((saved, svc_a), (twin, svc_t), (restored, svc_b)):
            learner.close()
            svc.close()
