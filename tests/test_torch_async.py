"""Asynchronous publication, the device prefetcher and `run_async`.

- `WeightStore.publish_async`: latest submit wins, landed versions only
  grow, `close` flushes, a publish after close is synchronous, and a
  snapshot (device tensors and blob) is the parameters as they stood at
  its publish, untouched by the learner's next in-place step.
- `DevicePrefetcher` on the CPU: batches in queue order, equal to
  `get_batch`'s; it stops cleanly when closed and when its queue closes.
- `run_async` of each family, on the CPU, at a small size.
"""

import threading

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu_torch.agents.impala import (
    ImpalaAgent, ImpalaBatch, ImpalaConfig)
from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Agent, R2D2Config
from distributed_reinforcement_learning_tpu_torch.agents.xformer import (
    XformerAgent, XformerConfig)
from distributed_reinforcement_learning_tpu_torch.agents.ximpala import (
    XImpalaAgent, XImpalaConfig)
from distributed_reinforcement_learning_tpu_torch.data import codec
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
from distributed_reinforcement_learning_tpu_torch.data.prefetch import DevicePrefetcher
from distributed_reinforcement_learning_tpu_torch.envs.batched import BatchedEnv
from distributed_reinforcement_learning_tpu_torch.envs.cartpole import (
    VectorCartPole, pomdp_project)
from distributed_reinforcement_learning_tpu_torch.envs.registry import make_env
from distributed_reinforcement_learning_tpu_torch.runtime import (
    actor_pipeline, impala_runner, r2d2_runner, xformer_runner, ximpala_runner)
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


def _params(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(5, 3, generator=g, requires_grad=True),
            "b": torch.randn(7, generator=g, requires_grad=True)}


def _decoded(store: WeightStore) -> dict:
    blob, _ = store.get_blob()
    return {k: torch.from_numpy(v) for k, v in codec.decode(blob, copy=True).items()}


def test_publish_async_latest_wins_and_versions_only_grow(monkeypatch):
    store = WeightStore()
    landed, entered, gate = [], threading.Event(), threading.Event()
    apply = store._apply

    def slow_apply(snap, blob, version, seq, bundle=None):
        entered.set()
        gate.wait(timeout=10.0)  # hold the worker inside its first item
        apply(snap, blob, version, seq, bundle)
        landed.append(version)

    monkeypatch.setattr(store, "_apply", slow_apply)
    params = _params(0)
    store.publish_async(params, 1)
    assert entered.wait(timeout=10.0)  # the worker holds version 1
    for v in range(2, 6):
        store.publish_async(params, v)
    gate.set()
    assert store.flush_async(timeout=10.0)
    assert landed == [1, 5]  # 2-4 were superseded while 1 was in flight
    assert store.version == 5
    assert store.get_if_newer(4)[1] == 5 and store.get_if_newer(5) is None
    store.close()


def test_close_flushes_and_a_later_publish_is_synchronous():
    store = WeightStore()
    params = _params(1)
    store.publish_async(params, 3)
    store.close()
    assert store.version == 3 and store.get_blob()[0] is not None
    with torch.no_grad():
        params["a"].add_(1.0)
    store.publish_async(params, 4)  # the worker is retired: lands at once
    assert store.version == 4
    assert torch.equal(store.get()[0]["a"], params["a"].detach())


def test_async_snapshot_survives_the_next_in_place_step():
    store = WeightStore()
    params = _params(2)
    before = {k: v.detach().clone() for k, v in params.items()}
    store.publish_async(params, 1)
    with torch.no_grad():  # the learner's next step, in place
        for p in params.values():
            p.mul_(-3.0).add_(1.0)
    assert store.flush_async(timeout=10.0)
    got, version = store.get()
    assert version == 1
    for k, v in before.items():
        assert torch.equal(got[k], v)
        assert torch.equal(_decoded(store)[k], v)
    store.close()


def test_learner_publication_matches_its_own_version():
    """A learner publishing asynchronously: whatever version has landed
    holds exactly the parameters the learner had after that step."""
    cfg = ImpalaConfig(obs_shape=(4,), num_actions=2, trajectory=5, lstm_size=8)
    agent = ImpalaAgent(cfg, device="cpu")
    queue, store = TrajectoryQueue(32), WeightStore()
    learner = impala_runner.ImpalaLearner(agent, queue, store, batch_size=4, seed=0)
    actor = impala_runner.ImpalaActor(agent, VectorCartPole(num_envs=4, seed=0), queue, store,
                                      seed=1)
    history = {0: {k: v.detach().clone() for k, v in learner.state.params.items()}}
    for _ in range(3):
        actor.run_unroll()
        learner.step(timeout=5.0)
        history[learner.train_steps] = {k: v.detach().clone()
                                        for k, v in learner.state.params.items()}
        got, version = store.get()
        for k, v in got.items():
            assert torch.equal(v, history[version][k])
    learner.close()
    got, version = store.get()
    assert version == 3
    for k, v in _decoded(store).items():
        assert torch.equal(v, history[3][k])


def _item(i: int) -> ImpalaBatch:
    return ImpalaBatch(state=np.full((3, 2), i, np.uint8), reward=np.full(3, i, np.float32),
                       action=np.full(3, i % 4, np.int32), done=np.zeros(3, bool),
                       behavior_policy=np.full((3, 4), 0.25, np.float32),
                       previous_action=np.zeros(3, np.int32),
                       initial_h=np.full((3, 2), i, np.float32),
                       initial_c=np.zeros((3, 2), np.float32))


def test_prefetcher_keeps_order_and_matches_get_batch():
    queue, twin = TrajectoryQueue(64), TrajectoryQueue(64)
    for i in range(12):
        queue.put(_item(i))
        twin.put(_item(i))
    pre = DevicePrefetcher(queue, batch_size=4, device=torch.device("cpu"))
    try:
        for _ in range(3):
            got, want = pre.get_batch(timeout=5.0), twin.get_batch(4)
            assert type(got) is ImpalaBatch
            for x, y in zip(got, want):
                assert x.dtype == y.dtype and np.array_equal(x, y)
        assert pre.get_batch(timeout=0.3) is None  # drained: a timeout, no error
    finally:
        pre.close()
    assert not pre._thread.is_alive()
    assert pre.h2d_ms() == []  # no device copies on the CPU


def test_prefetcher_stops_when_its_queue_closes():
    queue = TrajectoryQueue(8)
    pre = DevicePrefetcher(queue, batch_size=4, device=torch.device("cpu"))
    queue.put(_item(0))
    queue.close()
    pre._thread.join(timeout=5.0)
    assert not pre._thread.is_alive()
    assert pre.get_batch(timeout=0.3) is None
    pre.close()


def _assert_ran(learner, result, updates):
    assert learner.train_steps >= updates
    assert all(np.isfinite(v) for p in learner.state.params.values() for v in [p.sum().item()])
    assert isinstance(result["episode_returns"], list)


def test_run_async_impala():
    cfg = ImpalaConfig(obs_shape=(4,), num_actions=2, trajectory=8, lstm_size=16)
    agent = ImpalaAgent(cfg, device="cpu")
    queue, store = TrajectoryQueue(32), WeightStore()
    learner = impala_runner.ImpalaLearner(agent, queue, store, batch_size=8, seed=0,
                                          prefetch=True)
    actors = [impala_runner.ImpalaActor(agent, VectorCartPole(num_envs=4, seed=i), queue,
                                        store, seed=1 + i) for i in range(2)]
    result = impala_runner.run_async(learner, actors, 4, queue)
    _assert_ran(learner, result, 4)
    assert learner.prefetcher.batches == 4
    assert store.version == 4


def test_run_async_ximpala():
    cfg = XImpalaConfig(obs_shape=(4,), num_actions=2, trajectory=8, d_model=16, num_heads=2,
                        num_layers=1)
    agent = XImpalaAgent(cfg, device="cpu")
    queue, store = TrajectoryQueue(32), WeightStore()
    learner = ximpala_runner.XImpalaLearner(agent, queue, store, batch_size=8, seed=0,
                                            prefetch=True)
    actors = [ximpala_runner.XImpalaActor(agent, VectorCartPole(num_envs=8, seed=0), queue,
                                          store, seed=1)]
    result = ximpala_runner.run_async(learner, actors, 3, queue)
    _assert_ran(learner, result, 3)


def test_run_async_r2d2():
    cfg = R2D2Config(obs_shape=(2,), num_actions=2, seq_len=6, burn_in=2, lstm_size=16)
    agent = R2D2Agent(cfg, device="cpu")
    queue, store = TrajectoryQueue(64), WeightStore()
    learner = r2d2_runner.R2D2Learner(agent, queue, store, batch_size=8, replay_capacity=500,
                                      target_sync_interval=2, seed=0)
    actors = [r2d2_runner.R2D2Actor(agent, VectorCartPole(num_envs=4, seed=i), queue, store,
                                    seed=1 + i, obs_transform=pomdp_project) for i in range(2)]
    result = r2d2_runner.run_async(learner, actors, 3, queue)
    _assert_ran(learner, result, 3)
    assert learner.ingested_sequences >= 16
    assert queue.closed


def test_run_async_xformer():
    cfg = XformerConfig(obs_shape=(2,), num_actions=2, seq_len=6, burn_in=2, d_model=16,
                        num_heads=2, num_layers=1)
    agent = XformerAgent(cfg, device="cpu")
    queue, store = TrajectoryQueue(64), WeightStore()
    learner = xformer_runner.XformerLearner(agent, queue, store, batch_size=8,
                                            replay_capacity=500, target_sync_interval=2, seed=0)
    actors = [xformer_runner.XformerActor(agent, VectorCartPole(num_envs=4, seed=i), queue,
                                          store, seed=1 + i, obs_transform=pomdp_project)
              for i in range(2)]
    result = xformer_runner.run_async(learner, actors, 3, queue)
    _assert_ran(learner, result, 3)
    assert learner.ingested_sequences >= 16
    assert queue.closed


@pytest.mark.parametrize("family", ["impala", "ximpala", "r2d2", "xformer"])
def test_pipelined_actor_slices_fill_the_queue(family, monkeypatch):
    """`DRL_ACTOR_PIPE=1` wraps each family's actor in the pipeline: two
    slices of the envs, one round of unrolls per slice env."""
    monkeypatch.setenv("DRL_ACTOR_PIPE", "1")
    monkeypatch.setenv("DRL_NO_GYMNASIUM", "1")  # the in-tree CartPole stream
    env = BatchedEnv([(lambda s=s: make_env("CartPole-v0", seed=s)) for s in range(4)])
    queue, store = TrajectoryQueue(32), WeightStore()
    if family == "r2d2":
        agent = R2D2Agent(R2D2Config(obs_shape=(2,), num_actions=2, seq_len=5, burn_in=1,
                                     lstm_size=8), device="cpu")
        actor = r2d2_runner.R2D2Actor(agent, env, queue, store, seed=1,
                                      obs_transform=pomdp_project)
    elif family == "xformer":
        agent = XformerAgent(XformerConfig(obs_shape=(2,), num_actions=2, seq_len=5, burn_in=1,
                                           d_model=8, num_heads=2, num_layers=1), device="cpu")
        actor = xformer_runner.XformerActor(agent, env, queue, store, seed=1,
                                            obs_transform=pomdp_project)
    elif family == "ximpala":
        agent = XImpalaAgent(XImpalaConfig(obs_shape=(4,), num_actions=2, trajectory=5,
                                           d_model=8, num_heads=2, num_layers=1), device="cpu")
        actor = ximpala_runner.XImpalaActor(agent, env, queue, store, seed=1)
    else:
        agent = ImpalaAgent(ImpalaConfig(obs_shape=(4,), num_actions=2, trajectory=5,
                                         lstm_size=8), device="cpu")
        actor = impala_runner.ImpalaActor(agent, env, queue, store, seed=1)
    store.publish(agent.init_state(0).params, 0)
    pipe = actor_pipeline.maybe_wrap(actor)
    assert isinstance(pipe, actor_pipeline.ActorPipeline)
    try:
        assert pipe.run_unroll() == 4 * 5
    finally:
        pipe.close()
    assert queue.size() == 4
    assert pipe._version == 0


def test_one_agent_serves_concurrent_threads():
    """Threads sharing one agent (the learner and the actors of
    `run_async`) each act under their own parameters: the results equal
    the same calls made one after another."""
    import sys

    cfg = ImpalaConfig(obs_shape=(4,), num_actions=2, trajectory=4, lstm_size=8)
    agent = ImpalaAgent(cfg, device="cpu")
    params = [agent.init_state(seed).params for seed in range(4)]
    obs = torch.randn(3, 4)
    pa = torch.zeros(3, dtype=torch.long)
    h, c = agent.initial_lstm_state(3)

    def policy(i):
        return agent.act(params[i], obs, pa, h, c, torch.Generator().manual_seed(i)).policy

    want = [policy(i) for i in range(4)]
    got = [[] for _ in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda j=j: got[j].extend(
            policy(j % 4) for _ in range(30))) for j in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    for j in range(8):
        assert len(got[j]) == 30 and all(torch.equal(p, want[j % 4]) for p in got[j])


class _DyingActor:
    episode_returns: list = []

    def run_unroll(self):
        raise ValueError("env crashed")


@pytest.mark.parametrize("family", ["impala", "r2d2"])
def test_run_async_raises_once_every_actor_died(family):
    """A learner whose actor threads have all died raises instead of
    waiting for data forever."""
    queue, store = TrajectoryQueue(8), WeightStore()
    if family == "r2d2":
        agent = R2D2Agent(R2D2Config(obs_shape=(2,), num_actions=2, seq_len=4, burn_in=1,
                                     lstm_size=8), device="cpu")
        learner = r2d2_runner.R2D2Learner(agent, queue, store, batch_size=4, seed=0)
        run = r2d2_runner.run_async
    else:
        agent = ImpalaAgent(ImpalaConfig(obs_shape=(4,), num_actions=2, trajectory=4,
                                         lstm_size=8), device="cpu")
        learner = impala_runner.ImpalaLearner(agent, queue, store, batch_size=4, seed=0)
        run = impala_runner.run_async
    with pytest.raises(RuntimeError, match="every actor thread died"):
        run(learner, [_DyingActor()], 2, queue)
    assert queue.closed


def test_profiler_window_writes_a_chrome_trace(tmp_path, monkeypatch):
    """DRL_PROFILE_DIR / _START / _STEPS: a torch.profiler window over
    train steps 1-2 of a learner, written as a Chrome trace at its end."""
    import json

    monkeypatch.setenv("DRL_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("DRL_PROFILE_START", "1")
    monkeypatch.setenv("DRL_PROFILE_STEPS", "2")
    cfg = ImpalaConfig(obs_shape=(4,), num_actions=2, trajectory=4, lstm_size=8)
    agent = ImpalaAgent(cfg, device="cpu")
    queue, store = TrajectoryQueue(32), WeightStore()
    learner = impala_runner.ImpalaLearner(agent, queue, store, batch_size=4, seed=0)
    actor = impala_runner.ImpalaActor(agent, VectorCartPole(num_envs=4, seed=0), queue, store,
                                      seed=1)
    impala_runner.run_sync(learner, [actor], 4)
    traces = list(tmp_path.glob("trace-*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("learn" in str(e.get("name", "")) or "aten::" in str(e.get("name", ""))
               for e in events)
    assert set(learner.timer.run_counts()) >= {"dequeue", "learn", "publish"}
