"""Served acts (`runtime/inference.py`) against the JAX package's service.

Each family's adapter and the classic `InferenceServer` hold the JAX
`InferenceServer` on the same converted parameters and the same rows:
policy, q, h and c within atol 1e-5 (the converted-forward tolerance of
the port's family tests), greedy actions equal at epsilon 0, sampled
actions by distribution (within 5 standard errors of the JAX policy).
Then the port twins of tests/test_inference.py: batching, chunking of
pending rows and of one wide request, a mismatched request failing
alone, submits racing stop, a failed batch reaching every waiter, a
rollback republish reaching the device cache; every family's actor
acting through a service with no weight pull; an IMPALA actor training a
learner over TCP through OP_ACT; and a learner without a service
refusing OP_ACT for good.
"""

import socket
import threading

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.runtime import inference as jax_inference
from distributed_reinforcement_learning_tpu.runtime.weights import WeightStore as JaxStore
from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexAgent, ApexConfig
from distributed_reinforcement_learning_tpu_torch.agents.impala import ImpalaAgent, ImpalaConfig
from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Agent, R2D2Config
from distributed_reinforcement_learning_tpu_torch.agents.xformer import (
    XformerAgent, XformerConfig)
from distributed_reinforcement_learning_tpu_torch.agents.ximpala import (
    XImpalaAgent, XImpalaConfig)
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
from distributed_reinforcement_learning_tpu_torch.models.convert import (
    apex_params_from_jax, impala_params_from_jax, r2d2_params_from_jax,
    transformer_params_from_jax)
from distributed_reinforcement_learning_tpu_torch.runtime.inference import (
    InferenceServer, _bucket, make_act_adapter)
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

ATOL = 1e-5

_CONFIGS = {
    "impala": dict(obs_shape=(4,), num_actions=3, trajectory=8, lstm_size=32,
                   start_learning_rate=1e-3, learning_frame=10**6),
    "apex": dict(obs_shape=(4,), num_actions=3, start_learning_rate=1e-3),
    "r2d2": dict(obs_shape=(2,), num_actions=2, seq_len=6, burn_in=2, lstm_size=32,
                 learning_rate=1e-3),
    "xformer": dict(obs_shape=(2,), num_actions=2, seq_len=6, burn_in=2, d_model=32,
                    num_heads=2, num_layers=1),
    "ximpala": dict(obs_shape=(4,), num_actions=3, trajectory=6, d_model=32, num_heads=2,
                    num_layers=1),
}
_DETERMINISTIC = {"impala": ("policy", "h", "c"), "apex": ("q",), "r2d2": ("q", "h", "c"),
                  "xformer": ("q",), "ximpala": ("policy",)}


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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _agents(algo):
    """-> (JAX agent, its parameters, port agent, the converted parameters)."""
    from distributed_reinforcement_learning_tpu.agents import apex, impala, r2d2, xformer, ximpala

    jax_cls = {"impala": (impala.ImpalaAgent, impala.ImpalaConfig),
               "apex": (apex.ApexAgent, apex.ApexConfig),
               "r2d2": (r2d2.R2D2Agent, r2d2.R2D2Config),
               "xformer": (xformer.XformerAgent, xformer.XformerConfig),
               "ximpala": (ximpala.XImpalaAgent, ximpala.XImpalaConfig)}[algo]
    port_cls = {"impala": (ImpalaAgent, ImpalaConfig), "apex": (ApexAgent, ApexConfig),
                "r2d2": (R2D2Agent, R2D2Config), "xformer": (XformerAgent, XformerConfig),
                "ximpala": (XImpalaAgent, XImpalaConfig)}[algo]
    kw = _CONFIGS[algo]
    jagent = jax_cls[0](jax_cls[1](**kw))
    jparams = jagent.init_state(jax.random.PRNGKey(0)).params
    convert = {"impala": impala_params_from_jax, "apex": apex_params_from_jax,
               "r2d2": r2d2_params_from_jax,
               "xformer": lambda t: transformer_params_from_jax(t, head="dueling_q"),
               "ximpala": lambda t: transformer_params_from_jax(t, head="actor_critic")}[algo]
    agent = port_cls[0](port_cls[1](**kw), device="cpu")
    params = agent.state_from_params(convert(_np(jparams))).params
    return jagent, jparams, agent, params


def _request(algo, n, rng, epsilon=0.0):
    """A request of n rows in the family's layout (JAX `expected_keys`)."""
    kw = _CONFIGS[algo]
    if algo in ("impala", "apex", "r2d2"):
        obs = rng.standard_normal((n, *kw["obs_shape"])).astype(np.float32)
    else:
        w = kw.get("seq_len") or kw["trajectory"]
        obs = rng.standard_normal((n, w, *kw["obs_shape"])).astype(np.float32)
    if algo == "impala":
        h = (rng.standard_normal((n, kw["lstm_size"])) * 0.5).astype(np.float32)
        return {"obs": obs, "prev_action": rng.integers(0, kw["num_actions"], n).astype(np.int32),
                "h": h, "c": -h}
    if algo == "apex":
        return {"obs": obs, "prev_action": rng.integers(0, kw["num_actions"], n).astype(np.int32),
                "epsilon": np.full(n, epsilon, np.float32)}
    if algo == "r2d2":
        h = (rng.standard_normal((n, kw["lstm_size"])) * 0.5).astype(np.float32)
        return {"obs": obs, "h": h, "c": -h,
                "prev_action": rng.integers(0, kw["num_actions"], n).astype(np.int32),
                "epsilon": np.full(n, epsilon, np.float32)}
    w = obs.shape[1]
    done = np.zeros((n, w), bool)
    done[:, :2] = True  # leading pad slots, as an actor's window holds them
    done[::2, 3] = True  # an episode boundary inside some windows
    req = {"obs": obs, "prev_action": rng.integers(0, kw["num_actions"], (n, w)).astype(np.int32),
           "done": done}
    if algo == "xformer":
        req["epsilon"] = np.full(n, epsilon, np.float32)
    return req


def _services(algo, **kw):
    """The JAX and port services of one family on the same parameters."""
    jagent, jparams, agent, params = _agents(algo)
    jstore = JaxStore()
    jstore.publish(jparams, 0)
    store = WeightStore()
    store.publish(params, 0)
    jserver = jax_inference.InferenceServer.for_agent(algo, jagent, jstore, max_wait_ms=1.0, **kw)
    server = InferenceServer.for_agent(algo, agent, store, max_wait_ms=1.0, **kw)
    return jserver, server, agent, params


def _impala(max_batch=256, max_wait_ms=1.0, seed=0):
    agent = ImpalaAgent(ImpalaConfig(**_CONFIGS["impala"]), device="cpu")
    weights = WeightStore()
    weights.publish(agent.init_state(seed=0).params, 0)
    server = InferenceServer.for_agent("impala", agent, weights, max_batch=max_batch,
                                       max_wait_ms=max_wait_ms, seed=seed)
    return agent, weights, server


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_bucket():
    assert [_bucket(n) for n in (1, 2, 3, 5, 8, 9, 250)] == [1, 2, 4, 8, 8, 16, 256]
    assert _bucket(300) == 512
    assert _bucket(300) == jax_inference._bucket(300)


@pytest.mark.parametrize("algo", sorted(_CONFIGS))
def test_adapter_matches_jax_service(algo):
    """Same converted parameters, same rows: the deterministic outputs at
    atol 1e-5, the same keys, shapes and dtypes on the wire's row dicts;
    greedy actions equal at epsilon 0."""
    jserver, server, _, _ = _services(algo)
    try:
        req = _request(algo, 5, np.random.default_rng(1))
        want = jserver.submit(dict(req))
        got = server.submit(dict(req))
        assert set(got) == set(want)
        for k in got:
            assert got[k].shape == np.asarray(want[k]).shape, k
            assert got[k].dtype == np.asarray(want[k]).dtype, k
        for k in _DETERMINISTIC[algo]:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=ATOL, err_msg=k)
        if algo in ("apex", "r2d2", "xformer"):  # epsilon 0: the argmax
            np.testing.assert_array_equal(got["action"], np.asarray(want["action"]))
            np.testing.assert_array_equal(got["action"], np.argmax(got["q"], -1))
        else:
            assert np.all((got["action"] >= 0) & (got["action"] < _CONFIGS[algo]["num_actions"]))
    finally:
        jserver.stop()
        server.stop()


def test_adapter_keys_match_jax():
    for algo in _CONFIGS:
        jagent, _, agent, _ = _agents(algo)
        assert (make_act_adapter(algo, agent).expected_keys
                == jax_inference.make_act_adapter(algo, jagent).expected_keys), algo


@pytest.mark.parametrize("algo", ["impala", "ximpala"])
def test_sampled_actions_follow_the_jax_policy(algo):
    """Softmax families: served actions are drawn by the policy the JAX
    service computes for the same rows."""
    jserver, server, _, _ = _services(algo, max_batch=4096)
    n = 4096
    try:
        rng = np.random.default_rng(2)
        two = _request(algo, 2, rng)
        req = {k: np.repeat(v, n // 2, axis=0) for k, v in two.items()}
        want = np.asarray(jserver.submit({k: v[:: n // 2] for k, v in req.items()})["policy"])
        got = server.submit(req)
        for row in range(2):
            sl = slice(row * n // 2, (row + 1) * n // 2)
            freq = np.bincount(got["action"][sl], minlength=want.shape[1]) / (n // 2)
            sigma = np.sqrt(want[row] * (1 - want[row]) / (n // 2))
            assert np.all(np.abs(freq - want[row]) < 5 * sigma + 1e-9), (freq, want[row])
    finally:
        jserver.stop()
        server.stop()


@pytest.mark.parametrize("algo", ["apex", "r2d2", "xformer"])
def test_epsilon_one_explores_uniformly(algo):
    """Epsilon rides the rows: at 1 every action is a uniform draw."""
    _, server, _, _ = _services(algo, max_batch=2048)
    n = 2048
    try:
        req = _request(algo, 1, np.random.default_rng(3), epsilon=1.0)
        out = server.submit({k: np.repeat(v, n, axis=0) for k, v in req.items()})
        a = _CONFIGS[algo]["num_actions"]
        freq = np.bincount(out["action"], minlength=a) / n
        sigma = np.sqrt((1 / a) * (1 - 1 / a) / n)
        assert np.all(np.abs(freq - 1 / a) < 5 * sigma), freq
    finally:
        server.stop()


def test_served_policy_matches_the_local_act():
    agent, weights, server = _impala(max_batch=64)
    try:
        req = _request("impala", 5, np.random.default_rng(0))
        out = server.submit(dict(req))
        params, _ = weights.get()
        local = agent.act(params, *(torch.from_numpy(req[k]) for k in ("obs", "prev_action",
                                                                        "h", "c")),
                          torch.Generator().manual_seed(1))
        np.testing.assert_allclose(out["policy"], local.policy.numpy(), atol=1e-6)
        np.testing.assert_allclose(out["h"], local.h.numpy(), atol=1e-6)
        assert out["action"].dtype == np.int32 and out["action"].shape == (5,)
    finally:
        server.stop()


def test_same_seed_same_first_batch_same_actions():
    """The generator is the only randomness, consumed by the dispatch
    thread alone: two services with one seed agree on their first batch."""
    services = [_impala(seed=11)[2], _impala(seed=11)[2]]
    try:
        req = _request("impala", 6, np.random.default_rng(4))
        a, b = (s.submit(dict(req)) for s in services)
        np.testing.assert_array_equal(a["action"], b["action"])
    finally:
        for s in services:
            s.stop()


def test_concurrent_submits_are_batched():
    _, _, server = _impala(max_batch=64, max_wait_ms=20.0)
    results = [None] * 8

    def one(i):
        results[i] = server.submit(_request("impala", 4, np.random.default_rng(i)))

    try:
        one(0)
        threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert all(r is not None and r["action"].shape == (4,) for r in results)
        assert server.rows_served == 4 + 8 * 4
        assert server.batches_run <= 4, f"{server.batches_run} batches for 8 submits"
        stats = server.stats()
        assert stats["rows_served"] == 36 and 0 < stats["occupancy"] <= 1
        assert stats["latency_ms_p50"] is not None
    finally:
        server.stop()


def test_no_weights_raises():
    agent = ImpalaAgent(ImpalaConfig(**_CONFIGS["impala"]), device="cpu")
    server = InferenceServer.for_agent("impala", agent, WeightStore(), max_wait_ms=1.0)
    try:
        with pytest.raises(RuntimeError):
            server.submit(_request("impala", 1, np.random.default_rng(0)))
    finally:
        server.stop()


def test_a_bare_act_fn_runs_on_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceServer(lambda p, rows, g: rows, WeightStore())


def test_oversized_pending_is_chunked():
    _, _, server = _impala(max_batch=8, max_wait_ms=50.0)
    results = [None] * 6

    def one(i):
        results[i] = server.submit(_request("impala", 4, np.random.default_rng(i)))

    try:
        one(0)
        threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert all(r is not None for r in results)
        assert server.rows_served == 4 + 6 * 4
        assert server.padded_rows == server.rows_served  # 4 or 8 rows a batch
    finally:
        server.stop()


def test_mismatched_request_fails_alone():
    _, _, server = _impala()
    try:
        with pytest.raises(RuntimeError, match="algorithm mismatch"):
            server.submit({"obs": np.zeros((2, 4), np.float32),
                           "prev_action": np.zeros(2, np.int32),
                           "epsilon": np.zeros(2, np.float32)})  # Ape-X's rows
        with pytest.raises(RuntimeError, match="row counts disagree"):
            req = _request("impala", 2, np.random.default_rng(0))
            req["prev_action"] = np.zeros(3, np.int32)
            server.submit(req)
        with pytest.raises(RuntimeError, match="empty"):
            server.submit({})
        assert server.submit(_request("impala", 2, np.random.default_rng(1)))["action"].shape == (2,)
    finally:
        server.stop()


def test_oversized_request_is_chunked():
    agent, weights, server = _impala(max_batch=16)
    sizes = []
    inner = server.act_fn

    def recording(params, rows, generator):
        sizes.append(rows["obs"].shape[0])
        return inner(params, rows, generator)

    recording.expected_keys = inner.expected_keys
    server.act_fn = recording
    try:
        req = _request("impala", 70, np.random.default_rng(5))
        out = server.submit(req)
        assert out["action"].shape == (70,)
        assert sizes and max(sizes) <= 16, sizes
        assert server.rows_served == 70
        params, _ = weights.get()
        local = agent.act(params, *(torch.from_numpy(req[k]) for k in ("obs", "prev_action",
                                                                        "h", "c")),
                          torch.Generator().manual_seed(1))
        np.testing.assert_allclose(out["policy"], local.policy.numpy(), atol=1e-6)
    finally:
        server.stop()


def test_submit_racing_stop_never_hangs():
    _, _, server = _impala(max_batch=8)
    server.submit(_request("impala", 2, np.random.default_rng(0)))
    outcomes = []

    def spam():
        for i in range(50):
            try:
                server.submit(_request("impala", 2, np.random.default_rng(i)))
            except RuntimeError:
                outcomes.append("raised")
                return
        outcomes.append("done")

    threads = [threading.Thread(target=spam) for _ in range(4)]
    for t in threads:
        t.start()
    server.stop()
    for t in threads:
        t.join(timeout=10.0)
        assert not t.is_alive(), "submit hung across stop()"
    assert len(outcomes) == 4
    with pytest.raises(RuntimeError, match="stopped"):
        server.submit(_request("impala", 1, np.random.default_rng(0)))


def test_batch_failure_delivers_errors_to_every_waiter():
    _, _, server = _impala(max_batch=64, max_wait_ms=30.0)
    inner = server.act_fn
    boom = threading.Event()

    def failing(params, rows, generator):
        if boom.is_set():
            raise ValueError("injected batch failure")
        return inner(params, rows, generator)

    failing.expected_keys = inner.expected_keys
    server.act_fn = failing
    errors = []

    def one():
        try:
            server.submit(_request("impala", 4, np.random.default_rng(0)))
        except RuntimeError as e:
            errors.append(e)

    try:
        server.submit(_request("impala", 2, np.random.default_rng(1)))
        boom.set()
        threads = [threading.Thread(target=one) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
            assert not t.is_alive(), "waiter stranded by a failed batch"
        assert len(errors) == 3
        assert all("inference batch failed" in str(e) for e in errors)
        boom.clear()
        assert server.submit(_request("impala", 2, np.random.default_rng(2)))["action"].shape == (2,)
    finally:
        server.stop()


def test_rollback_republish_reaches_device_cache():
    """Versions are identities: a lower version published after a higher
    one must still replace the cached parameters."""
    weights = WeightStore()

    def act_fn(params, rows, generator):
        return {"marker": torch.full((rows["x"].shape[0],), float(params["w"]))}

    weights.publish({"w": torch.tensor(5.0)}, 5)
    server = InferenceServer(act_fn, weights, max_batch=8, max_wait_ms=1.0, device="cpu")
    try:
        np.testing.assert_array_equal(server.submit({"x": np.zeros(2, np.float32)})["marker"],
                                      [5.0, 5.0])
        weights.publish({"w": torch.tensor(3.0)}, 3)
        np.testing.assert_array_equal(server.submit({"x": np.zeros(2, np.float32)})["marker"],
                                      [3.0, 3.0])
    finally:
        server.stop()


def test_host_arrays_in_a_store_are_moved_once_a_version():
    weights = WeightStore()
    seen = []

    def act_fn(params, rows, generator):
        seen.append(params["w"])
        return {"y": rows["x"] * params["w"]}

    weights.publish({"w": torch.tensor(2.0)}, 0)
    server = InferenceServer(act_fn, weights, max_wait_ms=1.0, device="cpu")
    try:
        for _ in range(3):
            np.testing.assert_array_equal(server.submit({"x": np.ones(3, np.float32)})["y"], 2.0)
        assert seen[0] is seen[1] is seen[2]  # one placement for the version
    finally:
        server.stop()


def _family_actor(algo, service, queue, sliceable=False):
    from distributed_reinforcement_learning_tpu_torch.envs.batched import BatchedEnv
    from distributed_reinforcement_learning_tpu_torch.envs.cartpole import (
        VectorCartPole, pomdp_project)
    from distributed_reinforcement_learning_tpu_torch.envs.registry import make_env
    from distributed_reinforcement_learning_tpu_torch.runtime import (
        apex_runner, impala_runner, r2d2_runner, xformer_runner, ximpala_runner)

    cfg = _CONFIGS[algo]
    env = (BatchedEnv([lambda s=s: make_env("CartPole-v1", seed=s, num_actions=2)
                       for s in range(4)]) if sliceable
           else VectorCartPole(num_envs=4, seed=0))
    port_agent = _agents(algo)[2]
    weights = WeightStore()  # never published: the actor must not pull
    if algo == "impala":
        return impala_runner.ImpalaActor(port_agent, env, queue, weights, seed=1,
                                         remote_act=service.submit), cfg["trajectory"]
    if algo == "ximpala":
        return ximpala_runner.XImpalaActor(port_agent, env, queue, weights, seed=1,
                                           remote_act=service.submit), cfg["trajectory"]
    if algo == "apex":
        return apex_runner.ApexActor(port_agent, env, queue, weights, seed=1, unroll_size=8,
                                     local_capacity=200, remote_act=service.submit), 16
    cls = xformer_runner.XformerActor if algo == "xformer" else r2d2_runner.R2D2Actor
    return cls(port_agent, env, queue, weights, seed=1, obs_transform=pomdp_project,
               remote_act=service.submit), cfg["seq_len"]


@pytest.mark.parametrize("algo", sorted(_CONFIGS))
def test_every_family_acts_through_the_service(algo, monkeypatch):
    """An actor with `remote_act` steps its envs on served acts, records
    its rounds, and pulls no weights (its store is never published)."""
    monkeypatch.setenv("DRL_NO_GYMNASIUM", "1")
    _, server, _, _ = _services(algo)
    queue = TrajectoryQueue(capacity=64)
    actor, steps = _family_actor(algo, server, queue)
    try:
        if algo == "apex":
            frames = actor.run_steps(steps)
            assert len(actor._buffer) == steps * 4
        else:
            frames = actor.run_unroll()
            assert queue.size() == 4
        assert frames == steps * 4
        assert actor._params is None and actor._version == -1
        assert server.rows_served >= steps * 4
    finally:
        server.stop()


@pytest.mark.parametrize("algo", ["impala", "xformer"])
def test_pipelined_actor_pulls_no_weights(algo, monkeypatch):
    """The pipelined actor's round sync skips the pull under remote_act."""
    from distributed_reinforcement_learning_tpu_torch.runtime import actor_pipeline

    monkeypatch.setenv("DRL_NO_GYMNASIUM", "1")
    monkeypatch.setenv("DRL_ACTOR_PIPE", "1")
    _, server, _, _ = _services(algo)
    queue = TrajectoryQueue(capacity=64)
    actor, steps = _family_actor(algo, server, queue, sliceable=True)
    piped = actor_pipeline.maybe_wrap(actor, label="test")
    try:
        assert isinstance(piped, actor_pipeline.ActorPipeline)
        assert piped.run_unroll() == steps * 4
        assert actor._params is None
    finally:
        piped.close()
        server.stop()


def test_impala_actor_trains_via_remote_act(monkeypatch):
    """A remote-act actor feeds a live learner over TCP through OP_ACT and
    OP_PUT_TRAJ, and never pulls weights."""
    from distributed_reinforcement_learning_tpu_torch.envs.cartpole import VectorCartPole
    from distributed_reinforcement_learning_tpu_torch.runtime import impala_runner
    from distributed_reinforcement_learning_tpu_torch.runtime.transport import (
        RemoteInference, RemoteQueue, RemoteWeights, TransportClient, TransportServer)

    monkeypatch.setenv("DRL_NO_GYMNASIUM", "1")
    cfg = ImpalaConfig(**{**_CONFIGS["impala"], "num_actions": 2})
    agent = ImpalaAgent(cfg, device="cpu")
    queue = TrajectoryQueue(capacity=32)
    weights = WeightStore()
    learner = impala_runner.ImpalaLearner(agent, queue, weights, batch_size=8)
    inference = InferenceServer.for_agent("impala", agent, weights, max_wait_ms=2.0)
    port = _free_port()
    server = TransportServer(queue, weights, host="127.0.0.1", port=port,
                             inference=inference).start()
    client = TransportClient("127.0.0.1", port)
    actor = impala_runner.ImpalaActor(
        ImpalaAgent(cfg, device="cpu"), VectorCartPole(num_envs=4, seed=0), RemoteQueue(client),
        RemoteWeights(client), seed=1, remote_act=RemoteInference(client))
    stop = threading.Event()

    def actor_loop():
        while not stop.is_set():
            try:
                actor.run_unroll()
            except (ConnectionError, RuntimeError):
                return

    t = threading.Thread(target=actor_loop, daemon=True)
    t.start()
    try:
        for _ in range(3):
            m = learner.step(timeout=60.0)
            assert m is not None and np.isfinite(float(m["total_loss"]))
        assert learner.train_steps == 3
        assert inference.rows_served > 0
        assert server.stat("acts_served") > 0 and client.stat("acts") > 0
        assert actor._params is None and client.stat("weight_pulls") == 0
    finally:
        stop.set()
        queue.close()
        learner.close()
        server.stop()
        inference.stop()
        t.join(timeout=5.0)
        client.close()


def test_remote_act_against_plain_learner_fails_fast():
    from distributed_reinforcement_learning_tpu_torch.runtime.transport import (
        InferenceUnavailableError, TransportClient, TransportServer)

    port = _free_port()
    server = TransportServer(TrajectoryQueue(8), WeightStore(), host="127.0.0.1",
                             port=port).start()
    client = TransportClient("127.0.0.1", port)
    try:
        with pytest.raises(InferenceUnavailableError, match="serve_inference"):
            client.remote_act({"obs": np.zeros((1, 4), np.float32)})
    finally:
        server.stop()
        client.close()


@pytest.mark.parametrize("b", [1, 3])
def test_flash_route_hands_the_kernels_contiguous_rows(b, monkeypatch):
    """ROADMAP F10: a one-row served Transformer-IMPALA act took the flash
    route with q, k and v as views of a transpose (at b = 1 the reshape
    copies nothing), which the CUDA wrappers refuse ("takes contiguous
    tensors"); the port's actors never formed a batch of one."""
    from distributed_reinforcement_learning_tpu_torch.ops import attention
    from distributed_reinforcement_learning_tpu_torch.ops.kernels import attention as kattn

    inner = kattn.flash_attention_bhtd
    seen = []

    def strict(q, k, v, qs, ks, *args, **kw):
        seen.append(all(x.is_contiguous() for x in (q, k, v, qs, ks)))
        return inner(q, k, v, qs, ks, *args, **kw)

    monkeypatch.setattr(kattn, "flash_attention_bhtd", strict)
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(b, 16, 2, 32).astype(np.float32)) for _ in range(3))
    segs = torch.zeros(b, 16, dtype=torch.int32)
    out = attention.causal_attention(q, k, v, q_seg=segs, k_seg=segs)
    want = attention.dense_attention(q, k, v, causal=True, q_seg=segs, k_seg=segs)
    assert seen == [True]
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5)
