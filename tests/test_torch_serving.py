"""The act-serving tier (`runtime/serving.py` and the transport's act
surfaces), the port twins of tests/test_serving.py, and the act wire
across the packages.

- The continuous batcher: the classic server's first batch and the local
  act, coalescing while a batch is in flight, chunking, stop racing
  submit.
- Admission: a full pending budget raises InferenceBusy in process and
  answers ST_BUSY over the wire; the service serves again afterwards.
- Replica processes (`--mode inference`, `serving.run_replica`) fed by a
  port learner's store over TCP: a replica's action rows equal the
  learner-hosted service's with the same seed (the replica offsets the
  seed by 7777 + 131 * task, the learner by 7777); killing one of two
  replicas mid-hammer demotes it and every request completes on the
  survivor, whose JSON summary counts the acts it served.
- RemoteActService: busy failover to an idle sibling, an application
  error without a demotion; the replica gate over the verdict constant,
  which holds the JAX package's `benchmarks/inference_verdict.json`.
- The wire, both ways: a JAX client acting through a port server with a
  port service, and the port's RemoteActService through a JAX server
  with a JAX service, on converted parameters: the same row layouts and
  the same status codes (ST_OK rows, ST_BUSY, ST_ERROR, ST_UNAVAILABLE).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.runtime import inference as jax_inference
from distributed_reinforcement_learning_tpu.runtime import serving as jax_serving
from distributed_reinforcement_learning_tpu.runtime import transport as jax_transport
from distributed_reinforcement_learning_tpu.runtime.weights import WeightStore as JaxStore
from distributed_reinforcement_learning_tpu_torch.agents.impala import ImpalaAgent, ImpalaConfig
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
from distributed_reinforcement_learning_tpu_torch.models.convert import impala_params_from_jax
from distributed_reinforcement_learning_tpu_torch.runtime import serving
from distributed_reinforcement_learning_tpu_torch.runtime.inference import (
    InferenceBusy, InferenceServer, make_act_adapter)
from distributed_reinforcement_learning_tpu_torch.runtime.serving import (
    ContinuousInferenceServer, replica_count, replicas_auto_enabled)
from distributed_reinforcement_learning_tpu_torch.runtime.transport import (
    InferenceBusyError, InferenceUnavailableError, RemoteActFailed, RemoteActService,
    TransportClient, TransportServer)
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore
from distributed_reinforcement_learning_tpu_torch.utils.config import load_config

REPO = Path(__file__).resolve().parent.parent
CONFIG = REPO / "config.json"
SMALL = dict(obs_shape=(4,), num_actions=2, trajectory=8, lstm_size=32,
             start_learning_rate=1e-3, learning_frame=10**6)


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


def _agent(cfg=None):
    return ImpalaAgent(ImpalaConfig(**(cfg or SMALL)), device="cpu")


def _request(n, seed=0, lstm=32):
    rng = np.random.default_rng(seed)
    return {"obs": rng.random((n, 4), np.float32), "prev_action": np.zeros(n, np.int32),
            "h": np.zeros((n, lstm), np.float32), "c": np.zeros((n, lstm), np.float32)}


def _published_store(agent):
    weights = WeightStore()
    weights.publish(agent.init_state(seed=0).params, 0)
    return weights


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_pending(server, rows: int) -> None:
    deadline = time.monotonic() + 10.0
    while server._pending_rows < rows:
        assert time.monotonic() < deadline
        time.sleep(0.005)


class _GatedActFn:
    """An act_fn whose Nth call blocks on an event: holds a batch in
    flight while more submits pile up."""

    def __init__(self, inner, block_call=1):
        self.inner = inner
        self.block_call = block_call
        self.calls = 0
        self.entered = threading.Event()
        self.release = threading.Event()
        self.batch_rows = []
        self.expected_keys = inner.expected_keys
        self.device = inner.device

    def __call__(self, params, rows, generator):
        self.calls += 1
        self.batch_rows.append(next(iter(rows.values())).shape[0])
        if self.calls == self.block_call:
            self.entered.set()
            assert self.release.wait(timeout=30.0)
        return self.inner(params, rows, generator)


def _gated_server(agent, weights, **kw):
    gate = _GatedActFn(make_act_adapter("impala", agent), block_call=2)
    return gate, ContinuousInferenceServer(gate, weights, max_batch=64, seed=0, **kw)


def _hold_budget(gate, server) -> list[threading.Thread]:
    """Warm, then hold batch 2 in flight with 3 rows pending behind it."""
    server.submit(_request(2))
    t = threading.Thread(target=server.submit, args=(_request(2),))
    t.start()
    assert gate.entered.wait(timeout=10.0)
    t2 = threading.Thread(target=server.submit, args=(_request(3),))
    t2.start()
    _wait_pending(server, 3)
    return [t, t2]


class TestContinuousBatcher:
    def test_matches_classic_server_and_local_act(self):
        agent = _agent()
        weights = _published_store(agent)
        req = _request(5, seed=3)
        classic = InferenceServer.for_agent("impala", agent, weights, max_batch=64, seed=11)
        cont = ContinuousInferenceServer.for_agent("impala", agent, weights, max_batch=64,
                                                   seed=11)
        try:
            a = classic.submit(dict(req))
            b = cont.submit(dict(req))
            np.testing.assert_array_equal(a["action"], b["action"])
            np.testing.assert_array_equal(a["policy"], b["policy"])
            np.testing.assert_array_equal(a["h"], b["h"])
        finally:
            classic.stop()
            cont.stop()

    def test_next_batch_assembles_while_previous_in_flight(self):
        agent = _agent()
        gate, server = _gated_server(agent, _published_store(agent))
        results = [None] * 7

        def one(i):
            results[i] = server.submit(_request(4, seed=i))

        try:
            one(0)
            t0 = threading.Thread(target=one, args=(1,))
            t0.start()
            assert gate.entered.wait(timeout=10.0)
            rest = [threading.Thread(target=one, args=(i,)) for i in range(2, 7)]
            for t in rest:
                t.start()
            _wait_pending(server, 20)
            gate.release.set()
            for t in [t0, *rest]:
                t.join(timeout=30.0)
            assert all(r is not None and r["action"].shape == (4,) for r in results)
            assert gate.calls == 3, gate.batch_rows
            assert gate.batch_rows[2] == 32  # 20 rows padded to a power of two
            assert server.rows_served == 7 * 4
        finally:
            gate.release.set()
            server.stop()

    def test_oversized_submit_is_chunked(self):
        agent = _agent()
        weights = _published_store(agent)
        server = ContinuousInferenceServer.for_agent("impala", agent, weights, max_batch=16,
                                                     seed=0)
        sizes = []
        inner = server.act_fn

        def recording(params, rows, generator):
            sizes.append(rows["obs"].shape[0])
            return inner(params, rows, generator)

        recording.expected_keys = inner.expected_keys
        server.act_fn = recording
        try:
            req = _request(70, seed=1)
            out = server.submit(req)
            assert out["action"].shape == (70,) and out["policy"].shape == (70, 2)
            assert sizes and max(sizes) <= 16, sizes
            local = agent.act(weights.get()[0], *(torch.from_numpy(req[k])
                                                  for k in ("obs", "prev_action", "h", "c")),
                              torch.Generator().manual_seed(9))
            np.testing.assert_allclose(out["policy"], local.policy.numpy(), atol=1e-6)
        finally:
            server.stop()

    def test_stop_races_submit_without_hanging(self):
        agent = _agent()
        server = ContinuousInferenceServer.for_agent("impala", agent, _published_store(agent),
                                                     max_batch=8, seed=0)
        server.submit(_request(2))
        outcomes = []

        def spam():
            for i in range(50):
                try:
                    server.submit(_request(2, seed=i))
                except RuntimeError:
                    outcomes.append("raised")
                    return
            outcomes.append("done")

        threads = [threading.Thread(target=spam) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.05)
        server.stop()
        for t in threads:
            t.join(timeout=10.0)
            assert not t.is_alive(), "submit hung across stop()"
        assert len(outcomes) == 4

    def test_a_failed_batch_reaches_its_waiters_and_the_service_goes_on(self):
        agent = _agent()
        server = ContinuousInferenceServer.for_agent("impala", agent, _published_store(agent),
                                                     seed=0)
        inner = server.act_fn
        boom = threading.Event()

        def failing(params, rows, generator):
            if boom.is_set():
                raise RuntimeError("injected act failure")
            return inner(params, rows, generator)

        failing.expected_keys = inner.expected_keys
        server.act_fn = failing
        try:
            boom.set()
            with pytest.raises(RuntimeError, match="inference batch failed"):
                server.submit(_request(2))
            boom.clear()
            assert server.submit(_request(2))["action"].shape == (2,)
        finally:
            server.stop()


def test_concurrent_submits_each_get_their_own_rows():
    """Stress: more submitter threads than cores, a short switch interval,
    requests of 1-9 rows coalescing into batches of up to 16: each reply's
    policy is its own rows' (a misaligned scatter would hand a submitter
    another's rows), and every row is counted once."""
    agent = _agent()
    weights = _published_store(agent)
    params, _ = weights.get()
    server = ContinuousInferenceServer.for_agent("impala", agent, weights, max_batch=16, seed=0)
    errors, sizes = [], []
    lock = threading.Lock()

    def worker(tid):
        rng = np.random.default_rng(tid)
        for _ in range(10):
            n = int(rng.integers(1, 10))
            req = _request(n, seed=int(rng.integers(1 << 30)))
            got = server.submit(dict(req))
            with torch.no_grad():
                want = agent.act(params, *(torch.from_numpy(req[k])
                                           for k in ("obs", "prev_action", "h", "c")),
                                 torch.Generator().manual_seed(0))
            with lock:
                sizes.append(n)
                if not np.allclose(got["policy"], want.policy.numpy(), atol=1e-6):
                    errors.append(tid)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    n_threads = 4 * (os.cpu_count() or 1)
    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
            assert not t.is_alive(), "a submitter hung"
    finally:
        sys.setswitchinterval(interval)
        server.stop()
    assert errors == [] and len(sizes) == 10 * len(threads)
    assert server.rows_served == sum(sizes)


class TestAdmissionControl:
    def test_budget_rejects_and_recovers_in_process(self):
        agent = _agent()
        gate, server = _gated_server(agent, _published_store(agent), admission_rows=4)
        try:
            held = _hold_budget(gate, server)
            with pytest.raises(InferenceBusy, match="admission budget full"):
                server.submit(_request(2))  # 3 + 2 > 4
            assert server.admission_reject_count() == 1
            gate.release.set()
            for t in held:
                t.join(timeout=10.0)
            assert server.submit(_request(2))["action"].shape == (2,)
        finally:
            gate.release.set()
            server.stop()

    def test_busy_maps_to_st_busy_over_the_wire(self):
        agent = _agent()
        weights = _published_store(agent)
        gate, infer = _gated_server(agent, weights, admission_rows=4)
        port = _free_port()
        server = TransportServer(None, weights, host="127.0.0.1", port=port,
                                 inference=infer).start()
        client = TransportClient("127.0.0.1", port)
        retry_client = TransportClient("127.0.0.1", port)
        try:
            held = _hold_budget(gate, infer)
            with pytest.raises(InferenceBusyError):
                client.remote_act(_request(2), busy_retry=False)
            assert client.stat("act_busy_waits") == 1
            assert server.stat("act_busy_replies") >= 1
            got = []
            t3 = threading.Thread(target=lambda: got.append(retry_client.remote_act(_request(2))))
            t3.start()
            time.sleep(0.1)
            gate.release.set()
            t3.join(timeout=30.0)
            for t in held:
                t.join(timeout=10.0)
            assert got and got[0]["action"].shape == (2,)
            assert server.stat("acts_served") >= 1
        finally:
            gate.release.set()
            server.stop()
            infer.stop()
            client.close()
            retry_client.close()

    def test_a_queue_less_server_refuses_trajectories(self):
        agent = _agent()
        weights = _published_store(agent)
        port = _free_port()
        server = TransportServer(None, weights, host="127.0.0.1", port=port).start()
        client = TransportClient("127.0.0.1", port)
        try:
            from distributed_reinforcement_learning_tpu_torch.runtime import transport

            status, _ = client._exchange(transport.OP_QUEUE_SIZE, b"", retry=False, resend=True)
            assert status == transport.ST_UNAVAILABLE
            assert client.get_weights_if_newer(-1) is not None  # it still serves weights
        finally:
            server.stop()
            client.close()


# -- replica processes ------------------------------------------------------------


class _Learner:
    """A port learner's weight plane in this process: the
    `impala_cartpole` section's agent, published as version 0 and served
    over TCP (the replicas pull it)."""

    def __init__(self):
        agent_cfg, _ = load_config(CONFIG, "impala_cartpole")
        self.agent = ImpalaAgent(agent_cfg, device="cpu")
        self.lstm = agent_cfg.lstm_size
        self.weights = WeightStore()
        self.weights.publish(self.agent.init_state(seed=0).params, 0)
        self.port = _free_port()
        self.server = TransportServer(TrajectoryQueue(8), self.weights, host="127.0.0.1",
                                      port=self.port).start()

    def close(self):
        self.server.stop()


def _spawn_replica(learner: _Learner, task: int, iport: int) -> subprocess.Popen:
    env = dict(os.environ, DRL_LEARNER_ADDR=f"127.0.0.1:{learner.port}",
               DRL_INFER_PORT=str(iport), DRL_FLEET="0", OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    for key in ("DRL_SHM_WEIGHTS_NAME", "DRL_INFER_REPLICAS", "DRL_WEIGHTS_KEYS"):
        env.pop(key, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_reinforcement_learning_tpu_torch.train_impala",
         "--config", str(CONFIG), "--section", "impala_cartpole", "--mode", "inference",
         "--task", str(task), "--device", "cpu", "--actor_grace", "5"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + 60.0
    for line in proc.stdout:
        if f"[infer {task}] serving acts on :{iport}" in line:
            return proc
        if time.monotonic() > deadline:
            break
    proc.kill()
    raise RuntimeError(f"replica {task} did not start: {proc.stdout.read()[-2000:]}")


def _stop_replica(proc: subprocess.Popen) -> dict | None:
    """SIGINT (the launcher's stop request) -> the replica's JSON summary."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
    try:
        out, _ = proc.communicate(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        return None
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if lines else None


def test_replica_process_acts_equal_learner_hosted_acts():
    """A replica process and a learner-hosted service with the same
    parameters and seed (task 0: both 7777) give equal action rows for
    the same first batch."""
    learner = _Learner()
    iport = _free_port()
    proc = _spawn_replica(learner, 0, iport)
    local = InferenceServer.for_agent("impala", learner.agent, learner.weights, max_batch=64,
                                      seed=0 + 7777)
    client = TransportClient("127.0.0.1", iport)
    try:
        req = _request(5, seed=42, lstm=learner.lstm)
        mine = local.submit(dict(req))
        theirs = client.remote_act(dict(req))
        np.testing.assert_array_equal(mine["action"], theirs["action"])
        for k in ("policy", "h", "c"):
            np.testing.assert_array_equal(mine[k], theirs[k])
        client.close()
        summary = _stop_replica(proc)
        assert summary["role"] == "inference" and summary["acts_served"] == 1
        assert summary["rows_served"] == 5 and summary["weight_versions_seen"] == 1
        assert summary["launches"]["attention_fwd"] == 0  # the CPU takes the plain versions
    finally:
        client.close()
        local.stop()
        if proc.poll() is None:
            proc.kill()
        learner.close()


def test_replica_kill_demotes_to_survivor_without_losing_requests():
    learner = _Learner()
    ports = [_free_port(), _free_port()]
    procs = [_spawn_replica(learner, k, p) for k, p in enumerate(ports)]
    svc = RemoteActService.from_addrs([f"127.0.0.1:{p}" for p in ports], connect_retries=2)
    served, errors = [], []
    lock = threading.Lock()
    n_threads, per_thread = 3, 20

    def hammer(tid):
        for k in range(per_thread):
            try:
                out = svc(_request(4, seed=tid * 1000 + k, lstm=learner.lstm))
            except Exception as e:  # noqa: BLE001 — the test's assertion
                with lock:
                    errors.append(e)
                return
            with lock:
                served.append((out["action"].shape, out["policy"].shape))

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(n_threads)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30.0
        while True:
            with lock:
                done = len(served)
            if done >= 6:
                break
            assert time.monotonic() < deadline, "hammer never progressed"
            time.sleep(0.005)
        procs[0].kill()
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive(), "hammer thread hung after replica kill"
        assert errors == []
        assert len(served) == n_threads * per_thread
        assert all(a == (4,) and p == (4, 2) for a, p in served)
        assert svc.live_endpoints() == 1
        stats = svc.snapshot_stats()
        assert stats["replica_demotes"] == 1 and stats["acts"] == n_threads * per_thread
        survivor = _stop_replica(procs[1])
        assert survivor["acts_served"] > 0 and survivor["batches_run"] > 0
    finally:
        svc.close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=10)
        learner.close()


def test_replica_refuses_shard_scoped_pulls(monkeypatch):
    """Sharded publication is ported: a replica no longer refuses
    `DRL_WEIGHTS_KEYS` but scopes its refreshes to the named shards. Its
    first pull from a sharded learner is whole (both of the
    `impala_cartpole` parameters' shards), its refresh carries `rep`
    alone."""
    from distributed_reinforcement_learning_tpu_torch.runtime import weight_shards

    agent_cfg, _ = load_config(CONFIG, "impala_cartpole")
    params = ImpalaAgent(agent_cfg, device="cpu").init_state(seed=0).params
    weights = WeightStore(sharded=True)
    weights.publish(params, 0)
    server = TransportServer(TrajectoryQueue(8), weights, host="127.0.0.1",
                             port=_free_port()).start()
    for key, value in (("DRL_WEIGHTS_KEYS", "rep"), ("DRL_LEARNER_ADDR", f"127.0.0.1:{server.port}"),
                       ("DRL_INFER_PORT", str(_free_port())), ("DRL_INFER_PULL_S", "0.05"),
                       ("DRL_FLEET", "0")):
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("DRL_SHM_WEIGHTS_NAME", raising=False)
    assert weight_shards.role_keys() == ["rep"]

    def drive():
        deadline = time.monotonic() + 30.0
        while server.stat("shard_sends") < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        weights.publish({k: v + 1.0 for k, v in params.items()}, 1)
        while server.stat("shard_sends") < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        server.stop()  # the learner goes: the replica exits after its grace

    driver = threading.Thread(target=drive)
    driver.start()
    try:
        summary = serving.run_replica("impala", str(CONFIG), "impala_cartpole", device="cpu",
                                      grace=0.5)
    finally:
        driver.join()
        server.stop()
    assert summary["weight_versions_seen"] == 2 and summary["weight_version"] == 1
    stats = server.snapshot_stats()
    shards = {sh["key"] for sh in weight_shards.parse_manifest(weights.get_sharded(-1)[1])["shards"]}
    assert shards == {"rep", "-,model"}
    assert stats["shard_sends"] == 2 and stats["shard_full_sends"] == 2 + 1


# -- the replica tier's client side ----------------------------------------------


def test_busy_replica_fails_over_to_idle_sibling():
    agent = _agent()
    weights = _published_store(agent)
    gate, busy_infer = _gated_server(agent, weights, admission_rows=4)
    idle_infer = ContinuousInferenceServer.for_agent("impala", agent, weights, seed=1)
    ports = [_free_port(), _free_port()]
    servers = [TransportServer(None, weights, host="127.0.0.1", port=ports[0],
                               inference=busy_infer).start(),
               TransportServer(None, weights, host="127.0.0.1", port=ports[1],
                               inference=idle_infer).start()]
    svc = RemoteActService.from_addrs([f"127.0.0.1:{p}" for p in ports], connect_retries=2)
    try:
        _hold_budget(gate, busy_infer)
        out = svc(_request(2))
        assert out["action"].shape == (2,)
        stats = svc.snapshot_stats()
        assert stats["busy_failovers"] >= 1 and stats["replica_demotes"] == 0
        assert svc.live_endpoints() == 2  # saturated is not dead
    finally:
        gate.release.set()
        svc.close()
        for s in servers:
            s.stop()
        busy_infer.stop()
        idle_infer.stop()


def test_replica_app_error_does_not_demote():
    agent = _agent()
    empty = WeightStore()  # never published: every act answers ST_ERROR
    inference = ContinuousInferenceServer.for_agent("impala", agent, empty, seed=0)
    port = _free_port()
    server = TransportServer(None, empty, host="127.0.0.1", port=port,
                             inference=inference).start()
    svc = RemoteActService.from_addrs([f"127.0.0.1:{port}"], connect_retries=2)
    try:
        for _ in range(3):
            with pytest.raises(RemoteActFailed):
                svc(_request(2))
        assert svc.live_endpoints() == 1
        assert svc.snapshot_stats()["replica_demotes"] == 0
    finally:
        svc.close()
        server.stop()
        inference.stop()


def test_a_replica_that_dies_mid_run_is_demoted_in_seconds():
    """ROADMAP F9: from_addrs' 60 x 1 s connect budget covers topology
    start; once an endpoint has connected, a death costs RECONNECT_RETRIES
    tries (~3 s), where the JAX tier keeps 60 for the whole run (an
    in-flight act stalls ~60 s on a dead replica)."""
    agent = _agent()
    weights = _published_store(agent)
    services = [ContinuousInferenceServer.for_agent("impala", agent, weights, seed=k)
                for k in range(2)]
    ports = [_free_port(), _free_port()]
    servers = [TransportServer(None, weights, host="127.0.0.1", port=p, inference=svc).start()
               for p, svc in zip(ports, services)]
    addrs = [f"127.0.0.1:{p}" for p in ports]
    svc = RemoteActService.from_addrs(addrs)
    jsvc = jax_transport.RemoteActService.from_addrs(addrs)
    try:
        for _ in range(4):  # both endpoints serve
            assert svc(_request(2))["action"].shape == (2,)
            jsvc(_request(2))
        assert [ep.connect_retries for ep in svc._endpoints] == [60, 60]
        assert [ep.reconnect_retries for ep in svc._endpoints] == [3, 3]
        assert [ep.connect_retries for ep in jsvc._endpoints] == [60, 60]
        assert not hasattr(jsvc._endpoints[0], "reconnect_retries")
        servers[0].stop()
        t0 = time.monotonic()
        for _ in range(4):
            assert svc(_request(2))["action"].shape == (2,)
        assert time.monotonic() - t0 < 10.0
        assert svc.snapshot_stats()["replica_demotes"] == 1 and svc.live_endpoints() == 1
    finally:
        svc.close()
        jsvc.close()
        for s in servers:
            s.stop()
        for service in services:
            service.stop()


def test_a_dead_tier_falls_back_to_the_learner():
    agent = _agent()
    weights = _published_store(agent)
    inference = InferenceServer.for_agent("impala", agent, weights, max_wait_ms=1.0)
    port = _free_port()
    server = TransportServer(TrajectoryQueue(8), weights, host="127.0.0.1", port=port,
                             inference=inference).start()
    learner = TransportClient("127.0.0.1", port)
    svc = RemoteActService.from_addrs([f"127.0.0.1:{_free_port()}"], fallback=learner,
                                      connect_retries=1)
    try:
        assert svc(_request(3))["action"].shape == (3,)
        stats = svc.snapshot_stats()
        assert stats["replica_demotes"] == 1 and stats["fallback_acts"] == 1
    finally:
        svc.close()
        learner.close()
        server.stop()
        inference.stop()


class TestReplicaGate:
    def test_env_force_wins(self, monkeypatch):
        monkeypatch.setenv("DRL_INFER_REPLICAS", "3")
        assert replica_count() == 3
        monkeypatch.setenv("DRL_INFER_REPLICAS", "0")
        assert replica_count() == 0
        monkeypatch.setenv("DRL_INFER_REPLICAS", "x")
        with pytest.raises(ValueError, match="DRL_INFER_REPLICAS"):
            replica_count()

    def test_unset_defers_to_the_verdict(self, monkeypatch):
        monkeypatch.delenv("DRL_INFER_REPLICAS", raising=False)
        assert replicas_auto_enabled({"auto_enable": True}) is True
        assert replica_count({"auto_enable": True, "replicas": 4}) == 4
        assert replica_count({"auto_enable": True}) == 2
        assert replicas_auto_enabled({"auto_enable": False}) is False
        assert replica_count({"auto_enable": False}) == 0
        assert replica_count() == 0  # the constant: replicas off

    def test_the_constant_holds_the_jax_verdict(self, monkeypatch):
        monkeypatch.delenv("DRL_INFER_REPLICAS", raising=False)
        verdict = json.loads((REPO / "benchmarks" / "inference_verdict.json").read_text())
        assert serving.INFERENCE_VERDICT == {"auto_enable": verdict["auto_enable"],
                                             "replicas": verdict["replicas"]}
        assert replicas_auto_enabled() == jax_serving.replicas_auto_enabled()
        assert replica_count() == jax_serving.replica_count()

    def test_admission_budget_knob(self, monkeypatch):
        monkeypatch.delenv("DRL_INFER_BUDGET", raising=False)
        assert serving.admission_budget(64) == jax_serving.admission_budget(64) == 256
        monkeypatch.setenv("DRL_INFER_BUDGET", "7")
        assert serving.admission_budget(64) == 7
        monkeypatch.setenv("DRL_INFER_BUDGET", "seven")
        with pytest.raises(ValueError, match="DRL_INFER_BUDGET"):
            serving.admission_budget(64)


# -- the act wire across the packages ---------------------------------------------


def _converted_services(port_cls=InferenceServer, jax_cls=None, **kw):
    """An IMPALA service of each package on the same converted parameters."""
    from distributed_reinforcement_learning_tpu.agents.impala import ImpalaAgent as JaxAgent
    from distributed_reinforcement_learning_tpu.agents.impala import ImpalaConfig as JaxConfig

    jagent = JaxAgent(JaxConfig(**SMALL))
    jparams = jagent.init_state(jax.random.PRNGKey(0)).params
    jstore = JaxStore()
    jstore.publish(jparams, 0)
    agent = _agent()
    store = WeightStore()
    store.publish(agent.state_from_params(
        impala_params_from_jax(jax.tree.map(np.asarray, jparams))).params, 0)
    jax_cls = jax_cls or jax_inference.InferenceServer
    jserver = jax_cls.for_agent("impala", jagent, jstore, **kw)
    server = port_cls.for_agent("impala", agent, store, **kw)
    return jserver, jstore, server, store


def _same_rows(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    for k in ("policy", "h", "c"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


def test_a_jax_client_acts_through_a_port_server():
    jserver, _, server, store = _converted_services(max_wait_ms=1.0)
    port = _free_port()
    tserver = TransportServer(None, store, host="127.0.0.1", port=port,
                              inference=server).start()
    plain_port = _free_port()
    plain = TransportServer(TrajectoryQueue(8), store, host="127.0.0.1", port=plain_port).start()
    client = jax_transport.TransportClient("127.0.0.1", port)
    plain_client = jax_transport.TransportClient("127.0.0.1", plain_port)
    try:
        req = _request(5, seed=6)
        got = client.remote_act(dict(req))
        want = {k: np.asarray(v) for k, v in jserver.submit(dict(req)).items()}
        _same_rows(got, want)
        with pytest.raises(jax_transport.RemoteActFailed):  # ST_ERROR: Ape-X rows
            client.remote_act({"obs": req["obs"], "prev_action": req["prev_action"],
                               "epsilon": np.zeros(5, np.float32)})
        with pytest.raises(jax_transport.InferenceUnavailableError):  # no service
            plain_client.remote_act(dict(req))
        assert tserver.stat("acts_served") == 1
    finally:
        client.close()
        plain_client.close()
        tserver.stop()
        plain.stop()
        server.stop()
        jserver.stop()


def test_a_jax_client_sees_st_busy_from_a_port_service():
    agent = _agent()
    weights = _published_store(agent)
    gate, infer = _gated_server(agent, weights, admission_rows=4)
    port = _free_port()
    server = TransportServer(None, weights, host="127.0.0.1", port=port,
                             inference=infer).start()
    client = jax_transport.TransportClient("127.0.0.1", port)
    try:
        _hold_budget(gate, infer)
        with pytest.raises(jax_transport.InferenceBusyError):
            client.remote_act(_request(2), busy_retry=False)
    finally:
        gate.release.set()
        client.close()
        server.stop()
        infer.stop()


def test_the_port_service_acts_through_a_jax_server():
    jserver, jstore, server, _ = _converted_services(
        port_cls=ContinuousInferenceServer, jax_cls=jax_serving.ContinuousInferenceServer)
    port, plain_port = _free_port(), _free_port()
    jtserver = jax_transport.TransportServer(None, jstore, host="127.0.0.1", port=port,
                                             inference=jserver).start()
    jplain = jax_transport.TransportServer(None, jstore, host="127.0.0.1",
                                           port=plain_port).start()
    svc = RemoteActService.from_addrs([f"127.0.0.1:{port}"], connect_retries=2)
    plain_client = TransportClient("127.0.0.1", plain_port)
    try:
        req = _request(5, seed=7)
        got = svc(dict(req))
        want = server.submit(dict(req))
        _same_rows(got, want)
        with pytest.raises(RemoteActFailed):  # ST_ERROR from the JAX service
            svc({"obs": req["obs"], "prev_action": req["prev_action"],
                 "epsilon": np.zeros(5, np.float32)})
        assert svc.live_endpoints() == 1
        with pytest.raises(InferenceUnavailableError):  # a JAX server without a service
            plain_client.remote_act(dict(req))
        assert jtserver.stat("acts_served") == 1
    finally:
        svc.close()
        plain_client.close()
        jtserver.stop()
        jplain.stop()
        server.stop()
        jserver.stop()
