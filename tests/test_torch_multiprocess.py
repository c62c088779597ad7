"""The port's multi-process topology on the CPU: a learner process and an
actor process over TCP (`runtime/transport.py:run_role` through
`train_impala --mode learner|actor`, `train_apex` on a CartPole Ape-X
section, and the replay learners of `train_r2d2` and `train_xformer` on
the default sharded service), as tests/test_launch.py drives the JAX
launcher; the planes `run_role` refuses by name, and the opt-in planes
it now runs (sharded publication, the device sample path).

Each child runs in its own process group and is killed whole on its own
timeout; the learner binds a free port passed through
`DRL_LEARNER_ADDR`.
"""

import json
import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu_torch.runtime.transport import run_role

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "config.json"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # One thread for torch and for numpy's BLAS pool in this process (the
    # roles run in process here); the children get theirs by environment.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(args: list[str], env: dict, algo: str = "impala", config: Path = CONFIG,
           section: str = "impala_cartpole") -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", f"distributed_reinforcement_learning_tpu_torch.train_{algo}",
         "--config", str(config), "--section", section, "--device", "cpu", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)


def _finish(proc: subprocess.Popen, timeout: float) -> tuple[str, str]:
    try:
        return proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate(timeout=10)
        raise


def test_learner_and_actor_processes_train_over_tcp(tmp_path):
    env = dict(os.environ, DRL_LEARNER_ADDR=f"127.0.0.1:{_free_port()}",
               OMP_NUM_THREADS="2")
    learner = _spawn(["--mode", "learner", "--updates", "6",
                      "--checkpoint_dir", str(tmp_path / "ckpt")], env)
    actor = _spawn(["--mode", "actor", "--task", "0", "--actor_grace", "1"], env)
    try:
        out, err = _finish(learner, timeout=150)
        a_out, a_err = _finish(actor, timeout=60)
    finally:
        for p in (learner, actor):
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
    assert learner.returncode == 0, out[-2000:] + err[-2000:]
    assert actor.returncode == 0, a_out[-2000:] + a_err[-2000:]
    assert "[learner] serving on :" in out
    assert "done: 6 updates" in out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["train_steps"] == 6 and summary["frames_learned"] == 6 * 16 * 16
    assert summary["launches"]["vtrace"] == 0  # the CPU takes the plain version
    assert summary["transport"]["unrolls_accepted"] >= 6 * 16
    assert len(summary["queue_depth"]) == 6
    assert set(summary["stage_ms"]) >= {"dequeue", "learn", "publish"}
    a_summary = json.loads(a_out.strip().splitlines()[-1])
    assert a_summary["weight_version"] > 0 and a_summary["frames"] > 0
    assert (tmp_path / "ckpt" / "ckpt_0000000006.pt").exists()


def test_k_update_learner_and_actor_processes_train_over_tcp():
    """The `impala_cartpole_scan` section (K = 4) over TCP: the learner's
    prefetcher stacks 4 batches a call and each call is one `learn_many`."""
    env = dict(os.environ, DRL_LEARNER_ADDR=f"127.0.0.1:{_free_port()}",
               OMP_NUM_THREADS="2")
    kw = dict(section="impala_cartpole_scan")
    learner = _spawn(["--mode", "learner", "--updates", "8"], env, **kw)
    actor = _spawn(["--mode", "actor", "--task", "0", "--actor_grace", "1"], env, **kw)
    try:
        out, err = _finish(learner, timeout=150)
        a_out, a_err = _finish(actor, timeout=60)
    finally:
        for p in (learner, actor):
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
    assert learner.returncode == 0, out[-2000:] + err[-2000:]
    assert actor.returncode == 0, a_out[-2000:] + a_err[-2000:]
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["train_steps"] == 8 and summary["frames_learned"] == 8 * 16 * 16
    assert len(summary["queue_depth"]) == 2  # two calls of 4 steps
    a_summary = json.loads(a_out.strip().splitlines()[-1])
    assert a_summary["weight_version"] > 0 and a_summary["frames"] > 0


# A CartPole Ape-X section (config.json has only the Breakout one).
_APEX_CARTPOLE = {
    "num_actors": 1, "env": ["CartPole-v0"], "available_action": [2], "envs_per_actor": 4,
    "model_input": [4], "model_output": 2, "batch_size": 32, "queue_size": 32,
    "replay_capacity": 2000, "target_sync_interval": 10, "start_learning_rate": 0.001,
}


def test_apex_learner_and_actor_processes_train_over_tcp(tmp_path):
    """The monolithic replay, forced with DRL_REPLAY_SHARDS=0 (the demotion
    target of the default sharded service)."""
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"apex_cartpole": _APEX_CARTPOLE}))
    env = dict(os.environ, DRL_LEARNER_ADDR=f"127.0.0.1:{_free_port()}",
               OMP_NUM_THREADS="2", DRL_REPLAY_SHARDS="0")
    kw = dict(algo="apex", config=config, section="apex_cartpole")
    learner = _spawn(["--mode", "learner", "--updates", "3"], env, **kw)
    actor = _spawn(["--mode", "actor", "--task", "0", "--actor_grace", "1"], env, **kw)
    try:
        out, err = _finish(learner, timeout=150)
        a_out, a_err = _finish(actor, timeout=60)
    finally:
        for p in (learner, actor):
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
    assert learner.returncode == 0, out[-2000:] + err[-2000:]
    assert actor.returncode == 0, a_out[-2000:] + a_err[-2000:]
    assert "done: 3 updates" in out
    assert "[apex learner] replay: ArrayPrioritizedReplay over" in err
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["train_steps"] == 3 and summary["ingested_unrolls"] >= 10
    assert summary["queue"] == "NativeTrajectoryQueue"
    assert summary["replay"] == "ArrayPrioritizedReplay" and summary["replay_size"] >= 320
    assert set(summary["launches"].values()) == {0}
    a_summary = json.loads(a_out.strip().splitlines()[-1])
    assert a_summary["weight_version"] >= 0 and a_summary["frames"] > 0
    assert summary["replay_service"] is None


@pytest.mark.parametrize("algo, section, blob", [
    ("apex", "apex_cartpole", "unrolls"), ("r2d2", "r2d2", "sequences"),
    ("xformer", "xformer", "sequences")])
def test_replay_learner_defaults_to_the_sharded_service_over_tcp(algo, section, blob, tmp_path):
    """With no DRL_REPLAY_* set, a replay learner runs the JAX package's
    default: 2 ingest shards with the spill tier on. The shards hold
    exactly what the learner's server accepted, and the learner trains
    from them (its own queue stays empty). The xformer learner runs the
    section at full width."""
    config = tmp_path / "config.json"
    sections = json.loads(CONFIG.read_text())
    config.write_text(json.dumps({"apex_cartpole": _APEX_CARTPOLE,
                                  "r2d2": {**sections["r2d2"], "lstm_size": 32},
                                  "xformer": sections["xformer"]}))
    replay_knobs = ("DRL_REPLAY_SHARDS", "DRL_REPLAY_SCORER", "DRL_REPLAY_SPILL",
                    "DRL_REPLAY_SPILL_DIR", "DRL_REPLAY_SPILL_HOT_MB", "DRL_REPLAY_SPILL_SEG")
    env = {k: v for k, v in os.environ.items() if k not in replay_knobs}
    env.update(DRL_LEARNER_ADDR=f"127.0.0.1:{_free_port()}", OMP_NUM_THREADS="2",
               TMPDIR=str(tmp_path))  # the spill tier's default directory
    kw = dict(algo=algo, config=config, section=section)
    learner = _spawn(["--mode", "learner", "--updates", "3"], env, **kw)
    actor = _spawn(["--mode", "actor", "--task", "0", "--actor_grace", "1"], env, **kw)
    try:
        out, err = _finish(learner, timeout=150)
        a_out, a_err = _finish(actor, timeout=60)
    finally:
        for p in (learner, actor):
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
    assert learner.returncode == 0, out[-2000:] + err[-2000:]
    assert actor.returncode == 0, a_out[-2000:] + a_err[-2000:]
    assert "sharded replay: 2 shard(s), scorer max, spill tier on" in out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["train_steps"] == 3
    svc = summary["replay_service"]
    assert svc["shards"] == 2 and svc["spill"] and svc["healthy"] and not svc["demoted"]
    ingested = sum(s["ingested_blobs"] for s in svc["shard_stats"])
    assert ingested == summary["transport"]["unrolls_accepted"] > 0
    assert summary[f"ingested_{blob}"] == 0 and summary["replay_size"] == 0
    assert svc["admission"]["scored_blobs"] == ingested
    spill_dirs = list(tmp_path.glob("drl_replay_spill_*/shard_001"))
    assert len(spill_dirs) == 1


def _sharded_learner(params_of: str = "impala_cartpole"):
    """A port learner's sharded weight plane in this process: the
    section's initial parameters, published per shard as version 0 and
    served over TCP -> (store, server)."""
    from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
    from distributed_reinforcement_learning_tpu_torch.runtime import launch
    from distributed_reinforcement_learning_tpu_torch.runtime.transport import TransportServer
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore
    from distributed_reinforcement_learning_tpu_torch.utils.config import load_config

    agent_cfg, _ = load_config(CONFIG, params_of)
    agent = launch.make_agent("impala", agent_cfg, device="cpu")
    weights = WeightStore(sharded=True)
    weights.publish(agent.init_state(seed=0).params, 0)
    server = TransportServer(TrajectoryQueue(64), weights, host="127.0.0.1",
                             port=_free_port()).start()
    return weights, server


def _stop_after_sharded_pulls(server, pulls: int):
    import threading
    import time

    def stop():
        deadline = time.monotonic() + 60.0
        while server.stat("shard_sends") < pulls and time.monotonic() < deadline:
            time.sleep(0.01)
        server.stop()

    t = threading.Thread(target=stop)
    t.start()
    return t


# Each case names the plane by its JAX variable. Items 12e (sharded
# publication), 16 (the device sample path), 13a (the learner tier) and
# 13b (the multi-process learner) are ported: those cases run the role
# with the plane on (None; a seat count without a seat identity is the
# single learner, as in the JAX package); the tier together with a
# learner group is refused, naming both items.
@pytest.mark.parametrize("mode, env, item", [
    ("inference", {"DRL_WEIGHTS_KEYS": "rep"}, None),
    ("anakin", {"DRL_DEVICE_PATH": "1"}, None),
    ("learner", {"DRL_WEIGHTS_SHARDED": "on"}, None),
    ("actor", {"DRL_WEIGHTS_SHARDED": "1"}, None),
    ("learner", {"DRL_LEARNER_SEATS": "2"}, None),
    ("learner", {"DRL_COORDINATOR": "localhost:1234", "DRL_NUM_PROCESSES": "2",
                 "DRL_PROCESS_ID": "0", "DRL_LEARNER_RANK": "0",
                 "DRL_LEARNER_PEERS": "127.0.0.1:1,127.0.0.1:2"}, "item 13"),
    ("learner", {"DRL_DEVICE_PATH": "1"}, None),
    ("learner", {"DRL_WEIGHTS_SHARDED": "1"}, None),
])
def test_unported_planes_are_refused_by_name(mode, env, item, monkeypatch):
    from distributed_reinforcement_learning_tpu_torch.runtime import weight_shards

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DRL_FLEET", "0")
    for k in ("DRL_SHM_WEIGHTS_NAME", "DRL_SHM_WEIGHTS_CREATE", "DRL_SHM_RING_NAME",
              "DRL_SHM_RING_CREATE"):
        monkeypatch.delenv(k, raising=False)
    weight_shards.refresh_flags()
    try:
        if item is not None:
            with pytest.raises(ValueError, match=item):
                run_role("impala", str(CONFIG), "impala_cartpole", mode, 0, device="cpu")
        elif mode == "anakin":
            from distributed_reinforcement_learning_tpu_torch import train_impala

            out = train_impala.main(["--config", str(CONFIG), "--section", "impala_cartpole",
                                     "--mode", "anakin", "--updates", "1", "--anakin_envs", "4",
                                     "--device", "cpu"])
            assert out["frames"] > 0
        elif mode == "learner":
            monkeypatch.setenv("DRL_LEARNER_ADDR", f"127.0.0.1:{_free_port()}")
            summary = run_role("impala", str(CONFIG), "impala_cartpole", mode, 0,
                               num_updates=0, device="cpu")
            sharded = "DRL_WEIGHTS_SHARDED" in env
            assert (summary["weight_shards"] is not None) is sharded
            if sharded:  # the learner's first publish went out per shard
                assert summary["weight_shards"]["shard_publishes"] >= 1
        else:
            weights, server = _sharded_learner()
            monkeypatch.setenv("DRL_LEARNER_ADDR", f"127.0.0.1:{server.port}")
            monkeypatch.setenv("DRL_INFER_PORT", str(_free_port()))
            stopper = _stop_after_sharded_pulls(server, 1)
            try:
                summary = run_role("impala", str(CONFIG), "impala_cartpole", mode, 0,
                                   device="cpu", actor_grace=0.5)
            finally:
                stopper.join()
                server.stop()
            assert summary["weight_version"] == 0
            assert server.stat("shard_sends") >= 1 and server.stat("weight_sends") == 0
    finally:
        monkeypatch.undo()
        weight_shards.refresh_flags()


def test_serving_flags_are_refused(tmp_path, monkeypatch):
    """Serving acts is ported, and so is item 13c: a sequence axis on a
    non-transformer section is ignored, as in JAX. The learner with
    `serve_inference` and the actor with `remote_act` reach their agents
    with no mesh (the agent's construction stops each run here; the
    actor's client does not connect)."""
    from distributed_reinforcement_learning_tpu_torch.runtime import launch, transport

    cfg = json.loads(CONFIG.read_text())
    cfg["impala_cartpole"]["seq_parallel"] = 2
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    seen = []

    class Reached(Exception):
        pass

    def agent(algo, agent_cfg, device=None, rt=None, mesh=None, actor=False):
        seen.append((algo, rt.seq_parallel, mesh, actor))
        raise Reached

    monkeypatch.setattr(launch, "make_agent", agent)
    monkeypatch.setattr(transport, "TransportClient", lambda *a, **kw: None)
    with pytest.raises(Reached):
        run_role("impala", str(path), "impala_cartpole", "learner", 0, device="cpu",
                 serve_inference=True)
    with pytest.raises(Reached):
        run_role("impala", str(path), "impala_cartpole", "actor", 0, device="cpu",
                 remote_act=True)
    assert seen == [("impala", 2, None, False), ("impala", 2, None, True)]