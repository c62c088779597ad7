"""The port's multi-process learner (ROADMAP item 13b's learner half):
the twins of `tests/test_multihost.py` (its sequence- and
pipeline-parallel rows are `tests/test_torch_sequence.py` and
`tests/test_torch_pipeline.py`, item 13c).

- Two learner processes join one `DRL_COORDINATOR` world (gloo on the
  CPU) and each feeds its own queue different trajectories; the data
  mesh's all-reduce makes their per-step losses and published weights
  agree (this file's `__main__` block is one process).
- The socket topology through `run_role` (`train_impala --mode learner`):
  two learners, each serving its own data plane on the base port + its
  rank, and two actors dealt across them; both planes' weight versions
  advance in lockstep, then the pair restarts from the checkpoint (both
  print `resumed from step N`; only rank 0 wrote it) while the actors
  ride out the outage. Then the launcher's `--learners 2` runs the same
  group with two actors.
- The refusals: the learner tier together with a learner group, a batch
  that does not divide the group, and item 13c's axes where no mesh fits
  one process (JAX's own refusal); the knobs load as JAX loads them.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_reinforcement_learning_tpu_torch.runtime.transport import (
    _I64, OP_GET_WEIGHTS, TransportClient, run_role)

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "config.json"
SECTION = "impala_cartpole"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    return {**os.environ, "OMP_NUM_THREADS": "1", "DRL_NO_GYMNASIUM": "1",
            "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO),
                                                        os.environ.get("PYTHONPATH")])),
            **extra}


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
    for p in procs:
        try:
            p.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            pass


# -- one learner process of the two (this file's __main__ block) ------------------
GLOBAL_BATCH = 16


def _worker_main(pid: int, port: int) -> None:
    from distributed_reinforcement_learning_tpu_torch.agents.impala import (
        ImpalaAgent, ImpalaConfig)
    from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
    from distributed_reinforcement_learning_tpu_torch.parallel import distributed, make_mesh
    from distributed_reinforcement_learning_tpu_torch.runtime.impala_runner import ImpalaLearner
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore
    from distributed_reinforcement_learning_tpu_torch.utils.synthetic import (
        synthetic_impala_batch)

    torch.set_num_threads(1)
    assert distributed.initialize(f"localhost:{port}", 2, pid, device="cpu")
    rank, world = distributed.process_info()
    local = GLOBAL_BATCH // world
    cfg = ImpalaConfig(obs_shape=(4,), num_actions=2, trajectory=8, lstm_size=32,
                       start_learning_rate=1e-3, learning_frame=10**6)
    queue = TrajectoryQueue(capacity=4 * local)
    weights = WeightStore()
    learner = ImpalaLearner(ImpalaAgent(cfg, device="cpu"), queue, weights, batch_size=local,
                            mesh=make_mesh())
    for step in range(3):
        # Each process feeds different local trajectories (seeded by pid).
        big = synthetic_impala_batch(local, cfg.trajectory, cfg.obs_shape, cfg.num_actions,
                                     cfg.lstm_size, seed=1000 * (pid + 1) + step)
        for i in range(local):
            queue.put(type(big)(*(x[i] for x in big)))
        m = learner.step(timeout=10.0)
        assert m is not None
        print(f"RESULT {pid} {step} {float(m['total_loss']):.6f}", flush=True)
    learner.close()  # lands the async publication
    params, version = weights.get()
    assert version == 3
    assert all(np.all(np.isfinite(np.asarray(x))) for x in params.values())
    first = np.asarray(next(iter(params.values()))).ravel()[0]
    print(f"RESULT {pid} weights_ok {float(first):.6f}", flush=True)
    distributed.shutdown()


def test_two_process_learner_agrees():
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, __file__, str(pid), str(port)], cwd=REPO,
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, start_new_session=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        _kill(procs)
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\n{out}\n{err[-3000:]}"

    def results(out: str) -> dict[str, str]:
        return {line.split()[2]: line.split()[3] for line in out.splitlines()
                if line.startswith("RESULT")}

    r0, r1 = results(outs[0][1]), results(outs[1][1])
    assert set(r0) == set(r1) == {"0", "1", "2", "weights_ok"}
    assert r0 == r1, (r0, r1)
    assert "backend gloo on cpu" in outs[0][1]


# -- the socket topology through run_role --------------------------------------------
def _spawn(args: list[str], env: dict) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "distributed_reinforcement_learning_tpu_torch.train_impala",
         "--config", str(CONFIG), "--section", SECTION, "--device", "cpu", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)


def _poll_versions(base: int, deadline_s: float, least: int) -> list[tuple[int, int]]:
    """Both data planes' weight versions, every 50 ms, until both reach
    `least`. A CPU learner of `impala_cartpole` takes its 12 updates in
    about 0.2 s and then exits, so a slower poll can miss them all."""
    seen, clients = [], {}
    deadline = time.monotonic() + deadline_s
    try:
        while time.monotonic() < deadline:
            try:
                pair = []
                for k in range(2):
                    if k not in clients:
                        clients[k] = TransportClient("127.0.0.1", base + k, connect_retries=2,
                                                     retry_interval=0.2)
                    resp = clients[k]._call(OP_GET_WEIGHTS, _I64.pack(-2))
                    pair.append(_I64.unpack(resp[:_I64.size])[0])
                seen.append(tuple(pair))
                if min(pair) >= least:
                    break
            except (ConnectionError, OSError):
                pass  # the learners are still starting
            time.sleep(0.05)
    finally:
        for c in clients.values():
            c.close()
    return seen


def test_socket_topology_two_learners_with_restart(tmp_path):
    base = _free_port_run(2)
    ckpt = tmp_path / "ckpt"
    common = _env(DRL_LEARNER_ADDR=f"127.0.0.1:{base}", DRL_NUM_PROCESSES="2")

    def launch_learners(updates: int) -> list:
        coord = _free_port()
        return [_spawn(["--mode", "learner", "--updates", str(updates), "--seed", "7",
                        "--checkpoint_dir", str(ckpt), "--checkpoint_interval", "5"],
                       {**common, "DRL_COORDINATOR": f"localhost:{coord}",
                        "DRL_PROCESS_ID": str(pid)}) for pid in range(2)]

    def wait_all(procs, timeout) -> list:
        outs = [p.communicate(timeout=timeout) for p in procs]
        return [(p.returncode, *o) for p, o in zip(procs, outs)]

    learners = launch_learners(12)
    actors = [_spawn(["--mode", "actor", "--task", str(t), "--actor_grace", "60"],
                     {**common, "DRL_LEARNER_INDEX": str(t % 2)}) for t in range(2)]
    try:
        versions = _poll_versions(base, 90.0, least=3)
        assert versions and min(versions[-1]) >= 3, versions
        # Lockstep: the data mesh's collectives keep the step counts equal;
        # the async publication may lag a plane by up to 3 intervals.
        assert all(abs(a - b) <= 4 for a, b in versions), versions
        outs = wait_all(learners, 120)
        for rc, out, err in outs:
            assert rc == 0 and "done: 12 updates" in out, out + err[-3000:]
            summary = json.loads(out.strip().splitlines()[-1])
            assert summary["multihost"]["world"] == 2 and summary["train_steps"] == 12
            assert summary["multihost"]["backend"] == "gloo"
            assert summary["multihost"]["reduce_bytes"][0] > 0
        assert "serving on :%d" % base in outs[0][1] and "serving on :%d" % (base + 1) in outs[1][1]
        assert (ckpt / "ckpt_0000000012.pt").exists()
        # The pair restarts whole from rank 0's checkpoint; the actors are up.
        learners = launch_learners(24)
        for rc, out, err in wait_all(learners, 120):
            assert rc == 0 and "resumed from step 12" in out and "done: 24 updates" in out, \
                out + err[-3000:]
        for a in actors:
            assert a.poll() is None, a.communicate()[0]
            a.send_signal(signal.SIGINT)  # stop: the actor prints its summary
        for a in actors:
            out, err = a.communicate(timeout=60)
            assert a.returncode == 0, out[-2000:] + err[-2000:]
            assert json.loads(out.strip().splitlines()[-1])["weight_version"] > 0
    finally:
        _kill(learners + actors)


def _free_port_run(n: int) -> int:
    from distributed_reinforcement_learning_tpu_torch.launch_local_cluster import (
        _free_port_run as run)

    return run(n)


def test_launcher_runs_a_learner_group():
    """`launch_local_cluster --learners 2` with no tier sync: a group of
    two CPU learners (DRL_COORDINATOR), each with its own board and
    actor, exits 0 with both learners at the same step count."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_reinforcement_learning_tpu_torch.launch_local_cluster",
         "--section", SECTION, "--actors", "2", "--learners", "2", "--updates", "6",
         "--device", "cpu", "--actor_grace", "5"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=150)
    finally:
        _kill([proc])
    assert proc.returncode == 0, out[-4000:]
    assert "[cluster] multi-process learner: 2 ranks" in out
    summaries = [json.loads(line.split("] ", 1)[1]) for line in out.splitlines()
                 if line.startswith("[learner") and '"role": "learner"' in line]
    assert sorted(s["multihost"]["rank"] for s in summaries) == [0, 1]
    assert {s["train_steps"] for s in summaries} == {6}
    assert not [f for f in os.listdir("/dev/shm") if f"-{proc.pid}-" in f]


# -- the refusals ------------------------------------------------------------------
def test_tier_with_a_learner_group_is_refused(monkeypatch):
    monkeypatch.setenv("DRL_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("DRL_NUM_PROCESSES", "2")
    monkeypatch.setenv("DRL_PROCESS_ID", "0")
    monkeypatch.setenv("DRL_LEARNER_RANK", "0")
    monkeypatch.setenv("DRL_LEARNER_PEERS", "127.0.0.1:1,127.0.0.1:2")
    with pytest.raises(ValueError, match="different scale-out planes"):
        run_role("impala", str(CONFIG), SECTION, "learner", 0, device="cpu")


def test_a_batch_that_does_not_divide_is_refused():
    from distributed_reinforcement_learning_tpu_torch.runtime.transport import _multihost_mesh
    from distributed_reinforcement_learning_tpu_torch.utils.config import load_config

    agent_cfg, rt = load_config(CONFIG, SECTION)
    with pytest.raises(ValueError, match=f"batch_size {rt.batch_size} not divisible by 3"):
        _multihost_mesh("impala", agent_cfg, rt, 3)


@pytest.mark.parametrize("knob", [{"seq_parallel": 2}, {"expert_parallel": 2},
                                  {"attention": "ring"}, {"pipeline": True}])
def test_item_13c_sizes_are_refused_by_name(knob, tmp_path):
    # Item 13c is ported: each knob loads as the JAX package loads it, and a
    # learner whose step needs the axis is refused on one process for
    # JAX's own reason (no mesh fits one device), by run_role's sizing
    # and by make_agent's mesh; its actors get the plain-apply twin. A
    # sequence axis under dense attention is ignored, and the ring with
    # seq_parallel 1 runs over a mesh of one, as in JAX.
    from distributed_reinforcement_learning_tpu.utils.config import load_config as jax_load
    from distributed_reinforcement_learning_tpu_torch.runtime import launch
    from distributed_reinforcement_learning_tpu_torch.runtime.transport import _multihost_mesh
    from distributed_reinforcement_learning_tpu_torch.utils.config import load_config

    cfg = json.loads(CONFIG.read_text())
    section = "xformer_moe" if "parallel" in next(iter(knob)) else "xformer"
    cfg[section].update(knob)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    agent_cfg, rt = load_config(path, section)
    jax_cfg, jax_rt = jax_load(path, section)
    assert (rt.seq_parallel, rt.expert_parallel) == (jax_rt.seq_parallel, jax_rt.expert_parallel)
    assert (agent_cfg.attention, agent_cfg.pipeline) == (jax_cfg.attention, jax_cfg.pipeline)
    if "seq_parallel" in knob:
        assert not launch.needs_sharded_learner("xformer", agent_cfg, rt)
        assert _multihost_mesh("xformer", agent_cfg, rt, 1, False)[1] is None
        assert launch.make_agent("xformer", agent_cfg, device="cpu", rt=rt).mesh is None
        return
    assert launch.needs_sharded_learner("xformer", agent_cfg, rt)
    if "attention" in knob:
        assert _multihost_mesh("xformer", agent_cfg, rt, 1, False)[1] is None
        agent = launch.make_agent("xformer", agent_cfg, device="cpu", rt=rt)
        assert agent.mesh.shape["seq"] == 1 and agent.twin is not agent.model
        return
    with pytest.raises(ValueError, match="config requires a sharded learner .* no valid mesh "
                                         "fits on 1 devices"):
        _multihost_mesh("xformer", agent_cfg, rt, 1, False)
    with pytest.raises(ValueError, match="1 devices not divisible"):
        launch.make_agent("xformer", agent_cfg, device="cpu", rt=rt)
    actor = launch.make_agent("xformer", agent_cfg, device="cpu", rt=rt, actor=True)
    assert actor.mesh is None and actor.cfg.attention == "dense" and not actor.cfg.pipeline
    assert actor.cfg.stacked == agent_cfg.pipeline


def test_anakin_over_a_learner_group_is_refused(monkeypatch):
    monkeypatch.setenv("DRL_COORDINATOR", "localhost:1234")
    with pytest.raises(ValueError, match="builds no mesh.*refuses instead"):
        run_role("impala", str(CONFIG), SECTION, "anakin", 0, device="cpu")


if __name__ == "__main__":
    _worker_main(int(sys.argv[1]), int(sys.argv[2]))
