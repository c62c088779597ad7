"""The port's local-cluster launcher (`launch_local_cluster.py`) on the CPU.

One launch of a CartPole IMPALA section from a tmp config, the learner
on `--device cpu` and 2 actors, with rings and the weight board forced
on (`DRL_SHM_RING=1 DRL_SHM_WEIGHTS=1`): it ends with rc 0, the learner
serves both planes, every actor attaches them and holds a weight
version above 0, the learner's steps were fed through the rings alone,
no actor demoted to TCP before the learner began to shut down, and no
segment of the launch is left in /dev/shm. The refusals by name, and
the reaper's creator-pid rule. The `--chaos` drill (an actor and then
the learner SIGKILLed, both respawned, every ring and board re-attached)
is marked slow.
"""

import json
import os
import signal
import struct
import subprocess
import sys
from multiprocessing import resource_tracker, shared_memory
from pathlib import Path

import pytest

from distributed_reinforcement_learning_tpu_torch import launch_local_cluster as cluster

REPO = Path(__file__).resolve().parents[1]
UPDATES = 300  # enough learner work that both actors start and put before it ends


def _tmp_config(tmp_path: Path) -> Path:
    cfg = json.loads((REPO / "config.json").read_text())
    section = dict(cfg["impala_cartpole"], envs_per_actor=4, trajectory=8, batch_size=8,
                   lstm_size=16)
    path = tmp_path / "config.json"
    path.write_text(json.dumps({"impala_cartpole": section}))
    return path


def _json_lines(out: str, prefix: str) -> list[dict]:
    return [json.loads(line[len(prefix) + 3:]) for line in out.splitlines()
            if line.startswith(f"[{prefix}] {{")]


def test_launch_trains_through_rings_and_board(tmp_path):
    env = dict(os.environ, DRL_SHM_RING="1", DRL_SHM_WEIGHTS="1", DRL_NO_GYMNASIUM="1",
               OMP_NUM_THREADS="1")
    env.pop("DRL_LEARNER_ADDR", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_reinforcement_learning_tpu_torch.launch_local_cluster",
         "--config", str(_tmp_config(tmp_path)), "--section", "impala_cartpole", "--actors", "2",
         "--updates", str(UPDATES), "--device", "cpu", "--actor_grace", "5"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=150)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate(timeout=10)
        raise
    assert proc.returncode == 0, out[-4000:]
    assert "[cluster] /dev/shm:" in out
    assert "[learner] [learner] shm weight board serving co-hosted actors" in out
    assert "[learner] [learner] shm rings serving 2 co-hosted actor(s)" in out
    for k in range(2):
        assert f"[actor{k}] [actor {k}] shm ring attached: drlring-{proc.pid}-" in out
        assert f"[actor{k}] [actor {k}] shm weight board attached: drlwboard-{proc.pid}-" in out
    (learner,) = _json_lines(out, "learner")
    actors = _json_lines(out, "actor0") + _json_lines(out, "actor1")
    assert learner["train_steps"] == UPDATES and learner["device"] == "cpu"
    assert learner["transport"]["unrolls_accepted"] == 0  # every unroll came by ring
    assert learner["rings"]["unrolls_drained"] >= UPDATES * 8
    # Every version that landed went onto the board: the learner's first,
    # synchronous publish and each async one (latest wins, so fewer than
    # one a step).
    assert learner["board"]["attached"]
    assert learner["board"]["writes"] == learner["publishes_landed"] + 1 > 2
    assert len(actors) == 2
    for a in actors:
        assert a["weight_version"] > 0 and a["device"] == "cpu"
        assert a["board"]["board_pulls"] >= 1 and a["weight_pulls"]["surface"] == "BoardWeights"
        assert a["ring"]["unrolls_sent"] > 0 and a["transport"]["unrolls_sent"] == 0
        for at in a["ring"]["demoted_at"] + a["board"]["demoted_at"]:
            assert at >= learner["shutdown_at"]
    assert not [f for f in os.listdir("/dev/shm") if f"-{proc.pid}-" in f]


@pytest.mark.parametrize("argv, item", [
    (["--learners", "2"], "item 13"),
    (["--learner_sync", "async"], "item 13"),
    (["--remote_act"], "item 12d"),
    (["--serve_inference"], "item 12d"),
    (["--weights_sharded", "1"], "item 12e"),
])
def test_unported_options_are_refused_by_name(argv, item, capsys):
    with pytest.raises(SystemExit) as e:
        cluster.parse_args(["--section", "impala_cartpole", *argv])
    assert e.value.code == 2 and item in capsys.readouterr().err


def test_section_prefix_picks_the_family():
    assert cluster.parse_args(["--section", "r2d2_pixel"]).algo == "r2d2"
    assert cluster.parse_args(["--section", "impala", "--chaos"]).respawn == "chaos"


def _segment(name: str, pid: int) -> None:
    seg = shared_memory.SharedMemory(name=name, create=True, size=4096)
    struct.pack_into("<Q", seg.buf, 24, pid)
    resource_tracker.unregister(seg._name, "shared_memory")  # the test unlinks it
    seg.close()


def test_reaper_unlinks_only_segments_of_dead_creators():
    dead = subprocess.run([sys.executable, "-c", "import os; print(os.getpid())"],
                          capture_output=True, text=True, check=True)
    dead_pid = int(dead.stdout)
    names = [f"drltest-reap-{os.getpid()}-{tag}" for tag in ("dead", "live")]
    _segment(names[0], dead_pid)
    _segment(names[1], os.getpid())
    try:
        cluster.reap_segments(names, "test")
        assert not os.path.exists(f"/dev/shm/{names[0]}")
        assert os.path.exists(f"/dev/shm/{names[1]}")
    finally:
        for name in names:
            if os.path.exists(f"/dev/shm/{name}"):
                os.unlink(f"/dev/shm/{name}")


@pytest.mark.slow  # ~1-2 min: two learner incarnations; the drill, not a tier-1 check
def test_launcher_chaos_drill_respawns_and_reattaches(tmp_path):
    """`--chaos` SIGKILLs actor 0 and then the learner; both respawn, the
    new learner re-creates its segments under the same names, and every
    actor's ring and board demote and then re-attach to it."""
    env = dict(os.environ, DRL_SHM_RING="1", DRL_SHM_WEIGHTS="1", DRL_NO_GYMNASIUM="1",
               OMP_NUM_THREADS="2")
    env.pop("DRL_LEARNER_ADDR", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_reinforcement_learning_tpu_torch.launch_local_cluster",
         "--section", "impala_cartpole", "--actors", "2", "--updates", "1000", "--device", "cpu",
         "--chaos", "--chaos_interval", "4", "--actor_grace", "60",
         "--checkpoint_dir", str(tmp_path / "ck")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=400)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate(timeout=10)
        raise
    assert proc.returncode == 0, out[-4000:]
    assert "[cluster] respawning actor0 (exit -9" in out
    assert "[cluster] respawning learner (exit -9" in out
    assert "[learner] [learner] done: 1000 updates" in out
    lines = out.splitlines()
    for k in range(2):
        for plane, what in (("shm_ring", "PUTs back on shared memory"),
                            ("weight_board", "weight pulls back on shared memory")):
            assert any(line.startswith(f"[actor{k}] [{plane}] ") and f"-{proc.pid}-" in line
                       and line.endswith(f"re-attached; {what}") for line in lines), (k, plane)
    assert not [f for f in os.listdir("/dev/shm") if f"-{proc.pid}-" in f]
