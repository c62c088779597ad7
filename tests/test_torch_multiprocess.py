"""The port's multi-process topology on the CPU: a learner process and an
actor process over TCP (`runtime/transport.py:run_role` through
`train_impala --mode learner|actor`), as tests/test_launch.py drives the
JAX launcher; and the planes `run_role` refuses by name.

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

from distributed_reinforcement_learning_tpu_torch.runtime.transport import run_role

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "config.json"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(args: list[str], env: dict) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "distributed_reinforcement_learning_tpu_torch.train_impala",
         "--config", str(CONFIG), "--section", "impala_cartpole", "--device", "cpu", *args],
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


@pytest.mark.parametrize("mode, env, item", [
    ("inference", {}, "item 12"),
    ("anakin", {}, "item 14"),
    ("learner", {"DRL_SHM_RING_CREATE": "ring0"}, "item 12"),
    ("actor", {"DRL_SHM_WEIGHTS_NAME": "board0"}, "item 12"),
    ("learner", {"DRL_LEARNER_SEATS": "2"}, "item 13"),
    ("learner", {"DRL_COORDINATOR": "localhost:1234"}, "item 13"),
    ("learner", {"DRL_REPLAY_SHARDS": "2"}, "item 9"),
    ("actor", {"DRL_ADMISSION": "1"}, "item 9"),
])
def test_unported_planes_are_refused_by_name(mode, env, item, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=item):
        run_role("impala", str(CONFIG), "impala_cartpole", mode, 0, device="cpu")


def test_serving_flags_are_refused():
    with pytest.raises(ValueError, match="item 12"):
        run_role("impala", str(CONFIG), "impala_cartpole", "learner", 0, device="cpu",
                 serve_inference=True)
    with pytest.raises(ValueError, match="item 12"):
        run_role("impala", str(CONFIG), "impala_cartpole", "actor", 0, device="cpu",
                 remote_act=True)
