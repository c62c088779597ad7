"""Checkpoints of the port (`utils/checkpoint.py`, the learners' save and
restore): save -> restore -> learn equals an uninterrupted learn bit for
bit on the CPU for each family (R2D2 and Ape-X with their replay
snapshots and sampling streams); writes are atomic; the last 3 are kept;
an over-cap array replay is skipped before it is copied; local-mode
training resumes from its checkpoint.
"""

import json

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu_torch.agents.impala import ImpalaAgent, ImpalaConfig
from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Agent, R2D2Config
from distributed_reinforcement_learning_tpu_torch.agents.ximpala import (
    XImpalaAgent, XImpalaConfig)
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
from distributed_reinforcement_learning_tpu_torch.envs.cartpole import (
    VectorCartPole, pomdp_project)
from distributed_reinforcement_learning_tpu_torch.runtime import (
    impala_runner, r2d2_runner, ximpala_runner)
from distributed_reinforcement_learning_tpu_torch.runtime.launch import train_local
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore
from distributed_reinforcement_learning_tpu_torch.utils import checkpoint as ckpt_mod
from distributed_reinforcement_learning_tpu_torch.utils.checkpoint import Checkpointer


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # One thread for torch and for numpy's BLAS pool, as the parity files
    # pin them: several test workers share the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _family(name: str):
    """-> make(): a fresh (learner, actor) of the family over a new queue
    and store, at a small size."""
    if name == "impala":
        agent = ImpalaAgent(ImpalaConfig(obs_shape=(4,), num_actions=2, trajectory=6,
                                         lstm_size=8), device="cpu")
        learner_cls, actor_cls = impala_runner.ImpalaLearner, impala_runner.ImpalaActor
        extra = {}
    elif name == "ximpala":
        agent = XImpalaAgent(XImpalaConfig(obs_shape=(4,), num_actions=2, trajectory=8,
                                           d_model=16, num_heads=2, num_layers=1), device="cpu")
        learner_cls = ximpala_runner.XImpalaLearner
        actor_cls, extra = ximpala_runner.XImpalaActor, {}
    else:
        agent = R2D2Agent(R2D2Config(obs_shape=(2,), num_actions=2, seq_len=6, burn_in=2,
                                     lstm_size=8), device="cpu")
        learner_cls, actor_cls = r2d2_runner.R2D2Learner, r2d2_runner.R2D2Actor
        extra = {"obs_transform": pomdp_project}

    def make():
        queue, store = TrajectoryQueue(64), WeightStore()
        kw = ({"replay_capacity": 200, "target_sync_interval": 3} if name == "r2d2" else {})
        learner = learner_cls(agent, queue, store, batch_size=4, seed=0, **kw)
        actor = actor_cls(agent, VectorCartPole(num_envs=4, seed=0), queue, store, seed=1,
                          **extra)
        return learner, actor

    return make


def _items(make, rounds: int) -> list:
    """Trajectories from one actor under the initial weights, in order."""
    _, actor = make()
    for _ in range(rounds):
        actor.run_unroll()
    return [actor.queue.get(timeout=1.0) for _ in range(actor.queue.size())]


def _steps(learner, items, n: int) -> list[dict]:
    """n train steps, putting the next 4 items before each call; `items`
    is an iterator, consumed in order. -> each step's metrics as floats."""
    out = []
    is_r2d2 = isinstance(learner, r2d2_runner.R2D2Learner)
    while len(out) < n:
        for _ in range(4):
            learner.queue.put(next(items))
        if is_r2d2:
            learner.ingest_batch(timeout=0.0)
            m = learner.train()
        else:
            m = learner.step(timeout=5.0)
        if m is not None:
            out.append({k: float(v) for k, v in m.items()})
    return out


@pytest.mark.parametrize("family", ["impala", "ximpala", "r2d2"])
def test_restore_then_learn_equals_an_uninterrupted_run(family, tmp_path):
    make = _family(family)
    items = _items(make, rounds=10)
    learner, _ = make()
    learner.sync_publish = True
    stream = iter(items)
    _steps(learner, stream, 4)
    learner.save_checkpoint(Checkpointer(tmp_path))
    rest = list(stream)
    want = _steps(learner, iter(rest), 3)

    restored, _ = make()
    restored.sync_publish = True
    assert restored.restore_checkpoint(Checkpointer(tmp_path))
    assert restored.train_steps == 4 and restored.weights.version == 4
    got = _steps(restored, iter(rest), 3)
    assert got == want
    assert restored.train_steps == learner.train_steps == 7
    for k, v in learner.state.params.items():
        assert torch.equal(restored.state.params[k], v)
    if family == "r2d2":
        for k, v in learner.state.target_params.items():
            assert torch.equal(restored.state.target_params[k], v)
        assert restored.replay.snapshot()["tree"].tobytes() == \
            learner.replay.snapshot()["tree"].tobytes()
        assert restored.replay.beta == learner.replay.beta


def test_writes_are_atomic(tmp_path, monkeypatch):
    make = _family("impala")
    learner, _ = make()
    ck = Checkpointer(tmp_path)
    learner.train_steps = 1
    learner.save_checkpoint(ck)

    def torn_save(obj, f):
        f.write(b"partial payload")
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.torch, "save", torn_save)
    learner.train_steps = 2
    with pytest.raises(OSError, match="disk full"):
        learner.save_checkpoint(ck)
    monkeypatch.undo()
    assert ck.steps() == [1]  # the torn write never became a checkpoint
    assert not list(tmp_path.glob("*.tmp"))
    assert (tmp_path / "ckpt_0000000002.extra.json").exists()  # its sidecar, uncommitted
    ck2 = Checkpointer(tmp_path)  # a restart sweeps the orphaned sidecar
    assert not (tmp_path / "ckpt_0000000002.extra.json").exists()
    restored, _ = make()
    assert restored.restore_checkpoint(ck2) and restored.train_steps == 1


def test_only_the_last_three_are_kept(tmp_path):
    make = _family("r2d2")
    learner, _ = make()
    _steps(learner, iter(_items(make, rounds=3)), 1)
    ck = Checkpointer(tmp_path)
    for step in range(1, 6):
        learner.train_steps = step
        learner.save_checkpoint(ck)
    assert ck.steps() == [3, 4, 5]
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(f"ckpt_{s:010d}.{kind}" for s in (3, 4, 5)
                           for kind in ("pt", "extra.json", "blob.replay"))
    assert json.loads((tmp_path / "ckpt_0000000005.extra.json").read_text())["train_steps"] == 5


def test_replay_snapshot_is_optional(tmp_path, monkeypatch):
    make = _family("r2d2")
    learner, _ = make()
    _steps(learner, iter(_items(make, rounds=3)), 1)
    monkeypatch.setenv("DRL_CKPT_REPLAY", "0")
    learner.save_checkpoint(Checkpointer(tmp_path))
    assert not list(tmp_path.glob("*.blob.*"))
    restored, _ = make()
    assert restored.restore_checkpoint(Checkpointer(tmp_path))
    assert len(restored.replay) == 0 and restored.ingested_sequences == 0


def test_train_local_resumes_from_its_checkpoint(tmp_path):
    from pathlib import Path

    config = Path(__file__).resolve().parents[1] / "config.json"
    first = train_local(str(config), "impala_cartpole", 2, device="cpu",
                        checkpoint_dir=str(tmp_path), checkpoint_interval=1)
    assert first["last_metrics"] and Checkpointer(tmp_path).steps() == [1, 2]
    again = train_local(str(config), "impala_cartpole", 3, device="cpu",
                        checkpoint_dir=str(tmp_path), checkpoint_interval=1)
    assert Checkpointer(tmp_path).steps() == [1, 2, 3]
    assert again["frames"] > 0
    done = train_local(str(config), "impala_cartpole", 3, device="cpu",
                       checkpoint_dir=str(tmp_path))
    assert done["skipped"].startswith("checkpoint already at step 3")
    assert np.isfinite(list(again["last_metrics"].values())).all()


def _apex_unrolls(n: int, seed: int) -> list:
    from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexBatch

    rng = np.random.RandomState(seed)
    return [ApexBatch(state=rng.randn(32, 4).astype(np.float32),
                      next_state=rng.randn(32, 4).astype(np.float32),
                      previous_action=rng.randint(0, 2, 32).astype(np.int32),
                      action=rng.randint(0, 2, 32).astype(np.int32),
                      reward=rng.randn(32).astype(np.float32), done=rng.rand(32) < 0.1)
            for _ in range(n)]


def _apex_learner():
    from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexAgent, ApexConfig
    from distributed_reinforcement_learning_tpu_torch.runtime.apex_runner import ApexLearner

    agent = ApexAgent(ApexConfig(obs_shape=(4,), num_actions=2), device="cpu")
    learner = ApexLearner(agent, TrajectoryQueue(64), WeightStore(), batch_size=8,
                          replay_capacity=300, target_sync_interval=3, train_start_unrolls=2,
                          seed=0)
    learner.sync_publish = True
    return learner


def _apex_steps(learner, unrolls, n: int) -> list[dict]:
    out = []
    for u in unrolls[:n]:
        learner.queue.put(u)
        while learner.ingest_many(timeout=0.0):
            pass
        out.append({k: float(v) for k, v in learner.train().items()})
    return out


def test_apex_restore_then_learn_equals_an_uninterrupted_run(tmp_path):
    """The Ape-X learner's checkpoint (train state, sampling stream, target
    cadence, the array replay's exact snapshot): restore -> train equals
    the run that never stopped, bit for bit."""
    unrolls = _apex_unrolls(12, seed=0)
    learner = _apex_learner()
    for u in unrolls[:2]:
        learner.queue.put(u)
    assert _apex_steps(learner, unrolls[2:], 4)
    learner.save_checkpoint(Checkpointer(tmp_path))
    want = _apex_steps(learner, unrolls[6:], 4)

    restored = _apex_learner()
    assert restored.restore_checkpoint(Checkpointer(tmp_path))
    assert restored.train_steps == 4 and restored.ingested_unrolls == 6
    assert type(restored.replay).__name__ == "ArrayPrioritizedReplay"
    assert _apex_steps(restored, unrolls[6:], 4) == want
    for k, v in learner.state.params.items():
        assert torch.equal(restored.state.params[k], v)
        assert torch.equal(restored.state.target_params[k], learner.state.target_params[k])
    assert restored.replay.snapshot()["tree"].tobytes() == \
        learner.replay.snapshot()["tree"].tobytes()


def test_an_over_cap_array_replay_is_skipped_before_its_snapshot(monkeypatch, capsys):
    """The array backend prices its snapshot (`stacked` rings) without a
    copy: over `DRL_CKPT_REPLAY_MAX_MB` the checkpoint skips it with a log
    line and never calls `snapshot()`."""
    from distributed_reinforcement_learning_tpu_torch.data.replay import ArrayPrioritizedReplay

    replay = ArrayPrioritizedReplay(1000, seed=0)
    batch = {"frame": np.zeros((500, 84, 84), np.uint8), "r": np.zeros(500, np.float32)}
    replay.add_batch_stacked(np.ones(500), batch)
    assert ckpt_mod.encode_replay_snapshot(replay) is not None  # 3.5 MB under 512 MB
    monkeypatch.setenv("DRL_CKPT_REPLAY_MAX_MB", "1")

    def no_snapshot():
        raise AssertionError("snapshot() called on an over-cap replay")

    monkeypatch.setattr(replay, "snapshot", no_snapshot)
    assert ckpt_mod.encode_replay_snapshot(replay) is None
    assert "exceeds DRL_CKPT_REPLAY_MAX_MB=1; skipping" in capsys.readouterr().err
