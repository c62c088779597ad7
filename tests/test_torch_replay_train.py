"""The port's prioritized train calls (`runtime/replay_train.py`,
`agents/*.learn_many`) and the learners over the sharded replay service,
against the JAX package's, on the CPU.

- K-update calls: a port learner (Ape-X, and R2D2 on the plain LSTM) and
  the JAX learner start from converted weights, the same replay contents
  and the same seed. `updates_per_call` = 4 (R2D2: 2) samples the same
  K sets of indices; the parameters and the written-back priorities
  agree within the single-step parity tolerances of
  tests/test_torch_{apex,r2d2}.py (for the parameters Ape-X's Adam bound,
  scaled by K, in both families; see FAMILIES).
- `learn_many` is K `learn` steps.
- Service snapshots through `utils/checkpoint.py` cross between the
  packages in both directions and then sample identical indices.
- A learner whose every shard dies demotes to the monolithic replay and
  keeps training.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.agents.apex import ApexAgent as JaxApexAgent
from distributed_reinforcement_learning_tpu.agents.apex import ApexConfig as JaxApexConfig
from distributed_reinforcement_learning_tpu.agents.r2d2 import R2D2Agent as JaxR2D2Agent
from distributed_reinforcement_learning_tpu.agents.r2d2 import R2D2Config as JaxR2D2Config
from distributed_reinforcement_learning_tpu.data import replay_service as jax_rs
from distributed_reinforcement_learning_tpu.data.fifo import TrajectoryQueue as JaxQueue
from distributed_reinforcement_learning_tpu.runtime import apex_runner as jax_apex_runner
from distributed_reinforcement_learning_tpu.runtime import r2d2_runner as jax_r2d2_runner
from distributed_reinforcement_learning_tpu.runtime.weights import WeightStore as JaxWeights
from distributed_reinforcement_learning_tpu.utils import checkpoint as jax_checkpoint
from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexAgent, ApexConfig
from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Agent, R2D2Config
from distributed_reinforcement_learning_tpu_torch.data import codec, replay_service
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
from distributed_reinforcement_learning_tpu_torch.models.convert import (
    apex_params_from_jax, r2d2_params_from_jax)
from distributed_reinforcement_learning_tpu_torch.runtime import (
    apex_runner, r2d2_runner, replay_shard)
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore
from distributed_reinforcement_learning_tpu_torch.utils import checkpoint
from distributed_reinforcement_learning_tpu_torch.utils.config import load_config
from test_torch_replay_service import assert_batches_equal, blobs_of

CONFIG = Path(__file__).resolve().parents[1] / "config.json"


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


class _Recorder:
    """Wraps a replay's `sample` to keep each call's indices."""

    def __init__(self, replay):
        self.calls = []
        self._sample = replay.sample
        replay.sample = self

    def __call__(self, n, rng=None):
        out = self._sample(n, rng)
        self.calls.append(np.asarray(out[1]).copy())
        return out


# Per family: the agent configs, K, the converter, the learner classes,
# and the parameters' tolerance: rtol 1e-4 as in the single-step tests of
# tests/test_torch_{apex,r2d2}.py, and Ape-X's single-step atol of 1% of
# the learning rate. Adam moves a parameter whose gradient sits at
# float32's noise floor by a noise-sized fraction of lr; R2D2's single
# step (atol 1e-7 at lr 1e-3) happens to have no such element, but its
# second step does (measured: up to 0.5% of lr on 22 of 65,536 elements
# of one matrix), so both families take Ape-X's bound, scaled by K.
_APEX_LR = 1e-4
_R2D2_LR = 1e-3
FAMILIES = {
    "apex": dict(
        kw=dict(obs_shape=(4,), num_actions=2, start_learning_rate=_APEX_LR,
                end_learning_rate=1e-5, learning_frame=1000),
        k=4, mode="transition", convert=apex_params_from_jax,
        mine=(ApexAgent, ApexConfig, apex_runner.ApexLearner),
        ref=(JaxApexAgent, JaxApexConfig, jax_apex_runner.ApexLearner),
        param_atol=1e-2 * _APEX_LR, learner_kw=dict(train_start_unrolls=10), shape={}),
    "r2d2": dict(
        kw=dict(obs_shape=(2,), num_actions=2, seq_len=10, burn_in=5, lstm_size=32,
                learning_rate=_R2D2_LR),
        k=2, mode="sequence", convert=r2d2_params_from_jax, shape=dict(t=10, h=32),
        mine=(R2D2Agent, R2D2Config, r2d2_runner.R2D2Learner),
        ref=(JaxR2D2Agent, JaxR2D2Config, jax_r2d2_runner.R2D2Learner),
        param_atol=1e-2 * _R2D2_LR, learner_kw={}),
}


def _learners(family: str, sharded: bool):
    f = FAMILIES[family]
    m_agent, m_cfg, m_learner = f["mine"]
    r_agent, r_cfg, r_learner = f["ref"]
    services = (None, None)
    if sharded:
        services = (replay_service.ShardedReplayService(2, 512, mode=f["mode"], seed=0),
                    jax_rs.ShardedReplayService(2, 512, mode=f["mode"], seed=0))
    common = dict(batch_size=8, replay_capacity=512, target_sync_interval=10, seed=0,
                  updates_per_call=f["k"], **f["learner_kw"])
    ref = r_learner(r_agent(r_cfg(**f["kw"])), JaxQueue(8), JaxWeights(),
                    rng=jax.random.PRNGKey(0), replay_service=services[1], **common)
    mine = m_learner(m_agent(m_cfg(**f["kw"]), device="cpu"), TrajectoryQueue(8), WeightStore(),
                     replay_service=services[0], **common)
    mine.state = mine.agent.state_from_params(f["convert"](_np(ref.state.params)))
    return mine, ref


@pytest.mark.parametrize("sharded", [True, False], ids=["service", "monolithic"])
@pytest.mark.parametrize("family", ["apex", "r2d2"])
def test_k_update_call_matches_jax(family, sharded):
    f = FAMILIES[family]
    mine, ref = _learners(family, sharded)
    blobs = blobs_of(f["mode"], 9, 24, **f["shape"])
    try:
        if sharded:
            for i, blob in enumerate(blobs):
                mine.replay_service.shards[i % 2].ingest_blob(blob)
                ref.replay_service.shards[i % 2].ingest_blob(blob)
        else:
            errors = np.random.RandomState(4).rand(len(blobs)) * 2
            for e, blob in zip(errors, blobs):
                tree = codec.decode(blob, copy=True)
                n = len(tree.reward) if f["mode"] == "transition" else 1
                for learner in (mine, ref):
                    if f["mode"] == "transition":
                        learner.replay.add_batch_stacked(np.full(n, e), tree)
                    else:
                        learner.replay.add(float(e), tree)
            mine.ingested_unrolls = ref.ingested_unrolls = len(blobs)
            mine.ingested_sequences = ref.ingested_sequences = len(blobs)
        replays = [learner._active_replay() for learner in (mine, ref)]
        recs = [_Recorder(r) for r in replays]
        assert mine.train() is not None and ref.train() is not None
        assert mine.train_steps == ref.train_steps == f["k"]
        assert len(recs[0].calls) == len(recs[1].calls) == f["k"]
        for a, b in zip(*(r.calls for r in recs)):
            np.testing.assert_array_equal(a, b)
        if sharded:
            assert mine.replay_service.flush_updates() and ref.replay_service.flush_updates()
        got, want = replays[0].snapshot(), replays[1].snapshot()
        np.testing.assert_allclose(got["priorities"], want["priorities"], rtol=1e-4, atol=1e-6)
        want_t = f["convert"](_np(ref.state.params))
        assert set(want_t) == set(mine.state.params)
        for key, w in want_t.items():
            np.testing.assert_allclose(mine.state.params[key].detach().numpy(), w.numpy(),
                                       rtol=1e-4, atol=f["k"] * f["param_atol"], err_msg=key)
    finally:
        for learner in (mine, ref):
            learner.close()
            if learner.replay_service is not None:
                learner.replay_service.close()


@pytest.mark.parametrize("family", ["apex", "r2d2"])
def test_learn_many_is_k_learn_steps(family):
    """`learn_many` over a [K, B, ...] batch equals K `learn` calls, bit
    for bit, with the K priority rows and stacked metrics."""
    f = FAMILIES[family]
    agent_cls, cfg_cls, _ = f["mine"]
    agent = agent_cls(cfg_cls(**f["kw"]), device="cpu")
    a, b = agent.init_state(0), agent.init_state(0)
    svc = replay_service.ShardedReplayService(1, 512, mode=f["mode"], seed=0)
    try:
        for blob in blobs_of(f["mode"], 5, 16, **f["shape"]):
            svc.shards[0].ingest_blob(blob)
        from distributed_reinforcement_learning_tpu_torch.data.device_path import (
            gather_scan_batch)

        stacked, weights, idxs = gather_scan_batch(svc, 8, 3, np.random.RandomState(0))
    finally:
        svc.close()
    assert weights.shape == (3, 8) and len(idxs) == 3
    a, prio, metrics = agent.learn_many(a, stacked, weights)
    assert prio.shape == (3, 8) and all(v.shape == (3,) for v in metrics.values())
    for i in range(3):
        b, p, m = agent.learn(b, type(stacked)(*(x[i] for x in stacked)), weights[i])
        torch.testing.assert_close(prio[i], p, rtol=0, atol=0)
        for key in m:
            torch.testing.assert_close(metrics[key][i], torch.as_tensor(m[key]), rtol=0, atol=0)
    assert a.step == b.step == 3
    for key in a.params:
        torch.testing.assert_close(a.params[key], b.params[key], rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["transition", "sequence"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_service_snapshot_crosses_packages(writer, mode):
    """A service snapshot pickled by one package's checkpoint module
    restores in the other's service, and both then sample the same
    indices and contents."""
    pkgs = {"port": (replay_service, checkpoint), "jax": (jax_rs, jax_checkpoint)}
    reader = "jax" if writer == "port" else "port"
    src = pkgs[writer][0].ShardedReplayService(2, 256, mode=mode, scorer="td_proxy", seed=0)
    dst = {p: pkgs[p][0].ShardedReplayService(2, 256, mode=mode, seed=0) for p in pkgs}
    try:
        # The JAX package's pickle needs importable classes, so its
        # service holds the JAX namedtuples; the port's holds what the
        # wire decodes to.
        jax_codec = __import__("distributed_reinforcement_learning_tpu.data.codec",
                               fromlist=["decode"])
        for i, blob in enumerate(blobs_of(mode, 2, 12)):
            if writer == "port":
                src.shards[i % 2].ingest_blob(blob)
            else:
                src.shards[i % 2].ingest(_jax_class_tree(jax_codec.decode(blob, copy=True)))
        _, idxs, _ = src.sample(8, np.random.RandomState(1))
        src.update_batch(idxs, np.linspace(0.1, 2.0, 8))
        data = pkgs[writer][1].encode_replay_snapshot(src)
        for p in pkgs:
            dst[p].restore(pkgs[p if p == reader else writer][1].decode_replay_snapshot(data))
        assert len(dst["port"]) == len(dst["jax"]) == len(src)
        rng_p, rng_j = np.random.RandomState(3), np.random.RandomState(3)
        for _ in range(4):
            got, want = dst["port"].sample(8, rng_p), dst["jax"].sample(8, rng_j)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2], want[2])
            assert_batches_equal(got[0], want[0])
    finally:
        src.close()
        for svc in dst.values():
            svc.close()


def _jax_class_tree(tree):
    from distributed_reinforcement_learning_tpu.agents.apex import ApexBatch
    from distributed_reinforcement_learning_tpu.agents.r2d2 import R2D2Batch

    cls = {"ApexBatch": ApexBatch, "R2D2Batch": R2D2Batch}[type(tree).__name__]
    return cls(*tree)


def test_learner_checkpoint_round_trips_the_service(tmp_path):
    """save_checkpoint keeps the service's merged state; a new learner
    over a new service restores the same items and priorities (spread
    round-robin over its live shards, as in the JAX package) and beta."""
    f = FAMILIES["apex"]

    def learner():
        svc = replay_service.ShardedReplayService(2, 512, mode="transition", seed=0)
        return apex_runner.ApexLearner(ApexAgent(ApexConfig(**f["kw"]), device="cpu"),
                                       TrajectoryQueue(8), WeightStore(), batch_size=8,
                                       replay_capacity=512, seed=0, replay_service=svc)

    a, b = learner(), learner()
    try:
        facade = replay_shard.ReplayIngestFifo(a.replay_service, a.queue)
        for blob in blobs_of("transition", 6, 12):
            assert facade.ingest_blob(blob)
        assert a.train() is not None
        ckpt = checkpoint.Checkpointer(tmp_path)
        a.save_checkpoint(ckpt)
        assert b.restore_checkpoint(ckpt)
        assert b._warm_unrolls() == a._warm_unrolls() == 12
        assert len(b.replay_service) == len(a.replay_service) == 96
        assert b.replay_service.beta == a.replay_service.beta
        got, want = b.replay_service.snapshot(), a.replay_service.snapshot()
        np.testing.assert_array_equal(np.sort(got["priorities"]), np.sort(want["priorities"]))
        key = [item.state.tobytes() for item in want["items"]]
        assert sorted(key) == sorted(item.state.tobytes() for item in got["items"])
        assert len(b.replay_service.sample(8, np.random.RandomState(0))[1]) == 8
    finally:
        for x in (a, b):
            x.close()
            x.replay_service.close()


@pytest.mark.parametrize("family", ["apex", "r2d2"])
def test_learner_demotes_to_the_monolithic_replay_and_keeps_training(family):
    f = FAMILIES[family]
    agent_cls, cfg_cls, learner_cls = f["mine"]
    svc = replay_service.ShardedReplayService(2, 512, mode=f["mode"], seed=0)
    queue = TrajectoryQueue(64)
    learner = learner_cls(agent_cls(cfg_cls(**f["kw"]), device="cpu"), queue, WeightStore(),
                          batch_size=4, replay_capacity=512, seed=0, replay_service=svc,
                          **f["learner_kw"])
    facade = replay_shard.ReplayIngestFifo(svc, queue)
    blobs = blobs_of(f["mode"], 7, 24, **f["shape"])
    try:
        for blob in blobs[:12]:
            assert facade.ingest_blob(blob)
        assert learner.train() is not None and learner.train_steps == 1
        assert learner._active_replay() is svc
        for shard in svc.shards:
            svc.note_shard_death(shard)
        assert learner._active_replay() is learner.replay
        assert learner.train() is None  # the monolithic replay is still empty
        for blob in blobs[12:]:
            assert facade.ingest_blob(blob)
        assert facade.demoted and queue.size() == 12
        ingest = learner.ingest_many if family == "apex" else learner.ingest_batch
        while ingest(timeout=0.0):
            pass
        assert queue.size() == 0 and len(learner.replay) > 0
        steps = learner.train_steps
        for _ in range(3):
            if learner.train() is None:
                while ingest(timeout=0.0):
                    pass
        assert learner.train_steps > steps
    finally:
        learner.close()
        facade.close()


def test_updates_per_call_loads_for_the_replay_families(tmp_path):
    import json

    sections = json.loads(CONFIG.read_text())
    path = tmp_path / "config.json"
    path.write_text(json.dumps({
        "apex": {**sections["apex"], "updates_per_call": 4},
        "r2d2": {**sections["r2d2"], "updates_per_call": 2},
        "impala_cartpole": {**sections["impala_cartpole"], "updates_per_call": 2}}))
    assert load_config(path, "apex")[1].updates_per_call == 4
    assert load_config(path, "r2d2")[1].updates_per_call == 2
    # The IMPALA families' K-update calls are ported too.
    assert load_config(path, "impala_cartpole")[1].updates_per_call == 2


def test_k_beyond_the_target_sync_interval_and_the_recent_mix_are_refused(monkeypatch):
    f = FAMILIES["r2d2"]
    agent = R2D2Agent(R2D2Config(**f["kw"]), device="cpu")
    with pytest.raises(ValueError, match="target_sync_interval"):
        r2d2_runner.R2D2Learner(agent, TrajectoryQueue(4), WeightStore(), batch_size=4,
                                target_sync_interval=2, updates_per_call=3)
    # The recent mix refuses K > 1 and a replay service, as the JAX learner does.
    monkeypatch.setenv("DRL_R2D2_RECENT_FRACTION", "0.25")
    with pytest.raises(ValueError, match="updates_per_call > 1"):
        r2d2_runner.R2D2Learner(agent, TrajectoryQueue(4), WeightStore(), batch_size=4,
                                target_sync_interval=4, updates_per_call=2)
    svc = replay_service.ShardedReplayService(2, 64, mode="sequence", seed=0)
    try:
        with pytest.raises(ValueError, match="DRL_REPLAY_SHARDS"):
            r2d2_runner.R2D2Learner(agent, TrajectoryQueue(4), WeightStore(), batch_size=4,
                                    replay_service=svc)
    finally:
        svc.close()
