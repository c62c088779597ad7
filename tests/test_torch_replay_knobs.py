"""The replay learners' seeding, the R2D2 recent mix and the actors'
`timeout_nonterminal` against the JAX package, on the CPU.

- Seeding, as in the JAX learners: the parameters come from `init_seed`
  (the JAX learner's `rng`) and the replay samples from
  `RandomState(seed)`; the same sequences at the same priorities give the
  JAX learner's indices. `make_learner` seeds the parameters and leaves
  the replay stream at `RandomState(0)`, as the JAX launcher does.
- The recent mix (`DRL_R2D2_RECENT_FRACTION`, `DRL_R2D2_RECENT_WINDOW`)
  forces the list-backed replay and swaps the same rows for the same
  recent sequences as the JAX learner, from the same `RandomState`.
- `timeout_nonterminal` records a time-limit truncation as non-terminal in
  both sequence actors, and `make_actor` passes the section's setting.
"""

import dataclasses

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.agents.r2d2 import R2D2Agent as JaxR2D2Agent
from distributed_reinforcement_learning_tpu.agents.r2d2 import R2D2Config as JaxR2D2Config
from distributed_reinforcement_learning_tpu.data.fifo import TrajectoryQueue as JaxQueue
from distributed_reinforcement_learning_tpu.runtime import r2d2_runner as jax_r2d2_runner
from distributed_reinforcement_learning_tpu.runtime.weights import WeightStore as JaxStore
from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexAgent, ApexConfig
from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import (
    R2D2Agent, R2D2Batch, R2D2Config)
from distributed_reinforcement_learning_tpu_torch.agents.xformer import (
    XformerAgent, XformerConfig)
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
from distributed_reinforcement_learning_tpu_torch.envs.cartpole import (
    VectorCartPole, pomdp_project)
from distributed_reinforcement_learning_tpu_torch.runtime import (
    apex_runner, launch, r2d2_runner, xformer_runner)
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore
from distributed_reinforcement_learning_tpu_torch.utils.config import load_config
from test_torch_impala_k import CONFIG


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # One thread for torch and for numpy's BLAS pool, as the parity files
    # pin them: several test workers share the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)

KW = dict(obs_shape=(2,), num_actions=2, seq_len=6, burn_in=2, lstm_size=8)


def _sequences(n: int, seed: int) -> list[R2D2Batch]:
    rng = np.random.RandomState(seed)
    T, H = KW["seq_len"], KW["lstm_size"]
    return [R2D2Batch(state=(rng.randn(T, 2) * 50).astype(np.int32),
                      previous_action=rng.randint(0, 2, T).astype(np.int32),
                      action=rng.randint(0, 2, T).astype(np.int32),
                      reward=rng.randn(T).astype(np.float32), done=rng.rand(T) < 0.1,
                      initial_h=np.zeros(H, np.float32), initial_c=np.zeros(H, np.float32))
            for _ in range(n)]


def _fixed_td(_state, batch):
    """A stand-in for `td_error` that both packages compute alike: the
    priorities then do not depend on the parameters."""
    return np.abs(np.asarray(batch.reward).mean(axis=1)) + 0.1


def _fix_priorities(mine, ref) -> None:
    mine.agent.td_error = lambda state, batch: torch.from_numpy(_fixed_td(state, batch))
    ref.agent.td_error = _fixed_td


@pytest.mark.parametrize("init_seed, seed", [(0, 0), (5, 3), (2, 7)])
def test_learner_seeds_parameters_and_replay_apart(init_seed, seed):
    agent = R2D2Agent(R2D2Config(**KW), device="cpu")
    learner = r2d2_runner.R2D2Learner(agent, TrajectoryQueue(64), WeightStore(), batch_size=8,
                                      replay_capacity=128, init_seed=init_seed, seed=seed)
    want = agent.init_state(init_seed).params
    for k, v in want.items():
        torch.testing.assert_close(learner.state.params[k], v, rtol=0, atol=0)
    ref = jax_r2d2_runner.R2D2Learner(JaxR2D2Agent(JaxR2D2Config(**KW)), JaxQueue(64),
                                      JaxStore(), batch_size=8, replay_capacity=128, seed=seed)
    seqs = _sequences(24, seed=1)
    _fix_priorities(learner, ref)
    for ln in (learner, ref):
        for s in seqs:
            ln.queue.put(s)
        while ln.ingest_batch(timeout=0.0):
            pass
    assert learner.ingested_sequences == ref.ingested_sequences == 24
    for _ in range(3):
        _, got, gw = learner.replay.sample(8, learner._np_rng)
        _, want_idx, ww = ref.replay.sample(8, ref._np_rng)
        np.testing.assert_array_equal(got, want_idx)
        np.testing.assert_allclose(gw, ww, rtol=1e-6)


def test_apex_learner_seeds_parameters_and_replay_apart():
    agent = ApexAgent(ApexConfig(obs_shape=(4,), num_actions=2), device="cpu")
    learner = apex_runner.ApexLearner(agent, TrajectoryQueue(8), WeightStore(), batch_size=8,
                                      replay_capacity=64, init_seed=4, seed=9)
    for k, v in agent.init_state(4).params.items():
        torch.testing.assert_close(learner.state.params[k], v, rtol=0, atol=0)
    np.testing.assert_array_equal(learner._np_rng.randint(1 << 30, size=4),
                                  np.random.RandomState(9).randint(1 << 30, size=4))


@pytest.mark.parametrize("section", ["r2d2", "apex", "xformer", "impala_cartpole"])
def test_make_learner_seeds_as_the_jax_launcher(section):
    cfg, rt = load_config(CONFIG, section)
    if section == "r2d2":
        cfg = dataclasses.replace(cfg, lstm_size=16)
    algo = launch.algo_of(cfg)
    learner = launch.make_learner(algo, cfg, rt, TrajectoryQueue(8), WeightStore(), seed=5,
                                  device="cpu")
    want = learner.agent.init_state(5).params
    for k, v in want.items():
        torch.testing.assert_close(learner.state.params[k], v, rtol=0, atol=0)
    rng = getattr(learner, "_np_rng", None)
    if rng is not None:  # the replay families sample from RandomState(0)
        np.testing.assert_array_equal(rng.randint(1 << 30, size=4),
                                      np.random.RandomState(0).randint(1 << 30, size=4))
    learner.close()


def test_recent_mix_swaps_the_rows_the_jax_learner_swaps(monkeypatch):
    monkeypatch.setenv("DRL_R2D2_RECENT_FRACTION", "0.25")
    monkeypatch.setenv("DRL_R2D2_RECENT_WINDOW", "12")
    agent = R2D2Agent(R2D2Config(**KW), device="cpu")
    learner = r2d2_runner.R2D2Learner(agent, TrajectoryQueue(64), WeightStore(), batch_size=8,
                                      replay_capacity=128, seed=3)
    ref = jax_r2d2_runner.R2D2Learner(JaxR2D2Agent(JaxR2D2Config(**KW)), JaxQueue(64),
                                      JaxStore(), batch_size=8, replay_capacity=128, seed=3)
    assert type(learner.replay).__name__ == type(ref.replay).__name__ == "PrioritizedReplay"
    assert learner._recent.maxlen == ref._recent.maxlen == 12
    _fix_priorities(learner, ref)
    for ln in (learner, ref):
        for s in _sequences(30, seed=2):
            ln.queue.put(s)
        while ln.ingest_batch(timeout=0.0):
            pass
    assert [i for i, _ in learner._recent] == [i for i, _ in ref._recent]
    for _ in range(4):
        got = learner._mix_recent(*learner.replay.sample(8, learner._np_rng))
        want = ref._mix_recent(*ref.replay.sample(8, ref._np_rng))
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
        assert (got[2][-2:] == 1.0).all()  # round(0.25 * 8) recent rows at IS weight 1
        for a, b in zip(got[0], want[0]):
            np.testing.assert_array_equal(a.reward, b.reward)


def _actor(family: str, timeout_nonterminal: bool):
    env = VectorCartPole(num_envs=3, seed=0, max_steps=4)
    weights = WeightStore()
    queue = TrajectoryQueue(64)
    if family == "r2d2":
        agent = R2D2Agent(R2D2Config(**KW), device="cpu")
        cls = r2d2_runner.R2D2Actor
    else:
        agent = XformerAgent(XformerConfig(obs_shape=(2,), num_actions=2, seq_len=6, burn_in=2,
                                           d_model=8, num_heads=2, num_layers=1), device="cpu")
        cls = xformer_runner.XformerActor
    weights.publish(agent.init_state(0).params, 0)
    return cls(agent, env, queue, weights, seed=1, obs_transform=pomdp_project,
               timeout_nonterminal=timeout_nonterminal), queue


@pytest.mark.parametrize("family", ["r2d2", "xformer"])
def test_timeout_nonterminal_records_truncations_as_nonterminal(family):
    """CartPole capped at 4 steps truncates every 4th step (a pole does
    not fall in 4 steps from the reset): recorded as terminal by default,
    as non-terminal with the option; the returns count either way."""
    for option in (False, True):
        actor, queue = _actor(family, option)
        for _ in range(2):
            actor.run_unroll()
        dones = np.stack([queue.get(timeout=0.0).done for _ in range(6)])
        assert len(actor.episode_returns) == 9  # 12 steps x 3 envs / 4
        if option:
            assert not dones.any() and (actor._episodes == 0).all()
        else:
            assert dones.sum() == 9 and (actor._episodes == 3).all()


def test_make_actor_passes_timeout_nonterminal():
    cfg, rt = load_config(CONFIG, "xformer")
    rt = dataclasses.replace(rt, timeout_nonterminal=True, envs_per_actor=1)
    actor = launch.make_actor("xformer", cfg, rt, 0, TrajectoryQueue(8), WeightStore(),
                              device="cpu")
    assert actor.timeout_nonterminal is True
