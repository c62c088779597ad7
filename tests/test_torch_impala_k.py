"""IMPALA-family K-update train calls of the PyTorch port, on the CPU.

- A learner with `updates_per_call` K = 4 (IMPALA and Transformer-IMPALA)
  drains 4 batches from its queue and runs them as one `learn_many`; from
  the same converted parameters it matches the JAX agent's
  `learn_many` (`jit(scan_learn(_learn))`) on the same 4 batches: the
  last step's metrics at rtol 1e-4 and every parameter at rtol 1e-4 plus
  an atol of K x 1% of the learning rate, the K-update bar of
  `tests/test_torch_replay_train.py`.
- A partial drain trains every batch it got, one step each.
- The prefetcher stacks K batches a call and `reconfigure` changes K
  without handing over a stack of the old depth.
- `load_config` accepts every section of `config.json`.
"""

import functools
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.agents.impala import ImpalaAgent as JaxAgent
from distributed_reinforcement_learning_tpu.agents.impala import ImpalaBatch as JaxBatch
from distributed_reinforcement_learning_tpu.agents.impala import ImpalaConfig as JaxConfig
from distributed_reinforcement_learning_tpu.agents.ximpala import XImpalaBatch as JaxXBatch
from distributed_reinforcement_learning_tpu_torch.agents.impala import (
    ImpalaAgent, ImpalaBatch, ImpalaConfig)
from distributed_reinforcement_learning_tpu_torch.agents.ximpala import XImpalaBatch
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
from distributed_reinforcement_learning_tpu_torch.data.prefetch import DevicePrefetcher
from distributed_reinforcement_learning_tpu_torch.models.convert import (
    impala_params_from_jax, transformer_params_from_jax)
from distributed_reinforcement_learning_tpu_torch.runtime import impala_runner, ximpala_runner
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore
from distributed_reinforcement_learning_tpu_torch.utils.config import load_config
from test_torch_impala import LEARN_CASES, _batch as impala_batch
from test_torch_ximpala import _agents as ximpala_agents
from test_torch_ximpala import _batch as ximpala_batch

CONFIG = Path(__file__).resolve().parents[1] / "config.json"
K = 4
B = 4


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


@functools.lru_cache(maxsize=None)
def _jax_impala(case: str):
    """The JAX agent and its initial state, built once for the file."""
    jagent = JaxAgent(JaxConfig(**LEARN_CASES[case]))
    return jagent, jax.jit(jagent.init_state)(jax.random.PRNGKey(0))


def _impala(case: str = "cartpole"):
    kw = LEARN_CASES[case]
    jagent, jstate = _jax_impala(case)
    agent = ImpalaAgent(ImpalaConfig(**kw), device="cpu")
    state = agent.state_from_params(impala_params_from_jax(jax.tree.map(np.asarray, jstate.params)))
    batches = [impala_batch(kw, B, seed=10 + i) for i in range(K)]
    return (jagent, jstate, JaxBatch, agent, state, ImpalaBatch, batches,
            impala_runner.ImpalaLearner, impala_params_from_jax, kw["trajectory"])


def _ximpala():
    lr = 2e-3
    jagent, jstate, agent, state = ximpala_agents(entropy_coef=0.01, baseline_loss_coef=0.5,
                                                  start_learning_rate=lr)
    batches = [ximpala_batch(B, 16, 3, seed=20 + i) for i in range(K)]
    return (jagent, jstate, JaxXBatch, agent, state, XImpalaBatch, batches,
            ximpala_runner.XImpalaLearner,
            lambda tree: transformer_params_from_jax(tree, head="actor_critic"), 16)


FAMILIES = {"impala": _impala, "ximpala": _ximpala}


def _fill(queue, batch_cls, batches) -> None:
    for b in batches:
        for i in range(B):
            queue.put(batch_cls(**{k: v[i] for k, v in b.items()}))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_k_update_call_matches_k_jax_steps(family):
    (jagent, jstate, jbatch_cls, agent, state, batch_cls, batches, learner_cls, convert,
     _) = FAMILIES[family]()
    stacked = jbatch_cls(**{k: np.stack([b[k] for b in batches]) for k in batches[0]})
    jstate, jmetrics = jax.jit(jagent.learn_many)(jstate, stacked)

    queue = TrajectoryQueue(capacity=K * B)
    learner = learner_cls(agent, queue, WeightStore(), batch_size=B, updates_per_call=K)
    learner.state = state
    _fill(queue, batch_cls, batches)
    metrics = learner.step(timeout=0.0)
    assert learner.train_steps == K and queue.size() == 0 and state.step == K

    lr = agent.cfg.start_learning_rate
    assert set(metrics) == set(jmetrics)
    for k, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(np.asarray(want)[-1]), rtol=1e-4,
                                   err_msg=k)
    want_params = convert(jax.tree.map(np.asarray, jstate.params))
    assert set(want_params) == set(learner.state.params)
    for k, want in want_params.items():
        np.testing.assert_allclose(learner.state.params[k].detach().numpy(), want.numpy(),
                                   rtol=1e-4, atol=K * 1e-2 * lr, err_msg=k)


@pytest.mark.parametrize("got", [1, 2, 3])
def test_partial_drain_trains_every_batch(got):
    """With fewer than K batches queued by the deadline, the call trains
    the ones it got, one step each, as that many `learn` calls would."""
    _, _, _, agent, state, batch_cls, batches, learner_cls, _, _ = _impala()
    ref = agent.state_from_params({k: v.detach() for k, v in state.params.items()})
    queue = TrajectoryQueue(capacity=K * B)
    learner = learner_cls(agent, queue, WeightStore(), batch_size=B, updates_per_call=K)
    learner.state = state
    _fill(queue, batch_cls, batches[:got])
    metrics = learner.step(timeout=0.05)
    assert learner.train_steps == got and queue.size() == 0
    assert learner.frames_learned == got * B * agent.cfg.trajectory
    for b in batches[:got]:
        ref, want = agent.learn(ref, batch_cls(**b))
    for k, v in want.items():
        torch.testing.assert_close(torch.as_tensor(metrics[k]), torch.as_tensor(v), rtol=0,
                                   atol=0)
    for k, v in ref.params.items():
        torch.testing.assert_close(learner.state.params[k], v, rtol=0, atol=0)
    assert learner.step(timeout=0.0) is None  # nothing left: no step, no drop


def test_learn_many_is_k_learn_steps():
    """`learn_many` over a [K, B, ...] stack is K `learn` calls, bit for bit."""
    _, _, _, agent, state, batch_cls, batches, _, _, _ = _impala("pixels")
    ref = agent.state_from_params({k: v.detach() for k, v in state.params.items()})
    stacked = batch_cls(**{k: np.stack([b[k] for b in batches]) for k in batches[0]})
    state, metrics = agent.learn_many(state, stacked)
    for i, b in enumerate(batches):
        ref, m = agent.learn(ref, batch_cls(**b))
        for key in m:
            torch.testing.assert_close(metrics[key][i], torch.as_tensor(m[key]), rtol=0, atol=0)
    assert state.step == ref.step == K
    for k, v in ref.params.items():
        torch.testing.assert_close(state.params[k], v, rtol=0, atol=0)


def test_run_sync_with_k_updates_a_call():
    """The `impala_cartpole_scan` section (K = 4) through `run_sync` on the
    in-tree CartPole: 8 steps in 2 calls."""
    cfg, rt = load_config(CONFIG, "impala_cartpole_scan")
    assert rt.updates_per_call == 4
    agent = ImpalaAgent(cfg, device="cpu")
    queue = TrajectoryQueue(rt.queue_size)
    weights = WeightStore()
    learner = impala_runner.ImpalaLearner(agent, queue, weights, rt.batch_size,
                                          updates_per_call=rt.updates_per_call)
    from distributed_reinforcement_learning_tpu_torch.envs.cartpole import VectorCartPole

    actor = impala_runner.ImpalaActor(agent, VectorCartPole(num_envs=rt.envs_per_actor, seed=0),
                                      queue, weights, seed=1)
    result = impala_runner.run_sync(learner, [actor], 8)
    assert learner.train_steps == 8 and weights.version == 8
    assert all(np.isfinite(v) for v in result["last_metrics"].values())


def _items(n: int, offset: int):
    return [ImpalaBatch(*(np.full((2,), offset + i, np.float32) for _ in ImpalaBatch._fields))
            for i in range(n)]


def test_prefetcher_stacks_k_batches_and_reconfigures():
    queue = TrajectoryQueue(capacity=64)
    for it in _items(12, 0):
        queue.put(it)
    pre = DevicePrefetcher(queue, batch_size=2, device=torch.device("cpu"), stack_calls=3)
    try:
        assert pre.stack_calls == 3
        got = pre.get_batch(timeout=5.0)
        assert got.state.shape == (3, 2, 2)
        np.testing.assert_array_equal(got.state[:, :, 0], [[0, 1], [2, 3], [4, 5]])
        pre.reconfigure(1)
        for it in _items(8, 100):
            queue.put(it)
        # Whatever was stacked at depth 3 before the change is dropped,
        # never handed over; the next batch has the new depth.
        got = pre.get_batch(timeout=5.0)
        assert pre.stack_calls == 1 and got.state.shape == (2, 2)
        assert pre.dropped_batches in (0, 3)
    finally:
        pre.close()


@pytest.mark.parametrize("section", sorted(json.loads(CONFIG.read_text())))
def test_every_config_section_loads(section):
    agent_cfg, rt = load_config(CONFIG, section)
    assert rt.num_actors == len(rt.envs) == len(rt.available_action)
    assert agent_cfg.num_actions >= max(rt.available_action)
