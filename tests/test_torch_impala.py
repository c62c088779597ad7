"""IMPALA agent and single-process training of the PyTorch port.

- One learn step against the JAX package's `ImpalaAgent._learn` from the
  same converted parameters on the same numpy batch: each loss term,
  `grad_norm`, `learning_rate` and every parameter after the step, at
  rtol 1e-4 (float32; sums in another order). Parameters also take atol
  1e-8, far below one step's update (~lr = 6e-4), for entries whose update
  is itself near zero.
- Act samples by the policy (the RNG streams of the two packages differ,
  so the test compares frequencies with probabilities).
- Entry points run on CUDA unless asked for the CPU, and raise without it.
- A twin of `tests/test_e2e.py::test_impala_learns_cartpole` on the CPU,
  and one full-width update of the `impala` config section.
"""

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
from distributed_reinforcement_learning_tpu_torch import train_impala
from distributed_reinforcement_learning_tpu_torch.agents import common
from distributed_reinforcement_learning_tpu_torch.agents.impala import (
    ImpalaAgent, ImpalaBatch, ImpalaConfig)
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
from distributed_reinforcement_learning_tpu_torch.envs.cartpole import VectorCartPole
from distributed_reinforcement_learning_tpu_torch.models.convert import impala_params_from_jax
from distributed_reinforcement_learning_tpu_torch.ops.kernels import vtrace as kvt
from distributed_reinforcement_learning_tpu_torch.runtime import impala_runner
from distributed_reinforcement_learning_tpu_torch.runtime.launch import train_local
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

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


LEARN_CASES = {
    "cartpole": dict(obs_shape=(4,), num_actions=2, lstm_size=64, trajectory=4,
                     reward_clipping="abs_one"),
    "pixels": dict(obs_shape=(84, 84, 4), num_actions=6, lstm_size=32, trajectory=4,
                   reward_clipping="soft_asymmetric"),
}


def _batch(cfg, B, seed):
    rng = np.random.RandomState(seed)
    T, A, H = cfg["trajectory"], cfg["num_actions"], cfg["lstm_size"]
    if len(cfg["obs_shape"]) == 1:
        state = rng.randn(B, T, *cfg["obs_shape"]).astype(np.float32)
    else:
        state = rng.randint(0, 256, (B, T, *cfg["obs_shape"])).astype(np.uint8)
    logits = rng.randn(B, T, A)
    behavior = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return dict(
        state=state,
        reward=(rng.randn(B, T) * 2).astype(np.float32),
        action=rng.randint(0, A, (B, T)).astype(np.int32),
        done=rng.rand(B, T) < 0.2,
        behavior_policy=behavior.astype(np.float32),
        previous_action=rng.randint(0, A, (B, T)).astype(np.int32),
        initial_h=(rng.randn(B, T, H) * 0.5).astype(np.float32),
        initial_c=(rng.randn(B, T, H) * 0.5).astype(np.float32),
    )


@pytest.mark.parametrize("case", sorted(LEARN_CASES))
def test_learn_step_matches_jax(case):
    kw = LEARN_CASES[case]
    jagent = JaxAgent(JaxConfig(**kw))
    jstate = jax.jit(jagent.init_state)(jax.random.PRNGKey(0))
    agent = ImpalaAgent(ImpalaConfig(**kw), device="cpu")
    state = agent.state_from_params(impala_params_from_jax(jax.tree.map(np.asarray, jstate.params)))

    batch = _batch(kw, B=2, seed=1)
    jstate, jmetrics = jax.jit(jagent._learn)(jstate, JaxBatch(**batch))
    before = kvt.vtrace_cuda.launches
    state, metrics = agent.learn(state, ImpalaBatch(**batch))
    assert kvt.vtrace_cuda.launches == before  # CPU tensors take the plain version

    assert set(metrics) == set(jmetrics)
    for k, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(want), rtol=1e-4, err_msg=k)
    want_params = impala_params_from_jax(jax.tree.map(np.asarray, jstate.params))
    assert set(want_params) == set(state.params)
    for k, want in want_params.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-8, err_msg=k)
    assert state.step == 1


def test_optimizer_clips_like_optax():
    """Clip when the norm reaches the threshold, scale by clip/norm (no
    epsilon), mean square starting at ones, eps inside the root."""
    lr = common.polynomial_lr(0.5, 0.0, 4)
    assert [lr(s) for s in (0, 2, 4, 9)] == [0.5, 0.25, 0.0, 0.0]
    assert common.polynomial_lr(1.0, 0.0, 10**14)(2**30) == pytest.approx(0.5)
    tx = common.RMSPropWithClip(lr, clip_norm=1.0, decay=0.9, eps=0.1)
    params = {"w": torch.zeros(2)}
    state = common.TrainState(params, tx.init(params))
    g_norm = tx.apply(state, {"w": torch.tensor([3.0, 4.0])})
    assert float(g_norm) == 5.0
    g = np.array([0.6, 0.8])
    nu = 0.1 * g**2 + 0.9
    np.testing.assert_allclose(state.nu["w"].numpy(), nu, rtol=1e-6)
    np.testing.assert_allclose(params["w"].numpy(), -0.5 * g / np.sqrt(nu + 0.1), rtol=1e-6)
    with pytest.raises(ValueError):
        common.clip_rewards(torch.zeros(1), "bogus")


def test_act_samples_by_the_policy():
    cfg = ImpalaConfig(obs_shape=(4,), num_actions=3, lstm_size=16)
    agent = ImpalaAgent(cfg, device="cpu")
    params = agent.init_state(seed=3).params
    rng = np.random.RandomState(0)
    n = 20000
    obs = torch.from_numpy(np.repeat(rng.randn(2, 4).astype(np.float32) * 3, n // 2, axis=0))
    pa = torch.zeros(n, dtype=torch.long)
    h, c = agent.initial_lstm_state(n)
    out = agent.act(params, obs, pa, h, c, torch.Generator().manual_seed(1))
    assert out.action.shape == (n,) and out.policy.shape == (n, 3)
    for row in (0, 1):
        sl = slice(row * n // 2, (row + 1) * n // 2)
        p = out.policy[sl][0].numpy()
        freq = np.bincount(out.action[sl].numpy(), minlength=3) / (n // 2)
        sigma = np.sqrt(p * (1 - p) / (n // 2))
        assert np.all(np.abs(freq - p) < 5 * sigma + 1e-9), (freq, p)
    again = agent.act(params, obs, pa, h, c, torch.Generator().manual_seed(1))
    assert torch.equal(again.action, out.action)  # the generator is the only randomness


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_local(str(CONFIG), "impala_cartpole", 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ImpalaAgent(ImpalaConfig())
    assert ImpalaAgent(ImpalaConfig(), device="cpu").device.type == "cpu"


def test_publish_clones_the_parameters():
    store = WeightStore()
    params = {"w": torch.zeros(3, requires_grad=True)}
    store.publish(params, 1)
    with torch.no_grad():
        params["w"].add_(1.0)
    got, version = store.get()
    assert version == 1 and torch.equal(got["w"], torch.zeros(3))
    assert store.get_if_newer(1) is None and store.get_if_newer(0)[1] == 1


def test_impala_learns_cartpole():
    """Twin of tests/test_e2e.py::test_impala_learns_cartpole on the port."""
    cfg = ImpalaConfig(
        obs_shape=(4,), num_actions=2, trajectory=16, lstm_size=64,
        discount_factor=0.99, entropy_coef=0.01, baseline_loss_coef=0.5,
        start_learning_rate=5e-3, end_learning_rate=5e-3, learning_frame=10**9,
        reward_clipping="abs_one")
    agent = ImpalaAgent(cfg, device="cpu")
    queue = TrajectoryQueue(capacity=64)
    weights = WeightStore()
    learner = impala_runner.ImpalaLearner(agent, queue, weights, batch_size=16, seed=0)
    actor = impala_runner.ImpalaActor(agent, VectorCartPole(num_envs=16, seed=0), queue,
                                      weights, seed=1)

    result = impala_runner.run_sync(learner, [actor], num_updates=300)

    returns = result["episode_returns"]
    assert len(returns) > 20
    late = np.mean(returns[-20:])
    early = np.mean(returns[:20])
    assert late > 60, f"late mean return {late} (early {early})"
    assert late > early


def test_full_width_impala_update_on_cpu(tmp_path):
    """One update of the `impala` section (Breakout frames, NatureConv,
    LSTM 256, batch 32 x 20, 4 actors x 5 envs) through the launcher."""
    before = kvt.vtrace_cuda.launches
    result = train_impala.main(["--config", str(CONFIG), "--section", "impala",
                                "--updates", "1", "--device", "cpu",
                                "--run_dir", str(tmp_path)])
    assert kvt.vtrace_cuda.launches == before
    assert result["frames"] == 2 * 4 * 5 * 20  # two actor rounds fill a batch of 32
    m = result["last_metrics"]
    assert set(m) == {"pi_loss", "baseline_loss", "entropy", "total_loss", "grad_norm",
                      "learning_rate"}
    assert all(np.isfinite(v) for v in m.values())
    assert m["learning_rate"] == pytest.approx(6e-4)
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert {x["tag"] for x in lines} == {f"learner/{k}" for k in m}
