"""The port's device ring (`data/device_replay.py`) and replay loops
(`runtime/anakin_apex.py`, `runtime/anakin_r2d2.py`) against the JAX
package's.

- The ring: the same uniforms give JAX's indices, IS weights at rtol
  1e-6, beta, and the `ptr` / `size` wrap; priorities as `data/replay.py`.
- One Ape-X collect and one R2D2 collect against JAX's `_env_step`
  rollout from converted parameters, with JAX's env draws fed in and
  JAX's actions forced: observations, rewards, dones and the assembled
  batch equal, the recurrent state within 1e-6; then the TD-scored ring
  write (priorities at rtol 1e-4) and one prioritized learn step on the
  same sample (loss at rtol 1e-4).
- The JAX tests' mechanics: ring wrap, capacity alignment, target sync
  cadence, epsilon schedules, K above the sync interval refused, a mesh
  that is not a mesh of ranks, the pixel rings' uint8 storage; the launchers' `--mode
  anakin` summaries for `r2d2` and `apex`.
- The learning twin of `tests/test_anakin_apex.py:63`: the same
  configuration, update counts and bar.
"""

import functools
import json
from collections import namedtuple
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.agents.apex import ApexAgent as JaxApexAgent
from distributed_reinforcement_learning_tpu.agents.apex import ApexConfig as JaxApexConfig
from distributed_reinforcement_learning_tpu.agents.r2d2 import R2D2Agent as JaxR2D2Agent
from distributed_reinforcement_learning_tpu.agents.r2d2 import R2D2Config as JaxR2D2Config
from distributed_reinforcement_learning_tpu.data import device_replay as jax_replay
from distributed_reinforcement_learning_tpu.envs import cartpole_jax
from distributed_reinforcement_learning_tpu.envs.cartpole import pomdp_project as np_pomdp
from distributed_reinforcement_learning_tpu.runtime.anakin_apex import AnakinApex as JaxApex
from distributed_reinforcement_learning_tpu.runtime.anakin_r2d2 import AnakinR2D2 as JaxR2D2
from distributed_reinforcement_learning_tpu_torch import train_apex, train_r2d2
from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexAgent, ApexConfig
from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Agent, R2D2Config
from distributed_reinforcement_learning_tpu_torch.data import device_replay
from distributed_reinforcement_learning_tpu_torch.envs import breakout_device, cartpole_device
from distributed_reinforcement_learning_tpu_torch.models.convert import (
    apex_params_from_jax, r2d2_params_from_jax)
from distributed_reinforcement_learning_tpu_torch.runtime.anakin_apex import AnakinApex
from distributed_reinforcement_learning_tpu_torch.runtime.anakin_r2d2 import AnakinR2D2

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


def t(x):
    return torch.from_numpy(np.array(x))


# -- the ring ------------------------------------------------------------------


def test_ring_matches_jax_with_the_same_uniforms():
    rng = np.random.RandomState(0)
    C, W, n = 24, 8, 16
    storage = dict(x=np.zeros((C, 3), np.float32), a=np.zeros(C, np.int32))
    jr = jax_replay.make({k: jnp.asarray(v) for k, v in storage.items()}, C)
    Store = namedtuple("Store", "x a")
    tr = device_replay.make(Store(torch.zeros(C, 3), torch.zeros(C, dtype=torch.long)))
    key = jax.random.PRNGKey(0)
    for step in range(5):  # 40 writes into 24: wraps, size caps
        batch = dict(x=rng.randn(W, 3).astype(np.float32), a=rng.randint(0, 9, W).astype(np.int32))
        errs = (rng.randn(W) * 2).astype(np.float32)
        jr = jax_replay.ingest(jr, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(errs))
        device_replay.ingest(tr, Store(t(batch["x"]), t(batch["a"]).long()), t(errs))
        assert (tr.ptr, tr.size) == (int(jr.ptr), int(jr.size))
        np.testing.assert_allclose(tr.priorities.numpy(), np.asarray(jr.priorities), rtol=1e-6)
        key, k = jax.random.split(key)
        u = jax.random.uniform(k, (n,))
        jr, jbatch, jidx, jw = jax_replay.sample(jr, k, n)
        got, idx, w = device_replay.sample(tr, t(u))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
        np.testing.assert_array_equal(got.x.numpy(), np.asarray(jbatch["x"]))
        np.testing.assert_array_equal(got.a.numpy(), np.asarray(jbatch["a"]))
        assert tr.beta == np.float32(jr.beta)
        new = (rng.randn(n) * 3).astype(np.float32)
        jr = jax_replay.update_priorities(jr, jidx, jnp.asarray(new))
        device_replay.update_priorities(tr, idx, t(new))
        np.testing.assert_allclose(tr.priorities.numpy(), np.asarray(jr.priorities), rtol=1e-6)
    assert (tr.ptr, tr.size) == (16, 24)
    errs = np.asarray([0.0, 0.5, 2.0], np.float32)
    np.testing.assert_allclose(device_replay.priority(t(errs)).numpy(),
                               np.power(np.abs(errs) + device_replay.PER_EPS,
                                        device_replay.PER_ALPHA), rtol=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        device_replay.ingest(tr, Store(torch.zeros(5, 3), torch.zeros(5, dtype=torch.long)),
                             torch.zeros(5))


# -- the loops against JAX -------------------------------------------------------


def _jax_rollout(step_fn, carry, steps, n):
    """JAX's `_env_step` rollout -> (carry, records `[S, B, ...]`, the env
    draws of each step as the port's env takes them)."""
    recs, draws = [], []
    for _ in range(steps):
        _, _, k_env = jax.random.split(carry[-1], 3)  # `_env_step`'s own split
        draws.append(t(cartpole_jax._fresh(k_env, n)))
        carry, rec = step_fn(carry, None)
        recs.append(jax.tree.map(np.asarray, rec))
    return carry, {k: np.stack([r[k] for r in recs]) for k in recs[0]}, draws


def _cartpole_start(n):
    k_env = jax.random.PRNGKey(3)
    env, obs = cartpole_jax.reset(k_env, n)
    # Carts near the 200-step cap: dones and resets inside the collect.
    return env._replace(steps=jnp.asarray([196, 0, 190, 0], jnp.int32)[:n]), obs


def test_apex_collect_ingest_and_learn_match_jax():
    cfg = dict(obs_shape=(4,), num_actions=2, start_learning_rate=1e-3)
    B, S = 4, 6
    jan = JaxApex(JaxApexAgent(JaxApexConfig(**cfg)), num_envs=B, steps_per_collect=S,
                  capacity=2 * B * S, batch_size=8)
    jtrain = jax.jit(jan.agent.init_state)(jax.random.PRNGKey(1))
    env, obs = _cartpole_start(B)
    an = AnakinApex(ApexAgent(ApexConfig(**cfg), device="cpu"), num_envs=B, steps_per_collect=S,
                    capacity=2 * B * S, batch_size=8)
    st = an.init(0)
    st.train = an.agent.state_from_params(apex_params_from_jax(jax.tree.map(np.asarray, jtrain.params)))
    st.env, st.obs = cartpole_device.CartPoleState(*map(t, env)), t(obs)

    episodes = jnp.zeros(B, jnp.int32)
    step = jax.jit(functools.partial(jan._env_step, jtrain.params))
    carry, rec, draws = _jax_rollout(step, (env, obs, jnp.zeros(B, jnp.int32), episodes,
                                            jax.random.PRNGKey(2)), S, B)
    batch, stats = an.collect(st, actions=t(rec["action"]), env_draws=draws)
    for name in batch._fields:
        want = rec[name].reshape((B * S,) + rec[name].shape[2:])  # time-major, as JAX
        got = getattr(batch, name)
        assert got.is_contiguous()
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    np.testing.assert_array_equal(st.episodes.numpy(), np.asarray(carry[3]))
    assert rec["done"].any() and float(stats["boundaries_done"]) == rec["done"].sum()

    # The TD-scored ring write, then one prioritized learn on one sample.
    jbatch = type(jan._zero_transitions(obs))(**{
        k: jnp.asarray(getattr(batch, k).numpy()) for k in batch._fields})
    jreplay = jax.jit(jan._ingest)(jtrain, jax_replay.make(jan._zero_transitions(obs), 2 * B * S),
                                   jbatch)
    errs = an.ingest(st, batch)
    np.testing.assert_allclose(st.replay.priorities.numpy(), np.asarray(jreplay.priorities),
                               rtol=1e-4)
    assert errs.shape == (B * S,) and (st.replay.ptr, st.replay.size) == (B * S, B * S)
    k = jax.random.PRNGKey(9)
    u = t(jax.random.uniform(k, (8,)))
    jreplay, jsample, jidx, jw = jax.jit(jax_replay.sample, static_argnums=2)(jreplay, k, 8)
    _, jtd, jm = jax.jit(jan.agent._learn)(jtrain, jsample, jw)
    m = an._learn(st, uniforms=u)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(
        st.replay.priorities.numpy()[np.asarray(jidx)],
        np.asarray(jax_replay.priority(jtd)), rtol=1e-4)


def test_r2d2_collect_ingest_and_learn_match_jax():
    cfg = dict(obs_shape=(2,), num_actions=2, seq_len=6, burn_in=2, lstm_size=16,
               learning_rate=1e-3)
    B = 4
    jan = JaxR2D2(JaxR2D2Agent(JaxR2D2Config(**cfg)), num_envs=B, capacity=2 * B, batch_size=4,
                  obs_transform=np_pomdp)
    jtrain = jax.jit(jan.agent.init_state)(jax.random.PRNGKey(1))
    env, obs = _cartpole_start(B)
    obs = np_pomdp(obs)
    an = AnakinR2D2(R2D2Agent(R2D2Config(**cfg), device="cpu"), num_envs=B, capacity=2 * B,
                    batch_size=4, obs_transform=cartpole_device.pomdp_project)
    st = an.init(0)
    st.train = an.agent.state_from_params(r2d2_params_from_jax(jax.tree.map(np.asarray, jtrain.params)))
    st.env, st.obs = cartpole_device.CartPoleState(*map(t, env)), t(obs)
    h = (np.random.RandomState(0).randn(B, 16) * 0.3).astype(np.float32)  # a mid-run state
    st.h, st.c = t(h), t(h * 0.5)

    step = jax.jit(functools.partial(jan._env_step, jtrain.params))
    carry0 = (env, obs, jnp.zeros(B, jnp.int32), jnp.asarray(h), jnp.asarray(h * 0.5),
              jnp.zeros(B, jnp.int32), jax.random.PRNGKey(2))
    carry, rec, draws = _jax_rollout(step, carry0, 6, B)
    batch, _ = an.collect(st, actions=t(rec["action"]), env_draws=draws)
    for name in ("state", "previous_action", "action", "reward", "done"):
        got, want = getattr(batch, name), np.swapaxes(rec[name], 0, 1)
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    np.testing.assert_array_equal(batch.initial_h.numpy(), h)  # the sequence-start state
    np.testing.assert_allclose(st.h.numpy(), np.asarray(carry[3]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(st.c.numpy(), np.asarray(carry[4]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(st.prev_action.numpy(), np.asarray(carry[2]))
    assert rec["done"].any()

    jbatch = type(jan._zero_sequences())(**{
        k: jnp.asarray(getattr(batch, k).numpy()) for k in batch._fields})
    jreplay = jax.jit(jan._ingest)(jtrain, jax_replay.make(jan._zero_sequences(), 2 * B), jbatch)
    an.ingest(st, batch)
    np.testing.assert_allclose(st.replay.priorities.numpy(), np.asarray(jreplay.priorities),
                               rtol=1e-4)
    k = jax.random.PRNGKey(9)
    u = t(jax.random.uniform(k, (4,)))
    jreplay, jsample, jidx, jw = jax.jit(jax_replay.sample, static_argnums=2)(jreplay, k, 4)
    _, jerr, jm = jax.jit(jan.agent._learn)(jtrain, jsample, jw)
    m = an._learn(st, uniforms=u)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(st.replay.priorities.numpy()[np.asarray(jidx)],
                               np.asarray(jax_replay.priority(jerr)), rtol=1e-4)


# -- mechanics (twins of the JAX tests) ------------------------------------------


def _apex(num_envs=4, steps=4, capacity=32, batch_size=8, **kw):
    cfg = ApexConfig(obs_shape=(4,), num_actions=2, start_learning_rate=1e-3)
    return AnakinApex(ApexAgent(cfg, device="cpu"), num_envs=num_envs, steps_per_collect=steps,
                      capacity=capacity, batch_size=batch_size, **kw)


def _r2d2(num_envs=4, capacity=16, batch_size=4, **kw):
    cfg = R2D2Config(obs_shape=(2,), num_actions=2, seq_len=6, burn_in=2, lstm_size=16,
                     learning_rate=1e-3)
    kw.setdefault("obs_transform", cartpole_device.pomdp_project)
    return AnakinR2D2(R2D2Agent(cfg, device="cpu"), num_envs=num_envs, capacity=capacity,
                      batch_size=batch_size, **kw)


@pytest.mark.parametrize("make", [_apex, _r2d2])
def test_ring_wrap_chunks_and_guards(make):
    an = make(capacity=32) if make is _apex else make(capacity=8)
    st = an.init(0)
    st, _ = an.collect_chunk(st, 3)  # wraps once, size caps
    width = an.write_width if make is _apex else an.num_envs
    assert st.replay.size == an.capacity
    assert st.replay.ptr == (3 * width) % an.capacity
    assert bool((st.replay.priorities > 0).all())
    st, m = an.train_chunk(st, 3)
    assert st.train.step == 3 and torch.isfinite(m["loss"]).all()
    assert float(m["replay_size"][-1]) == an.capacity
    st, _ = an.train_chunk(st, 2)
    assert st.train.step == 5
    with pytest.raises(ValueError, match="multiple"):
        make(capacity=40) if make is _apex else make(capacity=10)
    with pytest.raises(ValueError, match="must not exceed"):
        make(updates_per_collect=8, target_sync_interval=4)
    with pytest.raises(TypeError, match="RankMesh"):
        make(mesh=object())


@pytest.mark.parametrize("make", [_apex, _r2d2])
def test_target_sync_steps_since_last(make):
    """K=2 with interval 3: the steps-since-last cadence syncs at step 4
    (a step modulo would wait for 6)."""
    an = make(updates_per_collect=2, target_sync_interval=3)
    st = an.init(0)
    st, _ = an.collect_chunk(st, 4)
    st, _ = an.train_chunk(st, 1)
    assert st.train.step == 2 and st.last_sync == 0
    st, _ = an.train_chunk(st, 1)
    assert st.train.step == 4 and st.last_sync == 4
    for k, p in st.train.params.items():
        assert torch.equal(st.train.target_params[k], p.detach()), k


def test_epsilon_schedules():
    an = _apex()
    np.testing.assert_allclose(an._epsilon(torch.tensor([0, 20, 100])).numpy(),
                               [1.0, 0.5, 1.0 / 6.0], rtol=1e-6)
    r = _r2d2(epsilon_floor=0.02)
    st = r.init(0)
    assert float(r._epsilon(st.episodes).mean()) == 1.0
    st, _ = r.collect_chunk(st, 30)  # plenty of episode ends
    assert int(st.episodes.sum()) > 0
    eps = r._epsilon(st.episodes)
    assert float(eps.mean()) < 1.0 and float(eps.min()) >= 0.02
    np.testing.assert_allclose(r._epsilon(torch.tensor([10])).numpy(), [0.5], rtol=1e-6)


def test_pixel_rings_are_uint8_and_train():
    cfg = ApexConfig(obs_shape=(84, 84, 4), num_actions=4, fold_normalize=True)
    an = AnakinApex(ApexAgent(cfg, device="cpu"), num_envs=2, steps_per_collect=3, capacity=12,
                    batch_size=4, env=breakout_device)
    st = an.init(0)
    assert st.replay.storage.state.dtype == torch.uint8
    assert st.replay.nbytes() == 12 * 2 * 84 * 84 * 4 + 12 * (8 + 8 + 4 + 1) + 12 * 4
    st, _ = an.collect_chunk(st, 1)
    st, m = an.train_chunk(st, 1)
    assert torch.isfinite(m["loss"]).all()
    cfg = R2D2Config(obs_shape=(84, 84, 4), num_actions=4, seq_len=4, burn_in=2, lstm_size=16,
                     torso="nature", fold_normalize=True, priority_eta=0.9)
    rn = AnakinR2D2(R2D2Agent(cfg, device="cpu"), num_envs=2, capacity=8, batch_size=2,
                    env=breakout_device)
    st = rn.init(0)
    assert st.replay.storage.state.dtype == torch.uint8
    st, _ = rn.collect_chunk(st, 1)
    st, m = rn.train_chunk(st, 1)
    assert torch.isfinite(m["loss"]).all()
    assert "mean_return" in rn.greedy_eval(st.train.params, 2, 8)


@pytest.mark.parametrize("main, argv, frames", [
    # r2d2: 12 envs x 10 steps a collect; warm-up ceil(3 * 32 / 12) = 8.
    (train_r2d2.main, ["--section", "r2d2", "--updates", "2"], (8 + 2) * 12 * 10),
    # apex: 2 envs x 16 steps a collect; warm-up ceil(3 * 32 / 32) = 3.
    (train_apex.main, ["--section", "apex", "--updates", "1", "--anakin_envs", "2",
                       "--anakin_capacity", "128"], (3 + 1) * 2 * 16),
])
def test_launchers_print_the_jax_summary(main, argv, frames, capsys):
    result = main(["--config", str(CONFIG), "--mode", "anakin", "--device", "cpu", *argv])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == {"frames", "chunk_mean_returns", "mean_return_last_chunk"}
    assert summary == result and result["frames"] == frames


def test_apex_learns_cartpole_on_device():
    """Twin of `tests/test_anakin_apex.py:63`: late mean return above 60."""
    an = AnakinApex(ApexAgent(ApexConfig(obs_shape=(4,), num_actions=2, start_learning_rate=1e-3),
                              device="cpu"),
                    num_envs=8, steps_per_collect=16, capacity=8192, batch_size=32,
                    updates_per_collect=4, target_sync_interval=25, epsilon_floor=0.02)
    st = an.init(0)
    st, _ = an.collect_chunk(st, 8)
    st, _ = an.train_chunk(st, 250)
    st, m = an.train_chunk(st, 50)
    episodes = float(m["episodes_done"].sum())
    mean_return = float(m["episode_return_sum"].sum()) / max(episodes, 1.0)
    assert episodes > 0
    assert mean_return > 60, f"late mean return {mean_return}"
