"""The port's on-device IMPALA loop (`runtime/anakin.py`) against the JAX
package's `runtime/anakin.py`, and the R2D2 loop's learning twin.

- One collect against JAX's `_env_step` rollout from converted
  parameters and the same env state, with JAX's env draws fed in and
  JAX's sampled actions forced (the two packages' samplers cannot
  match): per-step behaviour policy and stored (h, c) within 1e-6,
  observations, rewards, dones and the `prev_action` resets equal, the
  assembled `[B, T]` batch contiguous and equal to JAX's swapped
  records. Then one learn step on that batch: the losses at rtol 1e-4.
  On CartPole with a 5-way head aliased onto its 2 actions (the pixel
  envs are held to JAX step by step in `test_torch_anakin_envs.py`, and
  the pixel loops run in `test_torch_anakin_replay.py`).
- `greedy_rollout` against JAX's argmax rollout, compared over the steps
  before the first near-tie (top two probabilities within 1e-5).
- The JAX tests' mechanics: chunks, the obs-shape and head guards, a
  mesh that is not a mesh of ranks; the launcher's `--mode anakin`
  summary and resume.
- Learning twins of `tests/test_anakin.py:97` and
  `tests/test_anakin_r2d2.py:126`: the same configurations, update
  counts and bars.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.agents.impala import ImpalaAgent as JaxAgent
from distributed_reinforcement_learning_tpu.agents.impala import ImpalaBatch as JaxBatch
from distributed_reinforcement_learning_tpu.agents.impala import ImpalaConfig as JaxConfig
from distributed_reinforcement_learning_tpu.envs import cartpole_jax
from distributed_reinforcement_learning_tpu.runtime.anakin import AnakinImpala as JaxAnakin
from distributed_reinforcement_learning_tpu.runtime.anakin import AnakinState as JaxState
from distributed_reinforcement_learning_tpu_torch import train_impala, train_ximpala
from distributed_reinforcement_learning_tpu_torch.agents.impala import ImpalaAgent, ImpalaConfig
from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Agent, R2D2Config
from distributed_reinforcement_learning_tpu_torch.envs import (
    breakout_device, cartpole_device)
from distributed_reinforcement_learning_tpu_torch.models.convert import impala_params_from_jax
from distributed_reinforcement_learning_tpu_torch.ops.kernels import vtrace as kvt
from distributed_reinforcement_learning_tpu_torch.runtime.anakin import AnakinImpala
from distributed_reinforcement_learning_tpu_torch.runtime.anakin_r2d2 import AnakinR2D2
from distributed_reinforcement_learning_tpu_torch.runtime.transport import run_role

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


def anakin_cfg(**kw):
    base = dict(obs_shape=(4,), num_actions=2, trajectory=16, lstm_size=32,
                start_learning_rate=5e-3, end_learning_rate=5e-3,
                entropy_coef=0.01, baseline_loss_coef=0.5, learning_frame=10**9)
    base.update(kw)
    return base


def to_torch(tree, cls=None):
    if cls is None:
        return torch.from_numpy(np.array(tree))
    return cls(**{k: torch.from_numpy(np.array(v)) for k, v in tree._asdict().items()})


# A 5-way head aliased onto CartPole's 2 actions (`action % 2`).
CASE = dict(cfg=anakin_cfg(trajectory=8, num_actions=5), B=4)


def _twins():
    """(JAX loop, its state, the port loop, its state) from one start."""
    c = CASE
    jan = JaxAnakin(JaxAgent(JaxConfig(**c["cfg"])), num_envs=c["B"])
    # `jan.init`'s state, with its pieces compiled (op by op they take ~10 s).
    k_train, k_env, k_run = jax.random.split(jax.random.PRNGKey(1), 3)
    env, obs = jax.jit(cartpole_jax.reset, static_argnums=1)(k_env, c["B"])
    h, c0 = jan.agent.initial_lstm_state(c["B"])
    jst = JaxState(jax.jit(jan.agent.init_state)(k_train), env, obs,
                   jnp.zeros(c["B"], jnp.int32), h, c0, k_run)
    # Two carts near the 200-step cap: dones and resets inside the collect.
    jst = jst._replace(env=jst.env._replace(steps=jnp.asarray([197, 0, 192, 0], jnp.int32)))
    an = AnakinImpala(ImpalaAgent(ImpalaConfig(**c["cfg"]), device="cpu"), c["B"])
    st = an.init(0)
    st.train = an.agent.state_from_params(
        impala_params_from_jax(jax.tree.map(np.asarray, jst.train.params)))
    st.env, st.obs = to_torch(jst.env, cartpole_device.CartPoleState), to_torch(jst.obs)
    return jan, jst, an, st


def test_collect_and_learn_match_jax():
    c = CASE
    jan, jst, an, st = _twins()
    step = jax.jit(functools.partial(jan._env_step, jst.train.params))
    carry = (jst.env, jst.obs, jst.prev_action, jst.h, jst.c, jst.rng)
    recs, env_draws = [], []
    for _ in range(c["cfg"]["trajectory"]):
        _, _, k_env = jax.random.split(carry[-1], 3)  # `_env_step`'s own split
        env_draws.append(to_torch(cartpole_jax._fresh(k_env, c["B"])))
        carry, rec = step(carry, None)
        recs.append(jax.tree.map(np.asarray, rec))
    rec = {k: np.stack([r[k] for r in recs]) for k in recs[0]}  # [T, B, ...]
    actions = torch.from_numpy(rec["action"])

    batch, stats = an.collect(st, actions=actions, env_draws=env_draws)
    for name in batch._fields:
        got, want = getattr(batch, name), np.swapaxes(rec[name], 0, 1)
        assert got.is_contiguous() and got.shape == want.shape, name
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    # The carried state after T steps: env, obs, resets of prev_action, h, c.
    env, obs, prev_action, h, c_, _ = carry
    np.testing.assert_array_equal(st.prev_action.numpy(), np.asarray(prev_action))
    np.testing.assert_allclose(st.h.numpy(), np.asarray(h), rtol=0, atol=1e-6)
    np.testing.assert_allclose(st.c.numpy(), np.asarray(c_), rtol=0, atol=1e-6)
    np.testing.assert_allclose(st.obs.numpy().astype(np.float32), np.asarray(obs, np.float32),
                               rtol=0, atol=1e-6)
    assert float(stats["boundaries_done"]) == float(rec["done"].sum())
    assert float(stats["episode_return_sum"]) == pytest.approx(float(rec["episode_return"].sum()))
    assert rec["done"].any() and (rec["action"] >= 2).any()  # resets; aliased actions

    jbatch = JaxBatch(**{k: jnp.asarray(np.swapaxes(rec[k], 0, 1)) for k in JaxBatch._fields})
    _, jm = jax.jit(jan.agent._learn)(jst.train, jbatch)
    before = kvt.vtrace_cuda.launches
    st.train, m = an.agent.learn(st.train, batch)
    assert kvt.vtrace_cuda.launches == before  # CPU tensors: the plain version
    for k in ("pi_loss", "baseline_loss", "entropy", "total_loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)


def test_greedy_rollout_matches_jax_before_near_ties():
    jan, jst, an, st = _twins()
    params, n, steps, tol = jst.train.params, 6, 60, 1e-5
    k_reset, k_run = jax.random.split(jax.random.PRNGKey(5))
    env, obs = cartpole_jax.reset(k_reset, n)
    h, c = jan.agent.initial_lstm_state(n)
    pa = jnp.zeros(n, jnp.int32)
    apply = jax.jit(lambda o, a, h, c: jan.agent.model.apply(params, jan.agent._prep_obs(o), a, h, c))
    jpol, draws, jstep = [], [], jax.jit(cartpole_jax.step)
    for k in jax.random.split(k_run, steps):
        out = apply(obs, pa, h, c)
        action = jnp.argmax(out.policy, axis=-1).astype(jnp.int32)
        draws.append(to_torch(cartpole_jax._fresh(k, n)))
        env, obs, _r, done, _ep = jstep(env, jan._env_action(action), k)
        keep = (~done).astype(jnp.float32)[:, None]
        pa, h, c = jnp.where(done, 0, action), out.h * keep, out.c * keep
        jpol.append(np.asarray(out.policy))
    start = cartpole_device.reset(n, st.generator, fresh=to_torch(cartpole_jax._fresh(k_reset, n)))
    pol, actions, eps, completed = an.greedy_rollout(st.train.params, n, steps, env_draws=draws,
                                                     start=start)
    compared = 0
    for t, want in enumerate(jpol):
        np.testing.assert_allclose(pol[t].numpy(), want, rtol=0, atol=tol, err_msg=f"step {t}")
        np.testing.assert_array_equal(actions[t].numpy(), want.argmax(-1))
        compared += 1
        top2 = np.sort(want, axis=-1)[:, -2:]
        if (top2[:, 1] - top2[:, 0] <= tol).any():
            break  # a near-tie: the argmax may flip, the rollouts part
    assert compared >= 20
    ev = an.greedy_eval(st.train.params, 8, 120, seed=5)
    assert ev["episodes"] > 0 and 0 < ev["mean_return"] <= 200


def test_chunk_mechanics_and_guards():
    an = AnakinImpala(ImpalaAgent(ImpalaConfig(**anakin_cfg()), device="cpu"), num_envs=4)
    st = an.init(0)
    st, m = an.train_chunk(st, 3)
    assert st.train.step == 3
    assert m["total_loss"].shape == (3,) and torch.isfinite(m["total_loss"]).all()
    assert set(m) >= {"episode_return_sum", "episodes_done", "boundaries_done", "grad_norm"}
    st, _ = an.train_chunk(st, 3)
    assert st.train.step == 6
    with pytest.raises(ValueError, match="obs shape"):
        AnakinImpala(ImpalaAgent(ImpalaConfig(**anakin_cfg(obs_shape=(84, 84, 4))),
                                 device="cpu"), 4)
    with pytest.raises(ValueError, match="narrower"):
        AnakinImpala(ImpalaAgent(ImpalaConfig(**anakin_cfg(obs_shape=(84, 84, 4),
                                                           num_actions=3)), device="cpu"),
                     4, env=breakout_device)
    with pytest.raises(TypeError, match="RankMesh"):
        AnakinImpala(an.agent, 4, mesh=object())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_impala.main(["--config", str(CONFIG), "--section", "impala_cartpole",
                           "--mode", "anakin", "--updates", "1"])


def test_launcher_anakin_summary_and_resume(tmp_path, capsys):
    argv = ["--config", str(CONFIG), "--section", "impala_cartpole", "--mode", "anakin",
            "--device", "cpu", "--checkpoint_dir", str(tmp_path)]
    result = train_impala.main(argv + ["--updates", "2"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == {"frames", "chunk_mean_returns", "mean_return_last_chunk"}
    assert summary == result and result["frames"] == 2 * 16 * 16
    # A resume starts from the saved step and runs only the rest.
    result = train_impala.main(argv + ["--updates", "3"])
    assert result["frames"] == 3 * 16 * 16 and len(result["chunk_mean_returns"]) == 1
    with pytest.raises(ValueError, match="ring"):
        train_impala.main(argv + ["--updates", "1", "--anakin_capacity", "64"])
    with pytest.raises(ValueError, match="item 14"):
        train_ximpala.main(["--config", str(CONFIG), "--mode", "anakin", "--device", "cpu"])
    with pytest.raises(ValueError, match="unknown mode"):  # a launcher's mode, not a role
        run_role("impala", str(CONFIG), "impala_cartpole", "anakin", 0, device="cpu")


def test_learns_cartpole_on_device():
    """Twin of `tests/test_anakin.py:97`: late mean return above 60 after
    300 updates of 16 envs."""
    an = AnakinImpala(ImpalaAgent(ImpalaConfig(**anakin_cfg()), device="cpu"), num_envs=16)
    st = an.init(0)
    st, _ = an.train_chunk(st, 250)  # burn-in
    st, m = an.train_chunk(st, 50)  # the late window
    episodes = float(m["episodes_done"].sum())
    mean_return = float(m["episode_return_sum"].sum()) / max(episodes, 1.0)
    assert episodes > 0
    assert mean_return > 60, f"late mean return {mean_return}"


def test_r2d2_learns_cartpole_pomdp_on_device():
    """Twin of `tests/test_anakin_r2d2.py:126`: late mean return above 45."""
    cfg = R2D2Config(obs_shape=(2,), num_actions=2, seq_len=10, burn_in=5, lstm_size=32,
                     learning_rate=2e-3)
    an = AnakinR2D2(R2D2Agent(cfg, device="cpu"), num_envs=8, capacity=512, batch_size=32,
                    target_sync_interval=25, epsilon_floor=0.02,
                    obs_transform=cartpole_device.pomdp_project)
    st = an.init(0)
    st, _ = an.collect_chunk(st, 16)
    st, _ = an.train_chunk(st, 350)  # burn-in
    st, m = an.train_chunk(st, 50)  # the late window
    episodes = float(m["episodes_done"].sum())
    mean_return = float(m["episode_return_sum"].sum()) / max(episodes, 1.0)
    assert episodes > 0
    assert mean_return > 45, f"late mean return {mean_return}"
