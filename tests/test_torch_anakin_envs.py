"""The port's on-device envs (`envs/*_device.py`) against their JAX twins.

Each env steps from the same state with the same actions and with the
JAX env's own random draws fed in (the JAX step draws from its key; the
port's step takes the draws as an input, made here from that key by the
same calls). Over 40-60 steps that include life losses, auto-resets and
game overs: frames, stacks, rewards, dones and episode returns equal,
integer and boolean state equal, float state within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.envs import breakout_jax, cartpole_jax
from distributed_reinforcement_learning_tpu.envs import invaders_jax, pixel_jax, pong_jax
from distributed_reinforcement_learning_tpu.envs import pong_sim as jax_pong_sim
from distributed_reinforcement_learning_tpu_torch.envs import (
    breakout_device, cartpole_device, invaders_device, pixel_device, pong_device)
from distributed_reinforcement_learning_tpu_torch.envs.cartpole import pomdp_project

N = 4


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


def to_torch(jax_state, cls):
    return cls(**{k: torch.from_numpy(np.array(v)) for k, v in jax_state._asdict().items()})


def assert_state_equal(got, want, where):
    for name, w in want._asdict().items():
        g = getattr(got, name).numpy()
        w = np.asarray(w)
        assert g.shape == w.shape, (where, name)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=f"{where} {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{where} {name}")


def run_pair(jax_mod, jax_step, jax_draws, torch_mod, torch_step, jstate, tstate, steps, seed):
    """Step both envs `steps` times with the same actions and draws,
    holding every output, the state and the completed-episode mask equal;
    -> counts of dones, completed games, nonzero rewards and returns seen."""
    rng = np.random.RandomState(seed)
    key = jax.random.PRNGKey(seed)
    seen = {"done": 0, "reward": 0, "ep": 0, "completed": 0}
    num_actions = torch_mod.NUM_ACTIONS
    jax_mask = jax.jit(jax_mod.completed_episode_mask)
    for t in range(steps):
        key, k = jax.random.split(key)
        actions = rng.randint(0, num_actions, N).astype(np.int32)
        jstate, jobs, jr, jd, jep = jax_step(jstate, jnp.asarray(actions), k)
        tstate, tobs, tr, td, tep = torch_step(tstate, torch.from_numpy(actions), jax_draws(k))
        where = f"step {t}"
        if tobs.dtype.is_floating_point:  # cartpole: float32 physics
            np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=0, atol=1e-6,
                                       err_msg=where)
        else:
            np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs), err_msg=where)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr), err_msg=where)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=where)
        np.testing.assert_array_equal(tep.numpy(), np.asarray(jep), err_msg=where)
        assert_state_equal(tstate, jstate, where)
        completed = torch_mod.completed_episode_mask(td, tstate).numpy()
        np.testing.assert_array_equal(
            completed, np.asarray(jax_mask(jd, jstate)), err_msg=where)
        seen["completed"] += int(completed.sum())
        seen["done"] += int(np.asarray(jd).sum())
        seen["reward"] += int((np.asarray(jr) != 0).sum())
        seen["ep"] += int((np.asarray(jep) != 0).sum())
    return seen


def test_cartpole_matches_jax_with_its_draws():
    jstate, jobs = cartpole_jax.reset(jax.random.PRNGKey(3), N)
    tstate = to_torch(jstate, cartpole_device.CartPoleState)
    fresh = jax.jit(cartpole_jax._fresh, static_argnums=1)
    seen = run_pair(cartpole_jax, jax.jit(cartpole_jax.step),
                    lambda k: torch.from_numpy(np.array(fresh(k, N))),
                    cartpole_device, cartpole_device.step, jstate, tstate, 60, seed=0)
    assert seen["done"] >= N  # every env ended an episode at least once
    gen = torch.Generator().manual_seed(0)
    state, obs = cartpole_device.reset(N, gen)
    assert obs.dtype == torch.float32 and obs.shape == (N, 4)
    assert float(obs.abs().max()) <= 0.05
    assert cartpole_device.draws(gen, N).shape == (N, 4)


def test_cartpole_episode_cap_and_pomdp_view():
    state = cartpole_device.CartPoleState(
        physics=torch.zeros(1, 4), steps=torch.tensor([199], dtype=torch.int32),
        returns=torch.tensor([199.0]))
    _, _, _, done, ep = cartpole_device.step(state, torch.zeros(1, dtype=torch.int64),
                                             torch.zeros(1, 4))
    assert bool(done[0]) and float(ep[0]) == 200.0
    obs = np.random.RandomState(1).uniform(-1, 1, (5, 4)).astype(np.float32)
    np.testing.assert_array_equal(cartpole_device.pomdp_project(torch.from_numpy(obs)).numpy(),
                                  pomdp_project(obs))


def test_preprocess_matches_jax_frames():
    """Luma, the area resize, crop and uint8: equal to the JAX pipeline on
    the reset frames of all three games and on random frames."""
    gen = torch.Generator().manual_seed(0)
    frames = [mod.reset(2, gen)[0].prev_raw
              for mod in (breakout_device, pong_device, invaders_device)]
    frames.append(torch.randint(0, 256, (2, 210, 160, 3), generator=gen, dtype=torch.uint8))
    frames = torch.cat(frames)
    want = np.asarray(jax.vmap(pixel_jax.preprocess)(jnp.asarray(frames.numpy())))
    np.testing.assert_array_equal(pixel_device.preprocess(frames).numpy(), want)
    np.testing.assert_array_equal(pixel_device.reset_stack(frames).numpy(),
                                  np.asarray(pixel_jax.reset_stack(jnp.asarray(frames.numpy()))))


@jax.jit
def _breakout_draws(k):
    return jax.random.randint(k, (4, N), 0, 4)


def _breakout_start():
    jstate, _ = breakout_jax.reset(jax.random.PRNGKey(0), N)
    # Fewer lives in some games so that 60 steps see game overs too.
    return jstate._replace(lives=jnp.asarray([1, 2, 5, 1], jnp.int32))


def test_breakout_matches_jax_with_its_draws():
    jstate = _breakout_start()
    tstate = to_torch(jstate, breakout_device.BreakoutState)
    seen = run_pair(breakout_jax, breakout_jax.step,
                    lambda k: torch.from_numpy(np.array(_breakout_draws(k))),
                    breakout_device, breakout_device.step, jstate, tstate, 50, seed=1)
    # Life losses that end no game, and games that end.
    assert seen["done"] > seen["completed"] > 0 and seen["ep"] > 0
    gen = torch.Generator().manual_seed(0)
    state, obs = breakout_device.reset(N, gen)
    jreset, jobs = breakout_jax.reset(jax.random.PRNGKey(0), N)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    assert_state_equal(state, jreset, "reset")


def test_breakout_life_loss_flag():
    """Without `life_loss` a lost life is neither a `done` nor a -1: the
    same steps give the game-over dones and the raw rewards (the JAX
    env's flag, held against its own run above)."""
    gen = torch.Generator().manual_seed(1)
    start = to_torch(_breakout_start(), breakout_device.BreakoutState)
    shaped, raw = start, start
    lost = 0
    for _ in range(60):
        actions = torch.randint(0, 4, (N,), generator=gen)
        draws = breakout_device.draws(gen, N)
        shaped, _, r1, d1, _ = breakout_device.step(shaped, actions, draws)
        raw, _, r0, d0, _ = breakout_device.step(raw, actions, draws, life_loss=False)
        over = breakout_device.completed_episode_mask(d1, shaped)
        assert torch.equal(d0, over)
        life = d1 & ~over
        assert torch.equal(r1, torch.where(life, -1.0, r0))
        lost += int(life.sum())
    assert lost > 0


@jax.jit
def _jax_pong_draws(k):
    k_y, k_vy = jax.random.split(k)
    y = jax.random.randint(k_y, (4, N), jax_pong_sim.FIELD_TOP + 20, jax_pong_sim.FIELD_BOT - 20)
    return y, jax.random.randint(k_vy, (4, N), 0, 4)


def _pong_draws(k):
    return tuple(torch.from_numpy(np.array(d)) for d in _jax_pong_draws(k))


def test_pong_matches_jax_with_its_draws():
    jstate, _ = pong_jax.reset(jax.random.PRNGKey(0), N)
    # One point from the end in some games, so that games end and reset.
    jstate = jstate._replace(enemy_score=jnp.asarray([20, 0, 20, 5], jnp.int32),
                             player_score=jnp.asarray([0, 20, 3, 20], jnp.int32))
    tstate = to_torch(jstate, pong_device.PongState)
    seen = run_pair(pong_jax, pong_jax.step, _pong_draws, pong_device, pong_device.step,
                    jstate, tstate, 50, seed=3)
    assert seen["done"] > 0 and seen["reward"] > 0
    gen = torch.Generator().manual_seed(0)
    y, idx = pong_device.draws(gen, N)
    assert y.shape == idx.shape == (4, N)
    assert int(y.min()) >= jax_pong_sim.FIELD_TOP + 20 and int(y.max()) < jax_pong_sim.FIELD_BOT - 20


@jax.jit
def _jax_invaders_draws(k):
    k_spawn, k_col = jax.random.split(k)
    return jax.random.uniform(k_spawn, (4, N)), jax.random.uniform(k_col, (4, N))


def _invaders_draws(k):
    return tuple(torch.from_numpy(np.array(d)) for d in _jax_invaders_draws(k))


def test_invaders_matches_jax_with_its_draws():
    jstate, _ = invaders_jax.reset(jax.random.PRNGKey(0), N)
    jstate = jstate._replace(
        lives=jnp.asarray([1, 3, 1, 2], jnp.int32),
        frames=jnp.asarray([0, 9_880, 0, 0], jnp.int32),
        # A thinned grid: march speed-up, empty columns and a wave clear.
        aliens=jstate.aliens.at[3].set(False).at[3, 5, 2].set(True).at[2, :, 0].set(False),
        # A bomb just above game 3's cannon: a life lost that ends no game.
        bomb_live=jstate.bomb_live.at[3, 0].set(True),
        bomb_x=jstate.bomb_x.at[3, 0].set(78.0), bomb_y=jstate.bomb_y.at[3, 0].set(175.0))
    tstate = to_torch(jstate, invaders_device.InvadersState)
    seen = run_pair(invaders_jax, invaders_jax.step, _invaders_draws, invaders_device,
                    invaders_device.step, jstate, tstate, 40, seed=4)
    assert seen["done"] > seen["completed"] > 0 and seen["reward"] > 0
