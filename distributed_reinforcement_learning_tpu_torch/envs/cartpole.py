"""CartPole-v0 physics in numpy: single and vectorized variants, and the
POMDP view R2D2 trains on.

Copy of the JAX package's `envs/cartpole.py`: classic Barto-Sutton-Anderson
cart-pole with Euler integration, +1 reward per step, termination at
|x| > 2.4 or |theta| > 12deg, 200-step limit (v0).
"""

from __future__ import annotations

from typing import Any

import numpy as np

_GRAVITY = 9.8
_MASSCART = 1.0
_MASSPOLE = 0.1
_TOTAL_MASS = _MASSCART + _MASSPOLE
_LENGTH = 0.5  # half pole length
_POLEMASS_LENGTH = _MASSPOLE * _LENGTH
_FORCE_MAG = 10.0
_TAU = 0.02
_THETA_LIMIT = 12 * 2 * np.pi / 360
_X_LIMIT = 2.4


def _physics_step(state: np.ndarray, actions: np.ndarray) -> np.ndarray:
    """Euler-integrated cart-pole dynamics on `[N, 4]` states."""
    x, x_dot, theta, theta_dot = state.T
    force = np.where(actions == 1, _FORCE_MAG, -_FORCE_MAG)
    costheta = np.cos(theta)
    sintheta = np.sin(theta)
    temp = (force + _POLEMASS_LENGTH * theta_dot**2 * sintheta) / _TOTAL_MASS
    thetaacc = (_GRAVITY * sintheta - costheta * temp) / (
        _LENGTH * (4.0 / 3.0 - _MASSPOLE * costheta**2 / _TOTAL_MASS)
    )
    xacc = temp - _POLEMASS_LENGTH * thetaacc * costheta / _TOTAL_MASS
    return np.stack(
        [x + _TAU * x_dot, x_dot + _TAU * xacc, theta + _TAU * theta_dot, theta_dot + _TAU * thetaacc],
        axis=1,
    )


class CartPoleEnv:
    """Single CartPole-v0 with the gym step/reset contract."""

    num_actions = 2
    obs_shape = (4,)

    def __init__(self, seed: int | None = None, max_steps: int = 200):
        self._rng = np.random.RandomState(seed)
        self._max_steps = max_steps
        self._state = np.zeros(4, np.float64)
        self._steps = 0

    def reset(self) -> np.ndarray:
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._steps = 0
        return self._state.astype(np.float32)

    def step(self, action: int) -> tuple[np.ndarray, float, bool, dict[str, Any]]:
        self._state = _physics_step(self._state[None], np.asarray([action]))[0]
        self._steps += 1
        x, _, theta, _ = self._state
        failed = abs(x) > _X_LIMIT or abs(theta) > _THETA_LIMIT
        done = bool(failed or self._steps >= self._max_steps)
        # Time-limit truncation vs real termination (gymnasium semantics):
        # the cap ending an otherwise-alive episode is `truncated`.
        return (self._state.astype(np.float32), 1.0, done,
                {"truncated": bool(done and not failed)})


class VectorCartPole:
    """N independent CartPoles stepped in one numpy call, with auto-reset.

    step returns (obs `[N, 4]`, reward `[N]`, done `[N]`, infos). When an env
    terminates, `obs` already contains its *reset* observation and `done`
    is True for that slot — the batched-actor convention.
    """

    num_actions = 2
    obs_shape = (4,)

    def __init__(self, num_envs: int, seed: int = 0, max_steps: int = 200):
        self.num_envs = num_envs
        self._rng = np.random.RandomState(seed)
        self._max_steps = max_steps
        self._state = np.zeros((num_envs, 4), np.float64)
        self._steps = np.zeros(num_envs, np.int64)
        # Per-env episode returns, surfaced on done for score logging.
        self._returns = np.zeros(num_envs, np.float64)

    def reset(self) -> np.ndarray:
        self._state = self._rng.uniform(-0.05, 0.05, size=(self.num_envs, 4))
        self._steps[:] = 0
        self._returns[:] = 0
        return self._state.astype(np.float32)

    def step(self, actions: np.ndarray):
        self._state = _physics_step(self._state, np.asarray(actions))
        self._steps += 1
        self._returns += 1.0
        x = self._state[:, 0]
        theta = self._state[:, 2]
        failed = (np.abs(x) > _X_LIMIT) | (np.abs(theta) > _THETA_LIMIT)
        done = failed | (self._steps >= self._max_steps)
        truncated = done & ~failed  # time-limit cap, not a real terminal
        reward = np.ones(self.num_envs, np.float32)
        episode_returns = np.where(done, self._returns, 0.0)
        if done.any():
            idx = np.nonzero(done)[0]
            self._state[idx] = self._rng.uniform(-0.05, 0.05, size=(len(idx), 4))
            self._steps[idx] = 0
            self._returns[idx] = 0
        infos = {"episode_return": episode_returns, "done_mask": done.copy(),
                 "truncated": truncated}
        return self._state.astype(np.float32), reward, done, infos


def pomdp_project(obs: np.ndarray) -> np.ndarray:
    """CartPole POMDP view: keep position and pole angle only, scaled x255
    and cast to int32 (the reference's transport convention; the /255 is
    undone at the model input)."""
    return (obs[..., [0, 2]] * 255.0).astype(np.int32)
