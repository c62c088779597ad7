"""CartPole-v0 as batched tensor functions: the on-device (Anakin) env.

Counterpart of the JAX package's `envs/cartpole_jax.py`. Same physics,
termination and auto-reset as the numpy `envs.cartpole.VectorCartPole`,
over `[N]` tensors on any device, so a whole collect-and-learn loop runs
on the card with no host step between env and agent.

Numerics: float32 physics (`cartpole_jax.py:11-13`), where the numpy env
integrates in float64. Drawing is apart from stepping: `draws(generator,
n)` makes the `[n, 4]` uniforms in [-0.05, 0.05) that restart the done
slots (drawn every step, used only where done), and `step` takes them, so
a test can feed the JAX env's own draws in.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from distributed_reinforcement_learning_tpu_torch.envs.cartpole import (
    _FORCE_MAG,
    _GRAVITY,
    _LENGTH,
    _MASSPOLE,
    _POLEMASS_LENGTH,
    _TAU,
    _THETA_LIMIT,
    _TOTAL_MASS,
    _X_LIMIT,
)

NUM_ACTIONS = 2
OBS_SHAPE = (4,)


class CartPoleState(NamedTuple):
    physics: torch.Tensor  # [N, 4] f32 (x, x_dot, theta, theta_dot)
    steps: torch.Tensor  # [N] i32 since episode start
    returns: torch.Tensor  # [N] f32 accumulated episode return


def draws(generator: torch.Generator, n: int) -> torch.Tensor:
    """The `[n, 4]` fresh-cart uniforms one step (or a reset) consumes."""
    u = torch.rand((n, 4), generator=generator, device=generator.device)
    return u * 0.1 - 0.05


def reset(num_envs: int, generator: torch.Generator,
          fresh: torch.Tensor | None = None) -> tuple[CartPoleState, torch.Tensor]:
    """-> (state, obs `[N, 4]`) from `fresh` (default: drawn)."""
    physics = draws(generator, num_envs) if fresh is None else fresh
    device = physics.device
    state = CartPoleState(
        physics=physics,
        steps=torch.zeros(num_envs, dtype=torch.int32, device=device),
        returns=torch.zeros(num_envs, dtype=torch.float32, device=device),
    )
    return state, physics


def step(state: CartPoleState, actions: torch.Tensor, fresh: torch.Tensor,
         max_steps: int = 200):
    """-> (state', obs', reward, done, episode_return).

    As `VectorCartPole.step`: `obs'` holds the reset observation in done
    slots, `episode_return` the completed return where done, else 0."""
    x, x_dot, theta, theta_dot = state.physics.unbind(-1)
    force = torch.where(actions == 1, _FORCE_MAG, -_FORCE_MAG).to(torch.float32)
    costheta, sintheta = torch.cos(theta), torch.sin(theta)
    temp = (force + _POLEMASS_LENGTH * theta_dot**2 * sintheta) / _TOTAL_MASS
    thetaacc = (_GRAVITY * sintheta - costheta * temp) / (
        _LENGTH * (4.0 / 3.0 - _MASSPOLE * costheta**2 / _TOTAL_MASS)
    )
    xacc = temp - _POLEMASS_LENGTH * thetaacc * costheta / _TOTAL_MASS
    physics = torch.stack(
        [x + _TAU * x_dot, x_dot + _TAU * xacc,
         theta + _TAU * theta_dot, theta_dot + _TAU * thetaacc], dim=-1)

    steps = state.steps + 1
    returns = state.returns + 1.0
    done = ((physics[:, 0].abs() > _X_LIMIT) | (physics[:, 2].abs() > _THETA_LIMIT)
            | (steps >= max_steps))
    episode_return = torch.where(done, returns, 0.0)
    new_state = CartPoleState(
        physics=torch.where(done[:, None], fresh, physics),
        steps=torch.where(done, 0, steps),
        returns=torch.where(done, 0.0, returns),
    )
    reward = torch.ones_like(returns)
    return new_state, new_state.physics, reward, done, episode_return


def completed_episode_mask(done: torch.Tensor, new_state: CartPoleState) -> torch.Tensor:
    """Every CartPole `done` ends an episode (no life-loss boundaries)."""
    del new_state
    return done


def pomdp_project(obs: torch.Tensor) -> torch.Tensor:
    """`envs.cartpole.pomdp_project` on tensors: position and pole angle,
    x255, truncated to int32 (the R2D2 sections' 2-feature view)."""
    return (obs[..., [0, 2]] * 255.0).to(torch.int32)
