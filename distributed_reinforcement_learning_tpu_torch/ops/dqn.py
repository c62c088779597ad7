"""Q-value selection and the double-DQN target.

Counterpart of the JAX package's `ops/dqn.py`: one gather over the
trailing action axis serves flat `[B, A]` and sequence `[B, T, A]`
Q-values alike; the double-DQN target picks the next action with the
main net and evaluates it with the target net, with no gradient through
the target.
"""

from __future__ import annotations

import torch


def take_state_action_value(q_values: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """Q(s, a) over the trailing action axis: `[..., A]`, `[...]` -> `[...]`."""
    return torch.gather(q_values, -1, actions.long()[..., None])[..., 0]


def double_q_target(next_main_q: torch.Tensor, next_target_q: torch.Tensor,
                     rewards: torch.Tensor, discounts: torch.Tensor) -> torch.Tensor:
    """r + discount * Q_target(s', argmax_a Q_main(s', a)), detached. Ties
    go to the first maximal index, as `jnp.argmax` breaks them."""
    next_action = torch.argmax(next_main_q, dim=-1)
    next_value = take_state_action_value(next_target_q, next_action)
    return (rewards + discounts * next_value).detach()


def td_error(target_value: torch.Tensor, state_action_value: torch.Tensor) -> torch.Tensor:
    """|target - Q(s, a)|, the priority signal."""
    return torch.abs(target_value - state_action_value)
