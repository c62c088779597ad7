"""Q-value selection.

Counterpart of `take_state_action_value` in the JAX package's
`ops/dqn.py`: one gather over the trailing action axis serves flat
`[B, A]` and sequence `[B, T, A]` Q-values alike. (`double_q_target` and
`td_error` come with Ape-X.)
"""

from __future__ import annotations

import torch


def take_state_action_value(q_values: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """Q(s, a) over the trailing action axis: `[..., A]`, `[...]` -> `[...]`."""
    return torch.gather(q_values, -1, actions.long()[..., None])[..., 0]

