"""Transformer-IMPALA agent: V-trace actor-critic on the causal
transformer trunk.

Counterpart of the JAX package's `agents/ximpala.py`: IMPALA's loss
(`agents/impala.py`: double V-trace over the first/middle views,
sum-reduced losses, RMSProp + polynomial learning rate + global-norm
clip) over `TransformerQNet(head="actor_critic")`. The unroll is its own
context: there is no stored state, and one `[B, T]` forward with
episode-segment masking stands in for done-masked state resets.

- `act` samples from the softmax at the final position of each env's
  window of the current unroll's steps (the behavior policy).
- `loss` builds the attention segments from `env_done` (true episode
  ends) and the V-trace discounts from `done` (recorded, possibly
  life-loss shaped), and adds the MoE routers' load-balancing term
  (`moe_aux_weight` x the sum over layers) when `num_experts > 0`.

Parameters are explicit tensors run through `models.functional.functional_call`
on a meta-device model, as in `agents/impala.py`. On CUDA tensors every
attention call with T divisible by a power-of-two block of at least 8
runs the flash kernels K3a (forward), K3b and K3c (backward).

With `mesh=` the learn step is one rank's part of a step sharded as the
config's body knobs say (`agents/xformer.build_transformer_models`:
sequence, pipeline, experts); `act` runs the plain-apply twin.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from distributed_reinforcement_learning_tpu_torch.agents import common
from distributed_reinforcement_learning_tpu_torch.agents.impala import ImpalaAgent
from distributed_reinforcement_learning_tpu_torch.agents.xformer import (
    TwinModelMixin, build_transformer_models, init_transformer_params, moe_aux_term)
from distributed_reinforcement_learning_tpu_torch.models.functional import functional_call


@dataclasses.dataclass(frozen=True)
class XImpalaConfig:
    """IMPALA hyperparameters + transformer body knobs, mirroring the
    `ximpala` block of `config.json`; the body knobs are `XformerConfig`'s."""

    obs_shape: tuple[int, ...] = (2,)
    num_actions: int = 2
    trajectory: int = 20  # unroll length == acting window
    d_model: int = 256
    num_heads: int = 4
    num_layers: int = 2
    discount_factor: float = 0.99
    baseline_loss_coef: float = 1.0
    entropy_coef: float = 0.05
    gradient_clip_norm: float = 40.0
    reward_clipping: str = "abs_one"
    start_learning_rate: float = 6e-4
    end_learning_rate: float = 0.0
    learning_frame: int = 1_000_000_000
    attention: str = "dense"
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 1e-2
    pipeline: bool = False
    pipeline_microbatches: int = 2
    pipeline_stages: int = 0
    stacked: bool = False
    remat: bool = False


class XImpalaBatch(NamedTuple):
    """One learner batch of `[B, T, ...]` unrolls: the IMPALA payload
    minus the stored (h, c). `done` (recorded, possibly shaped) gates the
    V-trace discounts; `env_done` (true episode ends) gates the attention
    segments."""

    state: Any  # [B, T, *obs]
    reward: Any  # [B, T] f32 raw rewards
    action: Any  # [B, T] int
    done: Any  # [B, T] bool recorded (shaped) flags -> discounts
    env_done: Any  # [B, T] bool true episode ends -> attention segments
    behavior_policy: Any  # [B, T, A] f32 softmax at act time
    previous_action: Any  # [B, T] int


class XImpalaActOutput(NamedTuple):
    action: torch.Tensor  # [N]
    policy: torch.Tensor  # [N, A] window-final softmax (the behavior policy)


class XImpalaAgent(TwinModelMixin, ImpalaAgent):
    """`ImpalaAgent` (its loss, `learn` and optimizer) with the transformer
    as the model, so the IMPALA learner runs it; only the forward, the
    model and `act` differ."""

    loss_reduction = "sum"

    def __init__(self, cfg: XImpalaConfig, device: str | torch.device | None = None,
                 mesh=None):
        self.mesh = mesh
        super().__init__(cfg, device)
        self.twin  # noqa: B018 — build now, so a bad config raises here

    def _build_models(self, generator: torch.Generator | None):
        return build_transformer_models(self.cfg, self.mesh, seq_len=self.cfg.trajectory,
                                        head="actor_critic", generator=generator)

    def init_state(self, seed: int = 0) -> common.TrainState:
        """Fresh parameters drawn on the CPU from `seed` (the same numbers
        whatever the device), then moved to the agent's device."""
        return self.state_from_params(init_transformer_params(
            self.cfg, seq_len=self.cfg.trajectory, seed=seed, head="actor_critic"))

    @torch.inference_mode()
    def act(self, params: dict[str, torch.Tensor], obs_win: torch.Tensor,
            prev_action_win: torch.Tensor, done_win: torch.Tensor,
            generator: torch.Generator) -> XImpalaActOutput:
        """Sample from the window-final softmax policy with `generator`
        (on the agent's device). Windows are `[N, W, ...]`."""
        policy, _ = functional_call(
            self.twin, params, (common.normalize_obs(obs_win), prev_action_win, done_win))
        policy = policy[:, -1]
        action = torch.multinomial(policy, 1, generator=generator).squeeze(-1)
        return XImpalaActOutput(action, policy)

    def _forward(self, params: dict[str, torch.Tensor], batch: XImpalaBatch):
        """-> (policy, value) of one `[B, T]` forward, and the MoE aux term
        third when `num_experts > 0`. Attention segments come from
        env_done, not the shaped done: the context follows true episode
        boundaries (see XImpalaBatch)."""
        args = (common.normalize_obs(batch.state), batch.previous_action, batch.env_done)
        if not self.cfg.num_experts:
            return functional_call(self.model, params, args)
        (policy, value), aux = functional_call(self.model, params, args, {"return_aux": True})
        return policy, value, self.aux_share(moe_aux_term(self.cfg, aux))
