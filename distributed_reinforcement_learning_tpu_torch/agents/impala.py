"""IMPALA agent: V-trace actor-critic act and learn.

Counterpart of the JAX package's `agents/impala.py`:

- `act`: single-step policy/value and LSTM state advance, a sampled
  action per env (the actor hot path).
- `learn`: stored-state batched forward over `[B, T]`, double V-trace
  over the first/middle time views, sum-reduced losses, global-norm
  clip, RMSProp and a polynomial learning rate; `learn_many`: K such
  steps over a `[K, B, T, ...]` stack.

Loss math:
    vs, rho     = vtrace(first view; next_values = middle values)
    vs_plus_1   = vtrace(middle view; next_values = last values)
    pg_adv      = rho * (r_first + gamma_first * vs_plus_1 - V_first)
    total = pi_loss + c_v * baseline_loss + c_e * entropy_loss

Both `act` and `learn` take the parameters explicitly, as a dict of
tensors run through `models.functional.functional_call`, so actors act on the
snapshot they pulled while the learner updates its own tensors in place.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from distributed_reinforcement_learning_tpu_torch.agents import common
from distributed_reinforcement_learning_tpu_torch.models.functional import functional_call
from distributed_reinforcement_learning_tpu_torch.models.impala_net import (
    ImpalaActorCritic, apply_stored_state)
from distributed_reinforcement_learning_tpu_torch.ops import vtrace
from distributed_reinforcement_learning_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ImpalaConfig:
    """Hyperparameters, mirroring the `impala` block of `config.json`."""

    obs_shape: tuple[int, ...] = (84, 84, 4)
    num_actions: int = 18
    trajectory: int = 20
    lstm_size: int = 256
    discount_factor: float = 0.99
    baseline_loss_coef: float = 1.0
    entropy_coef: float = 0.05
    gradient_clip_norm: float = 40.0
    reward_clipping: str = "abs_one"
    start_learning_rate: float = 6e-4
    end_learning_rate: float = 0.0
    learning_frame: int = 1_000_000_000
    # Compute type of the torso, embedding and heads (the LSTM stays
    # float32); parameters, optimizer and losses stay float32.
    dtype: torch.dtype = torch.float32
    # Recompute the [B*T] stored-state forward in the backward pass
    # (`torch.utils.checkpoint`): about one more forward of work for not
    # holding the activations of B*T frames.
    remat: bool = False
    # Fold the /255 frame normalisation into conv0's kernel: integer
    # frames feed the model raw. No-op for vector observations.
    fold_normalize: bool = False
    # "nature" (reference parity) or "resnet" (the IMPALA paper's deep
    # torso with `torso_width`-multiplied channels).
    torso: str = "nature"
    torso_width: int = 1


class ImpalaBatch(NamedTuple):
    """One learner batch: `[B, T, ...]` unrolls (numpy from the queue,
    tensors on the learner's device inside `learn`)."""

    state: Any  # [B, T, *obs] uint8 (or float for vector envs)
    reward: Any  # [B, T] f32 raw rewards
    action: Any  # [B, T] int
    done: Any  # [B, T] bool
    behavior_policy: Any  # [B, T, A] f32 softmax at act time
    previous_action: Any  # [B, T] int
    initial_h: Any  # [B, T, H] actor-recorded per-step LSTM h
    initial_c: Any  # [B, T, H]


class ActOutput(NamedTuple):
    action: torch.Tensor
    policy: torch.Tensor
    h: torch.Tensor
    c: torch.Tensor


class ImpalaAgent(common.ThreadLocalModelMixin):
    """Config + model + optimizer; `act` and `learn` on `device`."""

    def __init__(self, cfg: ImpalaConfig, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # Structure only: act/learn always run it under explicit params.
        self._init_models()
        self._schedule = common.polynomial_lr(
            cfg.start_learning_rate, cfg.end_learning_rate, cfg.learning_frame)
        self.tx = common.RMSPropWithClip(self._schedule, cfg.gradient_clip_norm)

    def _build_model(self, generator: torch.Generator | None) -> ImpalaActorCritic:
        cfg = self.cfg
        return ImpalaActorCritic(
            num_actions=cfg.num_actions, obs_shape=cfg.obs_shape, lstm_size=cfg.lstm_size,
            fold_normalize=cfg.fold_normalize, torso=cfg.torso,
            torso_width=cfg.torso_width, generator=generator, dtype=cfg.dtype)

    # -- init ------------------------------------------------------------
    def init_state(self, seed: int = 0) -> common.TrainState:
        """Fresh parameters drawn on the CPU from `seed` (the same numbers
        whatever the device), then moved to the agent's device."""
        model = self._build_model(torch.Generator().manual_seed(seed))
        return self.state_from_params(model.state_dict())

    def state_from_params(self, params: dict[str, torch.Tensor]) -> common.TrainState:
        """A train state over a copy of `params` (for example a converted
        JAX checkpoint) with a fresh optimizer state at step 0."""
        own = {k: v.detach().to(self.device, torch.float32, copy=True).requires_grad_(True)
               for k, v in params.items()}
        return common.TrainState(params=own, nu=self.tx.init(own), step=0)

    def initial_lstm_state(self, batch_size: int) -> tuple[torch.Tensor, torch.Tensor]:
        z = torch.zeros(batch_size, self.cfg.lstm_size, device=self.device)
        return z, z.clone()

    def _prep_obs(self, obs: torch.Tensor) -> torch.Tensor:
        """Normalize frames, or pass integer frames raw when the model
        folds the /255 into conv0 (`fold_normalize`)."""
        if (self.cfg.fold_normalize and len(self.cfg.obs_shape) == 3
                and not obs.dtype.is_floating_point):
            return obs
        return common.normalize_obs(obs, self.cfg.dtype)

    # -- act -------------------------------------------------------------
    @torch.no_grad()
    def act(self, params: dict[str, torch.Tensor], obs: torch.Tensor,
            prev_action: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
            generator: torch.Generator) -> ActOutput:
        """Batched single-step act: sample from the softmax policy with
        `generator` (on the agent's device)."""
        out = functional_call(self.model, params, (self._prep_obs(obs), prev_action, h, c))
        action = torch.multinomial(out.policy, 1, generator=generator).squeeze(-1)
        return ActOutput(action, out.policy, out.h, out.c)

    # -- learn -----------------------------------------------------------
    def _forward(self, params: dict[str, torch.Tensor], batch: ImpalaBatch):
        """-> (policy [B, T, A], value [B, T]), each step seeded from its
        actor-recorded LSTM state. With `remat` (where autograd records)
        the forward runs under a non-reentrant checkpoint that takes the
        parameters as inputs: its recompute in the backward pass runs
        after `functional_call` has put the module's own tensors back."""
        args = (self._prep_obs(batch.state), batch.previous_action, batch.initial_h,
                batch.initial_c)
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return apply_stored_state(self.model, params, *args)
        names = list(params)

        def run(*tensors):
            return apply_stored_state(self.model, dict(zip(names, tensors[4:])), *tensors[:4])

        return checkpoint(run, *args, *(params[k] for k in names), use_reentrant=False)

    def loss(self, params: dict[str, torch.Tensor], batch: ImpalaBatch):
        """-> (total loss, metrics) for a batch of tensors on the device."""
        cfg = self.cfg
        # A third element is a model term added to the loss as it is (the
        # transformer's MoE load-balancing term).
        policy, value, *aux = self._forward(params, batch)

        clipped_r = common.clip_rewards(batch.reward, cfg.reward_clipping)
        discounts = (~batch.done).to(torch.float32) * cfg.discount_factor

        first_p, middle_p, _ = vtrace.split_data(policy)
        first_v, middle_v, last_v = vtrace.split_data(value)
        first_a, middle_a, _ = vtrace.split_data(batch.action)
        first_r, middle_r, _ = vtrace.split_data(clipped_r)
        first_d, middle_d, _ = vtrace.split_data(discounts)
        first_b, middle_b, _ = vtrace.split_data(batch.behavior_policy)

        vs, rho = vtrace.from_softmax(
            behavior_policy=first_b, target_policy=first_p, actions=first_a,
            discounts=first_d, rewards=first_r, values=first_v, next_values=middle_v)
        vs_plus_1, _ = vtrace.from_softmax(
            behavior_policy=middle_b, target_policy=middle_p, actions=middle_a,
            discounts=middle_d, rewards=middle_r, values=middle_v, next_values=last_v)

        pg_adv = (rho * (first_r + first_d * vs_plus_1 - first_v)).detach()

        pi_loss = vtrace.policy_gradient_loss(first_p, first_a, pg_adv)
        v_loss = vtrace.baseline_loss(vs, first_v)
        ent_loss = vtrace.entropy_loss(first_p)
        total = pi_loss + cfg.baseline_loss_coef * v_loss + cfg.entropy_coef * ent_loss
        if aux:
            total = total + aux[0]
        metrics = {
            "pi_loss": pi_loss.detach(),
            "baseline_loss": v_loss.detach(),
            "entropy": ent_loss.detach(),
            "total_loss": total.detach(),
        }
        return total, metrics

    def learn(self, state: common.TrainState, batch: ImpalaBatch, reducer=None):
        """One optimizer step, in place -> (state, metrics).

        `learning_rate` is the schedule at the step being taken (before
        the increment) and `grad_norm` the norm before clipping, as in the
        JAX package. Metric values are device tensors (no host sync).
        `reducer` (a `parallel/learner.MeshReducer`) makes it one rank's
        part of a step over a mesh: the losses are sums over the batch,
        so the gradients and the loss metrics are summed across the data
        axis before the clip."""
        batch = common.batch_to_device(batch, self.device)
        params = state.params if reducer is None else reducer.gather(state.params)
        total, metrics = self.loss(params, batch)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(total, [params[k] for k in names])))
        g_norm = None
        if reducer is not None:
            grads, metrics = reducer.reduce(grads, "sum", metrics)
            g_norm = reducer.norm(grads)
        metrics["grad_norm"] = self.tx.apply(state, grads, g_norm)
        metrics["learning_rate"] = self._schedule(state.step)
        state.step += 1
        return state, metrics

    def learn_many(self, state: common.TrainState, batches: ImpalaBatch, reducer=None):
        """K optimizer steps over a `[K, B, T, ...]` stack, in place ->
        (state, metrics stacked `[K]`): the JAX agent's
        `jit(scan_learn(_learn))`."""
        learn = self.learn if reducer is None else functools.partial(self.learn, reducer=reducer)
        return common.learn_many_unweighted(learn, state, batches, self.device)
