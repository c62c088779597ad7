"""Ape-X DQN agent: double DQN on a dueling network, prioritized replay.

Counterpart of the JAX package's `agents/apex.py`:

- `act`: epsilon-greedy over the main net's Q-values, epsilon as data
  (a per-env tensor), drawn from an explicit `torch.Generator`.
- `td_error`: the priority of each transition, |target - Q(s, a)|.
- `learn`: one weighted double-DQN step, the loss
  `mean(td^2 * is_weight)`; Adam with a global-norm clip and the
  polynomial learning rate (`common.AdamWithClip`, optax's order). It
  returns fresh |TD| for the priority update.
- `grads` / `apply_grads`: the two halves of `learn` (the learner tier
  merges gradients between them).
- `sync_target`: main -> target copy, in place.

The main net runs over the stacked [s; s'] batch in one pass (one conv
pass over 2B frames); the target net over s'. Parameters are explicit
(dicts of tensors through `models.functional.functional_call`) and updated in
place. `learn_many`: K `learn` steps over a `[K, B, ...]` batch in one
call, with the K priority rows stacked (`common.learn_many`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from distributed_reinforcement_learning_tpu_torch.agents import common
from distributed_reinforcement_learning_tpu_torch.models.apex_net import (
    DuelingQNetwork, SimpleQNetwork)
from distributed_reinforcement_learning_tpu_torch.models.functional import functional_call
from distributed_reinforcement_learning_tpu_torch.ops import dqn
from distributed_reinforcement_learning_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ApexConfig:
    """Hyperparameters, mirroring the `apex` block of `config.json`."""

    obs_shape: tuple[int, ...] = (84, 84, 4)
    num_actions: int = 4
    discount_factor: float = 0.99
    reward_clipping: str = "abs_one"
    gradient_clip_norm: float = 40.0
    start_learning_rate: float = 1e-4
    end_learning_rate: float = 0.0
    learning_frame: int = 100_000_000_000_000
    # Fold /255 into conv0's kernel; uint8 frames feed the model raw.
    fold_normalize: bool = False


class ApexBatch(NamedTuple):
    """Flat transition batch. Name, field order and dtypes are the JAX
    package's, so a codec blob of one package decodes in the other."""

    state: Any  # [B, *obs]
    next_state: Any  # [B, *obs]
    previous_action: Any  # [B] i32 (embedding input for s)
    action: Any  # [B] i32 (taken at s; embedding input for s')
    reward: Any  # [B] f32
    done: Any  # [B] bool


class ApexAgent(common.ThreadLocalModelMixin):
    """Config + model + optimizer; `act`, `td_error` and `learn` on `device`."""

    def __init__(self, cfg: ApexConfig, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._init_models()
        self._schedule = common.polynomial_lr(
            cfg.start_learning_rate, cfg.end_learning_rate, cfg.learning_frame)
        self.tx = common.AdamWithClip(self._schedule, clip_norm=cfg.gradient_clip_norm)

    def _build_model(self, generator: torch.Generator | None):
        cfg = self.cfg
        if len(cfg.obs_shape) == 1:
            return SimpleQNetwork(cfg.num_actions, cfg.obs_shape[0], generator=generator)
        return DuelingQNetwork(cfg.num_actions, cfg.obs_shape,
                               fold_normalize=cfg.fold_normalize, generator=generator)

    # -- init ------------------------------------------------------------
    def init_state(self, seed: int = 0) -> common.TargetTrainState:
        """Fresh parameters drawn on the CPU from `seed` (the same numbers
        whatever the device), moved to the agent's device; the target
        network starts as a copy."""
        return self.state_from_params(
            self._build_model(torch.Generator().manual_seed(seed)).state_dict())

    def state_from_params(self, params: dict[str, torch.Tensor]) -> common.TargetTrainState:
        """A train state over a copy of `params` (for example a converted
        JAX checkpoint): target = params, fresh Adam moments, step 0."""
        own = {k: v.detach().to(self.device, torch.float32, copy=True).requires_grad_(True)
               for k, v in params.items()}
        target = {k: v.detach().clone() for k, v in own.items()}
        mu, nu = self.tx.init(own)
        return common.TargetTrainState(params=own, target_params=target, mu=mu, nu=nu)

    def sync_target(self, state: common.TargetTrainState) -> common.TargetTrainState:
        return state.sync_target()

    def _prep_obs(self, obs: torch.Tensor) -> torch.Tensor:
        """Normalise frames, or pass integer frames raw when the conv torso
        folds the /255 (`fold_normalize`)."""
        if (self.cfg.fold_normalize and len(self.cfg.obs_shape) == 3
                and not obs.dtype.is_floating_point):
            return obs
        return common.normalize_obs(obs)

    # -- act -------------------------------------------------------------
    @torch.no_grad()
    def act(self, params, obs: torch.Tensor, prev_action: torch.Tensor,
            epsilon: torch.Tensor | float, generator: torch.Generator):
        """Batched epsilon-greedy -> (action `[N]`, q `[N, A]`); a uniform
        random action where a draw is <= epsilon, else the argmax."""
        q = functional_call(self.model, params, (self._prep_obs(obs), prev_action.long()))
        return common.epsilon_greedy(q, epsilon, self.cfg.num_actions, generator), q

    # -- target math -----------------------------------------------------
    def _targets(self, params, target_params, batch: ApexBatch):
        """-> (double-DQN target value, Q(s, a)), each `[B]`."""
        cfg = self.cfg
        obs = self._prep_obs(batch.state)
        next_obs = self._prep_obs(batch.next_state)
        # One main-net pass over [s; s'].
        q_all = functional_call(self.model, params, (
            torch.cat([obs, next_obs]), torch.cat([batch.previous_action, batch.action])))
        B = batch.state.shape[0]
        main_q, next_main_q = q_all[:B], q_all[B:]
        with torch.no_grad():
            target_q = functional_call(self.model, target_params, (next_obs, batch.action))
        clipped_r = common.clip_rewards(batch.reward, cfg.reward_clipping)
        discounts = (~batch.done).to(torch.float32) * cfg.discount_factor
        target_value = dqn.double_q_target(next_main_q, target_q, clipped_r, discounts)
        return target_value, dqn.take_state_action_value(main_q, batch.action)

    def td_error(self, state: common.TargetTrainState, batch: ApexBatch) -> torch.Tensor:
        """|TD| `[B]` (device tensor) under the current main and target
        networks."""
        batch = common.batch_to_device(batch, self.device)
        with torch.no_grad():
            return dqn.td_error(*self._targets(state.params, state.target_params, batch))

    # -- learn -----------------------------------------------------------
    def grads(self, state: common.TargetTrainState, batch: ApexBatch, is_weight,
              reducer=None):
        """The gradient half of `learn` -> (grads by parameter name, |TD|,
        loss); nothing is updated. `reducer` (a
        `parallel/learner.MeshReducer`) makes it one rank's part of a
        step over a mesh: the gradients (this rank's slices) and the loss
        averaged across the data axis (the loss is a mean over rows),
        |TD| gathered to the global batch."""
        batch = common.batch_to_device(batch, self.device)
        is_weight = torch.as_tensor(is_weight, dtype=torch.float32).to(self.device)
        params, target = state.params, state.target_params
        if reducer is not None:
            params, target = reducer.gather(params), reducer.gather(target, grad=False)
        tv, sav = self._targets(params, target, batch)
        loss = torch.mean(torch.square(tv - sav) * is_weight)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
        td, loss = dqn.td_error(tv, sav).detach(), loss.detach()
        if reducer is not None:
            grads, reduced = reducer.reduce(grads, "mean", {"loss": loss})
            td, loss = reducer.gather_rows(td), reduced["loss"]
        return grads, td, loss

    def apply_grads(self, state: common.TargetTrainState, grads: dict[str, torch.Tensor],
                    loss: torch.Tensor, reducer=None):
        """The update half of `learn`: Adam in place -> (state, metrics).
        `learning_rate` is the schedule at the step being taken and
        `grad_norm` the norm before clipping, as in the JAX package; over
        a mesh (`reducer`) the norm of the whole reduced gradient."""
        g_norm = None if reducer is None else reducer.norm(grads)
        metrics = {"loss": loss, "grad_norm": self.tx.apply(state, grads, g_norm),
                   "learning_rate": self._schedule(state.step)}
        state.step += 1
        return state, metrics

    def learn(self, state: common.TargetTrainState, batch: ApexBatch, is_weight,
              reducer=None):
        """One Adam step in place -> (state, |TD| `[B]`, metrics); |TD| and
        the metrics are device tensors (no host sync)."""
        grads, td, loss = self.grads(state, batch, is_weight, reducer)
        state, metrics = self.apply_grads(state, grads, loss, reducer)
        return state, td, metrics

    def learn_many(self, state: common.TargetTrainState, batches: ApexBatch, is_weights):
        """K `learn` steps over `[K, B, ...]` batches -> (state, |TD|
        `[K, B]`, metrics stacked `[K]`), all device tensors."""
        return common.learn_many(self.learn, state, batches, is_weights, self.device)
