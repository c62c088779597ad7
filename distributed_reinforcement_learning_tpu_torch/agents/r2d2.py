"""R2D2 agent: recurrent Q-learning with stored state, burn-in, rescaling.

Counterpart of the JAX package's `agents/r2d2.py`:

- Main and target nets unroll the whole sequence from the
  sequence-start stored state (h[0], c[0]), with done-masked resets
  inside the unroll (the LSTM kernels on the card).
- Burn-in: the first `burn_in` steps are sliced out of the loss, not the
  unroll; the gradient flows back through them.
- Double-Q over sequences with value rescaling on the target:
  target = h(h^-1(Q_target(s', a*)) * gamma + r).
- Loss: IS-weighted mean over time of the squared TD; priority |mean TD|
  per sequence (or the eta mixture, `priority_eta`).
- Optimizer: plain Adam(1e-4), no clipping unless `gradient_clip_norm`.

`act`, `td_error` and `learn` take parameters explicitly (dicts of
tensors through `torch.func.functional_call`), as the IMPALA agent does;
`learn_many` runs K `learn` steps in one call (`common.learn_many`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch.func import functional_call

from distributed_reinforcement_learning_tpu_torch.agents import common
from distributed_reinforcement_learning_tpu_torch.models.r2d2_net import R2D2Net
from distributed_reinforcement_learning_tpu_torch.ops.kernels.lstm import check_hidden_size
from distributed_reinforcement_learning_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class R2D2Config:
    """Hyperparameters, mirroring the `r2d2` block of `config.json`."""

    obs_shape: tuple[int, ...] = (2,)
    num_actions: int = 2
    seq_len: int = 10
    burn_in: int = 5
    lstm_size: int = 512
    discount_factor: float = 0.997
    learning_rate: float = 1e-4
    rescale_eps: float = 1e-3
    # None = the reference's |mean TD| sequence priority; a float (paper:
    # 0.9) = eta*max|TD| + (1-eta)*mean|TD|.
    priority_eta: float | None = None
    # None = the reference's plain unclipped Adam; a float adds a
    # global-norm clip in front.
    gradient_clip_norm: float | None = None
    # "mlp" = the reference's CartPole network; "nature" / "resnet" = conv
    # torsos for pixel envs.
    torso: str = "mlp"
    torso_width: int = 1
    # Fold /255 into conv0 (conv torsos): integer frames feed the model raw.
    fold_normalize: bool = False


class R2D2Batch(NamedTuple):
    """Sequence batch (numpy from the replay, tensors on the device inside
    the agent)."""

    state: Any  # [B, T, *obs] (int32-quantised x255 for CartPole-POMDP)
    previous_action: Any  # [B, T] int
    action: Any  # [B, T] int
    reward: Any  # [B, T] f32
    done: Any  # [B, T] bool
    initial_h: Any  # [B, H] sequence-start stored h
    initial_c: Any  # [B, H]


class R2D2Agent(common.SequenceReplayLearnMixin, common.ThreadLocalModelMixin):
    """Config + model + optimizer; `act`, `td_error` and `learn` on `device`."""

    def __init__(self, cfg: R2D2Config, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # The LSTM kernels' limit on H depends on the card: fail here,
            # before any launch.
            check_hidden_size(cfg.lstm_size,
                              torch.cuda.get_device_properties(self.device).multi_processor_count)
        # Structure only: every call runs it under explicit params.
        self._init_models()
        self.tx = common.AdamWithClip(cfg.learning_rate, clip_norm=cfg.gradient_clip_norm)

    def _build_model(self, generator: torch.Generator | None) -> R2D2Net:
        cfg = self.cfg
        return R2D2Net(cfg.num_actions, cfg.obs_shape, lstm_size=cfg.lstm_size,
                       torso=cfg.torso, torso_width=cfg.torso_width,
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

    def initial_lstm_state(self, batch_size: int) -> tuple[torch.Tensor, torch.Tensor]:
        z = torch.zeros(batch_size, self.cfg.lstm_size, device=self.device)
        return z, z.clone()

    def _prep_obs(self, obs: torch.Tensor) -> torch.Tensor:
        """Normalise frames, or pass integer frames raw when the conv torso
        folds the /255 (`fold_normalize`)."""
        if (self.cfg.fold_normalize and len(self.cfg.obs_shape) == 3
                and not obs.dtype.is_floating_point):
            return obs
        return common.normalize_obs(obs)

    # -- act -------------------------------------------------------------
    @torch.no_grad()
    def act(self, params, obs: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
            prev_action: torch.Tensor, epsilon: torch.Tensor | float,
            generator: torch.Generator):
        """Batched epsilon-greedy single step -> (action, q, h', c')."""
        q, new_h, new_c = functional_call(
            self.model, params, (self._prep_obs(obs), prev_action.long(), h, c))
        action = common.epsilon_greedy(q, epsilon, self.cfg.num_actions, generator)
        return action, q, new_h, new_c

    # -- sequence target math (SequenceReplayLearnMixin) -----------------
    def _sequence_td(self, params, target_params, batch: R2D2Batch):
        cfg = self.cfg
        obs = self._prep_obs(batch.state)
        args = (obs, batch.previous_action, batch.initial_h, batch.initial_c)
        main_q = functional_call(self.model, params, args, {"done": batch.done})
        with torch.no_grad():
            target_q = functional_call(self.model, target_params, args, {"done": batch.done})
        discounts = (~batch.done).to(torch.float32) * cfg.discount_factor
        return common.sequence_double_q_td(
            main_q, target_q, batch.action, batch.reward, discounts,
            burn_in=cfg.burn_in, rescale_eps=cfg.rescale_eps)

    def td_error(self, state: common.TargetTrainState, batch: R2D2Batch) -> torch.Tensor:
        """Per-sequence priorities `[B]` (device tensor) under the current
        main and target networks."""
        return self._td_error(state, common.batch_to_device(batch, self.device))

    def learn(self, state: common.TargetTrainState, batch: R2D2Batch, is_weight):
        """One Adam step in place -> (state, priorities `[B]`, metrics);
        priorities and metrics are device tensors (no host sync)."""
        batch = common.batch_to_device(batch, self.device)
        is_weight = torch.as_tensor(is_weight, dtype=torch.float32).to(self.device)
        return self._learn(state, batch, is_weight)

    def learn_many(self, state: common.TargetTrainState, batches: R2D2Batch, is_weights):
        """K `learn` steps over `[K, B, ...]` batches -> (state,
        priorities `[K, B]`, metrics stacked `[K]`), all device tensors;
        on CUDA each step runs the LSTM kernels."""
        return common.learn_many(self.learn, state, batches, is_weights, self.device)
