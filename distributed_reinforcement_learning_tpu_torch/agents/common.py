"""Shared agent machinery: train states, optimizers, preprocessing, and
the sequence-replay learn step.

Counterpart of the JAX package's `agents/common.py`. The optimizers there
are optax chains; here they are written out by hand, because the stock
PyTorch pieces compute something else:

- `torch.optim.RMSprop` adds eps outside the square root and starts its
  mean-square state at zero; optax's `scale_by_rms(initial_scale=1.0)`
  (TF1 parity) adds eps inside the root and starts at ones.
- `torch.nn.utils.clip_grad_norm_` divides by `norm + 1e-6`; optax's
  `clip_by_global_norm` scales by `clip / norm` once `norm >= clip`.
- `torch.optim.Adam` computes optax's `scale_by_adam` in another order
  (it folds the bias corrections into the step size); `AdamWithClip`
  keeps optax's.

Parameters are updated in place (PyTorch idiom; the JAX state is
immutable). Whoever hands them to another thread must copy them first
(`runtime/weights.py` does).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Iterable

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.ops import dqn, value_rescale


@dataclasses.dataclass
class TrainState:
    """Learner state: parameters, RMSProp mean-square state, step count."""

    params: dict[str, torch.Tensor]  # leaf tensors that require grad
    nu: dict[str, torch.Tensor]
    step: int = 0


@dataclasses.dataclass
class TargetTrainState:
    """Learner state with a target network (R2D2): parameters, target
    parameters, Adam moments, step count."""

    params: dict[str, torch.Tensor]  # leaf tensors that require grad
    target_params: dict[str, torch.Tensor]
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    step: int = 0

    @torch.no_grad()
    def sync_target(self) -> "TargetTrainState":
        """Copy the parameters into the target network, in place."""
        for k, p in self.params.items():
            self.target_params[k].copy_(p)
        return self


class ThreadLocalModelMixin:
    """`model`: the structure-only (meta-device) module that the agent's
    calls run under explicit parameters, one per thread.
    `torch.func.functional_call` swaps a module's parameters in and out
    while it runs, so threads that share one agent (the learner and the
    actor threads of `run_async`, the pipelined actor's act worker) must
    not share the module. The host class provides `_build_model(None)`
    and calls `_init_models()` in its constructor."""

    def _init_models(self) -> None:
        self._models = threading.local()
        self.model  # noqa: B018 — build now, so a bad config raises here

    @property
    def model(self):
        model = getattr(self._models, "model", None)
        if model is None:
            model = self._models.model = self._build_model(None).to("meta")
        return model


def polynomial_lr(start: float, end: float, transition_steps: int) -> Callable[[int], float]:
    """Linear decay from `start` to `end` over `transition_steps`, as
    `tf.train.polynomial_decay` / optax's `polynomial_schedule` with
    power 1. `transition_steps` is clamped to int32 range, as in the JAX
    package (the apex config's `learning_frame=1e14` never ends)."""
    steps = min(int(transition_steps), 2**31 - 1)

    def schedule(step: int) -> float:
        frac = 1.0 - min(max(step, 0), steps) / steps
        return (start - end) * frac + end

    return schedule


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


class RMSPropWithClip:
    """IMPALA optimizer: global-norm clip -> RMSProp(decay, eps) -> lr.

    The update of each parameter `p` with gradient `g`, optax's order:

        g  <- g                      if |g| < clip else (g / |g|) * clip
        nu <- (1 - decay) * g^2 + decay * nu        (nu starts at ones)
        p  <- p + g * rsqrt(nu + eps) * (-lr(step))
    """

    def __init__(self, lr: Callable[[int], float], clip_norm: float,
                 decay: float = 0.99, eps: float = 0.1):
        self.lr = lr
        self.clip_norm = clip_norm
        self.decay = decay
        self.eps = eps

    def init(self, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return {k: torch.ones_like(p, requires_grad=False) for k, p in params.items()}

    @torch.no_grad()
    def apply(self, state: TrainState, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        """Update `state.params` and `state.nu` in place; -> the pre-clip
        global gradient norm. Leaves `state.step` to the caller."""
        g_norm = global_norm(grads.values())
        keep = g_norm < self.clip_norm
        lr = self.lr(state.step)
        for k, p in state.params.items():
            g = torch.where(keep, grads[k], grads[k] / g_norm * self.clip_norm)
            nu = (1.0 - self.decay) * torch.square(g) + self.decay * state.nu[k]
            state.nu[k].copy_(nu)
            p.add_(g * torch.rsqrt(nu + self.eps) * (-lr))
        return g_norm


class AdamWithClip:
    """Replay optimizer: optional global-norm clip -> Adam -> lr.

    optax's `chain(clip_by_global_norm, scale_by_adam, scale_by_learning_rate)`
    with b1 0.9, b2 0.999, eps 1e-8, eps_root 0; `clip_norm=None` is
    R2D2's plain Adam. `lr` is a constant (R2D2) or a schedule of the
    step (Ape-X's `polynomial_lr`). The update of each parameter at count
    n = step + 1:

        mu <- (1 - b1) * g + b1 * mu,   nu <- (1 - b2) * g^2 + b2 * nu
        p  <- p + (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps) * (-lr)

    with the bias corrections taken in float32, as optax takes them.
    """

    def __init__(self, lr: float | Callable[[int], float], clip_norm: float | None = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr = lr
        self.clip_norm = clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: dict[str, torch.Tensor]):
        """-> (mu, nu), both zeros."""
        zeros = lambda: {k: torch.zeros_like(p, requires_grad=False) for k, p in params.items()}
        return zeros(), zeros()

    @torch.no_grad()
    def apply(self, state: TargetTrainState, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        """Update `state.params`, `state.mu`, `state.nu` in place; -> the
        pre-clip global gradient norm. Leaves `state.step` to the caller."""
        g_norm = global_norm(grads.values())
        n = np.float32(state.step + 1)
        c1 = float(np.float32(1) - np.float32(self.b1) ** n)
        c2 = float(np.float32(1) - np.float32(self.b2) ** n)
        lr = self.lr(state.step) if callable(self.lr) else self.lr
        for k, p in state.params.items():
            g = grads[k]
            if self.clip_norm is not None:
                g = torch.where(g_norm < self.clip_norm, g, g / g_norm * self.clip_norm)
            mu = (1.0 - self.b1) * g + self.b1 * state.mu[k]
            nu = (1.0 - self.b2) * torch.square(g) + self.b2 * state.nu[k]
            state.mu[k].copy_(mu)
            state.nu[k].copy_(nu)
            p.add_(mu / c1 / (torch.sqrt(nu / c2) + self.eps) * (-lr))
        return g_norm


def epsilon_greedy(q_values: torch.Tensor, epsilon: torch.Tensor | float, num_actions: int,
                   generator: torch.Generator) -> torch.Tensor:
    """Batched epsilon-greedy over `[N, A]` Q-values: a uniform random
    action where a uniform draw is <= epsilon (per row), else the argmax.
    `generator` lies on the Q-values' device."""
    greedy = torch.argmax(q_values, dim=-1)
    explore = torch.rand(greedy.shape, generator=generator, device=q_values.device) <= epsilon
    random_action = torch.randint(0, num_actions, greedy.shape, generator=generator,
                                  device=q_values.device)
    return torch.where(explore, random_action, greedy)


def sequence_double_q_td(main_q, target_q, action, reward, discounts, *, burn_in: int,
                         rescale_eps: float):
    """R2D2 target math over full `[B, T, ...]` sequences -> (target
    value, Q(s, a)) over the supervised positions: burn-in slice, (t,
    t+1) alignment, double-Q action choice on the main net, value
    rescaling around the bootstrapped target (no gradient through it)."""
    b = burn_in
    main_b, target_b = main_q[:, b:], target_q[:, b:]
    reward_b, disc_b, action_b = reward[:, b:], discounts[:, b:], action[:, b:]

    sav = dqn.take_state_action_value(main_b[:, :-1], action_b[:, :-1])
    next_action = torch.argmax(main_b[:, 1:], dim=-1)
    next_sav = dqn.take_state_action_value(target_b[:, 1:], next_action)

    descaled = value_rescale.inverse_value_rescale(next_sav, rescale_eps)
    raw_target = (descaled * disc_b[:, :-1] + reward_b[:, :-1]).detach()
    return value_rescale.value_rescale(raw_target, rescale_eps), sav


class SequenceReplayLearnMixin:
    """td_error / loss / learn of the sequence-replay agents.

    The host class provides `cfg`, `tx` (an `AdamWithClip`) and
    `_sequence_td(params, target_params, batch)` -> (target value, Q(s, a)).
    Loss: IS-weighted mean over sequences of the mean over time of the
    squared TD. Priority: the reference's |mean_t TD| by default; with
    `cfg.priority_eta` the R2D2 paper's eta * max_t|TD| + (1 - eta) *
    mean_t|TD|.
    """

    def _seq_priority(self, tv: torch.Tensor, sav: torch.Tensor) -> torch.Tensor:
        delta = tv - sav
        eta = self.cfg.priority_eta
        if eta is None:
            return torch.abs(torch.mean(delta, dim=1))
        ad = torch.abs(delta)
        return eta * torch.amax(ad, dim=1) + (1.0 - eta) * torch.mean(ad, dim=1)

    @torch.no_grad()
    def _td_error(self, state: TargetTrainState, batch) -> torch.Tensor:
        return self._seq_priority(*self._sequence_td(state.params, state.target_params, batch))

    def _loss(self, params, target_params, batch, is_weight: torch.Tensor):
        tv, sav = self._sequence_td(params, target_params, batch)
        per_seq = torch.mean(torch.square(tv - sav), dim=1)
        loss = torch.mean(per_seq * is_weight)
        return loss, self._seq_priority(tv, sav).detach()

    def _learn(self, state: TargetTrainState, batch, is_weight: torch.Tensor):
        """One Adam step in place -> (state, priorities, metrics); the
        metrics are device tensors (no host sync)."""
        loss, priorities = self._loss(state.params, state.target_params, batch, is_weight)
        names = list(state.params)
        grads = torch.autograd.grad(loss, [state.params[k] for k in names])
        grad_norm = self.tx.apply(state, dict(zip(names, grads)))
        state.step += 1
        return state, priorities, {"loss": loss.detach(), "grad_norm": grad_norm}


def learn_many(learn, state, batches, is_weights, device: torch.device):
    """K prioritized learn steps in a row, one per row of `[K, B, ...]`
    batches and `[K, B]` IS weights (the JAX package's
    `scan_learn_weighted`) -> (state, priorities `[K, B]`, metrics
    stacked `[K]` each). `learn(state, batch, is_weight)` is the agent's
    one step on `device`. The K batches go to the device in one copy; the
    priorities stay a device tensor (the caller copies all K rows to the
    host at once). Every batch was sampled before any of the K updates."""
    batches = batch_to_device(batches, device)
    is_weights = torch.as_tensor(is_weights, dtype=torch.float32).to(device)
    k = len(is_weights)
    priorities, metrics = [], []
    for i in range(k):
        state, prio, m = learn(state, type(batches)(*(x[i] for x in batches)), is_weights[i])
        priorities.append(prio)
        metrics.append(m)
    stacked = {key: torch.stack([torch.as_tensor(m[key]) for m in metrics])
               for key in metrics[0]}
    return state, torch.stack(priorities), stacked


_INDEX_FIELDS = ("action", "previous_action")


def batch_to_device(batch, device: torch.device):
    """A batch NamedTuple of numpy arrays (or tensors) -> the same NamedTuple
    of tensors on `device`; the action fields as int64, the index type
    `gather` and `one_hot` take."""
    out = {}
    for name, x in batch._asdict().items():
        t = torch.as_tensor(x)
        if name in _INDEX_FIELDS:
            t = t.long()
        out[name] = t.to(device)
    return type(batch)(**out)


def clip_rewards(rewards: torch.Tensor, mode: str) -> torch.Tensor:
    """`abs_one`: clip to [-1, 1]; `soft_asymmetric`: 5*tanh(r/5), scaled
    by 0.3 for negative rewards; `none`: pass through."""
    if mode == "abs_one":
        return torch.clamp(rewards, -1.0, 1.0)
    if mode == "soft_asymmetric":
        squeezed = torch.tanh(rewards / 5.0)
        return torch.where(rewards < 0, 0.3 * squeezed, squeezed) * 5.0
    if mode == "none":
        return rewards
    raise ValueError(f"unknown reward_clipping mode: {mode!r}")


def normalize_obs(obs: torch.Tensor) -> torch.Tensor:
    """Integer frames -> float32 in [0, 1]; float observations cast through."""
    if obs.dtype.is_floating_point:
        return obs.to(torch.float32)
    return obs.to(torch.float32) * (1.0 / 255.0)
