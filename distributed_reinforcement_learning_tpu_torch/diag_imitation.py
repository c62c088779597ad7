"""Diagnostic: can the IMPALA net FIT a competent Breakout policy at all?

Counterpart of the JAX package's `scripts/diag_imitation.py`. Given the
exact observation pipeline (`envs/breakout_device.py`'s 84x84x4 uint8
stacks) and the exact model (`models/impala_net.py`, one LSTM-cell step
from a zero state), can supervised cross-entropy on a scripted expert's
actions reach high accuracy?

- accuracy >> the action marginal: the representation path is fine; a
  plateau in RL is an RL-signal problem (exploration, credit
  assignment, scale).
- accuracy ~ the marginal: the obs/model path destroys the information.

The expert is the ball tracker on the device env's state (FIRE when the
ball is dead, else steer the paddle centre toward the ball). Its rollout
(`--envs` games x `--rollout` steps) stays on the device: `obs_t[t]` is
the observation after action `act_t[t]`, and the policy maps an
observation to the next action, so `obs_t[t]` pairs with `act_t[t+1]`.
Plain Adam at `--lr` then fits minibatches of `--batch` pairs drawn by
`np.random.default_rng(0)`. Prints one JSON line (`final_acc`: the last
step's minibatch accuracy before its update; `marginal_acc`: the
majority action's share). Runs on CUDA unless `--device` names another
device (`--platform cpu` is the JAX spelling).

    python -m distributed_reinforcement_learning_tpu_torch.diag_imitation \\
        [--steps 300] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.utils.device import add_device_arg


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    add_device_arg(p)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--envs", type=int, default=64)
    p.add_argument("--rollout", type=int, default=256, help="steps of expert rollout")
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-3)
    return p.parse_args(argv)


def tracker_actions(state) -> torch.Tensor:
    """The expert's `[N]` actions: FIRE (1) on a dead ball, else RIGHT (2)
    or LEFT (3) toward the ball beyond 2 px of the paddle centre, else
    NOOP (0)."""
    center = state.paddle_x + 8.0
    steer = torch.where(state.ball_x > center + 2.0, 2,
                        torch.where(state.ball_x < center - 2.0, 3, 0))
    return torch.where(state.ball_dead, 1, steer).to(torch.int32)


def expert_rollout(envs: int, rollout: int, generator: torch.Generator, draws=None):
    """-> (obs_t `[rollout, envs, 84, 84, 4]` u8, act_t `[rollout, envs]`
    int64) on `generator`'s device: the tracker's `rollout` steps from a
    reset, `obs_t[t]` the observation after `act_t[t]`. `draws(t)` gives
    step t's `[4, envs]` launch draws (default `breakout_device.draws`)."""
    from distributed_reinforcement_learning_tpu_torch.envs import breakout_device as bd

    state, _ = bd.reset(envs, generator)
    device = state.lives.device
    obs_t = torch.empty((rollout, envs, *bd.OBS_SHAPE), dtype=torch.uint8, device=device)
    act_t = torch.empty((rollout, envs), dtype=torch.int64, device=device)
    for t in range(rollout):
        a = tracker_actions(state)
        d = bd.draws(generator, envs) if draws is None else draws(t)
        state, obs, _, _, _ = bd.step(state, a, d)
        obs_t[t] = obs
        act_t[t] = a
    return obs_t, act_t


def expert_pairs(obs_t: torch.Tensor, act_t: torch.Tensor):
    """-> (X `[(T-1)*N, 84, 84, 4]`, Y `[(T-1)*N]`): each observation with
    the action taken after it, views of the rollout's tensors."""
    return obs_t[:-1].reshape(-1, *obs_t.shape[2:]), act_t[1:].reshape(-1)


def make_agent(device):
    """The IMPALA agent the diagnostic fits: Breakout frames, 4 actions,
    LSTM 256, float32, /255 folded into conv0."""
    from distributed_reinforcement_learning_tpu_torch.agents.impala import (
        ImpalaAgent, ImpalaConfig)
    from distributed_reinforcement_learning_tpu_torch.envs import breakout_device as bd

    cfg = ImpalaConfig(obs_shape=bd.OBS_SHAPE, num_actions=4, trajectory=20,
                       lstm_size=256, dtype=torch.float32, fold_normalize=True)
    return ImpalaAgent(cfg, device=device)


def ce_and_accuracy(agent, params: dict, xb: torch.Tensor, yb: torch.Tensor):
    """-> (cross-entropy, accuracy) of a one-step forward from a zero LSTM
    state and a zero previous action."""
    from distributed_reinforcement_learning_tpu_torch.models.functional import functional_call

    h0, c0 = agent.initial_lstm_state(xb.shape[0])
    pa0 = torch.zeros(xb.shape[0], dtype=torch.int64, device=xb.device)
    out = functional_call(agent.model, params, (agent._prep_obs(xb), pa0, h0, c0))
    logp = torch.log(out.policy + 1e-20)
    ce = -torch.take_along_dim(logp, yb[:, None], dim=-1).mean()
    acc = (torch.argmax(out.policy, -1) == yb).to(torch.float32).mean()
    return ce, acc


def adam_state(params: dict, lr: float):
    """-> (plain Adam, its state over a copy of `params`)."""
    from distributed_reinforcement_learning_tpu_torch.agents.common import AdamWithClip

    tx = AdamWithClip(lr, clip_norm=None)
    own = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    mu, nu = tx.init(own)
    return tx, SimpleNamespace(params=own, mu=mu, nu=nu, step=0)


def train_step(agent, tx, opt, xb: torch.Tensor, yb: torch.Tensor):
    """One Adam step on the minibatch, in place -> (ce, acc) before it."""
    ce, acc = ce_and_accuracy(agent, opt.params, xb, yb)
    names = list(opt.params)
    # A parameter the one-step forward never reads (the value head) gets a
    # zero gradient, as under jax.grad.
    grads = dict(zip(names, torch.autograd.grad(ce, [opt.params[k] for k in names],
                                                materialize_grads=True)))
    tx.apply(opt, grads)
    opt.step += 1
    return ce.detach(), acc


def main(argv: list[str] | None = None) -> dict:
    """Roll the expert out, fit it; -> the printed JSON object."""
    args = parse_args(argv)
    from distributed_reinforcement_learning_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    X, Y = expert_pairs(*expert_rollout(args.envs, args.rollout,
                                        torch.Generator(device).manual_seed(0)))
    counts = torch.bincount(Y, minlength=4).cpu().numpy()
    print(f"dataset {X.shape[0]} pairs; action marginal {counts / len(Y)}", file=sys.stderr)

    agent = make_agent(device)
    tx, opt = adam_state(agent.init_state(1).params, args.lr)
    nrng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.steps):
        idx = torch.as_tensor(nrng.integers(0, len(X), args.batch), device=device)
        ce, acc = train_step(agent, tx, opt, X[idx], Y[idx])
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i}: ce={float(ce):.4f} acc={float(acc):.3f}", file=sys.stderr)
    marginal_acc = float(counts.max() / len(Y))
    out = {
        "final_acc": round(float(acc), 4),
        "marginal_acc": round(marginal_acc, 4),
        "steps": args.steps,
        "pairs": int(X.shape[0]),
        "seconds": round(time.time() - t0, 1),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
