"""Evaluate a trained checkpoint: greedy(ish) episodes, no training.

Counterpart of the JAX package's `scripts/evaluate.py`. The reference has
no evaluation mode; this gives every algorithm family a standalone
rollout evaluator:

    python -m distributed_reinforcement_learning_tpu_torch.evaluate \\
        --section impala_cartpole --checkpoint_dir ckpts --episodes 20 [--device cpu]

It restores a `utils/checkpoint.py` checkpoint (`train_<algo>
--checkpoint_dir`, `train_local(..., checkpoint_dir=...)`) into
`make_agent`'s train state, publishes its parameters to a `WeightStore`
and runs the real actor of the family (same preprocessing, action
aliasing, POMDP projection, windowed transformer act) against a sink
queue, with the exploration schedule at its asymptote: the Q-family
actors' epsilon `1/(decay*episode+1)` is taken at episode 1e9 (epsilon
~0), and the actor-critic families act by their stochastic policy,
their on-policy evaluation regime. Prints one JSON line with return
statistics. The agent and its acts run on CUDA unless `--device` names
another device (`--platform cpu` is the JAX spelling).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from distributed_reinforcement_learning_tpu_torch.utils.device import add_device_arg


class _SinkQueue:
    """Queue surface the actors write to; evaluation discards trajectories."""

    capacity = 1 << 30

    def put(self, item, timeout=None):
        return True

    def put_many(self, items, timeout=None):
        return len(items)

    def size(self):
        return 0


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--config", default="config.json")
    p.add_argument("--section", default="impala_cartpole")
    p.add_argument("--checkpoint_dir", default=None,
                   help="restore the latest checkpoint (omit = random init)")
    p.add_argument("--episodes", type=int, default=20)
    p.add_argument("--max_unrolls", type=int, default=2000)
    p.add_argument("--seed", type=int, default=1234)
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    """Evaluate; -> the printed JSON object."""
    args = parse_args(argv)
    from distributed_reinforcement_learning_tpu_torch.runtime.launch import (
        algo_of, make_actor, make_agent)
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore
    from distributed_reinforcement_learning_tpu_torch.utils.config import load_config

    agent_cfg, rt = load_config(args.config, args.section)
    algo = algo_of(agent_cfg)
    agent = make_agent(algo, agent_cfg, device=args.device)
    state = agent.init_state(0)

    step = None
    if args.checkpoint_dir:
        from distributed_reinforcement_learning_tpu_torch.utils.checkpoint import Checkpointer

        got = Checkpointer(args.checkpoint_dir).restore(state)
        if got is None:
            raise SystemExit(f"no checkpoint found under {args.checkpoint_dir}")
        state, _, step = got

    weights = WeightStore()
    weights.publish(state.params, step or 0)

    actor = make_actor(algo, agent_cfg, rt, task=0, queue=_SinkQueue(),
                       weights=weights, seed=args.seed, agent=agent)
    if hasattr(actor, "_episodes"):
        # Q-family epsilon schedule at its asymptote: epsilon ~ 1e-9.
        actor._episodes = np.full_like(actor._episodes, 10**9)

    # Ape-X's actor surface is step-based; the others are unroll-based.
    advance = (actor.run_unroll if hasattr(actor, "run_unroll")
               else lambda: actor.run_steps(32))
    unrolls = 0
    while len(actor.episode_returns) < args.episodes and unrolls < args.max_unrolls:
        advance()
        unrolls += 1
    returns = np.asarray(actor.episode_returns[: args.episodes], np.float64)
    if returns.size == 0:
        raise SystemExit(
            f"no episodes completed in {unrolls} unrolls — raise --max_unrolls")
    out = {
        "section": args.section,
        "algorithm": algo,
        "checkpoint_step": step,
        "episodes": int(returns.size),
        "return_mean": round(float(returns.mean()), 2),
        "return_std": round(float(returns.std()), 2),
        "return_min": float(returns.min()),
        "return_max": float(returns.max()),
        "unrolls": unrolls,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
