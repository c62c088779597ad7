"""Greedy-eval a checkpointed on-device replay-family run (Ape-X/R2D2).

Counterpart of the JAX package's `scripts/eval_anakin_replay.py`. The
behaviour returns of the Anakin replay loops keep the epsilon ladder's
exploration in the score; this answers "how good is the POLICY":
argmax-Q rollouts on fresh device envs from a saved train state (written
by `train_apex` / `train_r2d2 --mode anakin --checkpoint_dir`), the
metric `AnakinImpala.greedy_eval` gives the IMPALA runs.

    python -m distributed_reinforcement_learning_tpu_torch.eval_anakin_replay --algo apex \\
        --config runs/apex_pong_config.json --section apex \\
        --checkpoint_dir runs/apex_pong_ckpt --eval-envs 32 --eval-steps 3000 --seeds 3

Prints one JSON line: per-seed mean returns and the mean pooled by
episode. Runs on CUDA unless `--device` names another device
(`--platform cpu` is the JAX spelling).
"""

from __future__ import annotations

import argparse
import json
import sys

from distributed_reinforcement_learning_tpu_torch.utils.device import add_device_arg


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--algo", required=True, choices=["apex", "r2d2"])
    p.add_argument("--config", required=True)
    p.add_argument("--section", required=True)
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--eval-envs", type=int, default=32)
    p.add_argument("--eval-steps", type=int, default=3000)
    p.add_argument("--seeds", type=int, default=3,
                   help="independent eval rollout batches")
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    """Evaluate; -> the printed JSON object."""
    args = parse_args(argv)
    from distributed_reinforcement_learning_tpu_torch.runtime import launch

    agent_cfg, rt = launch.load_config(args.config, args.section)
    env_mod, obs_transform = launch._device_env_for(agent_cfg, rt)
    n = rt.num_actors * rt.envs_per_actor
    if args.algo == "apex":
        from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexAgent
        from distributed_reinforcement_learning_tpu_torch.runtime.anakin_apex import AnakinApex

        agent = ApexAgent(agent_cfg, device=args.device)
        steps = 16
        anakin = AnakinApex(agent, num_envs=n, batch_size=rt.batch_size,
                            capacity=n * steps, steps_per_collect=steps,
                            env=env_mod, obs_transform=obs_transform)
    else:
        from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Agent
        from distributed_reinforcement_learning_tpu_torch.runtime.anakin_r2d2 import AnakinR2D2

        agent = R2D2Agent(agent_cfg, device=args.device)
        anakin = AnakinR2D2(agent, num_envs=n, batch_size=rt.batch_size,
                            capacity=n, env=env_mod, obs_transform=obs_transform)

    _ckpt, train = launch._restore_train(args.checkpoint_dir, agent.init_state(0))
    step = int(train.step)
    if step == 0:
        print("[eval] WARNING: checkpoint restore found step=0 — evaluating "
              "fresh params?", file=sys.stderr)

    per_seed = []
    episodes = 0
    return_sum = 0.0
    for s in range(args.seeds):
        out = anakin.greedy_eval(train.params, args.eval_envs, args.eval_steps, 1000 + s)
        per_seed.append(round(out["mean_return"], 2))
        episodes += out["episodes"]
        return_sum += out["mean_return"] * out["episodes"]
        print(f"[eval] seed {s}: mean_return {out['mean_return']:.2f} "
              f"({out['episodes']} episodes)", file=sys.stderr)
    # Pool by EPISODE (a short-budget seed with few completed games must
    # not get equal weight with a full one).
    pooled = return_sum / max(episodes, 1)
    result = {
        "algo": args.algo, "section": args.section, "train_step": step,
        "greedy_mean_return": round(pooled, 2), "per_seed": per_seed,
        "episodes": episodes, "eval_envs": args.eval_envs,
        "eval_steps": args.eval_steps,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
