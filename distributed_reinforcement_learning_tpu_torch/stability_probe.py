"""R2D2-family stability ablation harness.

Counterpart of the JAX package's `scripts/stability_probe.py`. Runs one
CartPole-POMDP training configuration (`r2d2` or `xformer` section of
the repo's `config.json`, through `runtime/launch.py:build_local`) and
reports the collapse-cycle statistics: the 50-episode rolling mean
sampled across the run, upward crossings of the "performing" threshold
(cycle count), the minimum of the rolling mean after first reaching
peak (collapse depth), and the late-20 mean. Every stabilizer knob is on
the command line. Prints one JSON line. Runs on CUDA unless `--device`
names another device (`--platform cpu` is the JAX spelling).

    python -m distributed_reinforcement_learning_tpu_torch.stability_probe \\
        --updates 2000 --seed 0 --priority-eta 0.9 --adam-clip 40 \\
        --epsilon-floor 0.02 --timeout-nonterminal --target-sync 100
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np

from distributed_reinforcement_learning_tpu_torch.utils.device import add_device_arg

CONFIG = Path(__file__).resolve().parent.parent / "config.json"


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--section", default="r2d2", choices=["r2d2", "xformer"])
    p.add_argument("--updates", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--priority-eta", type=float, default=None)
    p.add_argument("--adam-clip", type=float, default=None)
    p.add_argument("--epsilon-floor", type=float, default=None,
                   help="residual exploration floor; default keeps each "
                        "family's own (r2d2 0.0, xformer 0.15)")
    p.add_argument("--timeout-nonterminal", action="store_true")
    p.add_argument("--target-sync", type=int, default=None)
    p.add_argument("--replay-capacity", type=int, default=None)
    p.add_argument("--threshold", type=float, default=100.0,
                   help="rolling-mean level that counts as 'performing'")
    add_device_arg(p)
    return p.parse_args(argv)


def probe_stats(returns, threshold: float = 100.0) -> dict:
    """The collapse-cycle statistics of a run's episode returns: episodes,
    late20, best20 (20-episode windows every 10), upward crossings of
    `threshold` by the 50-episode rolling mean, its minimum after it
    first crossed, and the rolling mean at 40 evenly spaced points."""
    r = np.asarray(returns, float)
    roll = (np.convolve(r, np.ones(50) / 50, mode="valid")
            if r.size >= 50 else r)
    hi = roll > threshold
    upcrossings = int(((~hi[:-1]) & hi[1:]).sum()) if roll.size > 1 else 0
    first_hi = int(np.argmax(hi)) if hi.any() else None
    post_min = (round(float(roll[first_hi:].min()), 1)
                if first_hi is not None else None)
    return {
        "episodes": int(r.size),
        "late20": round(float(r[-20:].mean()), 2) if r.size else None,
        "best20": round(max(
            (float(r[i:i + 20].mean()) for i in range(0, max(1, r.size - 20), 10)),
            default=float("nan")), 2) if r.size >= 20 else None,
        "cycle_upcrossings": upcrossings,
        "min_roll_after_first_peak": post_min,
        "roll_curve": [round(float(roll[int(f * (roll.size - 1))]), 1)
                       for f in np.linspace(0, 1, 40)] if roll.size else [],
    }


def main(argv: list[str] | None = None) -> dict:
    """Train once with the knobs; -> the printed JSON object."""
    args = parse_args(argv)
    from distributed_reinforcement_learning_tpu_torch.runtime.launch import build_local
    from distributed_reinforcement_learning_tpu_torch.utils.config import load_config

    agent_cfg, rt = load_config(CONFIG, args.section)
    agent_over = {}
    if args.priority_eta is not None:
        agent_over["priority_eta"] = args.priority_eta
    if args.adam_clip is not None:
        agent_over["gradient_clip_norm"] = args.adam_clip
    if agent_over:
        agent_cfg = dataclasses.replace(agent_cfg, **agent_over)
    rt_over = {"timeout_nonterminal": args.timeout_nonterminal}
    if args.epsilon_floor is not None:
        rt_over["epsilon_floor"] = args.epsilon_floor
    if args.target_sync is not None:
        rt_over["target_sync_interval"] = args.target_sync
    if args.replay_capacity is not None:
        rt_over["replay_capacity"] = args.replay_capacity
    rt = dataclasses.replace(rt, **rt_over)

    learner, actors, run_fn = build_local(agent_cfg, rt, seed=args.seed, device=args.device)
    result = run_fn(learner, actors, args.updates)

    out = {"section": args.section, "updates": args.updates, "seed": args.seed,
           "knobs": {**agent_over, **rt_over},
           **probe_stats(result["episode_returns"], args.threshold)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
