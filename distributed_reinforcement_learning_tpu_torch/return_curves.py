"""Long-horizon return-curve artifacts.

Counterpart of the JAX package's `scripts/return_curves.py`. Runs each
algorithm family for >=2k updates (CartPole, the POMDP CartPole of the
replay families, the Breakout and Pong simulators) and writes its
per-episode return curve as JSONL under `runs/curves/` (the JAX script
writes `benchmarks/curves/`, where the port writes nothing), with a
summary table:

    python -m distributed_reinforcement_learning_tpu_torch.return_curves \\
        [--families a,b,...] [--updates-scale 1.0] [--seed 0] [--device cpu]

One JSONL per family: first line = meta (config, updates, wall seconds,
summary stats), then {"episode": i, "return": r} lines. `--seed k != 0`
names the files `<family>_seed<k>`; a scaled run (`--updates-scale` other
than 1) is a smoke check, suffixed `_smoke`, and leaves `summary.json`
alone; a full-scale run merges its families into `summary.json`. Every
family runs on CUDA unless `--device` names another device. A family
that raises is recorded as an error and the others still run; then the
exit code is 1 (the JAX script exits 0).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

from distributed_reinforcement_learning_tpu_torch.utils.device import add_device_arg

OUT_DIR = os.path.join("runs", "curves")
CONFIG = Path(__file__).resolve().parent.parent / "config.json"


def _summary(returns: list[float]) -> dict:
    r = np.asarray(returns, np.float64)
    if r.size == 0:
        return {"episodes": 0}
    win = 20
    best = max(
        (float(r[i:i + win].mean()) for i in range(0, max(1, r.size - win), 10)),
        default=float(r.mean()),
    )
    return {
        "episodes": int(r.size),
        "early20_mean": round(float(r[:win].mean()), 2),
        "late20_mean": round(float(r[-win:].mean()), 2),
        "best20_mean": round(best, 2),
        "overall_mean": round(float(r.mean()), 2),
    }


def _write_curve(name: str, meta: dict, returns: list[float]) -> dict:
    os.makedirs(OUT_DIR, exist_ok=True)
    meta = {**meta, **_summary(returns)}
    path = os.path.join(OUT_DIR, f"{name}.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"meta": meta}) + "\n")
        for i, r in enumerate(returns):
            f.write(json.dumps({"episode": i, "return": round(float(r), 2)}) + "\n")
    print(f"[curves] {name}: {meta}", file=sys.stderr)
    return meta


def _config_family(section: str, updates: int, seed: int = 0, device=None,
                   agent_overrides: dict | None = None, **rt_overrides):
    """A family driven through the config path (build_local + run_sync)."""
    from distributed_reinforcement_learning_tpu_torch.runtime.launch import build_local
    from distributed_reinforcement_learning_tpu_torch.utils.config import load_config

    agent_cfg, rt = load_config(CONFIG, section)
    if agent_overrides:
        agent_cfg = dataclasses.replace(agent_cfg, **agent_overrides)
    if rt_overrides:
        rt = dataclasses.replace(rt, **rt_overrides)
    learner, actors, run_fn = build_local(agent_cfg, rt, seed=seed, device=device)
    t0 = time.time()
    result = run_fn(learner, actors, updates)
    wall = time.time() - t0
    return {
        "section": section,
        "updates": updates,
        "seed": seed,
        "overrides": {k: str(v) for k, v in
                      {**(agent_overrides or {}), **rt_overrides}.items()},
        "wall_s": round(wall, 1),
    }, result["episode_returns"]


def run_apex_cartpole(updates: int, seed: int = 0, device=None):
    """Ape-X on CartPole (no config section exists for it; built direct,
    with the JAX script's hyperparameters: lr 1e-3, abs_one reward clip,
    batch 32, replay 10,000, target sync 25, 8 envs, unrolls of 32)."""
    from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexAgent, ApexConfig
    from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
    from distributed_reinforcement_learning_tpu_torch.envs.cartpole import VectorCartPole
    from distributed_reinforcement_learning_tpu_torch.runtime import apex_runner
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

    cfg = ApexConfig(obs_shape=(4,), num_actions=2, start_learning_rate=1e-3,
                     reward_clipping="abs_one")
    agent = ApexAgent(cfg, device=device)
    queue = TrajectoryQueue(capacity=64)
    weights = WeightStore()
    learner = apex_runner.ApexLearner(
        agent, queue, weights, batch_size=32, replay_capacity=10_000,
        target_sync_interval=25, init_seed=seed)
    env = VectorCartPole(num_envs=8, seed=seed)
    actor = apex_runner.ApexActor(
        agent, env, queue, weights, seed=seed + 1, unroll_size=32,
        local_capacity=5_000)
    t0 = time.time()
    result = apex_runner.run_sync(learner, [actor], num_updates=updates)
    return {
        "section": "apex_cartpole(direct)",
        "updates": updates,
        "seed": seed,
        "wall_s": round(time.time() - t0, 1),
    }, result["episode_returns"]


FAMILIES = {
    # The five families on CartPole (>=2k updates each).
    "impala_cartpole": lambda s, seed=0, device=None: _config_family(
        "impala_cartpole", int(2500 * s), seed=seed, device=device),
    "apex_cartpole": lambda s, seed=0, device=None: run_apex_cartpole(
        int(2500 * s), seed=seed, device=device),
    "r2d2_cartpole_pomdp": lambda s, seed=0, device=None: _config_family(
        "r2d2", int(2000 * s), seed=seed, device=device),
    # Stable mode: the eta-mixture sequence priority + epsilon floor.
    "r2d2_cartpole_pomdp_stable": lambda s, seed=0, device=None: _config_family(
        "r2d2", int(2000 * s), seed=seed, device=device,
        agent_overrides={"priority_eta": 0.9}, epsilon_floor=0.02),
    "xformer_cartpole_pomdp": lambda s, seed=0, device=None: _config_family(
        "xformer", int(2000 * s), seed=seed, device=device),
    # Transformer-R2D2 stable mode: the eta priority + Adam clip on top of
    # the xformer actor's own 0.15 epsilon floor.
    "xformer_cartpole_pomdp_stable": lambda s, seed=0, device=None: _config_family(
        "xformer", int(2000 * s), seed=seed, device=device,
        agent_overrides={"priority_eta": 0.9, "gradient_clip_norm": 40.0}),
    "ximpala_cartpole": lambda s, seed=0, device=None: _config_family(
        "ximpala", int(2000 * s), seed=seed, device=device),
    # IMPALA/Ape-X on the Breakout simulator (conv path; batch reduced so
    # 2k updates stay short; the curve's shape is the point).
    "impala_breakout_sim": lambda s, seed=0, device=None: _config_family(
        "impala", int(2000 * s), seed=seed, device=device,
        batch_size=8, num_actors=1, queue_size=64),
    "apex_breakout_sim": lambda s, seed=0, device=None: _config_family(
        "apex", int(2000 * s), seed=seed, device=device,
        batch_size=8, num_actors=1, queue_size=64),
    # IMPALA on the Pong simulator (a short curve: the mechanics and the
    # early trend only; Pong needs ~1M+ frames to go positive).
    "impala_pong_sim": lambda s, seed=0, device=None: _config_family(
        "impala", int(600 * s), seed=seed, device=device,
        envs=("PongDeterministic-v4",), available_action=(6,),
        batch_size=8, num_actors=1, queue_size=64),
}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--families", default=",".join(FAMILIES))
    p.add_argument("--updates-scale", type=float, default=1.0,
                   help="scale every family's update count (smoke: 0.01)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed != 0 writes <family>_seed<k>.jsonl")
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    """Run the families; -> the printed summaries. Exits 1 after the last
    family when any family failed."""
    args = parse_args(argv)
    smoke = args.updates_scale != 1.0
    summaries = {}
    failed = []
    for name in args.families.split(","):
        name = name.strip()
        if not name:
            continue
        out_name = name if args.seed == 0 else f"{name}_seed{args.seed}"
        if smoke:
            # A scaled run is a smoke check: it must never overwrite the
            # full-scale jsonl or summary entries.
            out_name += "_smoke"
        try:
            meta, returns = FAMILIES[name](args.updates_scale, seed=args.seed,
                                           device=args.device)
            summaries[out_name] = _write_curve(out_name, meta, returns)
        except Exception as e:  # noqa: BLE001 — one family must not sink the rest
            summaries[out_name] = {"error": f"{type(e).__name__}: {e}"}
            failed.append(out_name)
            print(f"[curves] {out_name} FAILED: {e}", file=sys.stderr)
    if not smoke:
        # Merge into the existing summary: a partial (one-family /
        # alt-seed) run must not clobber the full table. Tolerate a
        # corrupt existing file: hours of runs must not be lost to it.
        os.makedirs(OUT_DIR, exist_ok=True)
        path = os.path.join(OUT_DIR, "summary.json")
        merged = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    merged = json.load(f)
            except (json.JSONDecodeError, OSError) as e:
                print(f"[curves] WARNING: existing summary unreadable ({e}); "
                      f"rewriting with this run only", file=sys.stderr)
        merged.update(summaries)
        with open(path, "w") as f:
            json.dump(merged, f, indent=2)
            f.write("\n")
    print(json.dumps(summaries))
    if failed:
        print(f"[curves] {len(failed)} family(ies) failed: {', '.join(failed)}",
              file=sys.stderr)
        sys.exit(1)
    return summaries


if __name__ == "__main__":
    main()
