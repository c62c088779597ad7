"""R2D2 collapse-cycle probe: does recency-mixed sampling kill the
peak->random->recover cycle?

Counterpart of the JAX package's `scripts/r2d2_cycle_probe.py`. Runs the
committed stable recipe (priority_eta 0.9 + epsilon floor 0.05 on the
repo's `config.json`, written to `<out>/config_used.json`) with the
`DRL_R2D2_RECENT_FRACTION` / `DRL_R2D2_RECENT_WINDOW` knobs
(`runtime/r2d2_runner.py`) and, with `--baseline`, without them, N seeds
x `--updates` through `runtime/launch.py:train_local`, and reports the
cycle metric: rolling-mean(50) episode returns, counting DOWN-crossings
of 100 after the first up-crossing. Writes `returns_<variant>_seed<k>.json`
per run and `summary.json` under `--out`, which defaults to
`runs/r2d2_recent` (the JAX script's default lies under `benchmarks/`,
where the port writes nothing). Runs on CUDA unless `--device` names
another device.

    python -m distributed_reinforcement_learning_tpu_torch.r2d2_cycle_probe \\
        --updates 2000 --seeds 0 1 --recent-fraction 0.25
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np

from distributed_reinforcement_learning_tpu_torch.utils.device import add_device_arg

CONFIG = Path(__file__).resolve().parent.parent / "config.json"


def cycle_stats(returns: list[float], window: int = 50,
                bar: float = 100.0) -> dict:
    r = np.asarray(returns, np.float64)
    if len(r) < window:
        return {"episodes": len(r), "down_crossings": None,
                "note": "too few episodes"}
    roll = np.convolve(r, np.ones(window) / window, mode="valid")
    above = roll > bar
    ups = int(((~above[:-1]) & above[1:]).sum())
    # Down-crossings only count once the policy has reached peak at all.
    first_up = int(np.argmax(above)) if above.any() else None
    downs = 0
    if first_up is not None:
        seg = above[first_up:]
        downs = int((seg[:-1] & ~seg[1:]).sum())
    late = r[-20:].mean() if len(r) >= 20 else r.mean()
    return {
        "episodes": len(r),
        "roll_max": round(float(roll.max()), 1),
        "up_crossings": ups,
        "down_crossings": downs,
        "late20_mean": round(float(late), 1),
        "roll_tail": [round(float(x), 1) for x in roll[::max(1, len(roll) // 40)]],
    }


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--out", default="runs/r2d2_recent")
    p.add_argument("--updates", type=int, default=2000)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    p.add_argument("--recent-fraction", type=float, default=0.25)
    p.add_argument("--recent-window", type=int, default=256)
    p.add_argument("--baseline", action="store_true",
                   help="also run the recipe WITHOUT the knob")
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    """Run every variant and seed; -> the summary written to summary.json."""
    args = parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    # The committed stable recipe on top of the reference schema:
    # eta-priority + epsilon floor.
    cfg = json.loads(CONFIG.read_text())
    cfg["r2d2"]["priority_eta"] = 0.9
    cfg["r2d2"]["epsilon_floor"] = 0.05
    cfg_path = out / "config_used.json"
    cfg_path.write_text(json.dumps(cfg, indent=1))

    from distributed_reinforcement_learning_tpu_torch.runtime.launch import train_local

    variants = [("recent", args.recent_fraction)]
    if args.baseline:
        variants.append(("baseline", 0.0))
    results: dict = {"updates": args.updates,
                     "recent_fraction": args.recent_fraction,
                     "recent_window": args.recent_window, "runs": {}}
    for name, frac in variants:
        os.environ["DRL_R2D2_RECENT_FRACTION"] = str(frac)
        os.environ["DRL_R2D2_RECENT_WINDOW"] = str(args.recent_window)
        for seed in args.seeds:
            t0 = time.monotonic()
            r = train_local(str(cfg_path), "r2d2", args.updates, seed=seed, device=args.device)
            stats = cycle_stats(r["episode_returns"])
            stats["wall_s"] = round(time.monotonic() - t0, 1)
            key = f"{name}_seed{seed}"
            results["runs"][key] = stats
            (out / f"returns_{key}.json").write_text(
                json.dumps([round(float(x), 1) for x in r["episode_returns"]]))
            print(f"[probe] {key}: {stats}", flush=True)
    (out / "summary.json").write_text(json.dumps(results, indent=2))
    print(json.dumps(results["runs"], indent=2))
    return results


if __name__ == "__main__":
    main()
