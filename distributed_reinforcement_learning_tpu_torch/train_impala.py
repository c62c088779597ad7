"""Single-process IMPALA training with the PyTorch port.

    python -m distributed_reinforcement_learning_tpu_torch.train_impala \\
        --section impala --updates 100 [--device cpu] [--run_dir runs/x]

Runs on CUDA unless `--device` names another device. Prints the result
(frames, last metrics, mean return of the last 20 episodes) as JSON.
"""

from __future__ import annotations

import argparse
import json

from distributed_reinforcement_learning_tpu_torch.runtime.launch import train_local


def run_cli(doc: str, section: str, argv: list[str] | None) -> dict:
    """The launchers' shared command line: train, print the summary."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--config", default="config.json")
    ap.add_argument("--section", default=section)
    ap.add_argument("--updates", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--run_dir", default=None)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    result = train_local(args.config, args.section, args.updates, run_dir=args.run_dir,
                         seed=args.seed, device=args.device)
    summary = {k: v for k, v in result.items() if k != "episode_returns"}
    summary["episodes"] = len(result["episode_returns"])
    print(json.dumps(summary))
    return result


def main(argv: list[str] | None = None) -> dict:
    return run_cli(__doc__, "impala", argv)


if __name__ == "__main__":
    main()
