"""IMPALA training with the PyTorch port.

    python -m distributed_reinforcement_learning_tpu_torch.train_impala \\
        --section impala --updates 100 [--device cpu] [--run_dir runs/x]

- `--mode local` (default): the single-process loop; prints the result
  (frames, last metrics, mean return of the last 20 episodes) as JSON.
- `--mode learner` / `--mode actor --task k`: one process of the
  multi-process topology over the socket transport
  (`runtime/transport.py:run_role`); the learner listens on the
  section's `server_port` (or `DRL_LEARNER_ADDR`), actors connect to it.
  Co-hosted roles also take the shm rings and the weight board by the
  JAX package's `DRL_SHM_*` names; `launch_local_cluster.py` starts the
  whole topology and names them.

Every mode runs on CUDA unless `--device` names another device: start
actors with `--device cpu` to keep them off the card. Not ported, and
refused with a ValueError naming the ROADMAP item: `--mode anakin`
(item 14), `--mode inference`, `--serve_inference` and `--remote_act`
(serving, item 12d), `DRL_WEIGHTS_SHARDED` (item 12e), the learner tier
and multi-host learners (item 13) and `DRL_DEVICE_PATH` (item 16).
"""

from __future__ import annotations

import argparse
import json

from distributed_reinforcement_learning_tpu_torch.runtime.launch import train_local


def run_cli(doc: str, algo: str, section: str, argv: list[str] | None) -> dict:
    """The launchers' shared command line: train in the chosen mode and
    print the summary."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--config", default="config.json")
    ap.add_argument("--section", default=section)
    ap.add_argument("--mode", default="local",
                    choices=["local", "learner", "actor", "anakin", "inference"])
    ap.add_argument("--task", type=int, default=-1, help="actor index (actor mode)")
    ap.add_argument("--updates", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--run_dir", default=None)
    ap.add_argument("--checkpoint_dir", default=None,
                    help="save and resume train-state checkpoints here (local, learner)")
    ap.add_argument("--checkpoint_interval", type=int, default=500)
    ap.add_argument("--actor_grace", type=float, default=120.0,
                    help="actor mode: seconds to ride out a learner outage before exiting")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--serve_inference", action="store_true",
                    help="learner mode: serve acts (not ported, ROADMAP item 12d; raises)")
    ap.add_argument("--remote_act", action="store_true",
                    help="actor mode: act through the learner (not ported, ROADMAP item 12d; raises)")
    args = ap.parse_args(argv)
    if args.mode != "local" or args.serve_inference or args.remote_act:
        from distributed_reinforcement_learning_tpu_torch.runtime.transport import run_role

        return run_role(algo, args.config, args.section, args.mode, args.task,
                        num_updates=args.updates, run_dir=args.run_dir, seed=args.seed,
                        checkpoint_dir=args.checkpoint_dir,
                        checkpoint_interval=args.checkpoint_interval,
                        actor_grace=args.actor_grace, device=args.device,
                        serve_inference=args.serve_inference, remote_act=args.remote_act)
    result = train_local(args.config, args.section, args.updates, run_dir=args.run_dir,
                         seed=args.seed, device=args.device,
                         checkpoint_dir=args.checkpoint_dir,
                         checkpoint_interval=args.checkpoint_interval)
    summary = {k: v for k, v in result.items() if k != "episode_returns"}
    summary["episodes"] = len(result["episode_returns"])
    print(json.dumps(summary))
    return result


def main(argv: list[str] | None = None) -> dict:
    return run_cli(__doc__, "impala", "impala", argv)


if __name__ == "__main__":
    main()
