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
- `--mode anakin`: the on-device loop (`runtime/anakin.py`): envs,
  act, trajectory and learn all on the device, in chunks of 50 updates;
  `--anakin_envs` sets the env count. The section's env picks the
  device env (Breakout, Pong or SpaceInvaders names route to
  `envs/{breakout,pong,invaders}_device.py`, CartPole to
  `envs/cartpole_device.py`). Prints the summary (frames,
  chunk_mean_returns, mean_return_last_chunk) as JSON.
- Served acts: `--serve_inference` makes the learner answer acts on its
  device; `--remote_act` actors act through it (or through the replicas
  `DRL_INFER_ADDRS` names) and pull no weights; `--mode inference --task
  k` runs an act-serving replica (`runtime/serving.py`) that reads the
  learner's weight board, or pulls over TCP. Local mode ignores the two
  flags, as the JAX launchers do.

- The JAX package's opt-in planes, by its names: `DRL_WEIGHTS_SHARDED`
  (per-shard publication, with `DRL_WEIGHTS_QUANT`, `DRL_WEIGHTS_DELTA`
  and a role's `DRL_WEIGHTS_KEYS`; `runtime/weight_shards.py`) and, for
  the replay learners, `DRL_DEVICE_PATH` (the fused device sample path,
  `data/device_path.py`). Both are off unless set.

Every mode runs on CUDA unless `--device` names another device: start
actors with `--device cpu` to keep them off the card. A learner under
`DRL_COORDINATOR` / `DRL_NUM_PROCESSES` / `DRL_PROCESS_ID` is one rank
of a multi-process learner (ROADMAP item 13b; `runtime/transport.run_role`),
whose mesh carries the transformer families' sequence, pipeline and
expert axes (item 13c; a non-transformer section's `seq_parallel` and
`expert_parallel` are ignored, as in the JAX package). `--mode anakin`
under `DRL_COORDINATOR` is refused: the JAX package's builds no mesh
and ignores the names, so each process would run one independent loop
(ROADMAP F14); the Anakin loops take a mesh of ranks in the library
(`runtime/anakin_mesh.py`).
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
                    help="learner mode: also serve acts (OP_ACT) on the learner's device")
    ap.add_argument("--remote_act", action="store_true",
                    help="actor mode: act through the learner's service, or the replicas "
                         "DRL_INFER_ADDRS names; pull no weights")
    ap.add_argument("--anakin_envs", type=int, default=None,
                    help="anakin mode: envs on the device (default num_actors * "
                         "envs_per_actor from the section)")
    ap.add_argument("--anakin_capacity", type=int, default=None,
                    help="anakin mode, Ape-X and R2D2: the device ring's capacity "
                         "(default min(replay_capacity, 32768) transitions, 4096 sequences)")
    args = ap.parse_args(argv)
    if args.mode == "anakin":
        return _run_anakin(algo, args)
    if args.mode != "local":
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


def _run_anakin(algo: str, args) -> dict:
    """`--mode anakin`: the family's on-device loop; prints its summary."""
    from distributed_reinforcement_learning_tpu_torch.runtime import launch
    from distributed_reinforcement_learning_tpu_torch.runtime.transport import refuse_unported

    refuse_unported("anakin", algo)
    kw = dict(seed=args.seed, num_envs=args.anakin_envs, checkpoint_dir=args.checkpoint_dir,
              run_dir=args.run_dir, device=args.device)
    if algo == "impala":
        if args.anakin_capacity is not None:
            raise ValueError("--anakin_capacity sizes a replay ring; IMPALA's loop has none")
        result = launch.train_anakin(args.config, args.section, args.updates, **kw)
    else:
        train = launch.train_anakin_apex if algo == "apex" else launch.train_anakin_r2d2
        result = train(args.config, args.section, args.updates,
                       capacity=args.anakin_capacity, **kw)
    print(json.dumps(result))
    return result


def main(argv: list[str] | None = None) -> dict:
    return run_cli(__doc__, "impala", "impala", argv)


if __name__ == "__main__":
    main()
