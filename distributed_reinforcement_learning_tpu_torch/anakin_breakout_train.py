"""Chip-rate Breakout training: Anakin IMPALA over a device env, on the card.

Counterpart of the JAX package's `scripts/anakin_breakout_train.py`, with
the same arguments, files and printed rows: collect and learn entirely on
the device (`runtime/anakin.py` over `envs/breakout_device.py`, or the
Pong and SpaceInvaders twins), U updates a chunk, with periodic
checkpoints and greedy evaluations on the device (the loop of
`runtime/anakin_driver.py`, shared with `anakin_r2d2_train.py`).

Writes `<out>/config.json` (the run's arguments, `platform` the torch
device and `dtype` the compute type), one JSON row a chunk to
`<out>/progress.jsonl` (also printed), and checkpoints of the train state
to `<out>/ckpt` through `utils/checkpoint.py` (`--resume` restores the
newest; env and LSTM state start fresh, as an actor restart does).

    python -m distributed_reinforcement_learning_tpu_torch.anakin_breakout_train \\
        --out runs/anakin_breakout --num-envs 128 --total-frames 50_000_000

Runs on CUDA unless `--device` names another device (`--platform cpu`,
the JAX script's spelling, is the same as `--device cpu`); compute is
bfloat16 on the card unless `--f32`, float32 on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from distributed_reinforcement_learning_tpu_torch.runtime.anakin_driver import (
    EPISODE_FRAME_CAP, compute_dtype, run_chunks, write_config)
from distributed_reinforcement_learning_tpu_torch.utils.device import add_device_arg


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--out", required=True)
    p.add_argument("--env", default="breakout",
                   choices=["breakout", "pong", "invaders"],
                   help="which device pixel env to train "
                        "(envs/breakout_device.py, pong_device.py, invaders_device.py)")
    p.add_argument("--num-envs", type=int, default=128)
    p.add_argument("--trajectory", type=int, default=20)
    p.add_argument("--updates-per-chunk", type=int, default=50)
    p.add_argument("--total-frames", type=int, default=50_000_000,
                   help="env frames (post-frameskip actions x num_envs)")
    p.add_argument("--num-actions", type=int, default=None,
                   help="policy head width (default: the env's own action "
                        "count); wider exercises the reference's "
                        "action %% available_action aliasing")
    p.add_argument("--lstm", type=int, default=256)
    p.add_argument("--entropy", type=float, default=0.01)
    p.add_argument("--baseline-coef", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=6e-4)
    p.add_argument("--end-lr", type=float, default=0.0)
    p.add_argument("--learning-frames", type=int, default=0,
                   help="LR-decay horizon in frames (0 = --total-frames)")
    p.add_argument("--reward-clip", default="abs_one",
                   choices=["abs_one", "soft_asymmetric", "none"])
    p.add_argument("--clip-norm", type=float, default=40.0,
                   help="global-norm gradient clip (reference 40; with "
                        "SUM losses the norm scales with batch, so large "
                        "--num-envs runs may want it raised)")
    p.add_argument("--torso", default="nature", choices=["nature", "resnet"],
                   help="conv torso: reference Nature-CNN, or the IMPALA "
                        "paper's deep ResNet")
    p.add_argument("--torso-width", type=int, default=1,
                   help="ResNet channel multiplier")
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)
    p.add_argument("--f32", action="store_true",
                   help="float32 compute (default bf16 on the card)")
    p.add_argument("--checkpoint-every", type=int, default=20,
                   help="chunks between checkpoints")
    p.add_argument("--eval-every", type=int, default=10,
                   help="chunks between greedy evals (0 = never)")
    p.add_argument("--eval-envs", type=int, default=32)
    p.add_argument("--eval-steps", type=int, default=None,
                   help="adapter steps per eval rollout (default: the "
                        "env's episode frame cap / frameskip + slack, so "
                        "even a cap-length game completes inside the eval)")
    p.add_argument("--resume", action="store_true")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    """Train; -> {"config", "state", "rows", "anakin"} (the rows this run
    wrote)."""
    args = parse_args(argv)
    if args.torso != "resnet" and args.torso_width != 1:
        sys.exit("--torso-width only applies to --torso resnet "
                 "(the Nature CNN has fixed channel counts)")
    from distributed_reinforcement_learning_tpu_torch.agents.impala import (
        ImpalaAgent, ImpalaConfig)
    from distributed_reinforcement_learning_tpu_torch.envs import (
        breakout_device, invaders_device, pong_device)
    from distributed_reinforcement_learning_tpu_torch.runtime.anakin import AnakinImpala
    from distributed_reinforcement_learning_tpu_torch.utils.checkpoint import Checkpointer
    from distributed_reinforcement_learning_tpu_torch.utils.device import resolve_device

    env_mod = {"breakout": breakout_device, "pong": pong_device,
               "invaders": invaders_device}[args.env]
    if args.eval_steps is None:
        args.eval_steps = EPISODE_FRAME_CAP[args.env] // 4 + 500
    device = resolve_device(args.device)
    dtype = compute_dtype(device, args.f32)

    # The LR schedule counts OPTIMIZER UPDATES (agents/common.py
    # polynomial_lr, stepped with state.step), so the frame-denominated
    # horizon converts through frames-per-update; without this the decay
    # denominator would be ~2500x the actual step count and --end-lr a
    # silent no-op.
    frames_per_update = args.num_envs * args.trajectory
    horizon_updates = max(
        1, (args.learning_frames or args.total_frames) // frames_per_update)
    cfg = ImpalaConfig(
        obs_shape=env_mod.OBS_SHAPE,
        num_actions=args.num_actions or env_mod.NUM_ACTIONS,
        trajectory=args.trajectory,
        lstm_size=args.lstm,
        entropy_coef=args.entropy,
        baseline_loss_coef=args.baseline_coef,
        start_learning_rate=args.lr,
        end_learning_rate=args.end_lr,
        learning_frame=horizon_updates,
        reward_clipping=args.reward_clip,
        gradient_clip_norm=args.clip_norm,
        torso=args.torso,
        torso_width=args.torso_width,
        dtype=dtype,
        fold_normalize=True,  # frames stay uint8 through the whole loop
    )
    anakin = AnakinImpala(ImpalaAgent(cfg, device=device), num_envs=args.num_envs, env=env_mod)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    config = write_config(out, args, device, dtype)
    ck = Checkpointer(out / "ckpt", retain=3)

    state = anakin.init(args.seed)
    frames = 0
    chunk = 0
    if args.resume:
        restored = ck.restore(state.train)
        if restored is not None:
            state.train, extra, step = restored
            frames = int(extra.get("frames", 0))
            chunk = int(extra.get("chunk", 0))
            print(f"[resume] step={step} frames={frames:,}", file=sys.stderr)

    def loss_fields(m: dict) -> dict:
        return {
            "total_loss": round(float(m["total_loss"][-1]), 4),
            "entropy": round(float(m["entropy"][-1]), 4),
            "grad_norm": round(float(m["grad_norm"][-1]), 4),
            "lr": float(m["learning_rate"][-1]),
        }

    state, rows = run_chunks(anakin, state, args, ck, out / "progress.jsonl", frames, chunk,
                             frames_per_update * args.updates_per_chunk, loss_fields,
                             lambda _state: {})
    return {"config": config, "state": state, "rows": rows, "anakin": anakin}


if __name__ == "__main__":
    main()
