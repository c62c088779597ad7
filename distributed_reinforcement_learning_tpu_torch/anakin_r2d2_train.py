"""Train pixel R2D2 on a device game (Breakout/Pong): the Anakin
recurrent-replay configuration at chip rate.

Counterpart of the JAX package's `scripts/anakin_r2d2_train.py`, with the
same arguments, files and printed rows. The reference's R2D2 is its
CartPole downscaling (MLP torso); the R2D2 paper's agent puts the
Nature-DQN conv stack in front of the LSTM. This runs that configuration
with everything on the device: the device env (`envs/breakout_device.py`
or `pong_device.py`), the conv-torso `R2D2Net` (`torso="nature"`), the
per-sequence prioritized ring in device memory (`runtime/anakin_r2d2.py`),
stored-state + burn-in learning.

    python -m distributed_reinforcement_learning_tpu_torch.anakin_r2d2_train \\
        --out runs/r2d2_breakout --env breakout --num-envs 128 --total-frames 60000000

Writes `<out>/config.json`, one JSON row a chunk to `<out>/progress.jsonl`
(also printed) and checkpoints of the train state to `<out>/ckpt` with the
per-env episode counters (`--resume` restores both; the ring is not
checkpointed, so the warm-up collects run again). Runs on CUDA unless
`--device` names another device (`--platform cpu` is the JAX spelling);
compute is bfloat16 on the card unless `--f32`, float32 on the CPU.

The ring is priced from what it holds (uint8 frames, the int64 actions,
the stored (h, c), the priorities) and refused when it would take more
than half the device's free memory.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import torch

from distributed_reinforcement_learning_tpu_torch.runtime.anakin_driver import (
    EPISODE_FRAME_CAP, compute_dtype, run_chunks, write_config)
from distributed_reinforcement_learning_tpu_torch.utils.device import add_device_arg


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--env", default="breakout", choices=["breakout", "pong"])
    p.add_argument("--num-envs", type=int, default=128)
    p.add_argument("--seq-len", type=int, default=20)
    p.add_argument("--burn-in", type=int, default=10)
    p.add_argument("--lstm", type=int, default=256)
    p.add_argument("--capacity", type=int, default=8192,
                   help="replay ring capacity in SEQUENCES (each pixel "
                        "sequence is seq_len x 28 KB of uint8 frames)")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--updates-per-collect", type=int, default=2,
                   help="prioritized learn batches per collected unroll")
    p.add_argument("--updates-per-chunk", type=int, default=50)
    p.add_argument("--total-frames", type=int, default=60_000_000,
                   help="env frames (post-frameskip actions x num_envs)")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--discount", type=float, default=0.997)
    p.add_argument("--priority-eta", type=float, default=0.9,
                   help="R2D2-paper priority mixture eta*max+(1-eta)*mean "
                        "(the reference's |mean TD| quirk starves on "
                        "sparse-reward pixels); pass -1 for the reference "
                        "quirk")
    p.add_argument("--adam-clip", type=float, default=None,
                   help="optional global-norm clip in front of Adam")
    p.add_argument("--target-sync", type=int, default=400,
                   help="learn steps between target-net syncs")
    p.add_argument("--epsilon-decay", type=float, default=0.1)
    p.add_argument("--epsilon-floor", type=float, default=0.02)
    p.add_argument("--warmup-collects", type=int, default=8,
                   help="ring-fill collects before training starts")
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)
    p.add_argument("--f32", action="store_true")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--eval-every", type=int, default=20)
    p.add_argument("--eval-envs", type=int, default=32)
    p.add_argument("--eval-steps", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    return p.parse_args(argv)


def ring_bytes(capacity: int, seq_len: int, obs_shape: tuple[int, ...], lstm: int) -> int:
    """Bytes of `runtime/anakin_r2d2.py`'s sequence ring over a device
    game (`DeviceReplay.nbytes`): `capacity` sequences of `seq_len` uint8
    frames, int64 previous and taken actions, float32 rewards and bool
    dones, with the float32 stored (h, c) and a float32 priority each."""
    frame = 1
    for d in obs_shape:
        frame *= d
    step = frame + 8 + 8 + 4 + 1
    return capacity * (seq_len * step + 2 * lstm * 4 + 4)


def free_bytes(device: torch.device) -> int:
    """Free memory where the ring would live: the card's
    (`torch.cuda.mem_get_info`), or the host's available pages."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def check_ring(nbytes: int, free: int, device: torch.device) -> None:
    """Exit with a message when the ring would take more than half of the
    free memory on `device` (the learn step and the envs need the rest)."""
    if nbytes > free // 2:
        sys.exit(f"--capacity prices {nbytes / 2**30:.1f} GiB of replay ring (uint8 frames) "
                 f"against {free / 2**30:.1f} GiB free on {device}; lower it to keep the "
                 "ring within half of it")


def main(argv: list[str] | None = None) -> dict:
    """Train; -> {"config", "state", "rows", "anakin"} (the rows this run
    wrote)."""
    args = parse_args(argv)
    from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Agent, R2D2Config
    from distributed_reinforcement_learning_tpu_torch.envs import breakout_device, pong_device
    from distributed_reinforcement_learning_tpu_torch.runtime.anakin_r2d2 import AnakinR2D2
    from distributed_reinforcement_learning_tpu_torch.utils.checkpoint import Checkpointer
    from distributed_reinforcement_learning_tpu_torch.utils.device import resolve_device

    env_mod = {"breakout": breakout_device, "pong": pong_device}[args.env]
    if args.eval_steps is None:
        args.eval_steps = EPISODE_FRAME_CAP[args.env] // 4 + 500
    # Ring writes stay num_envs-aligned (AnakinR2D2 requirement).
    args.capacity -= args.capacity % args.num_envs
    if args.capacity < args.num_envs:
        sys.exit(f"--capacity must be at least --num-envs "
                 f"({args.num_envs}); alignment left {args.capacity}")
    device = resolve_device(args.device)
    check_ring(ring_bytes(args.capacity, args.seq_len, env_mod.OBS_SHAPE, args.lstm),
               free_bytes(device), device)
    dtype = compute_dtype(device, args.f32)

    cfg = R2D2Config(
        obs_shape=env_mod.OBS_SHAPE,
        num_actions=env_mod.NUM_ACTIONS,
        seq_len=args.seq_len,
        burn_in=args.burn_in,
        lstm_size=args.lstm,
        discount_factor=args.discount,
        learning_rate=args.lr,
        priority_eta=None if args.priority_eta < 0 else args.priority_eta,
        gradient_clip_norm=args.adam_clip,
        torso="nature",
        fold_normalize=True,  # frames stay uint8 through the whole loop
        dtype=dtype,
    )
    anakin = AnakinR2D2(
        R2D2Agent(cfg, device=device), num_envs=args.num_envs, batch_size=args.batch_size,
        capacity=args.capacity, target_sync_interval=args.target_sync,
        updates_per_collect=args.updates_per_collect,
        epsilon_decay=args.epsilon_decay, epsilon_floor=args.epsilon_floor,
        env=env_mod)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    config = write_config(out, args, device, dtype)
    ck = Checkpointer(out / "ckpt", retain=3)

    state = anakin.init(args.seed)
    # env frames per chunk: each update collects one seq_len unroll from
    # every env (training frames; greedy-eval rollouts not counted).
    frames_per_update = args.num_envs * args.seq_len
    frames = 0
    chunk = 0
    if args.resume:
        restored = ck.restore(state.train)
        if restored is not None:
            state.train, extra, step = restored
            frames = int(extra.get("frames", 0))
            chunk = int(extra.get("chunk", 0))
            # Restore the per-env episode counters, or the epsilon ladder
            # snaps back to 1.0 and a trained policy resumes collecting
            # pure noise. (Best effort: an env-count change falls back to
            # fresh counters.)
            eps_saved = extra.get("episodes_per_env")
            if eps_saved is not None and len(eps_saved) == args.num_envs:
                state.episodes = torch.tensor(eps_saved, dtype=torch.int32, device=device)
            print(f"[resume] step={step} frames={frames:,} "
                  f"eps_mean={float(anakin._epsilon(state.episodes).mean()):.3f}",
                  file=sys.stderr)
    # Ring fill: also on resume — the replay ring is NOT checkpointed, so
    # a resumed learner must not sample from an empty/near-empty ring.
    if args.warmup_collects:
        state, _ = anakin.collect_chunk(state, args.warmup_collects)
        frames += args.warmup_collects * frames_per_update

    def loss_fields(m: dict) -> dict:
        return {
            "loss": round(float(m["loss"][-1]), 5),
            "grad_norm": round(float(m["grad_norm"][-1]), 4),
            "epsilon": round(float(m["epsilon_mean"][-1]), 4),
            "replay_size": int(m["replay_size"][-1]),
        }

    state, rows = run_chunks(
        anakin, state, args, ck, out / "progress.jsonl", frames, chunk,
        frames_per_update * args.updates_per_chunk, loss_fields,
        lambda s: {"episodes_per_env": s.episodes.cpu().tolist()})
    return {"config": config, "state": state, "rows": rows, "anakin": anakin}


if __name__ == "__main__":
    main()
