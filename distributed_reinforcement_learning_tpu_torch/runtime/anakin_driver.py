"""The chunked loop that the Anakin run drivers share.

`anakin_breakout_train.py` (Anakin IMPALA) and `anakin_r2d2_train.py`
(Anakin R2D2) parse their own arguments and build their own loops; this
module holds what they have in common: the compute dtype, `config.json`,
and the loop of chunks with its rows, greedy evals and checkpoints.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Callable

import torch

# Emulated frames after which a device game ends (the envs' `max_frames`).
EPISODE_FRAME_CAP = {"breakout": 10_000, "pong": 20_000, "invaders": 10_000}

# Greedy eval of chunk c seeds its rollout `--seed + EVAL_SEED_OFFSET + c`.
EVAL_SEED_OFFSET = 1000


def compute_dtype(device: torch.device, f32: bool) -> torch.dtype:
    """bfloat16 on the card unless `f32`; float32 on the CPU."""
    return torch.float32 if (f32 or device.type == "cpu") else torch.bfloat16


def write_config(out: Path, args: argparse.Namespace, device: torch.device,
                 dtype: torch.dtype) -> dict:
    """`<out>/config.json`: the arguments with `platform` (the device, in
    `--device`'s place) and `dtype` (its name), the JAX script's keys."""
    desc = {("platform" if k == "device" else k): (str(device) if k == "device" else v)
            for k, v in vars(args).items()}
    desc["dtype"] = str(dtype).removeprefix("torch.")
    (out / "config.json").write_text(json.dumps(desc, indent=2))
    return desc


def run_chunks(anakin, state, args: argparse.Namespace, ck, progress: Path, frames: int,
               chunk: int, frames_per_chunk: int, loss_fields: Callable[[dict], dict],
               save_extra: Callable[[object], dict]) -> tuple[object, list[dict]]:
    """The drivers' loop until `--total-frames`: a chunk of
    `--updates-per-chunk` updates, its row (`loss_fields(metrics)` the
    family's own columns), a greedy eval every `--eval-every` chunks, a
    checkpoint every `--checkpoint-every` chunks and at the end (with
    `frames`, `chunk` and `save_extra(state)` in its extra) -> (state,
    rows). A chunk's metrics are read to the host once, which
    synchronises it."""
    rows = []
    t_start = time.monotonic()
    while frames < args.total_frames:
        t0 = time.monotonic()
        state, m = anakin.train_chunk(state, args.updates_per_chunk)
        m = {k: v.cpu() for k, v in m.items()}
        dt = time.monotonic() - t0
        chunk += 1
        frames += frames_per_chunk

        return_sum = float(m["episode_return_sum"].sum())
        episodes = float(m["episodes_done"].sum())  # true game ends
        row = {
            "chunk": chunk,
            "updates": int(state.train.step),
            "frames": frames,
            "fps": round(frames_per_chunk / dt, 1),
            "chunk_s": round(dt, 3),
            **loss_fields(m),
            "return_sum": round(return_sum, 1),
            "episodes": episodes,
            "mean_return": round(return_sum / max(episodes, 1.0), 2),
            "boundaries": float(m["boundaries_done"].sum()),
            "wall_s": round(time.monotonic() - t_start, 1),
        }

        if args.eval_every and chunk % args.eval_every == 0:
            # Seeded by the chunk, which the checkpoint carries, so a
            # resumed run draws no earlier eval's envs again (the JAX
            # script splits a fresh key in each process).
            t0 = time.monotonic()
            ev = anakin.greedy_eval(state.train.params, args.eval_envs, args.eval_steps,
                                    args.seed + EVAL_SEED_OFFSET + chunk)
            row["eval_mean_return"] = round(ev["mean_return"], 2)
            row["eval_episodes"] = ev["episodes"]
            row["eval_s"] = round(time.monotonic() - t0, 1)

        if chunk % args.checkpoint_every == 0 or frames >= args.total_frames:
            ck.save(int(state.train.step), state.train,
                    extra={"frames": frames, "chunk": chunk, **save_extra(state)})
            row["checkpoint"] = int(state.train.step)

        with progress.open("a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
        rows.append(row)
    return state, rows
