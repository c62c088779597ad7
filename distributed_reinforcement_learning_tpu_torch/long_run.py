"""Multi-million-frame endurance run driver.

Counterpart of the JAX package's `scripts/long_run.py`: checkpoint
cadence, replay and queue churn, publication staleness and memory growth
over an hours-long run, with every chunk a real process restart.

The parent loop spawns one child interpreter a chunk. Each child calls
the port's `train_local(..., checkpoint_dir=...)` for `--chunk` more
updates on `--device` (CUDA unless another device is named; the JAX
child forces the CPU), then exits; the next child restores from the
checkpoint. The parent appends one JSONL record a chunk to `--out`:
updates reached, cumulative frames, chunk wall seconds, the child's
max RSS (leak detection across a long run) and the chunk's episode
returns. It resumes from the records already in `--out`, stops early
when a `STOP` file appears beside `--out`, and aborts (rc 1) after 3
consecutive child failures.

    python -m distributed_reinforcement_learning_tpu_torch.long_run \\
        --config config.json --section impala --out runs/longrun/impala_breakout.jsonl \\
        --chunk 250 --max-updates 12000
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD_CODE = r"""
import json, resource, sys
sys.path.insert(0, {repo!r})
from distributed_reinforcement_learning_tpu_torch.runtime.launch import train_local
result = train_local({config!r}, {section!r}, {target!r},
                     seed={seed!r}, device={device!r}, checkpoint_dir={ckpt!r},
                     checkpoint_interval={interval!r})
result["max_rss_mb"] = round(
    resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0, 1)
with open({tmp_out!r}, "w") as f:
    json.dump(result, f)
"""

RETRY_SLEEP_S = 10  # after a failed child (an OOM kill, say): retry from the checkpoint
MAX_CONSECUTIVE_FAILURES = 3


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--section", default="impala")
    p.add_argument("--out", required=True)
    p.add_argument("--chunk", type=int, default=250)
    p.add_argument("--max-updates", type=int, default=12000)
    p.add_argument("--checkpoint-interval", type=int, default=250)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint dir (default: derived from --out, so two "
                        "runs with different out files never share a "
                        "checkpoint — restoring another config's params is "
                        "silent nonsense)")
    p.add_argument("--device", default=None,
                   help="each child's torch device (default: cuda)")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.out))[0]
    ckpt_dir = args.ckpt_dir or os.path.join(out_dir, "ckpt_" + stem)
    stop_file = os.path.join(out_dir, "STOP")
    tmp_out = os.path.join(out_dir, f".chunk_result_{stem}.json")

    # Resume the DRIVER too: continue from the updates already recorded.
    done_updates = 0
    frames_total = 0
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                rec = json.loads(line)
                done_updates = max(done_updates, rec.get("updates", 0))
                frames_total = max(frames_total, rec.get("frames_total", 0))

    t_start = time.time()
    consecutive_failures = 0
    while done_updates < args.max_updates and not os.path.exists(stop_file):
        target = min(done_updates + args.chunk, args.max_updates)
        code = CHILD_CODE.format(repo=REPO, config=args.config,
                                 section=args.section, target=target,
                                 seed=args.seed, device=args.device, ckpt=ckpt_dir,
                                 interval=args.checkpoint_interval,
                                 tmp_out=tmp_out)
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO)
        wall = time.time() - t0
        if proc.returncode != 0:
            consecutive_failures += 1
            rec = {"updates": done_updates, "error": f"child rc={proc.returncode}",
                   "wall_s": round(wall, 1), "t": round(time.time() - t_start, 1)}
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            if consecutive_failures >= MAX_CONSECUTIVE_FAILURES:
                # Deterministic failure (bad config, template mismatch):
                # abort rather than respawning the same child all night.
                print(f"[long_run] {MAX_CONSECUTIVE_FAILURES} consecutive chunk failures "
                      "— aborting", file=sys.stderr, flush=True)
                sys.exit(1)
            time.sleep(RETRY_SLEEP_S)
            continue
        consecutive_failures = 0
        with open(tmp_out) as f:
            result = json.load(f)
        chunk_frames = result.get("frames", 0)
        frames_total += chunk_frames
        returns = result.get("episode_returns", [])
        rec = {
            "updates": target,
            "frames_total": frames_total,
            "chunk_frames": chunk_frames,
            "wall_s": round(wall, 1),
            "frames_per_s": round(chunk_frames / max(wall, 1e-9), 1),
            "max_rss_mb": result.get("max_rss_mb"),
            "episodes": len(returns),
            "mean_return": (round(sum(returns) / len(returns), 2)
                            if returns else None),
            "last20": (round(sum(returns[-20:]) / len(returns[-20:]), 2)
                       if returns else None),
            "returns": [round(r, 1) for r in returns],
            "t": round(time.time() - t_start, 1),
        }
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        done_updates = target
        print(f"[long_run] {target}/{args.max_updates}"
              f" updates, {frames_total} frames, last20={rec['last20']}"
              f" rss={rec['max_rss_mb']}MB wall={wall:.0f}s", flush=True)

    print(f"[long_run] done: {done_updates} updates, {frames_total} frames "
          f"in {(time.time() - t_start) / 3600:.2f}h", flush=True)


if __name__ == "__main__":
    main()
