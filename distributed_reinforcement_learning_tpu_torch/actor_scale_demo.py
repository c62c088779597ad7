"""The reference's actor scale: `--actors` socket actors (20 by default)
feeding one learner through the real transport.

Counterpart of the JAX package's `scripts/actor_scale_demo.py`. It spawns
the topology as real processes, with the commands an operator runs:
`python -m distributed_reinforcement_learning_tpu_torch.train_impala
--mode learner` on `--device` (CUDA by default; the JAX demo forces its
learner onto the CPU) and `--mode actor --task k --device cpu` for each
actor (no card, `OMP_NUM_THREADS=1` unless set, as
`launch_local_cluster` starts them), with a copy of the repo's
`config.json` sized to the actor count and a free port. After `--minutes` it stops the actors and then the
learner (SIGINT: each prints its summary) and writes, under `--out`
(default `runs/actor_scale`; the JAX demo's default lies under
`benchmarks/`, where the port writes nothing):

- `summary.json`: the learner's update throughput (`metrics.jsonl` of
  its run dir), its transport counters (unrolls accepted, busy replies,
  partial accepts, weight sends), the queue depth over time, unrolls per
  actor (producer fairness), and the actors' last weight versions
  (publish staleness);
- `depth_series.jsonl`: the learner's `[transport] depth=... acts=...
  unrolls=...` lines (`DRL_TRANSPORT_STATS_S` = `--stats-interval`);
- `learner_tail.log`: the learner's last 200 lines.

Each actor's counters come from its `[actor k] stats {...}` lines under
the same interval. Prints the summary.

    python -m distributed_reinforcement_learning_tpu_torch.actor_scale_demo \\
        --actors 20 --minutes 10
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

from distributed_reinforcement_learning_tpu_torch.utils.device import add_device_arg

REPO = Path(__file__).resolve().parent.parent
DEPTH_LINE = re.compile(r"\[transport\] depth=(\d+) acts=(\d+) unrolls=(\d+) "
                        r"busy=(\d+) partial=(\d+) weight_sends=(\d+)")


def actor_stats_of(k: int, line: str) -> dict | None:
    """The counters of actor `k`'s `[actor k] stats {...}` line, else None."""
    m = re.match(rf"\[actor {k}\] stats (\{{.*\}})", line.strip())
    return None if m is None else ast.literal_eval(m.group(1))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--out", default="runs/actor_scale")
    p.add_argument("--actors", type=int, default=20)
    p.add_argument("--minutes", type=float, default=10.0)
    p.add_argument("--section", default="impala_cartpole")
    p.add_argument("--stats-interval", type=float, default=15.0)
    add_device_arg(p)
    return p.parse_args(argv)


def _stop(proc: subprocess.Popen, timeout: float) -> None:
    """SIGINT `proc` (it prints its summary and exits); kill its group if it
    has not exited within `timeout` seconds."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)


def main(argv: list[str] | None = None) -> dict:
    """Run the topology for `--minutes`; -> the summary."""
    args = parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    run_dir = out / "learner_run"
    port = _free_port()

    # One config copy with the demo's actor count and port, so the
    # learner's queue sizing and the actors' addressing both see it.
    cfg = json.loads((REPO / "config.json").read_text())
    section = cfg[args.section]
    section["num_actors"] = args.actors
    section["server_port"] = port
    # The schema requires per-actor env/available_action lists: replicate
    # to the count.
    section["env"] = [section["env"][0]] * args.actors
    section["available_action"] = [section["available_action"][0]] * args.actors
    cfg_path = out / "config_used.json"
    cfg_path.write_text(json.dumps(cfg, indent=1))

    env = dict(os.environ, DRL_TRANSPORT_STATS_S=str(args.stats_interval),
               PYTHONPATH=os.pathsep.join(filter(None, [str(REPO),
                                                        os.environ.get("PYTHONPATH")])))
    env.pop("DRL_LEARNER_ADDR", None)  # the config's port addresses every role

    # Actors as `launch_local_cluster` starts them: no card, one thread
    # unless the caller set OMP_NUM_THREADS.
    actor_env = dict(env, CUDA_VISIBLE_DEVICES="")
    actor_env.setdefault("OMP_NUM_THREADS", "1")

    def spawn(role: list[str], device: str | None, role_env: dict) -> subprocess.Popen:
        cmd = [sys.executable, "-m", "distributed_reinforcement_learning_tpu_torch.train_impala",
               *role, "--config", str(cfg_path), "--section", args.section]
        return subprocess.Popen(cmd + ([] if device is None else ["--device", device]),
                                env=role_env, text=True, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, start_new_session=True)

    learner = spawn(["--mode", "learner", "--updates", "100000000", "--run_dir", str(run_dir)],
                    args.device, env)
    depth_series: list[dict] = []
    learner_lines: list[str] = []
    t0 = time.monotonic()

    def pump_learner() -> None:
        for line in learner.stdout:  # type: ignore[union-attr]
            learner_lines.append(line)
            m = DEPTH_LINE.match(line)
            if m:
                depth_series.append({
                    "t": round(time.monotonic() - t0, 1),
                    "depth": int(m.group(1)), "acts": int(m.group(2)),
                    "unrolls": int(m.group(3)), "busy": int(m.group(4)),
                    "partial": int(m.group(5)), "weight_sends": int(m.group(6))})

    learner_pump = threading.Thread(target=pump_learner, daemon=True)
    learner_pump.start()

    actors: list[subprocess.Popen] = []
    actor_stats: dict[int, dict] = {}
    actor_pumps = []

    def pump_actor(k: int, proc: subprocess.Popen) -> None:
        for line in proc.stdout:  # type: ignore[union-attr]
            got = actor_stats_of(k, line)
            if got is not None:
                actor_stats[k] = got

    try:
        for k in range(args.actors):
            proc = spawn(["--mode", "actor", "--task", str(k)], "cpu", actor_env)
            actors.append(proc)
            pump = threading.Thread(target=pump_actor, args=(k, proc), daemon=True)
            pump.start()
            actor_pumps.append(pump)
        deadline = t0 + args.minutes * 60
        while time.monotonic() < deadline:
            if learner.poll() is not None:
                raise RuntimeError("learner exited early; see learner_tail.log")
            time.sleep(min(5.0, max(0.0, deadline - time.monotonic())))
    finally:
        for proc in actors:
            if proc.poll() is None:
                proc.send_signal(signal.SIGINT)
        for proc in actors:
            _stop(proc, timeout=30)
        _stop(learner, timeout=60)
        for pump in [learner_pump, *actor_pumps]:
            pump.join(timeout=10)
        (out / "learner_tail.log").write_text("".join(learner_lines[-200:]))

    # Learner throughput from metrics.jsonl (written by MetricsLogger).
    updates = 0
    metrics_file = run_dir / "metrics.jsonl"
    if metrics_file.exists():
        for line in metrics_file.read_text().splitlines():
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            updates = max(updates, int(row.get("step", 0)))

    wall_s = time.monotonic() - t0
    per_actor = {k: v.get("unrolls_sent", 0) for k, v in sorted(actor_stats.items())}
    counts = sorted(per_actor.values())
    versions = [v.get("weight_version") for v in actor_stats.values()
                if v.get("weight_version") is not None]
    last = depth_series[-1] if depth_series else {}
    summary = {
        "actors": args.actors,
        "wall_s": round(wall_s, 1),
        "learner_updates": updates,
        "updates_per_s": round(updates / wall_s, 2),
        "unrolls_accepted": last.get("unrolls"),
        "busy_replies": last.get("busy"),
        "partial_accepts": last.get("partial"),
        "weight_sends": last.get("weight_sends"),
        "queue_depth": {
            "series_points": len(depth_series),
            "max": max((d["depth"] for d in depth_series), default=None),
            "last": last.get("depth"),
        },
        "per_actor_unrolls": per_actor,
        "fairness": {
            "actors_reporting": len(counts),
            "min": counts[0] if counts else None,
            "max": counts[-1] if counts else None,
            "max_over_min": (round(counts[-1] / max(counts[0], 1), 2)
                             if counts else None),
        },
        "weight_versions": {
            "min": min(versions, default=None),
            "max": max(versions, default=None),
        },
    }
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    (out / "depth_series.jsonl").write_text(
        "".join(json.dumps(d) + "\n" for d in depth_series))
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
