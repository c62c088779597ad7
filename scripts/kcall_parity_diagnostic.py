"""Run chip_smoke.py's K-call parity (phase 18's `k_call_parity`) over many
gathered Ape-X batches on one CUDA card, with the CPU replay's ReLU
pattern pinned to the CUDA step's (the check as chip_smoke runs it) and
free (the check without `relu_tape`'s pin), to count how often a ReLU
input lands on either side of 0 on the two devices and what that does to
the gradients' bar.

The replay is filled as phase 18 fills it (the `apex` section's actors,
48 unroll blobs on 2 threads, 2 shards, no spill tier); each batch is
gathered with `RandomState(seed)` for seed 0, 1, ... until `--seconds`
have passed. One line a batch and mode goes to stdout and to `--out`,
then a summary line with the failures of each mode.

    python scripts/kcall_parity_diagnostic.py --seconds 360 --out kcall.txt
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from distributed_reinforcement_learning_tpu_torch.data import device_path, replay_service  # noqa: E402
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue  # noqa: E402
from distributed_reinforcement_learning_tpu_torch.runtime import launch, replay_shard  # noqa: E402
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=360.0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    out = args.out.open("w") if args.out else None

    def log(line: str) -> None:
        print(line, flush=True)
        if out:
            print(line, file=out, flush=True)

    agent_cfg, rt = cs.load_config(cs.CONFIG, "apex")
    svc = replay_service.ShardedReplayService(2, rt.replay_capacity, mode="transition",
                                              scorer="max", seed=0)
    queue = TrajectoryQueue(rt.queue_size)
    learner = launch.make_learner("apex", agent_cfg, rt, queue, WeightStore(), seed=0,
                                  device="cuda", replay_service=svc)
    blobs = cs.apex_unroll_blobs(agent_cfg, rt, learner, cs.SHARD_BLOBS)
    cs.ingest_on_threads(replay_shard.ReplayIngestFifo(svc, queue), blobs, 2)
    gather, tape = device_path.gather_scan_batch, cs.relu_tape
    modes = {"pinned": tape, "free": lambda t, pin=None: tape(t)}
    failures = dict.fromkeys(modes, 0)
    t0, n = time.time(), 0
    try:
        while time.time() - t0 < args.seconds:
            device_path.gather_scan_batch = (
                lambda s, b, k, rng, seed=n: gather(s, b, k, np.random.RandomState(seed)))
            for mode, relu_tape in modes.items():
                cs.relu_tape = relu_tape
                try:
                    line, ok = cs.k_call_parity(svc, agent_cfg, rt), True
                except (AssertionError, RuntimeError) as e:
                    line, ok = f"{type(e).__name__}: {e}", False
                failures[mode] += not ok
                log(f"seed {n} {mode} {'PASS' if ok else 'FAIL'} {line}")
            n += 1
    finally:
        device_path.gather_scan_batch, cs.relu_tape = gather, tape
        learner.close()
        svc.close()
    log(f"SUMMARY {n} batches: failures {failures}; {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
