"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises (and the script exits nonzero) on failure:

1. Require CUDA; print the device and its power limit (nvidia-smi).
2. Build every CUDA source of the port with nvcc, anew even where a
   library is already there, so that ptxas reports on every kernel in
   this process; print the build time and ptxas' register /
   shared-memory report. Beside them, g++ builds the port's native
   data-plane library (`cpp/`: ring queue, sum tree, batch gather) anew.
3. Hold each kernel against its plain PyTorch version on the card, at
   the main path's shape and larger ones, then time both (CUDA events
   over many eager calls, and per call inside a replayed CUDA graph,
   with the inputs rotated past the 50 MB L2 cache where they fit).
   V-trace (K1) at three shapes and on a set of NaN, +inf and -inf
   log-rhos, with and without the rho clip, each bit for bit equal to
   its plain version; each K1 call must make one kernel launch and run
   no other kernel, and ptxas may report no stack or spills for it.
   The LSTM forward and backward (K2a,
   K2b) at (T, B, H) = (10, 32, 512) and (10, 16, 512) (the r2d2 learn
   step and ingest), (20, 32, 256) and (20, 16, 256) (the r2d2_pixel
   learn step and ingest), (20, 256, 512) and (30, 32, 256), with ~15%
   dones, each kernel against its plain
   version and the gradients through `LSTMFunction` against autograd of
   the plain loop; the profiler may record no more than one device
   kernel per LSTM call (the persistent kernels), and the log gives each
   kernel's launch plan, ptxas' registers and spills, and its time a
   step. Then K1 and K2a/K2b fed bfloat16 through their wrappers (the
   cast to float32 the JAX kernels make): V-trace bit for bit, the LSTM
   pair at the r2d2_pixel shape at the tolerances above.
4. The IMPALA path: the `impala` section of config.json at full width
   (Breakout frames 84x84x4, NatureConv, LSTM 256, 18 actions, batch
   32 x 20, 4 actors x 5 envs), 3 learner updates on random seeded
   weights. Kernel launch counts are zeroed just before and read just
   after; the V-trace kernel must launch exactly twice per update, the
   metrics must be finite and the parameters must move. Then the
   synchronised learn-step time and a profiler breakdown of one step.
5. Device parity: one learn step from the same parameters on the same
   seeded batch on CUDA and on the CPU (TF32 off) must agree to rtol 1e-4
   on each loss term and the gradient norm.
6. The R2D2 path: the `r2d2` section at full width (CartPole-POMDP, MLP
   torso, LSTM 512, batch 32 x 10, 3 actors x 4 envs) through
   build_local and run_sync for 3 train steps (8 rounds). With the
   counts zeroed just before: exactly 2 K2a launches per ingest and 2
   K2a + 1 K2b per train step (22 and 3), finite loss and priorities,
   parameters that moved; then the synchronised learn step, a profiler
   breakdown that names K2's device time, and peak memory. The learner's
   replay must be `ArrayPrioritizedReplay` (`make_replay("auto")`).
7. R2D2 device parity: td_error and one learn step from the same
   parameters and seeded batch on CUDA and on the CPU (TF32 off): rtol
   1e-4 on loss, grad norm and priorities.
8. Flash attention (K3a forward, K3b dq, K3c dk/dv) at (B, H, T, D) =
   (16, 2, 16, 32) (the ximpala section's act and learn shape), (64, 4,
   32, 64) (bench.py's ximpala_learn shape) and (1, 4, 8192, 64), with
   ~8% dones in the segment ids: each kernel against its plain version,
   the gradients through `FlashAttentionFunction` against autograd of
   the plain `dense_attention`, and the yardstick
   `scaled_dot_product_attention` with a causal & same-segment mask
   against the same; each call must make one kernel launch and run no
   other kernel; then timings of all three beside their bounds and
   the launch floor (a one-element `add_` through the same harness, on
   its own log line), and ptxas' registers, stack and spills of the
   flash kernels (K3a, K3b and K3c at D = 32 and 64 must show none).
9. The Transformer-IMPALA path: the `ximpala` section at full width
   (CartPole, d_model 64, 2 heads, 2 layers, batch 16 x 16, 1 actor x 16
   envs) through build_local and run_sync for 3 updates. With the
   counts zeroed just before: exactly 16 x 2 + 2 K3a launches per update
   (the act calls and the learn forward, 102 in all), 2 K3b, 2 K3c and 2
   K1 per update (6 each) and no K2; finite metrics, parameters that
   moved; then the synchronised learn step, a profiler breakdown and
   the phase's own peak memory.
10. Transformer-IMPALA device parity: one learn step from the same
   parameters on the same seeded batch on CUDA and on the CPU (TF32
   off): rtol 1e-4 on each loss term and the gradient norm.
11. Multi-process IMPALA at full width: a learner process on CUDA
   (`train_impala --mode learner --section impala --updates 8`: the
   pinned prefetcher, async publication) fed over loopback TCP by 4 actor
   processes (`--mode actor --task k --device cpu`, 5 Breakout-sim envs
   each). Fails if any process exits non-zero, the learner does not take
   exactly 8 steps with 16 V-trace launches in its own process, or an
   actor never received a weight version above 0; logs the wall time per
   update, learned frames/s, the learner's busy share, the env frames/s
   the actors delivered, the H2D ms a batch, the publication latency,
   the queue depth at each step and the peak memory.
12. Multi-process `r2d2` and `ximpala`: one CUDA learner and one CPU actor
   each, 3 updates; the r2d2 learner on its monolithic replay
   (DRL_REPLAY_SHARDS=0, the sharded service's demotion target) launches
   K2a twice per ingest and per learn step and K2b once per learn step,
   the ximpala learner K3a, K3b, K3c once per layer and K1 twice per
   learn step.
13. Transport parity: a seeded `impala` batch through codec, server and
   client arrives bit-identical; a learner fed through the prefetcher
   matches the in-process learn step to rtol 1e-4; an async-published
   snapshot equals its version's parameters bit for bit.
14. `run_async` of each family in one process on CUDA, 3 updates.
15. The Ape-X path: the `apex` section at full width (Breakout frames
   84x84x4, NatureConv, dueling towers 256-256, batch 32, unrolls of 32,
   4 actors x 5 envs, replay 100,000) through build_local and run_sync
   for 5 updates. Fails unless the learner took 5 steps on an
   `ArrayPrioritizedReplay` over the port's native library built in
   phase 2 from `distributed_reinforcement_learning_tpu_torch/cpp/`, the
   replay holds at least 10 x 32 transitions, loss and TD are finite, the
   parameters moved, and no kernel launched (the counts are zeroed just
   before and read just after). Then the synchronised learn step, the TD
   ingest per 32-transition unroll pipelined and not, the replay's add
   and sample, a profiler breakdown of one learn step and the phase's
   own peak memory.
16. Ape-X device parity: `td_error` and one learn step from the same
   parameters on one seeded full-width batch on CUDA and on the CPU (TF32
   off): rtol 1e-4 on the loss, the grad norm, the gradients, the TD
   vector and the parameters after the step (where the two gradients
   agree to 0.1%; an element whose gradient sits at float32's noise
   floor gets Adam's lr-sized step either way, and is held to that
   bound).
17. Multi-process Ape-X at full width on the learner's monolithic replay
   (DRL_REPLAY_SHARDS=0, the demotion target of the sharded service that
   `run_role` builds by default): a CUDA learner (`train_apex --mode
   learner --section apex --updates 5`) fed over loopback TCP by 2 actor
   processes (`--mode actor --task k --device cpu`, 5 Breakout-sim envs
   each; 2 of the section's 4, since each warm actor step puts 1.81 MB
   and the actors share the learner's 8 cores). Fails if any process
   exits non-zero, the learner does not take exactly 5 steps, its queue
   is not `NativeTrajectoryQueue` or its replay not
   `ArrayPrioritizedReplay`, or no weight version above 0 reaches a
   client over TCP; logs the learner's unrolls ingested, MB received,
   ingest ms, queue depth at each step, busy share and peak memory, and
   the env frames/s the actors delivered.
18. The sharded replay in process, at the `apex` section's width: the
   port's `ShardedReplayService` with 2 shards over the section's
   capacity (100,000), the max scorer and the spill tier in a temporary
   directory (16 MiB hot a shard, 128-transition segments of ~7 MB). 48
   real unroll blobs of the section's 4 actors go in through the ingest
   facade on two threads, a shard each; an `ApexLearner` on CUDA over the
   service runs 5 K=1 and 2 K=4 train calls. Fails unless both shards
   hold blobs, no shard demoted, segments spilled (> 0) and promoted
   (>= 1) with no CRC drop, every call's metrics are finite and no kernel
   launched; then one K=4 call (`learn_many`) on CUDA against the CPU,
   TF32 off, at phase 16's bar at each of its 4 steps. Logs the ingest ms
   a blob per shard, the gather-sample of 32, the update route, the
   tier's counters (spilled, promoted, forced pads, CRC drops), the train
   calls at K=1 and K=4 and the phase's own peak memory.
19. Multi-process Ape-X with the learner `run_role` builds by default (no
   DRL_REPLAY_SHARDS or DRL_REPLAY_SPILL set, phase 18's spill sizes): 2
   actor processes, 5 updates. Fails unless the learner reports 2 shards
   with the spill tier on and healthy; logs the unrolls each shard
   ingested, the segments spilled, the learner's busy share, the env
   frames/s, the first step's time and the learner's peak memory.
20. Multi-process R2D2 with the default learner, from a temporary copy of
   the `r2d2` section with `updates_per_call: 2`: 1 actor process, 3
   train calls (6 learn steps). Fails unless the learner reports 2
   shards with the spill tier on, launched exactly 2 K2a and 1 K2b per
   learn step (12 and 6) and scored no ingest (so no K2a on ingest: the
   shards take max priorities); logs the sequences each shard ingested.
21. The Transformer-R2D2 path: the `xformer` section at full width
   (CartPole-POMDP, d_model 64, 2 heads, 2 layers, seq_len 10, burn-in
   5, batch 32, 3 actors x 4 envs) through build_local and run_sync for 3
   train steps (8 rounds). At seq_len 10 attention takes the dense
   route, so with the counts zeroed just before no kernel may launch;
   finite loss and priorities, parameters that moved, the learner's
   replay `ArrayPrioritizedReplay`; then the synchronised learn step
   and td_error, a profiler breakdown, the wall per round and the
   phase's own peak memory.
22. Transformer-R2D2 device parity, for `xformer` and `xformer_moe`:
   td_error and one learn step from the same parameters on one seeded
   full-width batch on CUDA and on the CPU (TF32 off). With experts,
   every routing call must first send every token to the same experts
   and slots on both devices; then rtol 1e-4 on loss, grad norm, TD and
   priorities, and the parameters after the step held as in phase 16.
23. Long context on K3: the `xformer` section's agent at seq_len 32
   (head dim 32: the flash route), remat off and then on: a learner on
   CUDA scores 64 seeded sequences and takes 3 train steps, then one
   td_error and one act on 12 windows of 32. With the counts zeroed
   before each: 4 K3a a td_error, 2 an act, and a learn step 4 K3a (6
   with remat, the recompute), 2 K3b and 2 K3c; no K1 or K2. The remat
   and plain gradients must agree on the card, and one learn step on
   CUDA and the CPU at phase 22's bar.
24. The `xformer_moe` section (4 experts, top-2, aux weight 0.01) as
   phase 21; the MoE aux term must be finite and above 0, and is logged
   beside the TD loss.
25. Multi-process Transformer-R2D2 with the learner `run_role` builds by
   default (no DRL_REPLAY_SHARDS or DRL_REPLAY_SPILL set): a CUDA learner
   (`train_xformer --mode learner --section xformer --updates 3`) and one
   CPU actor process. Fails unless the learner reports 2 shards with the
   spill tier on, takes 3 steps with no launch, and the actor held a
   weight version above 0; logs the sequences each shard ingested, the
   first step's time and the learner's peak memory.
26. The `r2d2_pixel` path: the section at full width (Breakout-sim
   84x84x4 uint8, Nature torso with fold_normalize, LSTM 256, batch 32 x
   seq_len 20 with a burn-in of 10 inside, replay 2,560, 3 actors x 4
   envs) through build_local and run_sync for 3 train steps (8 rounds):
   2 K2a per ingest and 2 K2a + 1 K2b per learn step at H 256 behind the
   conv torso (22 and 3), finite loss and priorities, parameters that
   moved; the learner's seeding (parameters from init_seed, the replay
   from RandomState(0), as the JAX launcher's) in its line; then the
   synchronised learn step and td_error, K2's device time and the peak.
27-29. `impala_atari_mix` (Breakout and Pong sims, 2 actors x 4 envs,
   batch 8), `impala_invaders` (SpaceInvaders sim, 6 actions, 4 actors x
   5 envs, batch 32), each 3 updates, and `impala_cartpole_scan` (K = 4:
   2 calls, 8 steps) through build_local and run_sync: exactly 2 K1
   launches a step and no other kernel, finite metrics, parameters that
   moved; each logs its actors' envs, the wall a call, the synchronised
   learn step (K-step call) and its own peak.
30. IMPALA options on the `impala` section's agent at full width: 3 learn
   steps each in float32, with `dtype=bfloat16` and with `remat=True` (2
   K1 launches a step, finite metrics), the synchronised step and the
   steps' own peak for each, and remat's gradients against the plain
   ones (within 1e-4 of each tensor's largest).
31. The `impala` section at full width through the port's local-cluster
   launcher (`launch_local_cluster.py`): the learner on CUDA, 4 CPU actor
   processes, 8 updates, (i) with the defaults (the shm weight board by
   its gate, rings off) and (ii) with DRL_SHM_RING=1. Each fails unless
   the launcher exits 0, the learner logged that it serves the board
   (and the rings), every actor logged that it attached them, no actor
   demoted to TCP before the learner began to shut down, the learner
   took 8 steps with exactly 2 K1 launches each, every actor held a
   weight version above 0 and no `drl*` segment is left in /dev/shm.
   Logs /dev/shm's size, and beside phase 11's TCP-only numbers the wall
   a step after the first, learned and env frames/s, the learner's busy
   share and `learn` stage, the board pulls and the actors' pull p50,
   the publication's handoff-to-board ms, and the ring puts and bytes.
32. The `r2d2` section through the launcher with DRL_SHM_RING=1: the
   learner's default sharded service fed by one actor's ring, 3
   updates. Fails unless the shards ingested every sequence the ring
   carried (and no TCP put), the learner took its 3 steps with 2 K2a and
   1 K2b launches each, and the checks of phase 31 on attaches,
   demotion and segments hold.
33. The respawn drill: `impala_cartpole` through the launcher with
   `--respawn on-exit`, rings and the board, 2 actors, 400 updates;
   actor 0 is SIGKILLed once it runs. Fails unless the launcher
   respawned it, the new actor attached its ring and board again, and
   the learner finished its 400 updates with 2 K1 launches each.
34. A `{"kernels": [...]}` line with each kernel's numbers (the Ape-X
   paths launch none; K1 carries phases 27-33's launches beside phase
   4's; K2a and K2b phase 20's, 26's and 32's beside phase 6's; K3a,
   K3b and K3c phase 23's beside phase 9's).
35. The device line, then `{"ok": true, "device": {...}}` as the last line.

Before each phase from 3 on, the device memory still allocated is
logged, so that the peaks of phases 4, 6, 9, 15, 18, 21, 23, 24 and
26-29 are read net of it.
Every child process runs in its own process group and is killed whole
if its phase fails.

Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.agents.common import batch_to_device
from distributed_reinforcement_learning_tpu_torch.agents.impala import ImpalaAgent, ImpalaBatch
from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Agent, R2D2Batch
from distributed_reinforcement_learning_tpu_torch.agents.xformer import (
    XformerAgent, XformerBatch)
from distributed_reinforcement_learning_tpu_torch.agents.ximpala import (
    XImpalaAgent, XImpalaBatch)
from distributed_reinforcement_learning_tpu_torch.data import replay_service
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue, tree_map
from distributed_reinforcement_learning_tpu_torch.ops.attention import dense_attention
from distributed_reinforcement_learning_tpu_torch.ops.kernels import _build
from distributed_reinforcement_learning_tpu_torch.ops.kernels import attention as kattn
from distributed_reinforcement_learning_tpu_torch.ops.kernels import lstm as klstm
from distributed_reinforcement_learning_tpu_torch.ops.kernels import vtrace as kvt
from distributed_reinforcement_learning_tpu_torch.ops.lstm import _scan_reference
from distributed_reinforcement_learning_tpu_torch.runtime.launch import build_local
from distributed_reinforcement_learning_tpu_torch.utils.config import load_config

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "config.json"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM, non-tensor-core float32
MAIN_SHAPE = (18, 32)  # V-trace at the impala section: T = trajectory - 2, B = batch
SHAPES = [MAIN_SHAPE, (20, 256), (20, 65536)]
UPDATES = 3
R2D2_UPDATES = 3  # warm-up takes 6 rounds of 12 sequences, so 8 rounds in all
# LSTM (T, B, H): the r2d2 learn step and ingest (12 sequences padded to
# 16), the r2d2_pixel section's learn step (T is seq_len 20, the burn-in
# of 10 inside) and ingest, a larger batch, and T 30 (a burn-in of 10 on
# top of seq_len 20).
LSTM_MAIN = (10, 32, 512)
LSTM_INGEST = (10, 16, 512)
LSTM_PIXEL = (20, 32, 256)
LSTM_SHAPES = [LSTM_MAIN, LSTM_INGEST, LSTM_PIXEL, (20, 16, 256), (20, 256, 512),
               (30, 32, 256)]
# Flash attention (B, H, T, D): the ximpala section's act and learn
# shape, bench.py's ximpala_learn shape, and a long sequence.
ATTN_MAIN = (16, 2, 16, 32)
ATTN_SHAPES = [ATTN_MAIN, (64, 4, 32, 64), (1, 4, 8192, 64)]
XIMPALA_UPDATES = 3
IMPALA_OPTION_STEPS = 3
SCAN_UPDATES = 8  # impala_cartpole_scan: 2 calls of K = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def vtrace_inputs(T: int, B: int, seed: int, device) -> list[torch.Tensor]:
    rng = np.random.RandomState(seed)
    arrays = [
        (rng.randn(T, B) * 0.3).astype(np.float32),  # log rhos
        ((rng.rand(T, B) > 0.1) * 0.99).astype(np.float32),  # discounts
        rng.randn(T, B).astype(np.float32),  # rewards
        rng.randn(T, B).astype(np.float32),  # values
        rng.randn(B).astype(np.float32),  # bootstrap
    ]
    return [torch.from_numpy(a).to(device) for a in arrays]


def vtrace_special_inputs(T: int, B: int, seed: int, device) -> list[torch.Tensor]:
    """`vtrace_inputs` with NaN, +inf and -inf log-rhos spread over the
    columns (a NaN log-rho comes from a taken action whose target and
    behaviour probabilities both underflow to 0)."""
    args = vtrace_inputs(T, B, seed, device)
    flat = args[0].view(-1)
    flat[0::7] = float("nan")
    flat[3::11] = float("inf")
    flat[5::13] = float("-inf")
    return args


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same bits everywhere, any NaN equal to any NaN."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a.masked_fill(nan, 0).view(torch.int32),
                            b.masked_fill(nan, 0).view(torch.int32)))


def check_no_spills(stem: str, kernels: str, where=lambda kernel: True) -> None:
    """Raise if ptxas reports stack or spills for a kernel of
    `csrc/<stem>.cu` whose name contains `kernels` and passes `where`,
    or if ptxas reported on none of them."""
    report = ptxas_report(stem)
    if not any(kernels in kernel for kernel in report):
        raise RuntimeError(f"no ptxas report for {kernels}* of csrc/{stem}.cu in this process")
    for kernel, line in report.items():
        spilled = [int(n) for n in re.findall(r"(\d+) bytes (?:stack|spill)", line)]
        spilled += [int(n) for n in re.findall(r"(\d+) bytes cumulative stack", line)]
        if kernels in kernel and where(kernel) and any(spilled):
            raise RuntimeError(f"{kernel} uses stack or spills: {line}")


def vtrace_bound_ms(T: int, B: int) -> tuple[float, str]:
    """Least time for one call: each input read once, each output written
    once, against ~10 float32 operations per element."""
    nbytes = (4 * T * B + B + 2 * T * B) * 4
    flops = 10 * T * B
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_eager_ms(fns, iters: int = 1000, warmup: int = 50) -> float:
    """Per-call time of eager calls, CUDA events around `iters` calls that
    cycle through `fns` (several input sets keep a large working set out
    of the 50 MB L2 cache, as the real caller would find it)."""
    for i in range(warmup):
        fns[i % len(fns)]()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fns, calls: int = 100, replays: int = 20) -> float:
    """Per-call device time: `calls` calls (cycling through `fns`)
    captured in one CUDA graph and replayed, so the host's launch cost
    drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def phase_memory(name: str) -> int:
    """Device memory still allocated as phase `name` starts, after
    gc.collect() and again after freeing cuBLAS's per-stream workspaces
    (PyTorch keeps one for every stream a cuBLAS call ran on, and counts
    it as allocated); logs both and returns the second, so that a phase's
    own peak can be read net of what came before it."""
    gc.collect()
    torch.cuda.synchronize()
    after_gc = torch.cuda.memory_allocated()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)  # private; absent on CPU builds
    if clear is not None:
        clear()
    start = torch.cuda.memory_allocated()
    log(f"[memory] {name} starts with {after_gc / 2**20:.1f} MiB allocated after gc.collect(), "
        f"{start / 2**20:.1f} MiB after freeing the cuBLAS workspaces")
    return start


def phase_build() -> Path:
    """-> the native library built here (the Ape-X phases check that the
    learners load it)."""
    import threading

    from distributed_reinforcement_learning_tpu_torch.data import native

    t0 = time.perf_counter()
    built: dict = {}

    def build_native():
        try:
            built["lib"] = native.build(force=True)
        except RuntimeError as e:  # raised below, on the main thread
            built["error"] = e
        built["s"] = time.perf_counter() - t0

    host = threading.Thread(target=build_native)
    host.start()  # g++ beside the nvcc builds
    libs = _build.build_all(force=True)  # ptxas' report of every kernel, for the checks
    log(f"[build] {len(libs)} CUDA source(s) built in {time.perf_counter() - t0:.2f} s "
        f"into {_build.BUILD_DIR.relative_to(ROOT)}")
    host.join()
    if "error" in built:
        raise built["error"]
    log(f"[build] native data-plane library built by g++ in {built['s']:.2f} s: "
        f"{built['lib'].relative_to(ROOT)}")
    for stem, text in sorted(_build.build_logs.items()):
        for line in text.splitlines():
            if "ptxas" in line and any(w in line for w in ("registers", "smem", "spill",
                                                            "Compiling", "Function")):
                log(f"[build] {stem}: {line.strip()}")
    return built["lib"]


def ptxas_report(stem: str) -> dict[str, str]:
    """Registers, stack and spills per kernel of `csrc/<stem>.cu`, from the
    `-Xptxas -v` output of this process's build."""
    report, name = {}, None
    for line in _build.build_logs.get(stem, "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill" in line:
            report[name] = line.strip()
        elif name and "Used" in line and "registers" in line:
            report[name] = line.split(":", 1)[1].strip() + "; " + report.get(name, "")
    return report


def launch_profile(fn, calls: int = 3) -> tuple[dict[str, int], int]:
    """Through torch.profiler over `calls` synchronised calls of `fn`:
    the device kernels (name -> count; copies and fills left out) and the
    number of kernel launches the host made through the CUDA runtime or
    driver API (`cudaLaunchKernel` and its kin)."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # once outside the profiler
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    counts: dict[str, int] = {}
    api = 0
    for e in prof.key_averages():  # a kernel's records may come in more than one group
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            if device_us(e) > 0 and not e.key.startswith(("Memcpy", "Memset")):
                counts[e.key] = counts.get(e.key, 0) + e.count
        elif e.key.startswith(("cudaLaunch", "cuLaunch")):
            api += e.count
    return counts, api


def device_kernels(fn, calls: int = 3) -> dict[str, int]:
    """The device kernels (name -> count) that `calls` synchronised calls
    of `fn` run, through torch.profiler (copies and fills left out)."""
    return launch_profile(fn, calls)[0]


def check_one_kernel_per_call(fn, kernel: str, calls: int = 3) -> str:
    """Raise unless `calls` calls of `fn` make exactly `calls` kernel
    launches on the host, and the device runs `kernel` and nothing else.
    The device's records are counted too, but the profiler drops one now
    and then (its log shows an "Activity Buffer Request" then): a device
    count below the host's is logged, never taken for a missing launch,
    and a window in which it recorded no kernel at all is profiled again
    (up to 3 windows). -> a line for the log."""
    for _ in range(3):
        launched, api = launch_profile(fn, calls)
        if launched:
            break
    names = list(launched)
    if api != calls or not names or any(kernel not in n for n in names):
        raise RuntimeError(f"{calls} calls made {api} kernel launches on the host and ran "
                           f"{launched} on the device, expected {calls} launches of {kernel}")
    return (f"{api} host launches in {calls} calls, the device's records: "
            f"{sum(launched.values())} of {kernel}")


def phase_vtrace() -> dict:
    """K1 against the plain version on the card, bit for bit (the kernel
    runs the plain version's operations in its order, NaN and inf
    included), one device kernel a call, no stack or spills; then
    timings."""
    max_err = 0.0
    for T, B in SHAPES:
        for clip in (1.0, None):
            for what, make in (("finite", vtrace_inputs), ("nan/inf", vtrace_special_inputs)):
                args = make(T, B, seed=T + B, device="cuda")
                vs, rhos = kvt.vtrace_cuda(*args, clip_rho_threshold=clip)
                want_vs, want_rhos = kvt.vtrace_plain(*args, clip_rho_threshold=clip)
                torch.cuda.synchronize()
                for name, a, b in (("vs", vs, want_vs), ("clipped_rhos", rhos, want_rhos)):
                    if not bit_equal(a, b):
                        diff = (a - b).abs().nan_to_num(nan=float("inf"))
                        raise RuntimeError(
                            f"vtrace T={T} B={B} clip_rho={clip} {what}: {name} differs from "
                            f"the plain version in {int((diff > 0).sum())} places")
                n_nan = int(torch.isnan(vs).sum())
                if what == "finite":
                    err = max(float((vs - want_vs).abs().max()),
                              float((rhos - want_rhos).abs().max()))
                    max_err = max(max_err, err)
                log(f"[vtrace] T={T} B={B} clip_rho={clip} {what} inputs: kernel and plain "
                    f"agree bit for bit ({n_nan} NaN vs)")
    args = vtrace_inputs(*MAIN_SHAPE, seed=0, device="cuda")
    log(f"[vtrace] {check_one_kernel_per_call(lambda: kvt.vtrace_cuda(*args), 'vtrace_kernel')}")
    for kernel, line in ptxas_report("vtrace").items():
        log(f"[vtrace] ptxas {kernel}: {line}")
    check_no_spills("vtrace", "vtrace_kernel")
    timings = {}
    for T, B in (MAIN_SHAPE, SHAPES[-1]):
        # The main path's 14 KB stay in L2 between its producer and the
        # kernel; the large shape rotates through 4 input sets (127 MB).
        sets = [vtrace_inputs(T, B, seed=i, device="cuda")
                for i in range(1 if B <= 4096 else 4)]
        kernel = [lambda a=a: kvt.vtrace_cuda(*a) for a in sets]
        plain = [lambda a=a: kvt.vtrace_plain(*a) for a in sets]
        row = {
            "ms": time_eager_ms(kernel),
            "plain_ms": time_eager_ms(plain),
            "graph_ms": time_graph_ms(kernel),
            "plain_graph_ms": time_graph_ms(plain, calls=20),
        }
        row["bound_ms"], row["bound_by"] = vtrace_bound_ms(T, B)
        timings[(T, B)] = row
        log(f"[vtrace] T={T} B={B}: kernel {row['ms'] * 1e3:.2f} us/call eager, "
            f"{row['graph_ms'] * 1e3:.2f} us in a graph; plain {row['plain_ms'] * 1e3:.2f} us "
            f"eager, {row['plain_graph_ms'] * 1e3:.2f} us in a graph; bound "
            f"{row['bound_ms'] * 1e3:.4f} us ({row['bound_by']})")
    return {"max_abs_err": max_err, "timings": timings}


def lstm_inputs(T: int, B: int, H: int, seed: int, device) -> list[torch.Tensor]:
    """(xg, wh, keep, h0, c0), time-major, with ~15% dones."""
    rng = np.random.RandomState(seed)
    arrays = [
        (rng.randn(T, B, 4 * H) * 0.5).astype(np.float32),
        (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
        (rng.rand(T, B) > 0.15).astype(np.float32),
        (rng.randn(B, H) * 0.1).astype(np.float32),
        (rng.randn(B, H) * 0.1).astype(np.float32),
    ]
    return [torch.from_numpy(a).to(device) for a in arrays]


def lstm_bound_ms(T: int, B: int, H: int, backward: bool) -> tuple[float, str]:
    """Least time for one call: the h @ Wh products (2*T*B*H*4H flops;
    the backward recomputes them and adds dgates @ Wh^T, twice that)
    against each input read once and each output written once."""
    flops = 2 * T * B * H * 4 * H * (2 if backward else 1)
    if backward:  # xg, wh, keep, h0, c0, h_all, c_all, dh_all, dhT, dcT -> dxg, dh0, dc0
        floats = 2 * T * B * 4 * H + H * 4 * H + T * B + 3 * T * B * H + 6 * B * H
    else:  # xg, wh, keep, h0, c0 -> h_all, c_all, hT, cT
        floats = T * B * 4 * H + H * 4 * H + T * B + 2 * T * B * H + 4 * B * H
    t_bytes, t_ops = 4 * floats / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def lstm_loss(h_all, hT, cT):
    """The loss of the JAX package's gradient test: touches h_all, hT, cT."""
    w = torch.cos(torch.arange(h_all.shape[-1], device=h_all.device, dtype=h_all.dtype))
    return (h_all * w).sum() + (hT ** 2).sum() + 0.3 * cT.sum()


def phase_lstm() -> dict:
    """K2a and K2b against their plain versions on the card, and the
    gradients through `LSTMFunction` against autograd of the plain loop;
    then timings. Tolerances: forward atol 1e-5 (512-term float32 sums in
    another order than cuBLAS), gradients atol 5e-5; dWh sums T*B
    products per entry, so its bar is 5e-5 times its largest magnitude
    where that exceeds 1."""
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err = {"fwd": 0.0, "bwd": 0.0}
    for T, B, H in LSTM_SHAPES:
        xg, wh, keep, h0, c0 = lstm_inputs(T, B, H, seed=T + B + H, device="cuda")
        got = klstm.lstm_fwd_cuda(xg, wh, keep, h0, c0)
        want = klstm.lstm_fwd_plain(xg, wh, keep, h0, c0)
        torch.cuda.synchronize()
        fwd_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        for name, a, b in zip(("h_all", "c_all", "hT", "cT"), got, want):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0, msg=lambda m, n=name: f"{n}: {m}")

        h_all, c_all = want[:2]
        rng = np.random.RandomState(T * B)
        dh_all, dhT, dcT = (torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda()
                            for s in ((T, B, H), (B, H), (B, H)))
        got = klstm.lstm_bwd_cuda(xg, wh, keep, h0, c0, h_all, c_all, dh_all, dhT, dcT)
        want = klstm.lstm_bwd_plain(xg, wh, keep, h0, c0, h_all, c_all, dh_all, dhT, dcT)
        torch.cuda.synchronize()
        bwd_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        for name, a, b in zip(("dxg", "dh0", "dc0"), got, want):
            torch.testing.assert_close(a, b, atol=5e-5, rtol=0, msg=lambda m, n=name: f"{n}: {m}")

        # End to end through autograd: the Function (K2a + K2b) against
        # autograd of the plain loop.
        leaves = [t.clone().requires_grad_(True) for t in (xg, wh, h0, c0)]
        out = klstm.LSTMFunction.apply(leaves[0], leaves[1], keep, leaves[2], leaves[3])
        grads = torch.autograd.grad(lstm_loss(*out), leaves)
        ref = [t.clone().requires_grad_(True) for t in (xg, wh, h0, c0)]
        h_ref, (hT_ref, cT_ref) = _scan_reference(ref[0], ref[1], keep, ref[2], ref[3])
        want = torch.autograd.grad(lstm_loss(h_ref, hT_ref, cT_ref), ref)
        torch.cuda.synchronize()
        dwh_bar = 5e-5 * max(1.0, float(want[1].abs().max()))
        for name, a, b in zip(("dxg", "dwh", "dh0", "dc0"), grads, want):
            atol = dwh_bar if name == "dwh" else 5e-5
            torch.testing.assert_close(a, b, atol=atol, rtol=0, msg=lambda m, n=name: f"{n}: {m}")
        grad_err = max(float((a - b).abs().max()) for a, b in zip(grads, want))
        dwh_err = float((grads[1] - want[1]).abs().max())
        err["fwd"] = max(err["fwd"], fwd_err)
        err["bwd"] = max(err["bwd"], bwd_err, grad_err)
        log(f"[lstm] T={T} B={B} H={H}: max |kernel - plain| forward {fwd_err:.3e}, "
            f"backward {bwd_err:.3e}; autograd grads {grad_err:.3e}, of which dWh "
            f"{dwh_err:.3e} against a bar of {dwh_bar:.3e} ({100 * dwh_err / dwh_bar:.1f}%)")

    timings = {}
    for T, B, H in LSTM_SHAPES:
        # Rotate through enough input sets to pass the 50 MB L2 cache.
        per_set = 4 * (T * B * 4 * H * 2 + H * 4 * H + 3 * T * B * H)
        sets = [lstm_inputs(T, B, H, seed=i, device="cuda")
                for i in range(max(1, min(8, -(-64 * 2**20 // per_set))))]
        bwd_sets = []
        for a in sets:
            h_all, c_all, _, _ = klstm.lstm_fwd_plain(*a)
            bwd_sets.append((*a, h_all, c_all, torch.ones_like(h_all),
                             torch.ones_like(a[3]), torch.ones_like(a[4])))
        row = {}
        for tag, kernel, plain, groups in (
                ("fwd", klstm.lstm_fwd_cuda, klstm.lstm_fwd_plain, sets),
                ("bwd", klstm.lstm_bwd_cuda, klstm.lstm_bwd_plain, bwd_sets)):
            k_fns = [lambda a=a: kernel(*a) for a in groups]
            p_fns = [lambda a=a: plain(*a) for a in groups]
            row[tag] = {
                "ms": time_eager_ms(k_fns, iters=200, warmup=20),
                "plain_ms": time_eager_ms(p_fns, iters=50, warmup=5),
                "graph_ms": time_graph_ms(k_fns, calls=20, replays=10),
                "plain_graph_ms": time_graph_ms(p_fns, calls=5, replays=10),
            }
            row[tag]["bound_ms"], row[tag]["bound_by"] = lstm_bound_ms(T, B, H, tag == "bwd")
            plan = klstm.lstm_plan(T, B, H, sms, backward=tag == "bwd")
            calls = 3
            launched = device_kernels(k_fns[0], calls)
            r = row[tag]
            # Only measured numbers go into the row: the plan is logged.
            r.update(us_per_step=r["graph_ms"] * 1e3 / T,
                     device_kernels_per_call=sum(launched.values()) / calls)
            log(f"[lstm] {tag} T={T} B={B} H={H}: kernel {r['ms'] * 1e3:.2f} us eager, "
                f"{r['graph_ms'] * 1e3:.2f} us in a graph ({r['us_per_step']:.2f} us a step); "
                f"plain {r['plain_ms'] * 1e3:.2f} us eager, {r['plain_graph_ms'] * 1e3:.2f} us "
                f"in a graph; bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}); "
                f"{len(groups)} input set(s); {plan.blocks} blocks x {plan.units} units, "
                f"{plan.rows}-row chunks, {plan.smem_bytes} bytes of shared memory a block; "
                f"device kernels in {calls} calls {launched}")
            # More than one kernel a call, or another kernel, is a fault; a
            # count below the calls is a record the profiler dropped.
            if (r["device_kernels_per_call"] > 1
                    or any(f"lstm_{tag}_kernel" not in k for k in launched)):
                raise RuntimeError(f"{calls} LSTM {tag} calls ran {launched} on the device, "
                                   f"expected {calls} launches of lstm_{tag}_kernel")
        timings[(T, B, H)] = row
    for kernel, line in sorted(ptxas_report("lstm").items()):
        log(f"[lstm] ptxas {kernel}: {line}")
    return {"max_abs_err": err, "timings": timings}


def phase_bf16_wrappers() -> dict:
    """K1 and K2a/K2b fed bfloat16 through their wrappers (the cast to
    float32 the JAX kernels make at their inputs): V-trace at the main
    shape bit for bit against the plain version of the cast inputs, the
    LSTM pair at the r2d2_pixel shape against theirs at phase 3's
    tolerances; each call one launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [a.to(torch.bfloat16) for a in vtrace_inputs(*MAIN_SHAPE, seed=1, device="cuda")]
    before = kvt.vtrace_cuda.launches
    got = kvt.vtrace(*args)
    want = kvt.vtrace_plain(*(a.float() for a in args))
    torch.cuda.synchronize()
    if kvt.vtrace_cuda.launches != before + 1 or not all(
            g.dtype == torch.float32 and bit_equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError("V-trace fed bfloat16 disagrees with its plain version")
    T, B, H = LSTM_PIXEL
    xg, wh, keep, h0, c0 = lstm_inputs(T, B, H, seed=2, device="cuda")
    xg16, keep16 = xg.to(torch.bfloat16), keep.to(torch.bfloat16)
    before = (klstm.lstm_fwd_cuda.launches, klstm.lstm_bwd_cuda.launches)
    got = klstm.lstm_fwd(xg16, wh, keep16, h0, c0)
    want = klstm.lstm_fwd_plain(xg16.float(), wh, keep16.float(), h0, c0)
    rng = np.random.RandomState(3)
    grads = [torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()
             for shape in ((T, B, H), (B, H), (B, H))]
    got_b = klstm.lstm_bwd(xg16, wh, keep16, h0, c0, want[0], want[1], *grads)
    want_b = klstm.lstm_bwd_plain(xg16.float(), wh, keep16.float(), h0, c0, want[0], want[1],
                                  *grads)
    torch.cuda.synchronize()
    fwd_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    bwd_err = max(float((g - w).abs().max()) for g, w in zip(got_b, want_b))
    if ((klstm.lstm_fwd_cuda.launches, klstm.lstm_bwd_cuda.launches)
            != (before[0] + 1, before[1] + 1) or fwd_err > 1e-5 or bwd_err > 5e-5
            or any(g.dtype != torch.float32 for g in (*got, *got_b))):
        raise RuntimeError(f"LSTM kernels fed bfloat16: forward {fwd_err:.3e}, backward "
                           f"{bwd_err:.3e}")
    log(f"[bf16] V-trace fed bfloat16 at {MAIN_SHAPE}: bit for bit the plain version of the "
        f"cast inputs; K2a/K2b fed a bfloat16 xg and keep at {LSTM_PIXEL}: max |kernel - plain| "
        f"forward {fwd_err:.3e}, backward {bwd_err:.3e}")
    return {"lstm_fwd": fwd_err, "lstm_bwd": bwd_err}


def seeded_batch(cfg, B: int, seed: int) -> ImpalaBatch:
    rng = np.random.RandomState(seed)
    T, A, H = cfg.trajectory, cfg.num_actions, cfg.lstm_size
    logits = rng.randn(B, T, A)
    behavior = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return ImpalaBatch(
        state=rng.randint(0, 256, (B, T, *cfg.obs_shape)).astype(np.uint8),
        reward=rng.choice([0.0, 0.0, 0.0, 1.0, 4.0, -1.0], (B, T)).astype(np.float32),
        action=rng.randint(0, A, (B, T)).astype(np.int32),
        done=rng.rand(B, T) < 0.05,
        behavior_policy=behavior.astype(np.float32),
        previous_action=rng.randint(0, A, (B, T)).astype(np.int32),
        initial_h=(rng.randn(B, T, H) * 0.1).astype(np.float32),
        initial_c=(rng.randn(B, T, H) * 0.1).astype(np.float32),
    )


def phase_main_path(mem_start: int) -> dict:
    agent_cfg, rt = load_config(CONFIG, "impala")
    learner, actors, run = build_local(agent_cfg, rt, seed=0, device="cuda")
    before = {k: v.detach().clone() for k, v in learner.state.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_launch_counts()
    t0 = time.perf_counter()
    result = run(learner, actors, UPDATES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"vtrace": kvt.vtrace_cuda.launches}

    peak = torch.cuda.max_memory_allocated()
    metrics = result["last_metrics"]
    log(f"[main] {UPDATES} updates, {result['frames']} env frames in {wall:.2f} s "
        f"({wall / UPDATES * 1e3:.1f} ms wall per update, "
        f"{result['frames'] / wall:.0f} env frames/s end to end); peak device memory "
        f"{peak / 2**20:.1f} MiB, {(peak - mem_start) / 2**20:.1f} MiB of it the phase's own; "
        f"launches {launches}")
    log(f"[main] last metrics {json.dumps(metrics)}")
    if launches["vtrace"] != 2 * UPDATES:
        raise RuntimeError(f"V-trace kernel launched {launches['vtrace']} times in "
                           f"{UPDATES} updates, expected {2 * UPDATES}")
    if learner.train_steps != UPDATES or not all(math.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"bad training result: steps {learner.train_steps}, {metrics}")
    moved = {k: float((learner.state.params[k].detach() - v).abs().max())
             for k, v in before.items()}
    still = [k for k, d in moved.items() if d == 0.0]
    if still:
        raise RuntimeError(f"parameters did not move: {still}")

    # Where an update's wall time goes: one actor unroll (20 act calls and
    # 20 steps of 5 envs), and the env steps alone.
    actor = actors[0]
    t0 = time.perf_counter()
    actor.run_unroll()
    torch.cuda.synchronize()
    unroll_ms = (time.perf_counter() - t0) * 1e3
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    for _ in range(agent_cfg.trajectory):
        actor.env.step(rng.randint(0, rt.available_action[0], actor.env.num_envs))
    env_ms = (time.perf_counter() - t0) * 1e3
    log(f"[main] one actor unroll ({agent_cfg.trajectory} steps x {actor.env.num_envs} envs): "
        f"{unroll_ms:.1f} ms, of which env steps alone take ~{env_ms:.1f} ms")

    # Learn-step time: host clock around learn steps that end in a sync,
    # on a seeded full-width batch (its host->device copy included).
    batch = seeded_batch(agent_cfg, rt.batch_size, seed=5)
    state = learner.state
    for _ in range(2):
        state, _ = learner.agent.learn(state, batch)
    torch.cuda.synchronize()
    steps = 10
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = learner.agent.learn(state, batch)
    torch.cuda.synchronize()
    learn_ms = (time.perf_counter() - t0) / steps * 1e3
    frames_per_s = rt.batch_size * agent_cfg.trajectory / (learn_ms / 1e3)
    log(f"[main] learn step {learn_ms:.2f} ms synchronised (B={rt.batch_size}, "
        f"T={agent_cfg.trajectory}): {frames_per_s:.0f} learned frames/s")

    profile_breakdown("one learn step", lambda: learner.agent.learn(state, batch))
    return {"launches": launches, "learn_ms": learn_ms, "wall_per_update_ms": wall / UPDATES * 1e3,
            "frames": result["frames"], "peak_mib": (peak - mem_start) / 2**20}


def phase_device_parity() -> None:
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    agent_cfg, _ = load_config(CONFIG, "impala")
    batch = seeded_batch(agent_cfg, 8, seed=7)
    results = {}
    for device in ("cuda", "cpu"):
        agent = ImpalaAgent(agent_cfg, device=device)
        state = agent.init_state(seed=11)
        _, metrics = agent.learn(state, batch)
        results[device] = {k: float(v) for k, v in metrics.items()}
    for k, want in results["cpu"].items():
        got = results["cuda"][k]
        if not math.isclose(got, want, rel_tol=1e-4):
            raise RuntimeError(f"cuda vs cpu learn step: {k} {got} vs {want}")
    worst = max(abs(results["cuda"][k] - v) / abs(v) for k, v in results["cpu"].items() if v)
    log(f"[parity] cuda vs cpu learn step agrees (worst rel diff {worst:.2e}): "
        f"{json.dumps(results['cuda'])}")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def device_us(e) -> float:
    """An event's own device time (the attribute's name changed across
    PyTorch versions)."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def profile_breakdown(what: str, fn) -> list:
    """torch.profiler over one synchronised call of `fn`: host time,
    device-kernel time, and the ten largest device items; -> the device
    items."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    total_us = sum(device_us(e) for e in events)
    log(f"[profile] {what}: {step_s * 1e3:.2f} ms host clock, {total_us / 1e3:.2f} ms "
        f"of device kernels ({100 * total_us / 1e3 / (step_s * 1e3):.1f}% busy)")
    for e in sorted(events, key=lambda e: -device_us(e))[:10]:
        log(f"[profile]   {device_us(e) / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    return events


def r2d2_batch(cfg, B: int, seed: int) -> tuple[R2D2Batch, np.ndarray]:
    """A seeded full-width sequence batch (CartPole-POMDP observations)
    and IS weights."""
    rng = np.random.RandomState(seed)
    T, H = cfg.seq_len, cfg.lstm_size
    batch = R2D2Batch(
        state=(rng.randn(B, T, 2) * 0.2 * 255).astype(np.int32),
        previous_action=rng.randint(0, cfg.num_actions, (B, T)).astype(np.int32),
        action=rng.randint(0, cfg.num_actions, (B, T)).astype(np.int32),
        reward=np.ones((B, T), np.float32),
        done=rng.rand(B, T) < 0.1,
        initial_h=(rng.randn(B, H) * 0.1).astype(np.float32),
        initial_c=(rng.randn(B, H) * 0.1).astype(np.float32),
    )
    return batch, (0.5 + 0.5 * rng.rand(B)).astype(np.float32)


def phase_r2d2(mem_start: int) -> dict:
    """The `r2d2` section at full width (CartPole-POMDP, MLP torso 256,
    LSTM 512, dueling head 128, batch 32 x 10, 3 actors x 4 envs) through
    build_local and run_sync for R2D2_UPDATES train steps."""
    agent_cfg, rt = load_config(CONFIG, "r2d2")
    learner, actors, run = build_local(agent_cfg, rt, seed=0, device="cuda")
    n_params = sum(p.numel() for p in learner.state.params.values())
    before = {k: v.detach().clone() for k, v in learner.state.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_launch_counts()
    t0 = time.perf_counter()
    result = run(learner, actors, R2D2_UPDATES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"lstm_fwd": klstm.lstm_fwd_cuda.launches,
                "lstm_bwd": klstm.lstm_bwd_cuda.launches, "vtrace": kvt.vtrace_cuda.launches}

    peak = torch.cuda.max_memory_allocated()
    per_round = sum(a.env.num_envs for a in actors) * agent_cfg.seq_len
    rounds = result["frames"] // per_round
    metrics = result["last_metrics"]
    log(f"[r2d2] {n_params:,} parameters; {R2D2_UPDATES} train steps in {rounds} rounds, "
        f"{result['frames']} env frames in {wall:.2f} s ({wall / rounds * 1e3:.1f} ms wall "
        f"per round, {result['frames'] / wall:.0f} env frames/s end to end); peak device "
        f"memory {peak / 2**20:.1f} MiB, {(peak - mem_start) / 2**20:.1f} MiB of it the "
        f"phase's own; launches {launches}; {seeding(learner)}")
    log(f"[r2d2] last metrics {json.dumps(metrics)}")
    want = {"lstm_fwd": 2 * rounds + 2 * R2D2_UPDATES, "lstm_bwd": R2D2_UPDATES, "vtrace": 0}
    if rounds != 8 or launches != want:
        raise RuntimeError(f"r2d2 path: {rounds} rounds, launches {launches}, expected 8 "
                           f"rounds and {want}")
    if type(learner.replay).__name__ != "ArrayPrioritizedReplay":
        raise RuntimeError(f"r2d2 learner replay is {type(learner.replay).__name__}, "
                           "not ArrayPrioritizedReplay")
    priorities = learner.replay.tree.export()[0]
    if (learner.train_steps != R2D2_UPDATES or not all(math.isfinite(v) for v in metrics.values())
            or not np.isfinite(priorities).all() or learner.replay.tree.total <= 0):
        raise RuntimeError(f"bad r2d2 result: steps {learner.train_steps}, {metrics}, "
                           f"priority total {learner.replay.tree.total}")
    still = [k for k, v in before.items()
             if float((learner.state.params[k].detach() - v).abs().max()) == 0.0]
    if still:
        raise RuntimeError(f"r2d2 parameters did not move: {still}")

    # Synchronised learn step and ingest scoring on replayed sequences.
    agent, state = learner.agent, learner.state
    batch, _, is_weight = learner.replay.sample(rt.batch_size, np.random.RandomState(0))
    ingest = tree_map(lambda x: x[:16], batch)
    for _ in range(2):
        agent.learn(state, batch, is_weight)
        agent.td_error(state, ingest)
    torch.cuda.synchronize()
    steps = 10
    t0 = time.perf_counter()
    for _ in range(steps):
        agent.learn(state, batch, is_weight)
    torch.cuda.synchronize()
    learn_ms = (time.perf_counter() - t0) / steps * 1e3
    t0 = time.perf_counter()
    for _ in range(steps):
        agent.td_error(state, ingest)
    torch.cuda.synchronize()
    td_ms = (time.perf_counter() - t0) / steps * 1e3
    frames_per_s = rt.batch_size * agent_cfg.seq_len / (learn_ms / 1e3)
    log(f"[r2d2] learn step {learn_ms:.2f} ms synchronised (B={rt.batch_size}, "
        f"T={agent_cfg.seq_len}): {frames_per_s:.0f} learned frames/s; ingest td_error "
        f"(B=16) {td_ms:.2f} ms")
    events = profile_breakdown("one r2d2 learn step", lambda: agent.learn(state, batch, is_weight))
    k2 = {e.key: (e.count, device_us(e)) for e in events if "lstm" in e.key}
    k2_us = sum(us for _, us in k2.values())
    total_us = sum(device_us(e) for e in events)
    log(f"[r2d2] K2 in one learn step: {sum(n for n, _ in k2.values())} device kernel(s), "
        f"{k2_us / 1e3:.3f} ms of {total_us / 1e3:.3f} ms of device time: "
        + "; ".join(f"{k[:40]} x{n} {us / 1e3:.3f} ms" for k, (n, us) in k2.items()))
    return {"launches": launches, "learn_ms": learn_ms, "td_ms": td_ms, "k2_ms": k2_us / 1e3,
            "wall_per_round_ms": wall / rounds * 1e3, "frames": result["frames"],
            "peak_mib": (peak - mem_start) / 2**20, "params": n_params}


def phase_r2d2_parity() -> None:
    """One R2D2 learn step (and the td_error before it) from the same
    parameters, target network and seeded batch on CUDA and on the CPU,
    TF32 off: rtol 1e-4 on loss, grad norm and priorities."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    agent_cfg, rt = load_config(CONFIG, "r2d2")
    batch, is_weight = r2d2_batch(agent_cfg, rt.batch_size, seed=7)
    results = {}
    for device in ("cuda", "cpu"):
        agent = R2D2Agent(agent_cfg, device=device)
        state = agent.init_state(seed=11)
        for k, v in agent.init_state(seed=12).params.items():
            state.target_params[k].copy_(v.detach())
        td = agent.td_error(state, batch).cpu().numpy()
        _, prio, metrics = agent.learn(state, batch, is_weight)
        results[device] = {"td": td, "prio": prio.cpu().numpy(),
                           **{k: float(v) for k, v in metrics.items()}}
    for k in ("loss", "grad_norm"):
        if not math.isclose(results["cuda"][k], results["cpu"][k], rel_tol=1e-4):
            raise RuntimeError(f"r2d2 cuda vs cpu learn step: {k} {results['cuda'][k]} "
                               f"vs {results['cpu'][k]}")
    worst = max(abs(results["cuda"][k] / results["cpu"][k] - 1) for k in ("loss", "grad_norm"))
    for k in ("td", "prio"):
        np.testing.assert_allclose(results["cuda"][k], results["cpu"][k], rtol=1e-4, atol=1e-7,
                                   err_msg=f"r2d2 cuda vs cpu {k}")
        worst = max(worst, float(np.max(np.abs(results["cuda"][k] - results["cpu"][k])
                                        / np.maximum(np.abs(results["cpu"][k]), 1e-7))))
    log(f"[parity] r2d2 cuda vs cpu learn step agrees (worst rel diff {worst:.2e}): "
        f"loss {results['cuda']['loss']}, grad_norm {results['cuda']['grad_norm']}")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def lstm_rows(k2: dict, r2d2: dict, r2d2_default: dict, r2d2_pixel: dict,
              launcher_r2d2: dict) -> list[dict]:
    """The K2a and K2b entries of the kernels line: `launches` from the
    r2d2 path (phase 6), with the default multi-process r2d2 learner's
    own count (phase 20, K=2 calls), the r2d2_pixel path's (phase 26) and
    the ring-fed r2d2 learner's (phase 32) beside it."""
    rows = []
    for tag, name, line in (("fwd", "lstm_fwd", 45), ("bwd", "lstm_bwd", 72)):
        t = k2["timings"][LSTM_MAIN][tag]
        rows.append({
            "name": name, "route": "cuda",
            "source": "distributed_reinforcement_learning_tpu_torch/csrc/lstm.cu",
            "replaces": f"distributed_reinforcement_learning_tpu/ops/pallas/lstm.py:{line}",
            "launches": r2d2["launches"][name], "max_abs_err": k2["max_abs_err"][tag],
            "launches_by_path": {"r2d2": r2d2["launches"][name],
                                 "multiprocess_r2d2_default": r2d2_default["launches"][name],
                                 "r2d2_pixel": r2d2_pixel["launches"][name],
                                 "launcher_r2d2_ring": launcher_r2d2["launches"][name]},
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "shape": list(LSTM_MAIN),
            "graph_ms": t["graph_ms"], "plain_graph_ms": t["plain_graph_ms"],
            "other_shapes": [{"shape": list(shape), **k2["timings"][shape][tag]}
                             for shape in LSTM_SHAPES[1:]],
        })
    return rows


def attention_inputs(B: int, H: int, T: int, D: int, seed: int, device):
    """q, k, v, dO `[BH, T, D]` and `[BH, T]` int32 segment ids (episode
    ids from ~8% dones, shared by the heads of a batch row)."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy((rng.randn(B * H, T, D) * s).astype(np.float32)).to(device)
                   for s in (0.3, 0.3, 0.3, 0.5))
    segs = np.repeat(np.cumsum(rng.rand(B, T) < 0.08, axis=1).astype(np.int32), H, axis=0)
    return q, k, v, torch.from_numpy(segs).to(device), do


def attended_pairs(segs: torch.Tensor) -> int:
    """(query, key) pairs with key <= query in the same segment, summed over
    rows: the work these inputs need. Episode ids increase along T, so a
    segment of length L holds L (L + 1) / 2 pairs."""
    rows = segs.cpu().numpy()
    assert (np.diff(rows, axis=1) >= 0).all()
    total = 0
    for row in rows:
        _, counts = np.unique(row, return_counts=True)
        total += int((counts * (counts + 1) // 2).sum())
    return total


def attention_bound_ms(kind: str, BH: int, T: int, D: int, pairs: int) -> tuple[float, str]:
    """Least time for one call: 4*D flops per attended pair forward (q.k
    and p.v), 6*D for dq (s, dO.v, ds.k) and 8*D for dk/dv (s, p.dO, dO.v,
    ds.q) at the float32 rate, against each input read and each output
    written once."""
    per_pair = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * D
    rows, mats = BH * T, BH * T * D
    floats = {"fwd": 3 * mats + 2 * rows + mats + rows,  # q k v qs ks -> o lse
              "dq": 4 * mats + 4 * rows + mats,  # q k v do qs ks lse delta -> dq
              "dkv": 4 * mats + 4 * rows + 2 * mats}[kind]  # ... -> dk dv
    t_bytes, t_ops = 4 * floats / HBM_BYTES_PER_S, per_pair * pairs / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flat_to_bthd(x: torch.Tensor, B: int, H: int) -> torch.Tensor:
    return x.reshape(B, H, x.shape[1], x.shape[2]).transpose(1, 2)


def bthd_to_flat(x: torch.Tensor) -> torch.Tensor:
    B, T, H, D = x.shape
    return x.transpose(1, 2).reshape(B * H, T, D)


def sdpa_mask(segs: torch.Tensor) -> torch.Tensor:
    T = segs.shape[1]
    causal = torch.ones(T, T, dtype=torch.bool, device=segs.device).tril()
    return causal[None] & (segs[:, :, None] == segs[:, None, :])


def phase_attention() -> dict:
    """K3a, K3b and K3c against their plain versions on the card, the
    gradients through `FlashAttentionFunction` against autograd of the
    plain `dense_attention`, and the library call held to the same bars;
    then timings. Tolerances: forward atol 1e-5 (o and lse); dq, dk, dv
    atol 1e-4 x max(1, max |ref|), the JAX package's gradient bar scaled
    where the gradients are large."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    err = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    timings = {}
    for B, H, T, D in ATTN_SHAPES:
        blk = kattn.flash_blocks(T)
        q, k, v, segs, do = attention_inputs(B, H, T, D, seed=T + D, device="cuda")
        o, lse = kattn.flash_fwd_cuda(q, k, v, segs, segs)
        want_o, want_lse = kattn.flash_fwd_plain(q, k, v, segs, segs, blk, blk)
        torch.cuda.synchronize()
        torch.testing.assert_close(o, want_o, atol=1e-5, rtol=0)
        torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0)
        fwd_err = max(float((o - want_o).abs().max()), float((lse - want_lse).abs().max()))

        delta = (do * want_o).sum(-1)
        dq = kattn.flash_dq_cuda(q, k, v, segs, segs, do, want_lse, delta)
        dk, dv = kattn.flash_dkv_cuda(q, k, v, segs, segs, do, want_lse, delta)
        want = kattn.flash_bwd_plain(q, k, v, segs, segs, do, want_lse, delta, blk, blk)
        torch.cuda.synchronize()
        bwd_err = {}
        for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            bar = 1e-4 * max(1.0, float(b.abs().max()))
            torch.testing.assert_close(a, b, atol=bar, rtol=0, msg=lambda m, n=name: f"{n}: {m}")
            bwd_err[name] = float((a - b).abs().max())

        # End to end through autograd: the Function (K3a + K3b + K3c)
        # against autograd of the dense reference; the library call too.
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = kattn.flash_attention_bhtd(*leaves, segs, segs, blk, blk)
        grads = torch.autograd.grad(out, leaves, do)
        ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        seg_b = segs[::H]
        ref = bthd_to_flat(dense_attention(*(flat_to_bthd(t, B, H) for t in ref_leaves),
                                           causal=True, q_seg=seg_b, k_seg=seg_b))
        ref_grads = torch.autograd.grad(ref, ref_leaves, do)
        mask = sdpa_mask(segs)
        lib_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        lib = F.scaled_dot_product_attention(*lib_leaves, attn_mask=mask)
        lib_grads = torch.autograd.grad(lib, lib_leaves, do)
        torch.cuda.synchronize()
        for what, got, got_grads in (("function", out, grads), ("library", lib, lib_grads)):
            torch.testing.assert_close(got, ref, atol=1e-5, rtol=0,
                                       msg=lambda m, w=what: f"{w} output vs dense: {m}")
            for name, a, b in zip(("dq", "dk", "dv"), got_grads, ref_grads):
                bar = 1e-4 * max(1.0, float(b.abs().max()))
                torch.testing.assert_close(a, b, atol=bar, rtol=0,
                                           msg=lambda m, n=name, w=what: f"{w} {n}: {m}")
        grad_err = max(float((a - b).abs().max()) for a, b in zip(grads, ref_grads))
        lib_err = max(float((a - b).abs().max()) for a, b in zip(lib_grads, ref_grads))
        err["fwd"] = max(err["fwd"], fwd_err)
        err["dq"] = max(err["dq"], bwd_err["dq"])
        err["dkv"] = max(err["dkv"], bwd_err["dk"], bwd_err["dv"])
        log(f"[attention] B={B} H={H} T={T} D={D}: max |kernel - plain| forward {fwd_err:.3e}, "
            f"dq {bwd_err['dq']:.3e}, dk {bwd_err['dk']:.3e}, dv {bwd_err['dv']:.3e}; "
            f"Function grads vs dense autograd {grad_err:.3e}; library grads vs dense "
            f"{lib_err:.3e}")
        del leaves, out, grads, ref_leaves, ref, ref_grads, lib_leaves, lib, lib_grads

        if (B, H, T, D) == ATTN_MAIN:
            one_kernel_per_call(q, k, v, segs, do, want_lse, delta)
        timings[(B, H, T, D)] = attention_timings(B, H, T, D, q, k, v, segs, do, want_lse,
                                                  delta, mask, blk)
    floor = launch_floor()
    log(f"[attention] launch floor: a one-element add_ takes {floor['ms'] * 1e3:.2f} us eager, "
        f"{floor['graph_ms'] * 1e3:.2f} us in a graph")
    flash_ptxas()
    return {"max_abs_err": err, "timings": timings, "launch_floor": floor}


def one_kernel_per_call(q, k, v, segs, do, lse, delta) -> None:
    """Through torch.profiler: each wrapper call of K3a, K3b and K3c runs
    exactly one device kernel, its own."""
    bwd_args = (q, k, v, segs, segs, do, lse, delta)
    for name, fn in (("flash_fwd_kernel", lambda: kattn.flash_fwd_cuda(q, k, v, segs, segs)),
                     ("flash_dq_kernel", lambda: kattn.flash_dq_cuda(*bwd_args)),
                     ("flash_dkv_kernel", lambda: kattn.flash_dkv_cuda(*bwd_args))):
        log(f"[attention] {name}'s wrapper: {check_one_kernel_per_call(fn, name)}")


def launch_floor() -> dict:
    """Per-call time of a one-element in-place add through the harness
    that times the kernels: what any launch costs, eager and in a graph."""
    x = torch.zeros(1, device="cuda")

    def fn():
        x.add_(1)

    return {"ms": time_eager_ms([fn], iters=500, warmup=20),
            "graph_ms": time_graph_ms([fn], calls=50, replays=10)}


def head_dim(kernel: str) -> str:
    """The D of a mangled flash kernel name (its template argument)."""
    return kernel.split("ILi")[1].split("E")[0]


def flash_ptxas() -> None:
    """Log ptxas' registers, stack and spills for each flash kernel; K3a,
    K3b and K3c at D = 32 and 64 must have no stack and no spills."""
    for kernel, line in sorted(ptxas_report("attention").items()):
        name = next(n for n in ("flash_fwd", "flash_dq", "flash_dkv") if n in kernel)
        log(f"[attention] ptxas {name} D={head_dim(kernel)}: {line}")
    check_no_spills("attention", "flash_", lambda kernel: head_dim(kernel) in ("32", "64"))


def attention_timings(B, H, T, D, q, k, v, segs, do, lse, delta, mask, blk) -> dict:
    """Eager and CUDA-graph per-call times of each kernel, its plain
    version and the library call, beside the bound of this data."""
    import torch.nn.functional as F

    big = T >= 1024
    eager = dict(iters=20, warmup=3) if big else dict(iters=500, warmup=20)
    graph = dict(calls=5, replays=3) if big else dict(calls=50, replays=10)
    plain_eager = dict(iters=5, warmup=1) if big else dict(iters=100, warmup=5)
    plain_graph = dict(calls=2, replays=3) if big else dict(calls=10, replays=5)
    lib_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(*lib_leaves, attn_mask=mask)
        return torch.autograd.grad(out, lib_leaves, do)

    bwd_args = (q, k, v, segs, segs, do, lse, delta)
    fns = {
        "fwd": (lambda: kattn.flash_fwd_cuda(q, k, v, segs, segs),
                lambda: kattn.flash_fwd_plain(q, k, v, segs, segs, blk, blk), sdpa_fwd),
        "dq": (lambda: kattn.flash_dq_cuda(*bwd_args),
               lambda: kattn.flash_bwd_plain(*bwd_args, blk, blk), sdpa_fwd_bwd),
        "dkv": (lambda: kattn.flash_dkv_cuda(*bwd_args), None, None),
    }
    pairs = attended_pairs(segs)
    causal_pairs = B * H * T * (T + 1) // 2
    rows = {}
    for kind, (kernel, plain, library) in fns.items():
        row = {"ms": time_eager_ms([kernel], **eager), "graph_ms": time_graph_ms([kernel], **graph)}
        row["bound_ms"], row["bound_by"] = attention_bound_ms(kind, B * H, T, D, pairs)
        row["bound_causal_ms"], row["bound_causal_by"] = attention_bound_ms(
            kind, B * H, T, D, causal_pairs)
        rows[kind] = row
        if plain is not None:
            row["plain_ms"] = time_eager_ms([plain], **plain_eager)
            row["plain_graph_ms"] = time_graph_ms([plain], **plain_graph)
            row["library_ms"] = time_eager_ms([library], **plain_eager)
            row["library_graph_ms"] = time_graph_ms([library], **plain_graph)
    # The plain backward and the library's backward each compute dq, dk and
    # dv together: the dk/dv row carries the same numbers.
    for key in ("plain_ms", "plain_graph_ms", "library_ms", "library_graph_ms"):
        rows["dkv"][key] = rows["dq"][key]
    for kind, r in rows.items():
        log(f"[attention] {kind} B={B} H={H} T={T} D={D}: kernel {r['ms'] * 1e3:.2f} us eager, "
            f"{r['graph_ms'] * 1e3:.2f} us in a graph; plain {r['plain_ms'] * 1e3:.2f} us eager, "
            f"{r['plain_graph_ms'] * 1e3:.2f} us in a graph; library "
            f"{r['library_ms'] * 1e3:.2f} us eager, {r['library_graph_ms'] * 1e3:.2f} us in a "
            f"graph; bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}, {pairs} attended "
            f"pairs), causal bound {r['bound_causal_ms'] * 1e3:.3f} us "
            f"({r['bound_causal_by']}, {causal_pairs} pairs)")
    return rows


def ximpala_batch(cfg, B: int, seed: int) -> XImpalaBatch:
    """A seeded full-width unroll batch (CartPole observations) whose
    recorded dones include extra shaped ones beside the env dones."""
    rng = np.random.RandomState(seed)
    T, A = cfg.trajectory, cfg.num_actions
    logits = rng.randn(B, T, A)
    env_done = rng.rand(B, T) < 0.05
    return XImpalaBatch(
        state=(rng.randn(B, T, *cfg.obs_shape) * 0.1).astype(np.float32),
        reward=np.ones((B, T), np.float32),
        action=rng.randint(0, A, (B, T)).astype(np.int32),
        done=env_done | (rng.rand(B, T) < 0.03),
        env_done=env_done,
        behavior_policy=(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(
            np.float32),
        previous_action=rng.randint(0, A, (B, T)).astype(np.int32),
    )


def zero_launch_counts() -> None:
    for fn in (kvt.vtrace_cuda, klstm.lstm_fwd_cuda, klstm.lstm_bwd_cuda, kattn.flash_fwd_cuda,
               kattn.flash_dq_cuda, kattn.flash_dkv_cuda):
        fn.launches = 0


def phase_ximpala(mem_start: int) -> dict:
    """The `ximpala` section at full width through build_local and
    run_sync for XIMPALA_UPDATES updates."""
    agent_cfg, rt = load_config(CONFIG, "ximpala")
    learner, actors, run = build_local(agent_cfg, rt, seed=0, device="cuda")
    n_params = sum(p.numel() for p in learner.state.params.values())
    before = {k: v.detach().clone() for k, v in learner.state.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_launch_counts()
    t0 = time.perf_counter()
    result = run(learner, actors, XIMPALA_UPDATES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"attention_fwd": kattn.flash_fwd_cuda.launches,
                "attention_dq": kattn.flash_dq_cuda.launches,
                "attention_dkv": kattn.flash_dkv_cuda.launches,
                "vtrace": kvt.vtrace_cuda.launches,
                "lstm": klstm.lstm_fwd_cuda.launches + klstm.lstm_bwd_cuda.launches}

    peak = torch.cuda.max_memory_allocated()
    metrics = result["last_metrics"]
    layers, T = agent_cfg.num_layers, agent_cfg.trajectory
    log(f"[ximpala] {n_params:,} parameters; {XIMPALA_UPDATES} updates, {result['frames']} env "
        f"frames in {wall:.2f} s ({wall / XIMPALA_UPDATES * 1e3:.1f} ms wall per update, "
        f"{result['frames'] / wall:.0f} env frames/s end to end); peak device memory "
        f"{peak / 2**20:.1f} MiB, {(peak - mem_start) / 2**20:.1f} MiB of it the phase's own; "
        f"launches {launches}")
    log(f"[ximpala] last metrics {json.dumps(metrics)}")
    # One actor round of 16 envs fills the batch of 16: per update, T act
    # calls and one learn forward, each through every layer.
    rounds = result["frames"] // (rt.envs_per_actor * rt.num_actors * T)
    want = {"attention_fwd": rounds * T * layers + XIMPALA_UPDATES * layers,
            "attention_dq": XIMPALA_UPDATES * layers, "attention_dkv": XIMPALA_UPDATES * layers,
            "vtrace": 2 * XIMPALA_UPDATES, "lstm": 0}
    if rounds != XIMPALA_UPDATES or launches != want or want["attention_fwd"] != 102:
        raise RuntimeError(f"ximpala path: {rounds} rounds, launches {launches}, expected "
                           f"{XIMPALA_UPDATES} rounds and {want}")
    if (learner.train_steps != XIMPALA_UPDATES
            or not all(math.isfinite(v) for v in metrics.values())):
        raise RuntimeError(f"bad ximpala result: steps {learner.train_steps}, {metrics}")
    still = [k for k, v in before.items()
             if float((learner.state.params[k].detach() - v).abs().max()) == 0.0]
    if still:
        raise RuntimeError(f"ximpala parameters did not move: {still}")

    # Where an update's wall time goes: one actor unroll (16 act calls on
    # 16 x 16 windows, 16 steps of 16 envs), and the env steps alone.
    actor = actors[0]
    t0 = time.perf_counter()
    actor.run_unroll()
    torch.cuda.synchronize()
    unroll_ms = (time.perf_counter() - t0) * 1e3
    actor.queue.get_batch(rt.batch_size, timeout=1.0)
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    for _ in range(T):
        actor.env.step(rng.randint(0, rt.available_action[0], actor.env.num_envs))
    env_ms = (time.perf_counter() - t0) * 1e3
    log(f"[ximpala] one actor unroll ({T} act calls, {T} steps x {actor.env.num_envs} envs): "
        f"{unroll_ms:.1f} ms, of which env steps alone take ~{env_ms:.1f} ms")

    batch = ximpala_batch(agent_cfg, rt.batch_size, seed=5)
    agent, state = learner.agent, learner.state
    for _ in range(2):
        agent.learn(state, batch)
    torch.cuda.synchronize()
    steps = 10
    t0 = time.perf_counter()
    for _ in range(steps):
        agent.learn(state, batch)
    torch.cuda.synchronize()
    learn_ms = (time.perf_counter() - t0) / steps * 1e3
    frames_per_s = rt.batch_size * T / (learn_ms / 1e3)
    log(f"[ximpala] learn step {learn_ms:.2f} ms synchronised (B={rt.batch_size}, T={T}): "
        f"{frames_per_s:.0f} learned frames/s")
    profile_breakdown("one ximpala learn step", lambda: agent.learn(state, batch))
    return {"launches": launches, "learn_ms": learn_ms, "unroll_ms": unroll_ms,
            "wall_per_update_ms": wall / XIMPALA_UPDATES * 1e3, "frames": result["frames"],
            "peak_mib": (peak - mem_start) / 2**20, "params": n_params}


def phase_ximpala_parity() -> None:
    """One ximpala learn step from the same parameters on the same seeded
    batch on CUDA and on the CPU, TF32 off: rtol 1e-4 on each loss term
    and the gradient norm."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    agent_cfg, rt = load_config(CONFIG, "ximpala")
    batch = ximpala_batch(agent_cfg, rt.batch_size, seed=7)
    results = {}
    for device in ("cuda", "cpu"):
        agent = XImpalaAgent(agent_cfg, device=device)
        _, metrics = agent.learn(agent.init_state(seed=11), batch)
        results[device] = {k: float(v) for k, v in metrics.items()}
    for k, want in results["cpu"].items():
        if not math.isclose(results["cuda"][k], want, rel_tol=1e-4):
            raise RuntimeError(f"ximpala cuda vs cpu learn step: {k} {results['cuda'][k]} "
                               f"vs {want}")
    worst = max(abs(results["cuda"][k] - v) / abs(v) for k, v in results["cpu"].items() if v)
    log(f"[parity] ximpala cuda vs cpu learn step agrees (worst rel diff {worst:.2e}): "
        f"{json.dumps(results['cuda'])}")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


# -- multi-process topology, transport parity, run_async -----------------------

MP_UPDATES = 8  # the multi-process impala phase: 8 updates, 4 CPU actor processes
MP_SMALL_UPDATES = 3  # the multi-process r2d2 and ximpala phases
MP_TIMEOUT_S = 300
# The replay learners' monolithic replay, the demotion target of the
# sharded service that `run_role` builds by default.
MONOLITHIC = {"DRL_REPLAY_SHARDS": "0"}
PAGEABLE_H2D_MS = 2.49  # PR 4's reading of the impala batch's pageable copy


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def last_json(text: str) -> dict:
    """The last line of a role's output that is a JSON object."""
    for line in reversed(text.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"no JSON line in:\n{text[-3000:]}")


def probe_weights(port: int, stop, versions: list) -> None:
    """A weight client of the learner on `port`: pulls every 0.1 s until
    `stop` is set or the learner is gone, appending each new version and
    its parameter count to `versions`."""
    from distributed_reinforcement_learning_tpu_torch.runtime.transport import (
        RemoteWeights, TransportClient, TransportError)

    # Up to 60 s for the learner to listen; once it has answered, one
    # reconnect attempt, so that the learner's exit ends the probe.
    client = TransportClient("127.0.0.1", port, connect_retries=60)
    weights, have = RemoteWeights(client, "cpu"), -1
    try:
        while not stop.is_set():
            got = weights.get_if_newer(have)
            client.connect_retries = 1
            if got is not None:
                params, have = got
                versions.append((have, sum(p.numel() for p in params.values())))
            stop.wait(0.1)
    except (TransportError, OSError):
        pass  # the learner has stopped serving
    finally:
        client.close()


def run_topology(algo: str, section: str, updates: int, actors: int,
                 versions: list | None = None, env_set: dict | None = None,
                 config: Path = CONFIG, tag: str = "") -> tuple[dict, list]:
    """One learner process on CUDA and `actors` actor processes with
    `--device cpu` (one torch thread each), over loopback TCP on a free
    port. Every process runs in its own process group; on any failure or
    timeout all of them are killed whole before this raises. With
    `versions`, a weight client in this process pulls from the learner
    while it runs (`probe_weights`). `env_set` sets (a value) or unsets
    (None) variables in every process's environment. -> (the learner's
    summary, the actors' summaries)."""
    import os
    import signal
    import threading

    port = free_port()
    env = dict(os.environ, DRL_LEARNER_ADDR=f"127.0.0.1:{port}")
    for key, value in (env_set or {}).items():
        if value is None:
            env.pop(key, None)
        else:
            env[key] = value
    actor_env = dict(env, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    base = [sys.executable, "-m", f"distributed_reinforcement_learning_tpu_torch.train_{algo}",
            "--config", str(config), "--section", section]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)

    def spawn(args, child_env, name):
        f = open(out_dir / f"smoke_{section}{tag}_{name}.log", "w+")
        proc = subprocess.Popen(base + args, cwd=ROOT, env=child_env, stdout=f,
                                stderr=subprocess.STDOUT, text=True, start_new_session=True)
        return proc, f

    procs = [spawn(["--mode", "learner", "--updates", str(updates)], env, "learner")]
    procs += [spawn(["--mode", "actor", "--task", str(k), "--device", "cpu",
                     "--actor_grace", "3"], actor_env, f"actor{k}") for k in range(actors)]
    stop = threading.Event()
    probe = None
    if versions is not None:
        probe = threading.Thread(target=probe_weights, args=(port, stop, versions),
                                 daemon=True)
        probe.start()
    try:
        deadline = time.monotonic() + MP_TIMEOUT_S
        for proc, _ in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        texts = []
        for proc, f in procs:
            f.seek(0)
            texts.append(f.read())
        bad = [(i, proc.returncode) for i, (proc, _) in enumerate(procs) if proc.returncode]
        if bad:
            raise RuntimeError(f"{section} topology: processes exited non-zero {bad}:\n"
                               + "\n".join(t[-2000:] for t in texts))
        return last_json(texts[0]), [last_json(t) for t in texts[1:]]
    finally:
        stop.set()
        if probe is not None:
            probe.join(timeout=30)
        for proc, f in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=30)
            f.close()


def impala_rates(learner: dict, actors: list, agent_cfg, rt) -> dict:
    """A multi-process IMPALA run's numbers from its roles' summaries."""
    T = agent_cfg.trajectory
    steps = learner["step_s"]
    n = len(steps)
    # Steps 2..n: the first pays the learner's one-off start-up (library
    # loads, cuDNN's first calls) and starts on a queue the actors filled
    # meanwhile; the last 4 start on a queue the learner has drained.
    steady = (steps[-1] - steps[0]) / (n - 1)
    tail = (steps[-1] - steps[-5]) / 4
    stage = learner["stage_total_ms"]
    steady_ms = (steps[-1] - steps[0]) * 1e3
    busy = (stage["learn"] + stage.get("publish", 0.0)) / steady_ms
    actor_rate = sum(a["frames"] / a["active_s"] for a in actors if a["active_s"] > 0)
    pulls = [a["weight_pulls"]["pull_ms_p50"] for a in actors
             if a["weight_pulls"]["pull_ms_p50"] is not None]
    return {
        "wall_per_update_ms": steady * 1e3, "tail_wall_per_update_ms": tail * 1e3,
        "first_step_s": steps[0], "learned_frames_per_s": rt.batch_size * T / steady,
        "busy_share": busy, "env_frames_per_s": actor_rate,
        "h2d_ms": learner["h2d_ms_per_batch"], "publish_ms": learner["stage_ms"]["publish"],
        "learn_ms": learner["stage_ms"]["learn"],
        "publish_land_ms": learner["publish_land_ms"], "peak_mib": learner["peak_device_mib"],
        "launches": learner["launches"],
        "pull_ms_p50": float(np.median(pulls)) if pulls else None,
        "weight_pulls": sum(a["weight_pulls"]["pulls"] for a in actors),
    }


def phase_multiprocess_impala() -> dict:
    """The `impala` section at full width across processes: the learner on
    CUDA (prefetcher, async publication), 4 actor processes of 5
    Breakout-sim envs on the CPU, MP_UPDATES updates over loopback TCP."""
    agent_cfg, rt = load_config(CONFIG, "impala")
    t0 = time.perf_counter()
    learner, actors = run_topology("impala", "impala", MP_UPDATES, rt.num_actors)
    total = time.perf_counter() - t0
    launches = learner["launches"]
    if learner["train_steps"] != MP_UPDATES or launches["vtrace"] != 2 * MP_UPDATES:
        raise RuntimeError(f"multi-process impala: {learner['train_steps']} steps, "
                           f"launches {launches}; expected {MP_UPDATES} and "
                           f"{2 * MP_UPDATES} V-trace launches")
    if any(a["weight_version"] <= 0 for a in actors):
        raise RuntimeError(f"an actor never received a weight version > 0: {actors}")
    steps = learner["step_s"]
    n = len(steps)
    steady = (steps[-1] - steps[0]) / (n - 1)
    tail = (steps[-1] - steps[-5]) / 4
    result = impala_rates(learner, actors, agent_cfg, rt)
    busy, actor_rate = result["busy_share"], result["env_frames_per_s"]
    log(f"[multiproc] impala: {learner['train_steps']} updates, {learner['frames_learned']} "
        f"frames learned; topology {total:.1f} s; learner loop {learner['wall_s']:.2f} s, "
        f"steps done at {[round(t, 3) for t in steps]} s; first step at {steps[0]:.2f} s "
        f"(start-up), then {steady * 1e3:.1f} ms wall per update = "
        f"{result['learned_frames_per_s']:.0f} learned frames/s ({tail * 1e3:.1f} ms over the "
        f"last 4); learner busy (learn + publish host time over steps "
        f"2..{n}) {100 * busy:.1f}%; the 4 actors delivered {actor_rate:.0f} env frames/s "
        f"(each actor's frames over its own active time, summed)")
    log(f"[multiproc] impala stage ms (mean a call over steps 2..{n}): "
        + ", ".join(f"{k} {v:.2f}" for k, v in learner["stage_ms"].items())
        + "; the first step: " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in learner["first_step_stage_ms"].items())
        + f"; H2D of a batch {learner['h2d_ms_per_batch']:.3f} ms on the copy stream "
        f"(each: {[round(x, 3) for x in learner['h2d_ms']]}; PR 4's pageable copy "
        f"{PAGEABLE_H2D_MS} ms); "
        f"publication lands {learner['publish_land_ms']:.2f} ms after its handoff "
        f"({learner['publishes_landed']} landed); queue depth at each step "
        f"{learner['queue_depth']}; {learner['transport']['bytes_received']} bytes received; "
        f"peak device memory {learner['peak_device_mib']:.1f} MiB; launches {launches}")
    for a in actors:
        log(f"[multiproc] impala actor {a['task']}: {a['frames']} env frames in "
            f"{a['active_s']:.2f} s, weight version {a['weight_version']}, {a['transport']}, "
            f"weight pulls {a['weight_pulls']}")
    log(f"[multiproc] impala weight pulls over TCP: {result['weight_pulls']} pulls, p50 "
        f"{result['pull_ms_p50']:.3f} ms (the actors' medians, median)")
    return result


def phase_multiprocess_small() -> dict:
    """The `r2d2` and `ximpala` sections across processes: one CUDA
    learner and one CPU actor each, MP_SMALL_UPDATES updates. The r2d2
    learner runs its monolithic replay (DRL_REPLAY_SHARDS=0, the sharded
    service's demotion target), which scores every ingest with K2a;
    phase 20 runs the default, sharded one."""
    out = {}
    lstm = klstm.lstm_fwd_cuda.launches
    for algo in ("r2d2", "ximpala"):
        agent_cfg, _ = load_config(CONFIG, algo)
        learner, actors = run_topology(algo, algo, MP_SMALL_UPDATES, 1,
                                       env_set=MONOLITHIC if algo == "r2d2" else None)
        n, got = MP_SMALL_UPDATES, learner["launches"]
        if algo == "r2d2":
            ingests = learner["stage_calls"].get("ingest_td", 0)
            want = {"lstm_fwd": 2 * ingests + 2 * n, "lstm_bwd": n, "vtrace": 0,
                    "attention_fwd": 0, "attention_dq": 0, "attention_dkv": 0}
        else:
            layers = agent_cfg.num_layers
            want = {"lstm_fwd": 0, "lstm_bwd": 0, "vtrace": 2 * n, "attention_fwd": n * layers,
                    "attention_dq": n * layers, "attention_dkv": n * layers}
        if learner["train_steps"] != n or got != want or (algo == "r2d2" and ingests == 0):
            raise RuntimeError(f"multi-process {algo}: {learner['train_steps']} steps, launches "
                               f"{got}, expected {want}; actor {actors[0]}")
        steps = learner["step_s"]
        log(f"[multiproc] {algo}: {n} updates in a {learner['wall_s']:.2f} s learner loop "
            + ("(DRL_REPLAY_SHARDS=0: the monolithic replay) " if algo == "r2d2" else "")
            + f"(first at {steps[0]:.2f} s), launches {got}, stage ms "
            + ", ".join(f"{k} {v:.2f}" for k, v in learner["stage_ms"].items())
            + f"; actor {actors[0]['frames']} env frames, weight version "
            f"{actors[0]['weight_version']}; peak {learner['peak_device_mib']:.1f} MiB")
        out[algo] = learner
    if klstm.lstm_fwd_cuda.launches != lstm:
        raise RuntimeError("a learner process's launches were counted in this process")
    return out


def phase_transport_parity() -> None:
    """A seeded full-width `impala` batch through codec.encode -> a
    TransportServer -> a TransportClient arrives bit-identical; a learner
    that takes it through the CUDA prefetcher matches one given the batch
    in process (rtol 1e-4, the learn-step bar); an async-published
    snapshot equals the parameters of its own version bit for bit."""
    from distributed_reinforcement_learning_tpu_torch.data import codec
    from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
    from distributed_reinforcement_learning_tpu_torch.runtime.impala_runner import ImpalaLearner
    from distributed_reinforcement_learning_tpu_torch.runtime.transport import (
        TransportClient, TransportServer)
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

    agent_cfg, rt = load_config(CONFIG, "impala")
    batch = seeded_batch(agent_cfg, rt.batch_size, seed=9)
    items = [type(batch)(*(x[i] for x in batch)) for i in range(rt.batch_size)]
    queue, store = TrajectoryQueue(rt.queue_size), WeightStore()
    port = free_port()
    server = TransportServer(queue, store, host="127.0.0.1", port=port).start()
    client = TransportClient("127.0.0.1", port)
    try:
        t0 = time.perf_counter()
        sent = client.put_trajectories(items)
        put_ms = (time.perf_counter() - t0) * 1e3
        wire = [queue.get(timeout=10.0) for _ in range(sent)]
    finally:
        client.close()
        server.stop()
    nbytes = sum(len(codec.encode(it)) for it in items)
    if sent != rt.batch_size or any(
            w._fields != it._fields or any(a.dtype != b.dtype or a.tobytes() != b.tobytes()
                                           for a, b in zip(w, it))
            for w, it in zip(wire, items)):
        raise RuntimeError("the impala batch did not arrive bit-identical over TCP")
    log(f"[parity] {sent} impala trajectories ({nbytes} bytes of blobs) arrived bit-identical "
        f"over loopback TCP in {put_ms:.1f} ms")

    agent = ImpalaAgent(agent_cfg, device="cuda")
    fed = TrajectoryQueue(rt.queue_size)
    for w in wire:
        fed.put(w)
    through = ImpalaLearner(agent, fed, WeightStore(), rt.batch_size, seed=11, prefetch=True)
    m_pre = through.step(timeout=30.0)
    state = agent.init_state(seed=11)
    _, m_in = agent.learn(state, batch)
    got = {k: float(v) for k, v in m_pre.items()}
    want = {k: float(v) for k, v in m_in.items()}
    for k, v in want.items():
        if not math.isclose(got[k], v, rel_tol=1e-4):
            raise RuntimeError(f"prefetched vs in-process learn step: {k} {got[k]} vs {v}")
    worst = 0.0
    for k, p in state.params.items():
        q = through.state.params[k].detach()
        if not torch.allclose(q, p.detach(), rtol=1e-4, atol=1e-7):
            raise RuntimeError(f"prefetched vs in-process parameters differ at {k}")
        worst = max(worst, float((q - p.detach()).abs().max()))
    log(f"[parity] the learner fed through the pinned prefetcher matches the in-process step "
        f"(max |param diff| {worst:.2e}): {json.dumps(got)}")

    # The learner published version 1 asynchronously after that step; the
    # next step updates the parameters in place right behind the clone.
    after_1 = {k: v.detach().clone() for k, v in through.state.params.items()}
    for w in wire:
        fed.put(w)
    through.step(timeout=30.0)
    if not through.weights.flush_async(timeout=30.0):
        raise RuntimeError("async publication did not land")
    snap, version = through.weights.get()
    blob, blob_version = through.weights.get_blob()
    host = codec.decode(blob, copy=True)
    if version != 2 or blob_version != 2:
        raise RuntimeError(f"published version {version}/{blob_version}, expected 2")
    after_2 = {k: v.detach() for k, v in through.state.params.items()}
    bad = [k for k, v in after_2.items()
           if not (bit_equal(snap[k], v) and host[k].tobytes() == v.cpu().numpy().tobytes())]
    moved = any(not torch.equal(after_1[k], after_2[k]) for k in after_2)
    through.close()
    if bad or not moved:
        raise RuntimeError(f"async snapshot differs from its version's parameters: {bad}")
    log(f"[parity] the async-published snapshot of version 2 (device tensors and blob) equals "
        f"that version's parameters bit for bit; publication landed in "
        f"{list(through.weights.land_ms)} ms")


def phase_run_async() -> dict:
    """`run_async` of each family in one process on CUDA for 3 updates
    (actor threads act on the card beside the learner)."""
    from distributed_reinforcement_learning_tpu_torch.runtime import (
        impala_runner, r2d2_runner, ximpala_runner)

    runners = {"impala": impala_runner, "r2d2": r2d2_runner, "ximpala": ximpala_runner}
    out = {}
    for algo, runner in runners.items():
        agent_cfg, rt = load_config(CONFIG, algo)
        learner, actors, _ = build_local(agent_cfg, rt, seed=0, device="cuda")
        before = {k: v.detach().clone() for k, v in learner.state.params.items()}
        t0 = time.perf_counter()
        runner.run_async(learner, actors, 3, learner.queue)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        moved = all(not torch.equal(learner.state.params[k].detach(), v) for k, v in before.items()
                    if v.numel() > 1)
        finite = all(torch.isfinite(p).all() for p in learner.state.params.values())
        if learner.train_steps < 3 or not moved or not finite:
            raise RuntimeError(f"run_async {algo}: {learner.train_steps} steps, moved {moved}, "
                               f"finite {finite}")
        log(f"[run_async] {algo}: {learner.train_steps} updates in {wall:.2f} s with "
            f"{len(actors)} actor thread(s) on the card; weight version "
            f"{learner.weights.version}")
        out[algo] = wall
    return out


APEX_UPDATES = 5  # the warm-up gate needs 10 ingested unrolls: ~3 rounds of 8 steps
APEX_MP_ACTORS = 2  # of the section's 4: each warm actor step puts 1.81 MB


def seeding(learner) -> str:
    """A replay learner's seeds, for its phase's line."""
    return (f"seeding: parameters from init_seed {learner.init_seed}, replay "
            f"RandomState({learner.replay_seed}) (as the JAX launcher)")


def all_launches() -> dict[str, int]:
    return {"vtrace": kvt.vtrace_cuda.launches, "lstm_fwd": klstm.lstm_fwd_cuda.launches,
            "lstm_bwd": klstm.lstm_bwd_cuda.launches,
            "attention_fwd": kattn.flash_fwd_cuda.launches,
            "attention_dq": kattn.flash_dq_cuda.launches,
            "attention_dkv": kattn.flash_dkv_cuda.launches}


def check_port_replay(replay, native_lib: Path) -> None:
    """The replay is the array backend over the library phase 2 built from
    the port's own `cpp/`."""
    from distributed_reinforcement_learning_tpu_torch.data import native

    name = type(replay).__name__
    loaded = native.loaded_path()
    port_build = ROOT / "distributed_reinforcement_learning_tpu_torch" / "cpp" / "build"
    if name != "ArrayPrioritizedReplay" or loaded != native_lib or loaded.parent != port_build:
        raise RuntimeError(f"replay {name} over {loaded}; expected ArrayPrioritizedReplay "
                           f"over {native_lib}, built in this run")


def apex_batch(cfg, B: int, seed: int):
    """A seeded full-width transition batch (raw uint8 frames) and IS weights."""
    from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexBatch

    rng = np.random.RandomState(seed)
    A = cfg.num_actions
    frames = lambda: rng.randint(0, 256, (B, *cfg.obs_shape)).astype(np.uint8)  # noqa: E731
    batch = ApexBatch(state=frames(), next_state=frames(),
                      previous_action=rng.randint(0, A, B).astype(np.int32),
                      action=rng.randint(0, A, B).astype(np.int32),
                      reward=rng.choice([0.0, 0.0, 1.0, 4.0, -1.0], B).astype(np.float32),
                      done=rng.rand(B) < 0.1)
    return batch, (0.3 + 0.7 * rng.rand(B)).astype(np.float32)


def time_ingest_ms(learner, unrolls: list, pipelined: bool) -> float:
    """ms per unroll of the learner's ingest (dequeue, TD forward, replay
    add) over `unrolls`, synchronised at the end."""
    learner.ingest_pipeline = pipelined
    for u in unrolls:
        learner.queue.put(u)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    while True:
        got = learner.ingest_many(max_unrolls=1, timeout=0.0)
        if not got:
            break
        n += got
    torch.cuda.synchronize()
    if n != len(unrolls):
        raise RuntimeError(f"ingest took {n} of {len(unrolls)} unrolls")
    return (time.perf_counter() - t0) / n * 1e3


def phase_apex(mem_start: int, native_lib: Path) -> dict:
    """The `apex` section at full width through build_local and run_sync
    for APEX_UPDATES updates."""
    agent_cfg, rt = load_config(CONFIG, "apex")
    learner, actors, run = build_local(agent_cfg, rt, seed=0, device="cuda")
    check_port_replay(learner.replay, native_lib)
    n_params = sum(p.numel() for p in learner.state.params.values())
    before = {k: v.detach().clone() for k, v in learner.state.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_launch_counts()
    t0 = time.perf_counter()
    result = run(learner, actors, APEX_UPDATES, close_learner=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()

    peak = torch.cuda.max_memory_allocated()
    metrics = result["last_metrics"]
    rounds = result["frames"] // (sum(a.env.num_envs for a in actors) * 8)
    log(f"[apex] {n_params:,} parameters; {learner.train_steps} updates in {rounds} rounds of "
        f"8 steps, {result['frames']} env frames in {wall:.2f} s ({wall / rounds * 1e3:.1f} ms "
        f"wall per round); {learner.ingested_unrolls} unrolls ingested, replay "
        f"{len(learner.replay)} transitions ({type(learner.replay).__name__}); peak device "
        f"memory {peak / 2**20:.1f} MiB, {(peak - mem_start) / 2**20:.1f} MiB of it the "
        f"phase's own; launches {launches}; {seeding(learner)}")
    log(f"[apex] last metrics {json.dumps(metrics)}")
    if any(launches.values()):
        raise RuntimeError(f"the Ape-X path launched kernels: {launches}")
    if learner.train_steps != APEX_UPDATES or len(learner.replay) < 10 * 32:
        raise RuntimeError(f"apex: {learner.train_steps} steps, replay {len(learner.replay)}")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"apex metrics not finite: {metrics}")
    still = [k for k, v in before.items()
             if float((learner.state.params[k].detach() - v).abs().max()) == 0.0]
    if still:
        raise RuntimeError(f"apex parameters did not move: {still}")

    agent, state = learner.agent, learner.state
    batch, _, is_weight = learner.replay.sample(rt.batch_size, np.random.RandomState(0))
    td = agent.td_error(state, batch)
    if td.shape != (rt.batch_size,) or not bool(torch.isfinite(td).all()):
        raise RuntimeError(f"apex td_error: shape {tuple(td.shape)}, finite "
                           f"{bool(torch.isfinite(td).all())}")

    # Synchronised learn step on a replay batch (its H2D copy included).
    for _ in range(2):
        agent.learn(state, batch, is_weight)
    torch.cuda.synchronize()
    steps = 10
    t0 = time.perf_counter()
    for _ in range(steps):
        agent.learn(state, batch, is_weight)
    torch.cuda.synchronize()
    learn_ms = (time.perf_counter() - t0) / steps * 1e3

    # Ingest per 32-transition unroll, plain and pipelined; then the
    # replay's add of one unroll and its sample of one batch.
    rng = np.random.RandomState(1)
    unrolls = [learner.replay.sample(32, rng)[0] for _ in range(40)]
    time_ingest_ms(learner, unrolls[:4], pipelined=False)  # warm
    plain_ms = time_ingest_ms(learner, unrolls[:20], pipelined=False)
    piped_ms = time_ingest_ms(learner, unrolls[20:], pipelined=True)
    td_np = np.abs(rng.randn(32))
    reps = 50
    t0 = time.perf_counter()
    for i in range(reps):
        learner.replay.add_batch_stacked(td_np, unrolls[i % len(unrolls)])
    add_ms = (time.perf_counter() - t0) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        learner.replay.sample(rt.batch_size, rng)
    sample_ms = (time.perf_counter() - t0) / reps * 1e3
    log(f"[apex] learn step {learn_ms:.2f} ms synchronised (B={rt.batch_size}: main net over "
        f"[s; s'] = {2 * rt.batch_size} frames, target over {rt.batch_size}): "
        f"{rt.batch_size / (learn_ms / 1e3):.0f} learned transitions/s; TD ingest per "
        f"32-transition unroll {plain_ms:.2f} ms plain, {piped_ms:.2f} ms pipelined; replay "
        f"add of one unroll {add_ms:.3f} ms, sample of {rt.batch_size} {sample_ms:.3f} ms")
    events = profile_breakdown("one apex learn step",
                               lambda: agent.learn(state, batch, is_weight))
    learner.close()
    total_us = sum(device_us(e) for e in events)
    return {"learn_ms": learn_ms, "ingest_ms": plain_ms, "ingest_pipelined_ms": piped_ms,
            "replay_add_ms": add_ms, "replay_sample_ms": sample_ms,
            "device_ms": total_us / 1e3, "wall_per_round_ms": wall / rounds * 1e3,
            "peak_mib": (peak - mem_start) / 2**20, "params": n_params, "launches": launches}


def adam_ratio_bound(t: int, b1: float = 0.9, b2: float = 0.999) -> float:
    """The most |mu_hat| / sqrt(nu_hat) can reach at Adam's step t, whatever
    the gradients (Cauchy-Schwarz over the bias-corrected weights of the t
    gradients): 1 at the first step, 1.007 at the fourth for the default
    b1 and b2. An Adam step moves a parameter by at most this times lr."""
    i = np.arange(1, t + 1)
    a = (1 - b1) * b1 ** (t - i) / (1 - b1 ** t)
    w = (1 - b2) * b2 ** (t - i) / (1 - b2 ** t)
    return float(np.sqrt(np.sum(a * a / w)))


def adam_step_close(name: str, p_got, p_want, g_got, g_want, lr: float, t: int = 1) -> int:
    """Parameters after Adam's step t on two devices, from the same state
    and their gradients. The gradients must agree to float32 accuracy
    (rtol 1e-4, atol 1e-5 of the tensor's largest). Where the two
    gradients agree to 0.1%, the step is settled and the parameters must
    agree to rtol 1e-4 (atol 1% of lr); elsewhere the gradient sits at
    float32's noise floor, Adam normalises it to up to lr either way (up
    to `adam_ratio_bound(t)` lr after the first step), and the parameters
    must differ by no more than twice that. -> the count of unsettled
    elements."""
    torch.testing.assert_close(g_got, g_want, rtol=1e-4, atol=1e-5 * float(g_want.abs().max()),
                               msg=lambda m: f"{name} gradient: {m}")
    settled = (g_got - g_want).abs() <= 1e-3 * g_want.abs()
    torch.testing.assert_close(p_got[settled], p_want[settled], rtol=1e-4, atol=1e-2 * lr,
                               msg=lambda m: f"{name} after the step: {m}")
    worst = float((p_got - p_want).abs().max())
    bound = 2 * adam_ratio_bound(t) * lr
    if worst > bound * (1 + 1e-5):
        raise RuntimeError(f"{name} after step {t} differs by {worst}, beyond Adam's {bound}")
    return int((~settled).sum())


def phase_apex_parity() -> None:
    """td_error and one Ape-X learn step (`grads` then `apply_grads`, which
    together are `learn`) from the same parameters (and a different target
    network) on one seeded full-width batch on CUDA and on the CPU, TF32
    off: rtol 1e-4 on the loss, the grad norm, the gradients, the TD vector
    and the parameters after the step (`adam_step_close`)."""
    from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexAgent

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    agent_cfg, rt = load_config(CONFIG, "apex")
    batch, is_weight = apex_batch(agent_cfg, rt.batch_size, seed=7)
    results = {}
    for device in ("cuda", "cpu"):
        agent = ApexAgent(agent_cfg, device=device)
        state = agent.init_state(seed=11)
        for k, v in agent.init_state(seed=12).params.items():
            state.target_params[k].copy_(v.detach())
        td0 = agent.td_error(state, batch).cpu().numpy()
        grads, td, loss = agent.grads(state, batch, is_weight)
        host_grads = {k: v.cpu() for k, v in grads.items()}
        _, metrics = agent.apply_grads(state, grads, loss)
        results[device] = {"td0": td0, "td": td.cpu().numpy(), "grads": host_grads,
                           "params": {k: v.detach().cpu() for k, v in state.params.items()},
                           **{k: float(v) for k, v in metrics.items()}}
    cu, cpu = results["cuda"], results["cpu"]
    for k in ("loss", "grad_norm", "learning_rate"):
        if not math.isclose(cu[k], cpu[k], rel_tol=1e-4):
            raise RuntimeError(f"apex cuda vs cpu learn step: {k} {cu[k]} vs {cpu[k]}")
    worst = max(abs(cu[k] / cpu[k] - 1) for k in ("loss", "grad_norm"))
    for k in ("td0", "td"):
        np.testing.assert_allclose(cu[k], cpu[k], rtol=1e-4, atol=1e-6,
                                   err_msg=f"apex cuda vs cpu {k}")
        worst = max(worst, float(np.max(np.abs(cu[k] - cpu[k])
                                        / np.maximum(np.abs(cpu[k]), 1e-6))))
    lr = agent_cfg.start_learning_rate
    unsettled = {k: adam_step_close(f"apex cuda vs cpu {k}", cu["params"][k], v,
                                    cu["grads"][k], cpu["grads"][k], lr)
                 for k, v in cpu["params"].items()}
    worst_p = max(float((cu["params"][k] - v).abs().max()) for k, v in cpu["params"].items())
    n = sum(v.numel() for v in cpu["params"].values())
    log(f"[parity] apex cuda vs cpu td_error and learn step agree (worst rel diff {worst:.2e} "
        f"on loss, grad norm and TD): loss {cu['loss']}, grad_norm {cu['grad_norm']}; "
        f"parameters after the step within {worst_p:.2e} ({worst_p / lr:.1e} of the learning "
        f"rate), {sum(unsettled.values())} of {n:,} elements at the gradients' noise floor "
        f"({ {k: c for k, c in unsettled.items() if c} })")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def phase_multiprocess_apex() -> dict:
    """The `apex` section at full width across processes: the learner on
    CUDA, APEX_MP_ACTORS actor processes of 5 Breakout-sim envs on the
    CPU, APEX_UPDATES updates over loopback TCP; the learner's monolithic
    replay (DRL_REPLAY_SHARDS=0), the demotion target of the sharded
    service that phase 19 runs."""
    versions: list = []
    t0 = time.perf_counter()
    learner, actors = run_topology("apex", "apex", APEX_UPDATES, APEX_MP_ACTORS,
                                   versions=versions, env_set=MONOLITHIC)
    total = time.perf_counter() - t0
    launches = learner["launches"]
    if (learner["train_steps"] != APEX_UPDATES or learner["queue"] != "NativeTrajectoryQueue"
            or learner["replay"] != "ArrayPrioritizedReplay" or any(launches.values())):
        raise RuntimeError(f"multi-process apex: {learner['train_steps']} steps, queue "
                           f"{learner['queue']}, replay {learner['replay']}, launches {launches}")
    if not any(v > 0 for v, _ in versions):
        raise RuntimeError(f"no weight version above 0 reached a client over TCP: {versions}")
    steps = learner["step_s"]
    n = len(steps)
    stage = learner["stage_total_ms"]
    steady_ms = (steps[-1] - steps[0]) * 1e3
    busy_keys = ("ingest_td", "ingest_td_sync", "ingest_replay_add", "replay_sample", "learn",
                 "replay_update", "publish")
    busy = sum(stage.get(k, 0.0) for k in busy_keys) / steady_ms if steady_ms > 0 else None
    # An actor's steps over its stepping time (a round cut short by the
    # learner's exit included; rounds of 64 steps are long beside 5 updates).
    _, rt = load_config(CONFIG, "apex")
    actor_rate = sum(a["env_steps"] * rt.envs_per_actor / a["stepping_s"] for a in actors
                     if a["stepping_s"] > 0)
    mb = learner["transport"]["bytes_received"] / 1e6
    calls = learner["stage_calls"]
    result = {"ingested_unrolls": learner["ingested_unrolls"], "mb_received": mb,
              "ingest_td_ms": learner["stage_ms"].get("ingest_td"), "busy_share": busy,
              "env_frames_per_s": actor_rate, "peak_mib": learner["peak_device_mib"],
              "queue_depth": learner["queue_depth"], "first_step_s": steps[0]}
    log(f"[multiproc] apex (DRL_REPLAY_SHARDS=0: the monolithic replay, the sharded "
        f"service's demotion target): {learner['train_steps']} updates, "
        f"{learner['ingested_unrolls']} "
        f"unrolls ingested ({learner['replay_size']} transitions in the "
        f"{learner['replay']}), {mb:.1f} MB received over the {learner['queue']}; topology "
        f"{total:.1f} s; learner loop {learner['wall_s']:.2f} s, steps done at "
        f"{[round(t, 3) for t in steps]} s; learner busy (ingest, replay, learn and publish "
        f"host time over steps 2..{n}) "
        + ("n/a" if busy is None else f"{100 * busy:.1f}%")
        + f"; the {len(actors)} actors delivered {actor_rate:.0f} env frames/s; queue depth at "
        f"each step {learner['queue_depth']}; peak device memory "
        f"{learner['peak_device_mib']:.1f} MiB; weight versions pulled by this process's "
        f"client {[v for v, _ in versions]}; launches {launches}")
    log(f"[multiproc] apex stage ms (mean a call over steps 2..{n}): "
        + ", ".join(f"{k} {v:.2f} (x{calls.get(k, 0)})" for k, v in learner["stage_ms"].items())
        + "; the first step: " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in learner["first_step_stage_ms"].items()))
    for a in actors:
        log(f"[multiproc] apex actor {a['task']}: {a['env_steps']} steps of "
            f"{rt.envs_per_actor} envs in {a['stepping_s']:.2f} s ({a['frames']} env frames in "
            f"completed rounds), weight version {a['weight_version']}, {a['transport']}")
    return result


# The spill tier's sizes in phases 18 and 19: at ~56 KB a transition
# (two uint8 84x84x4 frames), 128-transition segments of ~7 MB under a
# 16 MiB hot budget a shard, so that a few dozen unrolls spill and
# promote segments.
SPILL_ENV = {"DRL_REPLAY_SPILL_HOT_MB": "16", "DRL_REPLAY_SPILL_SEG": "128"}
SHARD_BLOBS = 48  # unrolls phase 18 ingests, half on each of 2 threads
SHARD_K = 4  # phase 18's K-update calls


def apex_unroll_blobs(agent_cfg, rt, learner, n: int) -> list[bytes]:
    """At least `n` codec blobs of the unrolls the `apex` section's 4
    actors put (acting on the card with `learner`'s published weights)."""
    from distributed_reinforcement_learning_tpu_torch.data import codec
    from distributed_reinforcement_learning_tpu_torch.runtime import launch

    queue = TrajectoryQueue(256)
    actors = [launch.make_actor("apex", agent_cfg, rt, i, queue, learner.weights,
                                seed=1 + i, agent=learner.agent)
              for i in range(rt.num_actors)]
    blobs: list[bytes] = []
    while len(blobs) < n:
        for actor in actors:
            actor.run_steps(8)
        while (item := queue.get(timeout=0.0)) is not None:
            blobs.append(bytes(codec.encode(item)))
    return blobs


def ingest_on_threads(facade, blobs: list[bytes], threads: int) -> list[list[float]]:
    """Each of `threads` threads puts its share of `blobs` through the
    facade (a thread owns a shard); -> each thread's ms per blob."""
    import threading

    times: list[list[float]] = [[] for _ in range(threads)]
    errors: list[BaseException] = []

    def run(i: int) -> None:
        try:
            for blob in blobs[i::threads]:
                t0 = time.perf_counter()
                if not facade.ingest_blob(blob):
                    raise RuntimeError("a facade ingest returned False")
                times[i].append((time.perf_counter() - t0) * 1e3)
        except BaseException as e:  # noqa: BLE001 — re-raised on the phase's thread
            errors.append(e)

    workers = [threading.Thread(target=run, args=(i,)) for i in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=300)
    if errors or any(w.is_alive() for w in workers):
        raise RuntimeError(f"sharded ingest failed: {errors}")
    return times


def k_call_parity(svc, agent_cfg, rt) -> str:
    """One K-update call (`learn_many`) on CUDA and on the CPU, TF32 off,
    from the same parameters (and another target network) on the same
    gathered [K, B] batch. Each of the K CUDA steps is taken again on the
    CPU from the state it started from (parameters, target, Adam moments,
    step) on its row of the batch, and held to phase 16's bar: loss, grad
    norm, learning rate, TD and gradients at rtol 1e-4, the parameters
    after it by `adam_step_close`. The call's stacked priorities and
    metrics must be its steps' own. The CPU's own K-call then ends within
    rtol 1e-4 (atol K x 1% of lr) of the CUDA call's parameters wherever
    the two calls' gradients agree to 0.1% at all K steps, and within the
    sum of Adam's K step bounds elsewhere. (A step of the two calls starts
    from parameters that earlier steps left apart at the gradients' noise
    floor, so their gradients are held to each other only through the
    parameters.) -> a log line."""
    from distributed_reinforcement_learning_tpu_torch.agents import common
    from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexAgent
    from distributed_reinforcement_learning_tpu_torch.data.device_path import gather_scan_batch

    def host(tensors: dict) -> dict:
        return {k: v.detach().cpu().clone() for k, v in tensors.items()}

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stacked, weights, _ = gather_scan_batch(svc, rt.batch_size, SHARD_K,
                                            np.random.RandomState(5))
    results = {}
    for device in ("cuda", "cpu"):
        agent = ApexAgent(agent_cfg, device=device)
        state = agent.init_state(seed=11)
        for k, v in agent.init_state(seed=12).params.items():
            state.target_params[k].copy_(v.detach())
        steps: list[dict] = []

        def recording_learn(st, batch, w, agent=agent, steps=steps):
            before = {"params": host(st.params), "target": host(st.target_params),
                      "mu": host(st.mu), "nu": host(st.nu), "step": st.step,
                      "batch": type(batch)(*(x.cpu() for x in batch)), "w": w.cpu()}
            grads, td, loss = agent.grads(st, batch, w)
            st, metrics = agent.apply_grads(st, grads, loss)
            steps.append({"before": before, "grads": host(grads), "td": td.cpu(),
                          "metrics": {k: float(torch.as_tensor(v)) for k, v in metrics.items()},
                          "params": host(st.params)})
            return st, td, metrics

        state, prio, metrics = common.learn_many(recording_learn, state, stacked, weights,
                                                 agent.device)
        results[device] = {"prio": prio.cpu(), "steps": steps,
                           "metrics": {k: v.cpu().numpy() for k, v in metrics.items()},
                           "params": host(state.params)}
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    cu, cpu = results["cuda"], results["cpu"]
    for i, s in enumerate(cu["steps"]):
        if not torch.equal(cu["prio"][i], s["td"]) or any(
                float(cu["metrics"][k][i]) != v for k, v in s["metrics"].items()):
            raise RuntimeError(f"K-call step {i}: stacked priorities or metrics are not the "
                               f"step's own")
    replay = ApexAgent(agent_cfg, device="cpu")
    worst_rel, grad_margin, unsettled_steps = 0.0, 0.0, 0
    for i, s in enumerate(cu["steps"]):
        b = s["before"]
        st = replay.state_from_params(b["params"])
        for name in st.params:
            st.target_params[name].copy_(b["target"][name])
            st.mu[name].copy_(b["mu"][name])
            st.nu[name].copy_(b["nu"][name])
        st.step = b["step"]
        grads, td, loss = replay.grads(st, b["batch"], b["w"])
        st, m = replay.apply_grads(st, grads, loss)
        for key in ("loss", "grad_norm", "learning_rate"):
            if not math.isclose(s["metrics"][key], float(m[key]), rel_tol=1e-4):
                raise RuntimeError(f"K-call step {i} cuda vs cpu {key}: "
                                   f"{s['metrics'][key]} vs {float(m[key])}")
        np.testing.assert_allclose(s["td"].numpy(), td.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=f"K-call step {i} cuda vs cpu TD")
        worst_rel = max(worst_rel, float(np.max(np.abs(s["td"].numpy() - td.numpy())
                                                / np.maximum(np.abs(td.numpy()), 1e-6))))
        lr_i = float(m["learning_rate"])
        for name, g in grads.items():
            err = (s["grads"][name] - g).abs() / (1e-5 * g.abs().max() + 1e-4 * g.abs())
            grad_margin = max(grad_margin, float(err.max()))
        unsettled_steps += sum(
            adam_step_close(f"K-call step {i} {name}", s["params"][name], p.detach(),
                            s["grads"][name], grads[name], lr_i, t=b["step"] + 1)
            for name, p in st.params.items())

    lr = agent_cfg.start_learning_rate
    bound = sum(2 * adam_ratio_bound(t) for t in range(1, SHARD_K + 1)) * lr
    unsettled, worst = 0, 0.0
    for name, want in cpu["params"].items():
        settled = torch.ones_like(want, dtype=torch.bool)
        for s_cu, s_cpu in zip(cu["steps"], cpu["steps"]):
            a, b = s_cu["grads"][name], s_cpu["grads"][name]
            settled &= (a - b).abs() <= 1e-3 * b.abs()
        got = cu["params"][name]
        torch.testing.assert_close(got[settled], want[settled], rtol=1e-4,
                                   atol=SHARD_K * 1e-2 * lr,
                                   msg=lambda m: f"K-call {name} after the call: {m}")
        diff = float((got - want).abs().max())
        if diff > bound * (1 + 1e-5):
            raise RuntimeError(f"K-call {name} differs by {diff}, beyond Adam's {bound}")
        unsettled += int((~settled).sum())
        worst = max(worst, diff)
    n = sum(v.numel() for v in cpu["params"].values())
    return (f"K={SHARD_K} call cuda vs cpu (TF32 off): each step within phase 16's bar from "
            f"the state it started from (TD worst rel {worst_rel:.2e}, "
            f"gradients at {grad_margin:.2f} of their bar, {unsettled_steps} element-steps at the gradients' noise floor), losses "
            f"{[s['metrics']['loss'] for s in cu['steps']]}; the two calls' parameters within "
            f"{worst:.2e} ({worst / lr:.1e} of lr), {unsettled} of {n:,} elements at the "
            f"noise floor")


def phase_apex_shards(native_lib: Path) -> dict:
    """The `apex` section's learner over the sharded replay service, in
    process: 2 shards over the section's capacity, the max scorer, the
    spill tier in a temporary directory at SPILL_ENV's sizes. 48 real
    unroll blobs of the section's actors go in on two threads (a shard
    each); an ApexLearner on CUDA over the service then runs 5 K=1 calls
    and 2 K=4 calls; one K=4 call is held against the CPU."""
    import dataclasses
    import os
    import shutil
    import tempfile

    from distributed_reinforcement_learning_tpu_torch.runtime import launch, replay_shard
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

    t_phase = time.perf_counter()
    agent_cfg, rt = load_config(CONFIG, "apex")
    spill_dir = tempfile.mkdtemp(prefix="smoke_spill_")
    saved = {k: os.environ.get(k) for k in (*SPILL_ENV, "DRL_REPLAY_SPILL_DIR")}
    os.environ.update(SPILL_ENV, DRL_REPLAY_SPILL_DIR=spill_dir)
    try:
        cfg = replay_shard.spill_config()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    svc = replay_service.ShardedReplayService(2, rt.replay_capacity, mode="transition",
                                              scorer="max", seed=0, spill=cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_start = torch.cuda.memory_allocated()
    try:
        queue = TrajectoryQueue(rt.queue_size)
        learner = launch.make_learner("apex", agent_cfg, rt, queue, WeightStore(), seed=0,
                                      device="cuda", replay_service=svc)
        check_port_replay(learner.replay, native_lib)
        learner4 = launch.make_learner(
            "apex", agent_cfg, dataclasses.replace(rt, updates_per_call=SHARD_K), queue,
            WeightStore(), seed=0, device="cuda", replay_service=svc)
        blobs = apex_unroll_blobs(agent_cfg, rt, learner, SHARD_BLOBS)
        facade = replay_shard.ReplayIngestFifo(svc, queue)
        zero_launch_counts()
        times = ingest_on_threads(facade, blobs, 2)
        if not svc.flush_tier(timeout=60.0):
            raise RuntimeError("the spill tier did not quiesce")
        shard_stats = svc.shard_stats()
        held = [s["ingested_blobs"] for s in shard_stats]
        if sum(held) != len(blobs) or min(held) == 0 or facade.demoted:
            raise RuntimeError(f"sharded ingest: {held} of {len(blobs)} blobs, demoted "
                               f"{facade.demoted}")
        spilled_at_ingest = sum(t["spilled_segments"] for t in svc.tier_stats())

        calls = {1: [], SHARD_K: []}
        for lrn, k, n in ((learner, 1, 5), (learner4, SHARD_K, 2)):
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics = lrn.train()
                torch.cuda.synchronize()
                if metrics is None or not all(math.isfinite(float(v)) for v in metrics.values()):
                    raise RuntimeError(f"sharded K={k} train call: {metrics}")
                calls[k].append((time.perf_counter() - t0) * 1e3)
        if learner.train_steps != 5 or learner4.train_steps != 2 * SHARD_K:
            raise RuntimeError(f"train steps {learner.train_steps}, {learner4.train_steps}")
        launches = all_launches()
        if any(launches.values()):
            raise RuntimeError(f"the sharded Ape-X path launched kernels: {launches}")

        rng = np.random.RandomState(3)
        sample_ms, route_ms = [], []
        for _ in range(10):
            t0 = time.perf_counter()
            _, idxs, _ = svc.sample(rt.batch_size, rng)
            sample_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            svc.update_batch(idxs, np.abs(rng.randn(rt.batch_size)))
            if not svc.flush_updates(timeout=30.0):
                raise RuntimeError("routed priority updates did not land")
            route_ms.append((time.perf_counter() - t0) * 1e3)
        if not svc.flush_tier(timeout=60.0):
            raise RuntimeError("the spill tier did not quiesce")
        tiers = svc.tier_stats()
        spilled = sum(t["spilled_segments"] for t in tiers)
        promoted = sum(t["promoted_segments"] for t in tiers)
        pads = sum(t["forced_pads"] for t in tiers)
        crc = sum(t["crc_dropped"] for t in tiers)
        if spilled == 0 or promoted < 1 or crc:
            raise RuntimeError(f"spill tier: {spilled} spilled, {promoted} promoted, {crc} "
                               f"CRC drops; {tiers}")
        peak = torch.cuda.max_memory_allocated()
        parity = k_call_parity(svc, agent_cfg, rt)
        stage = learner.timer.run_means_ms()
        stage4 = learner4.timer.run_means_ms()
        learner.close()
        learner4.close()
    finally:
        svc.close()
        shutil.rmtree(spill_dir, ignore_errors=True)
    med = lambda xs: float(np.median(xs))  # noqa: E731
    result = {
        "ingest_ms_per_blob": [med(t) for t in times], "ingested_per_shard": held,
        "sample_ms": med(sample_ms), "route_ms": med(route_ms),
        "spilled_segments": spilled, "spilled_at_ingest": spilled_at_ingest,
        "promoted_segments": promoted, "forced_pads": pads, "crc_dropped": crc,
        "train_k1_ms": med(calls[1]), "train_k4_ms": med(calls[SHARD_K]),
        "learn_k1_ms": stage.get("learn"), "learn_k4_ms": stage4.get("learn"),
        "peak_mib": (peak - mem_start) / 2**20, "seconds": time.perf_counter() - t_phase}
    log(f"[shards] apex, 2 shards over {rt.replay_capacity:,}, scorer max, spill tier in "
        f"{cfg.directory} ({cfg.hot_bytes // 2**20} MiB hot, {cfg.seg_items}-transition "
        f"segments): {len(blobs)} unroll blobs of the section's actors ({sum(map(len, blobs)) / 1e6:.1f} "
        f"MB) on 2 threads, {held} a shard; ingest ms a blob (median per shard) "
        f"{[round(x, 3) for x in result['ingest_ms_per_blob']]}; gather-sample of "
        f"{rt.batch_size} {result['sample_ms']:.3f} ms; update route (enqueue + router "
        f"apply) {result['route_ms']:.3f} ms; tier: {spilled} segments spilled "
        f"({spilled_at_ingest} by the end of ingest), {promoted} promoted, {pads} forced "
        f"pads, {crc} CRC drops")
    log(f"[shards] apex train calls (synchronised): K=1 {result['train_k1_ms']:.2f} ms "
        f"(learn stage {stage.get('learn', 0):.2f} ms), K={SHARD_K} "
        f"{result['train_k4_ms']:.2f} ms a call (learn stage {stage4.get('learn', 0):.2f} "
        f"ms); stages K=1 " + ", ".join(f"{k} {v:.2f}" for k, v in stage.items())
        + f"; K={SHARD_K} " + ", ".join(f"{k} {v:.2f}" for k, v in stage4.items())
        + f"; the phase's own peak device memory {result['peak_mib']:.1f} MiB; "
        f"launches {launches}; phase {result['seconds']:.1f} s")
    log(f"[shards] {parity}")
    return result


def phase_multiprocess_apex_default() -> dict:
    """The `apex` learner process as `run_role` builds it by default (no
    DRL_REPLAY_SHARDS or DRL_REPLAY_SPILL set): 2 ingest shards with the
    spill tier on, at phase 18's spill sizes; 2 CPU actor processes,
    APEX_UPDATES updates."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    spill_dir = tempfile.mkdtemp(prefix="smoke_spill_")
    try:
        learner, actors = run_topology(
            "apex", "apex", APEX_UPDATES, APEX_MP_ACTORS, tag="_default",
            env_set={"DRL_REPLAY_SHARDS": None, "DRL_REPLAY_SPILL": None,
                     "DRL_REPLAY_SPILL_DIR": spill_dir, **SPILL_ENV})
    finally:
        shutil.rmtree(spill_dir, ignore_errors=True)
    svc = learner["replay_service"]
    launches = learner["launches"]
    if (learner["train_steps"] != APEX_UPDATES or svc is None or svc["shards"] != 2
            or not svc["spill"] or not svc["healthy"] or any(launches.values())):
        raise RuntimeError(f"default apex learner: {learner['train_steps']} steps, replay "
                           f"service {svc}, launches {launches}")
    per_shard = [s["ingested_blobs"] for s in svc["shard_stats"]]
    spilled = sum(t["spilled_segments"] for t in svc["tier_stats"])
    steps = learner["step_s"]
    stage = learner["stage_total_ms"]
    steady_ms = (steps[-1] - steps[0]) * 1e3
    busy_keys = ("ingest_td", "ingest_td_sync", "ingest_replay_add", "replay_sample", "learn",
                 "replay_update", "publish")
    busy = sum(stage.get(k, 0.0) for k in busy_keys) / steady_ms if steady_ms > 0 else None
    _, rt = load_config(CONFIG, "apex")
    actor_rate = sum(a["env_steps"] * rt.envs_per_actor / a["stepping_s"] for a in actors
                     if a["stepping_s"] > 0)
    result = {"ingested_per_shard": per_shard, "spilled_segments": spilled,
              "busy_share": busy, "env_frames_per_s": actor_rate, "first_step_s": steps[0],
              "peak_mib": learner["peak_device_mib"], "seconds": time.perf_counter() - t_phase}
    log(f"[multiproc] apex default learner: sharded replay, {svc['shards']} shards, scorer "
        f"{svc['scorer']}, spill tier {'on' if svc['spill'] else 'off'}; "
        f"{learner['train_steps']} updates; unrolls ingested a shard {per_shard} (the server "
        f"accepted {learner['transport']['unrolls_accepted']}); {spilled} segments spilled; "
        f"learner busy (host time of its stages over steps 2..{len(steps)}) "
        + ("n/a" if busy is None else f"{100 * busy:.1f}%")
        + f"; the {len(actors)} actors delivered {actor_rate:.0f} env frames/s; first step "
        f"{steps[0]:.2f} s into the loop, steps at {[round(t, 3) for t in steps]} s; stage ms "
        + ", ".join(f"{k} {v:.2f}" for k, v in learner["stage_ms"].items())
        + f"; peak device memory {learner['peak_device_mib']:.1f} MiB; tier "
        f"{[{k: t[k] for k in ('spilled_segments', 'promoted_segments', 'forced_pads', 'crc_dropped')} for t in svc['tier_stats']]}; "
        f"phase {result['seconds']:.1f} s")
    return result


R2D2_K = 2  # phase 20's updates_per_call
R2D2_K_CALLS = 3


def phase_multiprocess_r2d2_default() -> dict:
    """The `r2d2` learner process as `run_role` builds it by default, from
    a temporary copy of the section with `updates_per_call: 2`: 1 CPU
    actor, 3 train calls. The sharded service scores at ingest with the
    max scorer, so no K2a may launch on ingest; each of the 6 learn steps
    launches 2 K2a and 1 K2b."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="smoke_r2d2_"))
    try:
        sections = json.loads(CONFIG.read_text())
        config = tmp / "config.json"
        config.write_text(json.dumps({"r2d2": {**sections["r2d2"],
                                               "updates_per_call": R2D2_K}}))
        steps_total = R2D2_K * R2D2_K_CALLS
        learner, actors = run_topology(
            "r2d2", "r2d2", steps_total, 1, config=config, tag="_default",
            env_set={"DRL_REPLAY_SHARDS": None, "DRL_REPLAY_SPILL": None,
                     "DRL_REPLAY_SPILL_DIR": str(tmp / "spill")})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    svc = learner["replay_service"]
    got = learner["launches"]
    ingest_calls = learner["stage_calls"].get("ingest_td", 0)
    want = {"lstm_fwd": 2 * steps_total, "lstm_bwd": steps_total, "vtrace": 0,
            "attention_fwd": 0, "attention_dq": 0, "attention_dkv": 0}
    if (learner["train_steps"] != steps_total or svc is None or svc["shards"] != 2
            or not svc["spill"] or got != want or ingest_calls != 0):
        raise RuntimeError(f"default r2d2 learner: {learner['train_steps']} steps, launches "
                           f"{got} (expected {want}), {ingest_calls} ingest scorings, "
                           f"service {svc}")
    per_shard = [s["ingested_blobs"] for s in svc["shard_stats"]]
    steps = learner["step_s"]
    result = {"launches": got, "ingested_per_shard": per_shard, "first_step_s": steps[0],
              "peak_mib": learner["peak_device_mib"], "seconds": time.perf_counter() - t_phase}
    log(f"[multiproc] r2d2 default learner, updates_per_call {R2D2_K}: "
        f"{learner['train_steps']} learn steps in {len(steps)} calls; launches in the learner "
        f"{got} (K2a {got['lstm_fwd']}, K2b {got['lstm_bwd']}: 2 and 1 a learn step); "
        f"{ingest_calls} ingest scorings, so no K2a on ingest; sequences ingested a shard "
        f"{per_shard} (scorer {svc['scorer']}, spill tier {'on' if svc['spill'] else 'off'}); "
        f"calls done at {[round(t, 3) for t in steps]} s; stage ms "
        + ", ".join(f"{k} {v:.2f}" for k, v in learner["stage_ms"].items())
        + f"; actor {actors[0]['frames']} env frames; peak {learner['peak_device_mib']:.1f} "
        f"MiB; phase {result['seconds']:.1f} s")
    return result


# -- Transformer-R2D2 (phases 21-25) --------------------------------------------

XFORMER_UPDATES = 3  # 8 rounds of 12 sequences: the warm-up gate needs 64
XFORMER_LONG_T = 32  # phase 23's seq_len: the flash route at head dim 32


def xformer_batch(cfg, B: int, seed: int) -> tuple[XformerBatch, np.ndarray]:
    """A seeded full-width sequence batch (CartPole-POMDP observations,
    quantised x255 as the actors send them) and IS weights."""
    rng = np.random.RandomState(seed)
    T = cfg.seq_len
    batch = XformerBatch(
        state=(rng.randn(B, T, 2) * 0.2 * 255).astype(np.int32),
        previous_action=rng.randint(0, cfg.num_actions, (B, T)).astype(np.int32),
        action=rng.randint(0, cfg.num_actions, (B, T)).astype(np.int32),
        reward=np.ones((B, T), np.float32),
        done=rng.rand(B, T) < 0.1,
    )
    return batch, (0.5 + 0.5 * rng.rand(B)).astype(np.float32)


def td_and_aux(agent, state, batch, is_weight) -> tuple[float, float]:
    """(the IS-weighted TD loss, the MoE aux term) of one batch, without a
    step: the two parts of the loss `learn` reports."""
    from distributed_reinforcement_learning_tpu_torch.agents import common

    dev = common.batch_to_device(batch, agent.device)
    w = torch.as_tensor(is_weight, dtype=torch.float32, device=agent.device)
    with torch.no_grad():
        tv, sav, aux = agent._sequence_td(state.params, state.target_params, dev)
        td = torch.mean(torch.mean(torch.square(tv - sav), dim=1) * w)
    return float(td), float(aux)


def phase_xformer(mem_start: int, section: str) -> dict:
    """A Transformer-R2D2 section at full width (CartPole-POMDP, d_model
    64, 2 heads, 2 layers, seq_len 10, batch 32, 3 actors x 4 envs)
    through build_local and run_sync for XFORMER_UPDATES train steps. At
    seq_len 10 attention takes the dense route: no kernel may launch."""
    agent_cfg, rt = load_config(CONFIG, section)
    t_phase = time.perf_counter()
    learner, actors, run = build_local(agent_cfg, rt, seed=0, device="cuda")
    n_params = sum(p.numel() for p in learner.state.params.values())
    before = {k: v.detach().clone() for k, v in learner.state.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_launch_counts()
    t0 = time.perf_counter()
    result = run(learner, actors, XFORMER_UPDATES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()

    peak = torch.cuda.max_memory_allocated()
    per_round = sum(a.env.num_envs for a in actors) * agent_cfg.seq_len
    rounds = result["frames"] // per_round
    metrics = result["last_metrics"]
    log(f"[{section}] {n_params:,} parameters; {XFORMER_UPDATES} train steps in {rounds} "
        f"rounds, {result['frames']} env frames in {wall:.2f} s ({wall / rounds * 1e3:.1f} ms "
        f"wall per round, {result['frames'] / wall:.0f} env frames/s end to end); peak device "
        f"memory {peak / 2**20:.1f} MiB, {(peak - mem_start) / 2**20:.1f} MiB of it the "
        f"phase's own; launches {launches}; {seeding(learner)}")
    log(f"[{section}] last metrics {json.dumps(metrics)}")
    if rounds != 8 or any(launches.values()):
        raise RuntimeError(f"{section} path: {rounds} rounds, launches {launches}, expected 8 "
                           "rounds and no launch (seq_len 10 takes the dense route)")
    if type(learner.replay).__name__ != "ArrayPrioritizedReplay":
        raise RuntimeError(f"{section} learner replay is {type(learner.replay).__name__}, "
                           "not ArrayPrioritizedReplay")
    priorities = learner.replay.tree.export()[0]
    if (learner.train_steps != XFORMER_UPDATES
            or not all(math.isfinite(v) for v in metrics.values())
            or not np.isfinite(priorities).all() or learner.replay.tree.total <= 0):
        raise RuntimeError(f"bad {section} result: steps {learner.train_steps}, {metrics}, "
                           f"priority total {learner.replay.tree.total}")
    still = [k for k, v in before.items()
             if float((learner.state.params[k].detach() - v).abs().max()) == 0.0]
    if still:
        raise RuntimeError(f"{section} parameters did not move: {still}")

    agent, state = learner.agent, learner.state
    batch, _, is_weight = learner.replay.sample(rt.batch_size, np.random.RandomState(0))
    td_loss, aux = td_and_aux(agent, state, batch, is_weight)
    log(f"[{section}] on a replayed batch: TD loss {td_loss:.6f}, MoE aux term {aux:.6f} "
        f"(moe_aux_weight {agent_cfg.moe_aux_weight} x the layers' router terms)")
    if agent_cfg.num_experts and not (math.isfinite(aux) and aux > 0):
        raise RuntimeError(f"{section}: the MoE aux term is {aux}")
    ingest = tree_map(lambda x: x[:16], batch)
    for _ in range(2):
        agent.learn(state, batch, is_weight)
        agent.td_error(state, ingest)
    torch.cuda.synchronize()
    steps = 10
    t0 = time.perf_counter()
    for _ in range(steps):
        agent.learn(state, batch, is_weight)
    torch.cuda.synchronize()
    learn_ms = (time.perf_counter() - t0) / steps * 1e3
    t0 = time.perf_counter()
    for _ in range(steps):
        agent.td_error(state, ingest)
    torch.cuda.synchronize()
    td_ms = (time.perf_counter() - t0) / steps * 1e3
    frames_per_s = rt.batch_size * agent_cfg.seq_len / (learn_ms / 1e3)
    log(f"[{section}] learn step {learn_ms:.2f} ms synchronised (B={rt.batch_size}, "
        f"T={agent_cfg.seq_len}): {frames_per_s:.0f} learned frames/s; ingest td_error "
        f"(B=16) {td_ms:.2f} ms")
    profile_breakdown(f"one {section} learn step", lambda: agent.learn(state, batch, is_weight))
    return {"launches": launches, "learn_ms": learn_ms, "td_ms": td_ms,
            "wall_per_round_ms": wall / rounds * 1e3, "frames": result["frames"],
            "peak_mib": (peak - mem_start) / 2**20, "params": n_params, "td_loss": td_loss,
            "aux": aux, "seconds": time.perf_counter() - t_phase}


class RouteRecorder:
    """Records the dispatch tensor of every MoE routing call
    (`ops/moe.py:_dispatch_combine`) while it is entered."""

    def __init__(self):
        self.dispatch: list[torch.Tensor] = []

    def __enter__(self):
        from distributed_reinforcement_learning_tpu_torch.ops import moe as moe_ops

        self._moe, self._orig = moe_ops, moe_ops._dispatch_combine

        def recording(probs, top_k, capacity):
            out = self._orig(probs, top_k, capacity)
            self.dispatch.append(out[0].detach().cpu())
            return out

        moe_ops._dispatch_combine = recording
        return self

    def __exit__(self, *exc):
        self._moe._dispatch_combine = self._orig


def xformer_device_parity(agent_cfg, B: int, label: str) -> str:
    """`td_error` and one learn step from the same parameters (another
    target network) on one seeded batch, on CUDA and on the CPU with TF32
    off: with experts, first the same experts and slots for every token
    of every routing call; then rtol 1e-4 on loss, grad norm, TD and
    priorities, and the parameters after the step by `adam_step_close`
    (each device's gradient read off Adam's first moment, g = mu / 0.1).
    -> a log line."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        batch, is_weight = xformer_batch(agent_cfg, B, seed=7)
        results = {}
        for device in ("cuda", "cpu"):
            agent = XformerAgent(agent_cfg, device=device)
            state = agent.init_state(seed=11)
            for k, v in agent.init_state(seed=12).params.items():
                state.target_params[k].copy_(v.detach())
            with RouteRecorder() as routes:
                td = agent.td_error(state, batch).cpu().numpy()
                _, prio, metrics = agent.learn(state, batch, is_weight)
            results[device] = {
                "td": td, "prio": prio.cpu().numpy(), "routes": routes.dispatch,
                "params": {k: v.detach().cpu() for k, v in state.params.items()},
                "grads": {k: v.cpu() / 0.1 for k, v in state.mu.items()},
                **{k: float(v) for k, v in metrics.items()}}
        got, want = results["cuda"], results["cpu"]
        if len(got["routes"]) != len(want["routes"]):
            raise RuntimeError(f"{label}: {len(got['routes'])} routing calls on CUDA, "
                               f"{len(want['routes'])} on the CPU")
        flipped = [i for i, (a, b) in enumerate(zip(got["routes"], want["routes"]))
                   if not torch.equal(a, b)]
        if flipped:
            # A near-tie in the router probabilities that rounds the other
            # way on one device: a finding, not a reason to loosen the bar.
            raise RuntimeError(f"{label}: routing calls {flipped} sent a token to another "
                               "expert or slot on CUDA than on the CPU")
        for k in ("loss", "grad_norm"):
            if not math.isclose(got[k], want[k], rel_tol=1e-4):
                raise RuntimeError(f"{label} cuda vs cpu learn step: {k} {got[k]} vs {want[k]}")
        for k in ("td", "prio"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"{label} cuda vs cpu {k}")
        unsettled = sum(adam_step_close(f"{label} {k}", got["params"][k], want["params"][k],
                                        got["grads"][k], want["grads"][k],
                                        agent_cfg.learning_rate) for k in want["params"])
        worst = max(abs(got[k] / want[k] - 1) for k in ("loss", "grad_norm"))
        worst_p = max(float((got["params"][k] - want["params"][k]).abs().max())
                      for k in want["params"]) / agent_cfg.learning_rate
        return (f"[parity] {label} cuda vs cpu agrees: {len(got['routes'])} routing calls "
                f"identical, loss {got['loss']:.6f}, grad_norm {got['grad_norm']:.6f} (worst "
                f"rel diff {worst:.2e}), TD and priorities within rtol 1e-4, parameters "
                f"within {100 * worst_p:.2f}% of lr ({unsettled} noise-floor elements)")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def phase_xformer_parity() -> float:
    """Device parity of the `xformer` and `xformer_moe` sections at full
    width (batch 32 x 10). -> the phase's seconds."""
    t0 = time.perf_counter()
    for section in ("xformer", "xformer_moe"):
        agent_cfg, rt = load_config(CONFIG, section)
        log(xformer_device_parity(agent_cfg, rt.batch_size, section))
    return time.perf_counter() - t0


def phase_xformer_long(mem_start: int) -> dict:
    """The `xformer` section's agent at seq_len 32 (built directly, not a
    config section): the flash route in the learn step, td_error and act.
    For remat off and on, a learner on CUDA scores 64 seeded sequences
    (2 ingest td_error calls) and takes XFORMER_UPDATES train steps; then
    one td_error and one act call on 12 windows of 32. The counts, zeroed
    before each, must be exact: 4 K3a a td_error (2 layers, online and
    target), 2 an act, and a learn step 4 K3a (+2 with remat, the
    recompute), 2 K3b and 2 K3c; no K1 or K2. Then the remat and plain
    gradients on the card, and CUDA vs CPU at phase 22's bar."""
    import dataclasses

    from distributed_reinforcement_learning_tpu_torch.runtime import xformer_runner
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

    t_phase = time.perf_counter()
    base_cfg, rt = load_config(CONFIG, "xformer")
    cfg = dataclasses.replace(base_cfg, seq_len=XFORMER_LONG_T)
    layers = cfg.num_layers
    seqs, _ = xformer_batch(cfg, 2 * rt.batch_size, seed=3)
    win, _ = xformer_batch(cfg, 12, seed=4)
    out: dict = {"launches": {}}
    grads = {}
    torch.cuda.reset_peak_memory_stats()
    for remat in (False, True):
        agent = XformerAgent(dataclasses.replace(cfg, remat=remat), device="cuda")
        learner = xformer_runner.XformerLearner(
            agent, TrajectoryQueue(rt.queue_size), WeightStore(), batch_size=rt.batch_size,
            replay_capacity=rt.replay_capacity, target_sync_interval=rt.target_sync_interval,
            seed=0)
        for i in range(len(seqs.reward)):
            learner.queue.put(XformerBatch(*(x[i] for x in seqs)))
        zero_launch_counts()
        ingested = learner.ingest_batch() + learner.ingest_batch()
        torch.cuda.synchronize()
        counts = {"ingest (2 td_error calls)": all_launches()}
        zero_launch_counts()
        t0 = time.perf_counter()
        for _ in range(XFORMER_UPDATES):
            metrics = learner.train()
            if metrics is None or not all(math.isfinite(float(v)) for v in metrics.values()):
                raise RuntimeError(f"seq_len {XFORMER_LONG_T} train call: {metrics}")
        torch.cuda.synchronize()
        train_ms = (time.perf_counter() - t0) / XFORMER_UPDATES * 1e3
        counts[f"{XFORMER_UPDATES} learn steps"] = all_launches()
        zero_launch_counts()
        agent.td_error(learner.state, tree_map(lambda x: x[:rt.batch_size], seqs))
        counts["1 td_error"] = all_launches()
        zero_launch_counts()
        dev = lambda x, dt=None: torch.as_tensor(x, dtype=dt, device="cuda")  # noqa: E731
        agent.act(learner.state.params, dev(win.state), dev(win.previous_action),
                  dev(win.done), dev(np.full(12, 0.1, np.float32)),
                  torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        counts["1 act"] = all_launches()
        n = XFORMER_UPDATES
        want = {
            "ingest (2 td_error calls)": (2 * 2 * layers, 0, 0),
            f"{XFORMER_UPDATES} learn steps": (n * (2 + remat) * layers, n * layers, n * layers),
            "1 td_error": (2 * layers, 0, 0),
            "1 act": (layers, 0, 0)}
        for what, got in counts.items():
            k3 = (got["attention_fwd"], got["attention_dq"], got["attention_dkv"])
            k12 = got["vtrace"] + got["lstm_fwd"] + got["lstm_bwd"]
            if k3 != want[what] or k12:
                raise RuntimeError(f"seq_len {XFORMER_LONG_T}, remat {remat}: {what} launched "
                                   f"{got}, expected K3a/K3b/K3c {want[what]} and no K1 or K2")
        if ingested != 2 * rt.batch_size or learner.train_steps != n:
            raise RuntimeError(f"seq_len {XFORMER_LONG_T}: {ingested} ingested, "
                               f"{learner.train_steps} steps")
        label = f"remat_{'on' if remat else 'off'}"
        out["launches"][label] = {what: {k: v for k, v in got.items() if v}
                                  for what, got in counts.items()}
        batch, is_weight = xformer_batch(cfg, rt.batch_size, seed=5)
        for _ in range(2):
            agent.learn(learner.state, batch, is_weight)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            agent.learn(learner.state, batch, is_weight)
        torch.cuda.synchronize()
        out[f"learn_ms_{label}"] = (time.perf_counter() - t0) / 10 * 1e3
        out[f"train_call_ms_{label}"] = train_ms
        log(f"[xformer seq_len {XFORMER_LONG_T}] remat {'on' if remat else 'off'}: launches "
            f"{json.dumps(out['launches'][label])}; train call {train_ms:.2f} ms, learn step "
            f"{out[f'learn_ms_{label}']:.2f} ms synchronised (B={rt.batch_size}, "
            f"T={XFORMER_LONG_T})")
        # The gradients of one loss from one set of parameters, remat off and on.
        from distributed_reinforcement_learning_tpu_torch.agents import common

        state = agent.init_state(seed=21)
        for k, v in agent.init_state(seed=22).params.items():
            state.target_params[k].copy_(v.detach())
        loss, _ = agent._loss(state.params, state.target_params,
                              common.batch_to_device(batch, agent.device),
                              torch.as_tensor(is_weight, device="cuda"))
        names = list(state.params)
        grads[remat] = dict(zip(names, torch.autograd.grad(loss, [state.params[k]
                                                                  for k in names])))
    worst = 0.0
    for k, g in grads[False].items():
        scale = float(g.abs().max())
        torch.testing.assert_close(grads[True][k], g, rtol=1e-5, atol=1e-6 * scale,
                                   msg=lambda m, k=k: f"remat vs plain gradient {k}: {m}")
        worst = max(worst, float((grads[True][k] - g).abs().max()) / max(scale, 1e-30))
    log(f"[xformer seq_len {XFORMER_LONG_T}] remat and plain gradients agree on the card "
        f"(worst difference {worst:.2e} of a tensor's largest gradient)")
    out["remat_grad_worst"] = worst
    out["peak_mib"] = (torch.cuda.max_memory_allocated() - mem_start) / 2**20
    log(xformer_device_parity(cfg, rt.batch_size, f"xformer seq_len {XFORMER_LONG_T}"))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[xformer seq_len {XFORMER_LONG_T}] the phase's own peak {out['peak_mib']:.1f} MiB; "
        f"phase {out['seconds']:.1f} s")
    return out


def phase_multiprocess_xformer_default() -> dict:
    """The `xformer` learner process as `run_role` builds it by default (no
    DRL_REPLAY_SHARDS or DRL_REPLAY_SPILL set: 2 shards, max scorer,
    spill tier on) on CUDA, one CPU actor process, 3 updates. Fails unless
    the learner reports 2 shards with the spill tier on, takes 3 steps
    with no kernel launch (seq_len 10) and the actor held a weight version
    above 0."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="smoke_xformer_"))
    try:
        learner, actors = run_topology(
            "xformer", "xformer", XFORMER_UPDATES, 1, tag="_default",
            env_set={"DRL_REPLAY_SHARDS": None, "DRL_REPLAY_SPILL": None,
                     "DRL_REPLAY_SPILL_DIR": str(tmp / "spill")})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    svc = learner["replay_service"]
    got = learner["launches"]
    if (learner["train_steps"] != XFORMER_UPDATES or svc is None or svc["shards"] != 2
            or not svc["spill"] or any(got.values()) or actors[0]["weight_version"] <= 0):
        raise RuntimeError(f"default xformer learner: {learner['train_steps']} steps, launches "
                           f"{got}, service {svc}, actor {actors[0]}")
    per_shard = [s["ingested_blobs"] for s in svc["shard_stats"]]
    steps = learner["step_s"]
    result = {"ingested_per_shard": per_shard, "first_step_s": steps[0],
              "peak_mib": learner["peak_device_mib"],
              "weight_version": actors[0]["weight_version"],
              "seconds": time.perf_counter() - t_phase}
    log(f"[multiproc] xformer default learner: sharded replay, {svc['shards']} shards, scorer "
        f"{svc['scorer']}, spill tier {'on' if svc['spill'] else 'off'}; "
        f"{learner['train_steps']} updates, launches {got}; sequences ingested a shard "
        f"{per_shard} (the server accepted {learner['transport']['unrolls_accepted']}); first "
        f"step {steps[0]:.2f} s into the loop, steps at {[round(t, 3) for t in steps]} s; "
        f"stage ms " + ", ".join(f"{k} {v:.2f}" for k, v in learner["stage_ms"].items())
        + f"; actor {actors[0]['frames']} env frames, weight version "
        f"{actors[0]['weight_version']}; peak device memory "
        f"{learner['peak_device_mib']:.1f} MiB; phase {result['seconds']:.1f} s")
    return result


def phase_r2d2_pixel(mem_start: int) -> dict:
    """The `r2d2_pixel` section at full width (Breakout-sim 84x84x4 uint8,
    Nature torso with fold_normalize, LSTM 256, dueling head, batch 32 x
    seq_len 20 with a burn-in of 10 inside, replay 2,560, 3 actors x 4
    envs) through build_local and run_sync for R2D2_UPDATES train steps:
    K2a and K2b at H 256 behind the conv torso."""
    t_phase = time.perf_counter()
    agent_cfg, rt = load_config(CONFIG, "r2d2_pixel")
    learner, actors, run = build_local(agent_cfg, rt, seed=0, device="cuda")
    n_params = sum(p.numel() for p in learner.state.params.values())
    before = {k: v.detach().clone() for k, v in learner.state.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    t0 = time.perf_counter()
    result = run(learner, actors, R2D2_UPDATES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    seqs_per_round = sum(a.env.num_envs for a in actors)
    rounds = result["frames"] // (seqs_per_round * agent_cfg.seq_len)
    # Warm once 2 x batch sequences are in: then one train step a round.
    want_rounds = -(-2 * rt.batch_size // seqs_per_round) + R2D2_UPDATES - 1
    metrics = result["last_metrics"]
    log(f"[r2d2_pixel] {n_params:,} parameters; {R2D2_UPDATES} train steps in {rounds} rounds, "
        f"{result['frames']} env frames in {wall:.2f} s ({wall / rounds * 1e3:.1f} ms wall per "
        f"round); peak device memory {peak / 2**20:.1f} MiB, {(peak - mem_start) / 2**20:.1f} "
        f"MiB of it the phase's own; launches {launches}; {seeding(learner)}")
    log(f"[r2d2_pixel] last metrics {json.dumps(metrics)}")
    want = {"vtrace": 0, "lstm_fwd": 2 * rounds + 2 * R2D2_UPDATES, "lstm_bwd": R2D2_UPDATES,
            "attention_fwd": 0, "attention_dq": 0, "attention_dkv": 0}
    envs = {type(a.env.envs[0].env).__name__ for a in actors}
    if rounds != want_rounds or launches != want or envs != {"BreakoutSimRaw"}:
        raise RuntimeError(f"r2d2_pixel path: {rounds} rounds, launches {launches}, envs {envs}; "
                           f"expected {want_rounds} rounds, {want} and BreakoutSimRaw")
    priorities = learner.replay.tree.export()[0]
    if (learner.train_steps != R2D2_UPDATES or not all(math.isfinite(v) for v in metrics.values())
            or not np.isfinite(priorities).all()
            or len(learner.replay) != seqs_per_round * rounds):
        raise RuntimeError(f"bad r2d2_pixel result: steps {learner.train_steps}, {metrics}, "
                           f"replay {len(learner.replay)}")
    still = [k for k, v in before.items()
             if float((learner.state.params[k].detach() - v).abs().max()) == 0.0]
    if still:
        raise RuntimeError(f"r2d2_pixel parameters did not move: {still}")

    agent, state = learner.agent, learner.state
    batch, _, is_weight = learner.replay.sample(rt.batch_size, np.random.RandomState(0))
    ingest = tree_map(lambda x: x[:16], batch)
    for _ in range(2):
        agent.learn(state, batch, is_weight)
        agent.td_error(state, ingest)
    torch.cuda.synchronize()
    steps = 5
    t0 = time.perf_counter()
    for _ in range(steps):
        agent.learn(state, batch, is_weight)
    torch.cuda.synchronize()
    learn_ms = (time.perf_counter() - t0) / steps * 1e3
    t0 = time.perf_counter()
    for _ in range(steps):
        agent.td_error(state, ingest)
    torch.cuda.synchronize()
    td_ms = (time.perf_counter() - t0) / steps * 1e3
    events = profile_breakdown("one r2d2_pixel learn step",
                               lambda: agent.learn(state, batch, is_weight))
    k2_us = sum(device_us(e) for e in events if "lstm" in e.key)
    log(f"[r2d2_pixel] learn step {learn_ms:.2f} ms synchronised (B={rt.batch_size}, "
        f"T={agent_cfg.seq_len}, H={agent_cfg.lstm_size}); ingest td_error (B=16) {td_ms:.2f} "
        f"ms; K2 {k2_us / 1e3:.3f} ms of device time a learn step "
        f"({time.perf_counter() - t_phase:.1f} s)")
    return {"launches": launches, "learn_ms": learn_ms, "td_ms": td_ms, "k2_ms": k2_us / 1e3,
            "wall_per_round_ms": wall / rounds * 1e3, "peak_mib": (peak - mem_start) / 2**20,
            "seconds": time.perf_counter() - t_phase}


def phase_impala_section(mem_start: int, section: str, updates: int) -> dict:
    """An IMPALA section at full width through build_local and run_sync for
    `updates` learner steps (with `updates_per_call` K, updates / K
    calls): 2 K1 launches a step, finite metrics, parameters that moved,
    each actor on its section's env; then the synchronised learn step (or
    K-step call) on a seeded full-width batch."""
    t_phase = time.perf_counter()
    agent_cfg, rt = load_config(CONFIG, section)
    learner, actors, run = build_local(agent_cfg, rt, seed=0, device="cuda")
    before = {k: v.detach().clone() for k, v in learner.state.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    t0 = time.perf_counter()
    result = run(learner, actors, updates)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    metrics = result["last_metrics"]
    k = rt.updates_per_call
    envs = [type(getattr(a.env.envs[0], "env", a.env.envs[0])).__name__ for a in actors]
    want = {"vtrace": 2 * updates, "lstm_fwd": 0, "lstm_bwd": 0, "attention_fwd": 0,
            "attention_dq": 0, "attention_dkv": 0}
    if (launches != want or learner.train_steps != updates
            or not all(math.isfinite(v) for v in metrics.values())):
        raise RuntimeError(f"{section}: steps {learner.train_steps}, launches {launches} "
                           f"(expected {want}), metrics {metrics}")
    still = [n for n, v in before.items()
             if float((learner.state.params[n].detach() - v).abs().max()) == 0.0]
    if still:
        raise RuntimeError(f"{section} parameters did not move: {still}")
    if len(agent_cfg.obs_shape) == 3:
        batch = seeded_batch(agent_cfg, rt.batch_size, seed=5)
    else:
        batch = vector_batch(agent_cfg, rt.batch_size, seed=5)
    agent, state = learner.agent, learner.state
    if k > 1:
        batch = type(batch)(*(np.stack([x] * k) for x in batch))
    step = (lambda: agent.learn_many(state, batch)) if k > 1 else (lambda: agent.learn(state, batch))
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    calls = 5
    t0 = time.perf_counter()
    for _ in range(calls):
        step()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) / calls * 1e3
    calls_run = updates // k
    log(f"[{section}] {updates} steps in {calls_run} call(s) of K={k}, {result['frames']} env "
        f"frames in {wall:.2f} s ({wall / calls_run * 1e3:.1f} ms wall a call); actors' envs "
        f"{envs} (available actions {list(rt.available_action)}); launches {launches}; "
        f"learn {call_ms:.2f} ms a call synchronised ({call_ms / k:.2f} ms a step, "
        f"B={rt.batch_size}, T={agent_cfg.trajectory}); peak device memory "
        f"{peak / 2**20:.1f} MiB, {(peak - mem_start) / 2**20:.1f} MiB of it the phase's own; "
        f"last metrics {json.dumps(metrics)} ({time.perf_counter() - t_phase:.1f} s)")
    return {"launches": launches, "call_ms": call_ms, "learn_ms": call_ms / k,
            "wall_per_call_ms": wall / calls_run * 1e3, "envs": envs,
            "peak_mib": (peak - mem_start) / 2**20, "seconds": time.perf_counter() - t_phase}


def vector_batch(cfg, B: int, seed: int) -> ImpalaBatch:
    """`seeded_batch` for vector observations (CartPole)."""
    batch = seeded_batch(dataclasses.replace(cfg, obs_shape=(1,)), B, seed)
    rng = np.random.RandomState(seed + 1)
    return batch._replace(state=rng.randn(B, cfg.trajectory, *cfg.obs_shape).astype(np.float32))


def phase_impala_options(mem_start: int) -> dict:
    """The `impala` section's agent at full width with `dtype=bfloat16`
    and with `remat=True`, against float32 without remat on one seeded
    batch: IMPALA_OPTION_STEPS learn steps each (2 K1 launches a step),
    finite metrics, the synchronised step and the phase's peak for each;
    remat's gradients against the plain ones on the card."""
    t_phase = time.perf_counter()
    agent_cfg, rt = load_config(CONFIG, "impala")
    batch = seeded_batch(agent_cfg, rt.batch_size, seed=13)
    out: dict = {"launches": {}, "learn_ms": {}, "peak_mib": {}}
    grads = {}
    for label, cfg in (("float32", agent_cfg),
                       ("bfloat16", dataclasses.replace(agent_cfg, dtype=torch.bfloat16)),
                       ("remat", dataclasses.replace(agent_cfg, remat=True))):
        agent = ImpalaAgent(cfg, device="cuda")
        state = agent.init_state(seed=3)
        if label != "bfloat16":
            loss, _ = agent.loss(state.params, batch_to_device(batch, agent.device))
            grads[label] = torch.autograd.grad(loss, list(state.params.values()))
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        for _ in range(IMPALA_OPTION_STEPS):
            state, metrics = agent.learn(state, batch)
        torch.cuda.synchronize()
        launches = all_launches()
        metrics = {k: float(v) for k, v in metrics.items()}
        if (launches["vtrace"] != 2 * IMPALA_OPTION_STEPS
                or sum(launches.values()) != launches["vtrace"]
                or not all(math.isfinite(v) for v in metrics.values())):
            raise RuntimeError(f"impala {label}: launches {launches}, metrics {metrics}")
        out["peak_mib"][label] = (torch.cuda.max_memory_allocated() - base) / 2**20
        t0 = time.perf_counter()
        for _ in range(IMPALA_OPTION_STEPS):
            state, _ = agent.learn(state, batch)
        torch.cuda.synchronize()
        out["learn_ms"][label] = (time.perf_counter() - t0) / IMPALA_OPTION_STEPS * 1e3
        out["launches"][label] = launches["vtrace"]
        log(f"[impala options] {label}: {IMPALA_OPTION_STEPS} learn steps, launches {launches}, "
            f"{out['learn_ms'][label]:.2f} ms a step synchronised, the steps' own peak "
            f"{out['peak_mib'][label]:.1f} MiB; last metrics {json.dumps(metrics)}")
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)
                for a, b in zip(grads["remat"], grads["float32"]))
    if worst > 1e-4:
        raise RuntimeError(f"impala remat gradients differ from the plain ones by {worst:.2e} "
                           "of a tensor's largest")
    log(f"[impala options] remat vs plain gradients: worst {worst:.2e} of a tensor's largest "
        f"({time.perf_counter() - t_phase:.1f} s)")
    out["remat_grad_diff"] = worst
    out["seconds"] = time.perf_counter() - t_phase
    return out


def attention_rows(k3: dict, ximpala: dict, xformer_long: dict) -> list[dict]:
    """The K3a, K3b and K3c entries of the kernels line, at the main path's
    shape, with the other shapes beside. `launches` is the ximpala path's
    (phase 9); the Transformer-R2D2 path at seq_len 32 (phase 23, remat
    off and on) is beside it."""
    rows = []
    for kind, line in (("fwd", 59), ("dq", 108), ("dkv", 152)):
        name = f"attention_{kind}"
        t = k3["timings"][ATTN_MAIN][kind]
        rows.append({
            "name": name, "route": "cuda",
            "source": "distributed_reinforcement_learning_tpu_torch/csrc/attention.cu",
            "replaces": f"distributed_reinforcement_learning_tpu/ops/pallas/attention.py:{line}",
            "launches": ximpala["launches"][name], "max_abs_err": k3["max_abs_err"][kind],
            "launches_by_path": {
                "ximpala": ximpala["launches"][name],
                **{f"xformer_seq{XFORMER_LONG_T}_{label}": {
                    what: got.get(name, 0) for what, got in by_call.items()}
                   for label, by_call in xformer_long["launches"].items()}},
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_call": ("scaled_dot_product_attention, causal & same-segment mask"
                             + ("" if kind == "fwd" else ", forward + backward (dq, dk, dv)")),
            "shape": list(ATTN_MAIN), "graph_ms": t["graph_ms"],
            "plain_graph_ms": t["plain_graph_ms"], "library_graph_ms": t["library_graph_ms"],
            "bound_causal_ms": t["bound_causal_ms"],
            "other_shapes": [{"shape": list(shape), **k3["timings"][shape][kind]}
                             for shape in ATTN_SHAPES[1:]],
        })
    return rows


# -- the launcher's topology on the card (phases 31-33) ------------------------

LAUNCH_TIMEOUT_S = 240
RESPAWN_SECTION = "impala_cartpole"
RESPAWN_UPDATES = 400  # the learner outlives a respawned actor's start-up


def shm_segments() -> list[str]:
    return sorted(f for f in Path("/dev/shm").iterdir() if f.name.startswith("drl")) \
        if Path("/dev/shm").is_dir() else []


def shm_size() -> str:
    import os

    st = os.statvfs("/dev/shm")
    return (f"/dev/shm {st.f_bavail * st.f_frsize / 1e6:.0f} MB free of "
            f"{st.f_blocks * st.f_frsize / 1e6:.0f} MB")


def role_json(out: str, role: str) -> list[dict]:
    """The JSON summaries the launcher relayed for `role` ("learner",
    "actor0", ...)."""
    head = f"[{role}] {{"
    return [json.loads(line[len(role) + 3:]) for line in out.splitlines()
            if line.startswith(head)]


def run_launcher(section: str, updates: int, actors: int, tag: str, env_set: dict,
                 extra: list[str] = (), during=None) -> str:
    """`launch_local_cluster` from this checkout: the learner on CUDA, the
    actors on the CPU, in a process group of its own that is killed whole
    on failure or timeout. `during(proc, log_path)` runs while it does.
    Fails unless it exits 0 and leaves no `drl*` segment in /dev/shm.
    -> its output (each line prefixed by its role)."""
    import os
    import signal

    env = dict(os.environ)
    for key, value in env_set.items():
        if value is None:
            env.pop(key, None)
        else:
            env[key] = value
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    log_path = out_dir / f"smoke_launcher_{tag}.log"
    cmd = [sys.executable, "-m", "distributed_reinforcement_learning_tpu_torch.launch_local_cluster",
           "--config", str(CONFIG), "--section", section, "--actors", str(actors),
           "--updates", str(updates), "--actor_grace", "5", *extra]
    with open(log_path, "w+") as f:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT,
                                text=True, start_new_session=True)
        try:
            if during is not None:
                during(proc, log_path)
            proc.wait(timeout=LAUNCH_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=30)
        f.seek(0)
        out = f.read()
    if proc.returncode != 0:
        raise RuntimeError(f"launcher {tag}: exit {proc.returncode}:\n{out[-4000:]}")
    left = shm_segments()
    if left:
        raise RuntimeError(f"launcher {tag}: segments left in /dev/shm: {left}")
    return out


def check_attached(out: str, tag: str, actors: int, rings: bool,
                   times: tuple[int, ...] | None = None) -> None:
    """The learner served the board (and the rings) and actor k logged
    `times[k]` attaches of each (once by default)."""
    want = ["[learner] [learner] shm weight board serving co-hosted actors"]
    if rings:
        want.append(f"[learner] [learner] shm rings serving {actors} co-hosted actor(s)")
    missing = [w for w in want if w not in out]
    for k in range(actors):
        n = 1 if times is None else times[k]
        for plane in ("shm weight board attached", "shm ring attached")[:2 if rings else 1]:
            line = f"[actor{k}] [actor {k}] {plane}: "
            if out.count(line) != n:
                missing.append(f"{line}... x{n} (got {out.count(line)})")
    if missing:
        raise RuntimeError(f"launcher {tag}: missing {missing}")


def check_no_early_demotion(learner: dict, actors: list, tag: str) -> None:
    """No actor's ring or board demoted to TCP before the learner began
    to shut down (the planes' demotion at shutdown is their design)."""
    early = [(a["task"], plane, at) for a in actors for plane in ("ring", "board")
             if a.get(plane) for at in a[plane]["demoted_at"] if at < learner["shutdown_at"]]
    if early:
        raise RuntimeError(f"launcher {tag}: demoted to TCP before the learner stopped: {early}")


def phase_launcher_impala(tcp: dict) -> dict:
    """The `impala` section at full width through the port's launcher:
    the learner on CUDA, rt.num_actors CPU actors, MP_UPDATES updates,
    (i) with the defaults (the weight board by its gate, rings off) and
    (ii) with DRL_SHM_RING=1; logged beside phase 11's TCP-only run
    (`tcp`)."""
    agent_cfg, rt = load_config(CONFIG, "impala")
    out = {}
    log(f"[launcher] {shm_size()}; segments before: {shm_segments()}")
    for tag, env_set in (("defaults", {"DRL_SHM_RING": None, "DRL_SHM_WEIGHTS": None}),
                         ("rings", {"DRL_SHM_RING": "1", "DRL_SHM_WEIGHTS": None})):
        t0 = time.perf_counter()
        text = run_launcher("impala", MP_UPDATES, rt.num_actors, f"impala_{tag}", env_set)
        seconds = time.perf_counter() - t0
        rings = tag == "rings"
        check_attached(text, tag, rt.num_actors, rings)
        (learner,) = role_json(text, "learner")
        actors = [j for k in range(rt.num_actors) for j in role_json(text, f"actor{k}")]
        if len(actors) != rt.num_actors:
            raise RuntimeError(f"launcher {tag}: {len(actors)} actor summaries")
        launches = learner["launches"]
        if learner["train_steps"] != MP_UPDATES or launches["vtrace"] != 2 * MP_UPDATES:
            raise RuntimeError(f"launcher {tag}: {learner['train_steps']} steps, launches "
                               f"{launches}; expected {MP_UPDATES} and {2 * MP_UPDATES} V-trace")
        if any(a["weight_version"] <= 0 for a in actors):
            raise RuntimeError(f"launcher {tag}: an actor never held a weight version > 0")
        check_no_early_demotion(learner, actors, tag)
        got = impala_rates(learner, actors, agent_cfg, rt)
        board = learner["board"]
        ring_puts = [a["ring"]["unrolls_sent"] for a in actors] if rings else None
        ring_mb = sum(a["ring"]["bytes_sent"] for a in actors) / 1e6 if rings else None
        got.update(board_pulls=sum(a["board"]["board_pulls"] for a in actors),
                   handoff_to_board_ms=board["handoff_to_board_ms"],
                   board_write_ms=board["write_ms"], ring_puts=ring_puts, ring_mb=ring_mb,
                   seconds=seconds)
        out[tag] = got
        log(f"[launcher] impala {tag}: {learner['train_steps']} updates, launches {launches}; "
            f"wall a step after the first {got['wall_per_update_ms']:.1f} ms (TCP, phase 11: "
            f"{tcp['wall_per_update_ms']:.1f}); learned frames/s "
            f"{got['learned_frames_per_s']:.0f} ({tcp['learned_frames_per_s']:.0f}); env "
            f"frames/s {got['env_frames_per_s']:.0f} ({tcp['env_frames_per_s']:.0f}); learner "
            f"busy {100 * got['busy_share']:.1f}% ({100 * tcp['busy_share']:.1f}%); learn "
            f"stage {got['learn_ms']:.2f} ms ({tcp['learn_ms']:.2f}); weight pulls "
            f"{got['weight_pulls']}, {got['board_pulls']} from the board, actors' pull p50 "
            f"{got['pull_ms_p50']:.3f} ms (TCP {tcp['pull_ms_p50']:.3f}); board writes "
            f"{board['writes']}, {board['write_ms']:.3f} ms each, handoff to board "
            f"{board['handoff_to_board_ms']:.2f} ms (TCP landing {tcp['publish_land_ms']:.2f})"
            + (f"; ring puts {ring_puts}, {ring_mb:.1f} MB, drained "
               f"{learner['rings']['unrolls_drained']}; TCP puts accepted "
               f"{learner['transport']['unrolls_accepted']}" if rings else "")
            + f"; stage ms " + ", ".join(f"{k} {v:.2f}" for k, v in learner["stage_ms"].items())
            + f"; phase {seconds:.1f} s")
    return out


def phase_launcher_r2d2_ring() -> dict:
    """The `r2d2` section through the launcher with DRL_SHM_RING=1: the
    learner's default sharded service drains one actor's ring, 3
    updates. Fails unless the shards ingested the ring's sequences (all
    of them: no TCP put) and the learner took its steps, 2 K2a and 1 K2b
    a step."""
    n = MP_SMALL_UPDATES
    t0 = time.perf_counter()
    text = run_launcher("r2d2", n, 1, "r2d2_ring", {"DRL_SHM_RING": "1", "DRL_SHM_WEIGHTS": None,
                                                    "DRL_REPLAY_SHARDS": None})
    check_attached(text, "r2d2", 1, rings=True)
    (learner,) = role_json(text, "learner")
    actors = role_json(text, "actor0")
    svc = learner["replay_service"]
    drained = (learner["rings"] or {}).get("unrolls_drained", 0)
    ingested = sum(sh["ingested_blobs"] for sh in svc["shard_stats"]) if svc else 0
    want = {"lstm_fwd": 2 * n, "lstm_bwd": n, "vtrace": 0, "attention_fwd": 0,
            "attention_dq": 0, "attention_dkv": 0}
    if (learner["train_steps"] != n or svc is None or svc["shards"] != 2 or drained == 0
            or ingested != drained or learner["transport"]["unrolls_accepted"] != 0
            or learner["launches"] != want or len(actors) != 1):
        raise RuntimeError(f"launcher r2d2: {learner['train_steps']} steps, {drained} drained, "
                           f"{ingested} ingested, launches {learner['launches']} (expected "
                           f"{want}), service {svc}, transport {learner['transport']}")
    check_no_early_demotion(learner, actors, "r2d2")
    seconds = time.perf_counter() - t0
    log(f"[launcher] r2d2 through a ring: {n} updates, {drained} sequences drained from the "
        f"ring and ingested by the shards {[sh['ingested_blobs'] for sh in svc['shard_stats']]}, "
        f"no TCP put; launches {learner['launches']}; ring {actors[0]['ring']}; stage ms "
        + ", ".join(f"{k} {v:.2f}" for k, v in learner["stage_ms"].items())
        + f"; phase {seconds:.1f} s")
    return {"drained": drained, "launches": learner["launches"], "seconds": seconds}


def kill_actor_mid_run(proc, log_path: Path, seen: dict) -> None:
    """SIGKILL actor 0 once it and the learner are running; record its pid."""
    import os
    import signal

    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and proc.poll() is None:
        text = log_path.read_text()
        if "[learner] [learner] serving on" in text and "[actor0] [actor 0] connected" in text:
            break
        time.sleep(0.2)
    else:
        raise RuntimeError("respawn drill: actor 0 never connected")
    time.sleep(1.0)
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
            cmdline = (entry / "cmdline").read_bytes().split(b"\0")
        except OSError:
            continue
        ppid = int(stat.rsplit(")", 1)[1].split()[1])
        if ppid == proc.pid and b"actor" in cmdline and cmdline[cmdline.index(b"--task") + 1] == b"0":
            os.kill(int(entry.name), signal.SIGKILL)
            seen["pid"] = int(entry.name)
            return
    raise RuntimeError("respawn drill: actor 0's process not found")


def phase_launcher_respawn() -> dict:
    """`--respawn on-exit` with rings and the board: SIGKILL actor 0 mid-run.
    Fails unless the launcher respawned it, the new incarnation attached
    its ring and board again, the learner finished its RESPAWN_UPDATES
    updates (2 K1 launches each) and every actor held a weight version."""
    seen: dict = {}
    t0 = time.perf_counter()
    text = run_launcher(RESPAWN_SECTION, RESPAWN_UPDATES, 2, "respawn",
                        {"DRL_SHM_RING": "1", "DRL_SHM_WEIGHTS": None},
                        extra=["--respawn", "on-exit"],
                        during=lambda proc, path: kill_actor_mid_run(proc, path, seen))
    if "[cluster] respawning actor0 (exit -9" not in text:
        raise RuntimeError("respawn drill: actor 0 was not respawned")
    check_attached(text, "respawn", 2, rings=True, times=(2, 1))
    (learner,) = role_json(text, "learner")
    actors = role_json(text, "actor0") + role_json(text, "actor1")
    if (learner["train_steps"] != RESPAWN_UPDATES
            or learner["launches"]["vtrace"] != 2 * RESPAWN_UPDATES or len(actors) != 2
            or any(a["weight_version"] <= 0 for a in actors)):
        raise RuntimeError(f"respawn drill: {learner['train_steps']} steps, launches "
                           f"{learner['launches']}, actors {actors}")
    check_no_early_demotion(learner, actors, "respawn")
    seconds = time.perf_counter() - t0
    log(f"[launcher] respawn drill ({RESPAWN_SECTION}, 2 actors, rings and board): actor 0 "
        f"(pid {seen['pid']}) SIGKILLed, respawned, ring and board attached again; learner "
        f"{learner['train_steps']} updates, launches {learner['launches']}; the new actor 0: "
        f"{actors[0]['frames']} frames, ring {actors[0]['ring']}, board {actors[0]['board']}; "
        f"phase {seconds:.1f} s")
    return {"launches": learner["launches"], "seconds": seconds}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"nvidia-smi: {smi}")
    t_start = time.perf_counter()
    native_lib = phase_build()
    phase_memory("vtrace")
    k1 = phase_vtrace()
    phase_memory("lstm")
    k2 = phase_lstm()
    phase_bf16_wrappers()
    main_path = phase_main_path(phase_memory("impala path"))
    phase_memory("impala parity")
    phase_device_parity()
    r2d2 = phase_r2d2(phase_memory("r2d2 path"))
    phase_memory("r2d2 parity")
    phase_r2d2_parity()
    phase_memory("attention")
    k3 = phase_attention()
    ximpala = phase_ximpala(phase_memory("ximpala path"))
    phase_memory("ximpala parity")
    phase_ximpala_parity()
    phase_memory("multi-process impala")
    multiproc = phase_multiprocess_impala()
    phase_multiprocess_small()
    phase_memory("transport parity")
    phase_transport_parity()
    phase_memory("run_async")
    phase_run_async()
    apex = phase_apex(phase_memory("apex path"), native_lib)
    phase_memory("apex parity")
    phase_apex_parity()
    phase_memory("multi-process apex")
    apex_mp = phase_multiprocess_apex()
    phase_memory("apex shards")
    shards = phase_apex_shards(native_lib)
    phase_memory("multi-process apex, default replay")
    apex_default = phase_multiprocess_apex_default()
    phase_memory("multi-process r2d2, default replay")
    r2d2_default = phase_multiprocess_r2d2_default()
    xformer = phase_xformer(phase_memory("xformer path"), "xformer")
    phase_memory("xformer parity")
    xformer_parity_s = phase_xformer_parity()
    xformer_long = phase_xformer_long(phase_memory("xformer seq_len 32"))
    xformer_moe = phase_xformer(phase_memory("xformer_moe path"), "xformer_moe")
    phase_memory("multi-process xformer, default replay")
    xformer_mp = phase_multiprocess_xformer_default()
    r2d2_pixel = phase_r2d2_pixel(phase_memory("r2d2_pixel path"))
    sections = {name: phase_impala_section(phase_memory(f"{name} path"), name, updates)
                for name, updates in (("impala_atari_mix", UPDATES),
                                      ("impala_invaders", UPDATES),
                                      ("impala_cartpole_scan", SCAN_UPDATES))}
    options = phase_impala_options(phase_memory("impala options"))
    phase_memory("launcher")
    t_launcher = time.perf_counter()
    launcher = phase_launcher_impala(multiproc)
    launcher_r2d2 = phase_launcher_r2d2_ring()
    respawn = phase_launcher_respawn()
    launcher_s = time.perf_counter() - t_launcher

    t = k1["timings"][MAIN_SHAPE]
    big = k1["timings"][SHAPES[-1]]
    kernels = [{
        "name": "vtrace",
        "route": "cuda",
        "source": "distributed_reinforcement_learning_tpu_torch/csrc/vtrace.cu",
        "replaces": "distributed_reinforcement_learning_tpu/ops/pallas/vtrace.py:36",
        "launches": main_path["launches"]["vtrace"],
        "max_abs_err": k1["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "launches_by_path": {"impala": main_path["launches"]["vtrace"],
                             **{name: got["launches"]["vtrace"] for name, got in sections.items()},
                             **{f"impala_{label}": n
                                for label, n in options["launches"].items()},
                             **{f"impala_launcher_{tag}": got["launches"]["vtrace"]
                                for tag, got in launcher.items()},
                             "impala_cartpole_respawn": respawn["launches"]["vtrace"]},
        "shape": list(MAIN_SHAPE), "graph_ms": t["graph_ms"],
        "plain_graph_ms": t["plain_graph_ms"],
        "large": {"shape": list(SHAPES[-1]), "ms": big["ms"], "plain_ms": big["plain_ms"],
                  "graph_ms": big["graph_ms"], "plain_graph_ms": big["plain_graph_ms"],
                  "bound_ms": big["bound_ms"], "bound_by": big["bound_by"]},
    }, *lstm_rows(k2, r2d2, r2d2_default, r2d2_pixel, launcher_r2d2),
        *attention_rows(k3, ximpala, xformer_long)]
    log(f"[main] learn_ms {main_path['learn_ms']:.3f}, wall per update "
        f"{main_path['wall_per_update_ms']:.1f} ms, own peak {main_path['peak_mib']:.1f} MiB; "
        f"r2d2 learn_ms {r2d2['learn_ms']:.3f}, wall per round {r2d2['wall_per_round_ms']:.1f} "
        f"ms, own peak {r2d2['peak_mib']:.1f} MiB, K2 device ms a learn step {r2d2['k2_ms']:.3f}; "
        f"ximpala learn_ms {ximpala['learn_ms']:.3f}, "
        f"wall per update {ximpala['wall_per_update_ms']:.1f} ms, own peak "
        f"{ximpala['peak_mib']:.1f} MiB; multi-process impala {multiproc['wall_per_update_ms']:.1f} "
        f"ms wall per update, H2D {multiproc['h2d_ms']:.3f} ms a batch, peak "
        f"{multiproc['peak_mib']:.1f} MiB; apex learn_ms {apex['learn_ms']:.3f}, ingest "
        f"{apex['ingest_ms']:.2f} / {apex['ingest_pipelined_ms']:.2f} ms an unroll (plain / "
        f"pipelined), own peak {apex['peak_mib']:.1f} MiB, launches "
        f"{sum(apex['launches'].values())}; multi-process apex "
        f"{apex_mp['env_frames_per_s']:.0f} env frames/s delivered, "
        f"{apex_mp['ingested_unrolls']} unrolls ingested, peak {apex_mp['peak_mib']:.1f} MiB; "
        f"apex shards: ingest {shards['ingest_ms_per_blob']} ms a blob, sample "
        f"{shards['sample_ms']:.3f} ms, route {shards['route_ms']:.3f} ms, "
        f"{shards['spilled_segments']} spilled / {shards['promoted_segments']} promoted, train "
        f"call K=1 {shards['train_k1_ms']:.2f} / K={SHARD_K} {shards['train_k4_ms']:.2f} ms "
        f"({shards['seconds']:.1f} s); default apex learner {apex_default['ingested_per_shard']} "
        f"unrolls a shard, {apex_default['spilled_segments']} spilled "
        f"({apex_default['seconds']:.1f} s); default r2d2 learner K2a/K2b "
        f"{r2d2_default['launches']['lstm_fwd']}/{r2d2_default['launches']['lstm_bwd']} "
        f"({r2d2_default['seconds']:.1f} s); xformer learn_ms {xformer['learn_ms']:.3f}, wall "
        f"per round {xformer['wall_per_round_ms']:.1f} ms, own peak {xformer['peak_mib']:.1f} "
        f"MiB ({xformer['seconds']:.1f} s); xformer parity ({xformer_parity_s:.1f} s); seq_len "
        f"{XFORMER_LONG_T} learn_ms {xformer_long['learn_ms_remat_off']:.3f} / "
        f"{xformer_long['learn_ms_remat_on']:.3f} (remat off / on), own peak "
        f"{xformer_long['peak_mib']:.1f} MiB ({xformer_long['seconds']:.1f} s); xformer_moe "
        f"learn_ms {xformer_moe['learn_ms']:.3f}, TD loss {xformer_moe['td_loss']:.5f}, aux "
        f"{xformer_moe['aux']:.5f} ({xformer_moe['seconds']:.1f} s); multi-process xformer "
        f"{xformer_mp['ingested_per_shard']} sequences a shard, first step "
        f"{xformer_mp['first_step_s']:.2f} s, peak {xformer_mp['peak_mib']:.1f} MiB "
        f"({xformer_mp['seconds']:.1f} s); r2d2_pixel learn_ms {r2d2_pixel['learn_ms']:.3f}, "
        f"wall per round {r2d2_pixel['wall_per_round_ms']:.1f} ms, K2 {r2d2_pixel['k2_ms']:.3f} "
        f"ms a learn step, own peak {r2d2_pixel['peak_mib']:.1f} MiB "
        f"({r2d2_pixel['seconds']:.1f} s); "
        + "; ".join(f"{name} learn_ms {got['learn_ms']:.3f}, wall per call "
                    f"{got['wall_per_call_ms']:.1f} ms, own peak {got['peak_mib']:.1f} MiB "
                    f"({got['seconds']:.1f} s)" for name, got in sections.items())
        + "; impala learn_ms " + ", ".join(f"{label} {ms:.3f}"
                                             for label, ms in options["learn_ms"].items())
        + f" ({options['seconds']:.1f} s); launcher: impala defaults "
        f"{launcher['defaults']['wall_per_update_ms']:.1f} / rings "
        f"{launcher['rings']['wall_per_update_ms']:.1f} ms a step after the first (TCP "
        f"{multiproc['wall_per_update_ms']:.1f}), r2d2 ring {launcher_r2d2['drained']} "
        f"sequences, respawn drill {respawn['seconds']:.1f} s; phases 31-33 {launcher_s:.1f} s; "
        f"smoke took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
