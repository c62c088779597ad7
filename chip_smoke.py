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
   V-trace (K1) at seven shapes (with (18, 20), Anakin IMPALA's on the
   impala section, (18, 16), a rank's of the sharded impala learner
   at data 2, phase 46, and (18, 10), a rank's of Anakin IMPALA at data
   2, phase 47) and on a set of NaN, +inf and -inf
   log-rhos, with and without the rho clip, each bit for bit equal to
   its plain version; each K1 call must make one kernel launch and run
   no other kernel, and ptxas may report no stack or spills for it.
   The LSTM forward and backward (K2a,
   K2b) at (T, B, H) = (10, 32, 512) and (10, 16, 512) (the r2d2 learn
   step and ingest), (20, 32, 256) and (20, 16, 256) (the r2d2_pixel
   learn step and ingest), (20, 256, 512) and (30, 32, 256), and the
   Anakin ingest shapes, `anakin_r2d2_train`'s (with (10, 6, 512), a rank's Anakin
   R2D2 ingest at data 2, phase 47), with ~15% dones, each kernel
   against its plain
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
   its gate, rings off) and (ii) with DRL_SHM_RING=1 and
   `--weights_sharded 1` (the segmented board and shard-scoped TCP
   pulls; the learner must report its shard publishes and every actor
   its shard pulls from the board). Each fails unless
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
34. Served acts in process: each family's `InferenceServer` on CUDA at
   its section's full width over seeded random parameters, one 16-row
   batch against the same agent's act on the CPU on the same rows (TF32
   off; policy, q, h and c at rtol 1e-4, atol 1e-5; greedy actions
   equal at epsilon 0); with the counts zeroed just before, 2 K3a for
   the `ximpala` batch (one a layer) and no kernel for the others; the
   round trip of a served batch at 1, 16 and 32 rows (2 K3a a ximpala
   batch again); K3a at the served batch shapes (1 and 32 rows; 16 is
   phase 8's main shape) against its plain version, timed.
35. The `impala` section through the launcher with `--serve_inference
   --remote_act`: the learner on CUDA acts for 4 CPU actor processes, 8
   updates. Fails unless the learner logged its service, served acts,
   no actor pulled a weight blob, every actor acted through it, 2 K1 a
   step, the launcher exited 0 and left no segment; logs env frames/s,
   the actors' act round trip p50 / p99, batch occupancy and rows, the
   service's latency beside phase 34's idle round trip, and the `learn`
   stage beside phase 11's.
36. The `ximpala` section with `--serve_inference --remote_act
   --inference_replicas 2`, 2 CPU actors, each replica on the card
   reading the weight board; replica 0 SIGKILLed mid-run. Fails unless
   the actors demoted it once each and no act of theirs failed or fell
   back to the learner, the learner took its 60 updates, and the
   surviving replica's summary shows acts served and 2 K3a a batch.
37. The device envs (`envs/*_device.py`: CartPole, Breakout, Pong,
   SpaceInvaders), each stepped 64 steps of 8 envs on CUDA and on the
   CPU from one state (some games near their end) with the same actions
   and draws: frames (the stacks and the raw frames), rewards, dones and
   episode returns equal, float state (CartPole's physics) within 1e-6;
   then env frames/s on CUDA at 20 and 256 envs.
38. Anakin IMPALA (`runtime/anakin.py`) on the `impala` section at full
   width: Breakout on the card, 20 envs, T 20, the 18-way head aliased
   onto 4 actions; 3 updates after one of warm-up, with the counts
   zeroed just before: exactly 2 K1 launches an update and no other
   kernel, finite metrics, parameters that moved; logs frames/s, the
   synchronised ms an update and its split between the collect and the
   learn step, the busy share and the device kernels of one update
   (profiler, device activity only, over one act and env step and one
   learn step: an update is T of the first and one of the second) and
   the peak. Then one CUDA collect replayed
   on the CPU from the same parameters and state with the CUDA run's env
   draws and actions forced (behaviour policy and stored h, c within
   1e-5, frames, rewards and dones equal) and one learn step on that
   batch on both devices (loss terms and grad norm at rtol 1e-4, TF32
   off).
39. Anakin Ape-X (`runtime/anakin_apex.py`) on the `apex` section: 20
   Breakout envs, 16 steps a collect, the default ring (32,640
   transitions of two uint8 stacks), the launcher's warm-up, 3 updates:
   no kernel, finite loss, parameters that moved; logs the ring's bytes,
   frames/s and the peak.
40. Anakin R2D2 (`runtime/anakin_r2d2.py`) on `r2d2` and `r2d2_pixel`:
   12 envs, the default sequence ring, the launcher's warm-up, 3 updates
   of K learns: exactly (2 + 2K) K2a and K K2b launches an update (the
   ingest's main and target unrolls, each learn's two and its BPTT),
   finite loss and priorities, parameters that moved; logs as phase 39.
41. Sharded weight publication (`runtime/weight_shards.py`) on the
   `xformer_moe` section's agent at full width on CUDA: stores publishing
   through `publish_async` per shard in float32 and in bfloat16 (the
   shards `expert`, `-,model` and `rep`), each with a segmented board,
   and a whole-blob store, all served over TCP. At each of 22 versions
   (the first, one that moves the experts alone, then 20 learn steps)
   CPU readers pull over TCP (`ShardedRemoteWeights`) and through the
   board (`BoardWeights`); each must be bit for bit the whole-blob
   decode (float32) or its bfloat16 round trip. Logs the bytes a version
   (whole, sharded, bfloat16), the shards each publish memcpys (1 when
   only the experts moved) and each reader's pull p50.
42. The fused device sample path (`data/device_path.py`) under
   `device_path_force`, against the default 2-shard service: `r2d2` at
   K = 2 and `apex` at its section's K, each beside a host-path learner
   over a service fed the same blobs, from the same parameters and
   sampling seed. The first call of each path must launch the same
   kernels (2K K2a and K K2b for r2d2, none for apex), sample the same
   indices, write back priorities at rtol 1e-4 and leave parameters at
   phase 16's bar (rtol 1e-4, an element at Adam's noise floor within
   2 lr a step). Logs the H2D copy's device ms, the share of it inside
   the learn calls and the ms a call on both paths.
43. The learner tier (`runtime/learner_tier.py` over
   `parallel/collective.py`), TF32 off for (a) and (b). (a) Two `apex`
   seats, ApexLearners on CUDA in threads of this process, under
   allreduce over loopback, each on one half of a seeded batch of 32: at
   each of 3 steps the seats hold the same bits and sit at phase 16's bar
   of one CUDA learner that took the step on the union batch from the
   same state; 12 more steps time the rounds; the flat vector's D2H and
   H2D are timed apart. (b) Two `r2d2` seats from different seeds under
   async with a merge every step, in turns: 2 K2a and 1 K2b a learn
   step, a merge on each seat, seat 1's first merge bit for bit the mean
   of both. (c) The launcher with `--learners 2 --learner_sync
   allreduce` on `apex` (seats on CUDA, 2 CPU actors, the shared board):
   seat 0 SIGKILLed at its step 20; seat 1 finishes its 80 updates as
   the publisher (peer_deaths 1, promotions 1, the board re-created), a
   TCP client of seat 1 and a fresh reader of the shared board in this
   process (pulling as actor 1 would, which pulls once in 1,600 steps)
   see versions past the kill, and the launcher exits 137.
   No round gives up. Logs rounds, retries, giveups, round ms p50, bytes
   a round, D2H and H2D ms, merges and the phase's seconds.
44. The run drivers (the port's `anakin_breakout_train`,
   `anakin_r2d2_train`, `eval_anakin_replay`, `evaluate` and `long_run`)
   on the card, their files in a temporary directory. (a) The Breakout
   driver at its defaults (Nature CNN on 84x84x4 uint8, LSTM 256, 128
   envs, T 20, bfloat16), 5 updates a chunk for 3 chunks, greedy evals of
   32 envs x 300 steps every 2 chunks, a checkpoint every 2 and at the
   end, then `--resume` for a 4th chunk: rows for chunks 1-3 then chunk 4
   at 20 updates, the restored parameters the first run's bit for bit,
   exactly 2 K1 launches an update and no other kernel (counts zeroed
   around each run), finite losses; logs frames/s a chunk and the peak.
   (b) The R2D2 driver on Breakout (LSTM 256, 32 envs, seq_len 20,
   burn-in 10, a ring of 1024 sequences, batch 64, K 2, 4 updates a
   chunk, 4 warm-up collects) for 2 chunks, then `--resume` for a 3rd:
   K2a 2 a warm-up collect and 2 + 2K an update, K2b K an update, the
   parameters bit for bit, the warm-up run again from the restored
   episode counters. (c) `eval_anakin_replay` on `apex` and `r2d2`
   checkpoints that `train_apex` / `train_r2d2 --mode anakin
   --checkpoint_dir` wrote 2 updates earlier: the saved step restored,
   the JAX script's keys. (d) `evaluate` on a `train_local` checkpoint of
   `impala_cartpole`: step 4, 2 episodes. (e) `long_run` on
   `impala_cartpole` in its own process group, 2 chunks of 4 updates,
   one child on the card each: records at 4 and 8 updates with
   `max_rss_mb`, 1024 frames each (the second child resumed).
45. One learn step on a `utils/synthetic.py` batch at each of the
   `impala`, `r2d2`, `apex`, `ximpala` and `xformer` sections' shapes:
   with the counts zeroed just before, K1 2 (`impala`), K2a 2 and K2b 1
   (`r2d2`), K1 2 and K3a/K3b/K3c 2 each (`ximpala`), none for `apex` and
   `xformer` (seq_len 10), and no other kernel; finite metrics.
46. The sharded learner (`parallel/`), each rank a child process in its
   own group, each with its own timeout, failing the phase if it fails.
   (a) A world of one over NCCL (`DRL_COORDINATOR` on a free port,
   `DRL_NUM_PROCESSES=1`): `ShardedLearner` over `impala`, `r2d2`,
   `ximpala` and `apex` at full width, 3 steps each from the plain
   learner's state on its batches (TF32 off): the parameters bit for bit
   the plain learner's, the kernel launches equal. (b) Two ranks on this
   card, both on cuda:0 over gloo (the backend rule): `impala` and `r2d2`
   at data 2, each rank on half of each union batch (K1 at (18, 16), K2a
   and K2b at (10, 16, 512); 2 K1, 2 K2a and 1 K2b a step), the ranks'
   parameters bit for bit equal and within rtol 1e-4 (an Adam element at
   the noise floor within 2 lr a step) of the union-batch learner; `apex`
   at model 2, each rank holding half of each sharded leaf and its
   moments. (c) `launch_local_cluster --learners 2` on `impala_cartpole`
   with 2 CPU actors, 20 updates: both learners on cuda:0 over gloo,
   both data planes' versions within 4 of each other, every role exits 0
   and no segment is left in /dev/shm. Logs each rank's backend, the
   learn-step ms against the plain step, the reduction's ms p50 and bytes
   a step, and the bytes a rank holds, beside the nvidia-smi line.
47. The Anakin mesh (`runtime/anakin_mesh.py`) and the mesh-sharded
   tier seat, each rank a child process as in phase 46, on the card's
   deterministic algorithms. (a) A world of one over NCCL: Anakin
   IMPALA (20 Breakout envs), Ape-X and R2D2 at phases 38-40's widths,
   a warm update then 3 updates each, the parameters bit for bit the
   plain loop's from the same seed, the launches equal (K1 6; K2a 12 and
   K2b 3; none). (b) Two ranks on cuda:0 over gloo at data 2 (K1 at
   (18, 10); K2a at (10, 6, 512) on ingest and (10, 16, 512) on learn):
   the ranks bit for bit equal, `replay_size` the global count, each
   rank half the ring's bytes, the plain loop's launches a rank; Anakin
   IMPALA at data 1 x model 2 holding 40-60% of the state a rank and
   within rtol 1e-4 + 1% lr of the plain loop. (c) Two `apex` tier
   seats, each two ranks at model 2 (4 processes) under allreduce for 3
   steps: the seats bit for bit equal, within rtol 1e-3 (Adam's
   noise-floor elements within its bound) of the union-batch sharded
   learner, 3 owner-scoped rounds with `-,model` bytes, each seat's
   publish whole. Logs ms an update against the single-device loop, the
   reductions' ms p50 and bytes, beside the nvidia-smi line.
48. The model-parallel transformer body (ROADMAP item 13c), one world of
   two ranks sharing cuda:0 over gloo, on the card's deterministic
   algorithms: (a) ring, zigzag ring and Ulysses attention at seq 2 at
   the `xformer` width (B 32, T 32, 2 heads of 32) with episode
   segments, values within 1e-5 and gradients within 1e-4 of
   `dense_attention` on one device; three learn steps of `xformer` at
   seq_len 32 (b) with `attention: ring_zigzag` at seq 2, (c) of
   `xformer_moe` at expert 2, (d) with `pipeline: true` at 2 stages of 2
   microbatches: the ranks bit for bit equal; each step against the
   single-device agent's step from the same whole state on the union
   batch: the loss, gradient norm and priorities within ROADMAP F14's
   bar (rtol 2e-4, atol 2e-5), every leaf at phase 46's bar for Adam
   (`adam_step_close`: its gradient at rtol 1e-4, the parameters it
   settles at rtol 1e-4; only an element whose gradient is float32
   noise within Adam's bound of a step); with each
   collective's bytes, the ms a step and the
   K3 launches (K3a at (32, 2, 32, 32) under the expert axis and at (16,
   2, 32, 32) in each pipeline stage; none under the ring). A world of
   one over NCCL runs `xformer_moe` bit for bit the plain agent. Beside
   both, a `train_xformer` group through `launch_local_cluster --learners 2` at
   seq_parallel 2 (ring_zigzag, seq_len 32) for 3 updates: both
   learners on cuda:0 over gloo, the mesh's seq axis 2, exit 0, no
   segment left.
49. The scripts: the port's counterparts of the JAX package's last
   seven scripts, each from a temporary directory removed after, on the
   card: `profile_learn_decomp 128` and `profile_nature_learn` (32)
   alone, each a child process, each variant's wall ms (CUDA events) and
   device ms (torch.profiler); then `actor_scale_demo --actors 4 --minutes 0.5
   --stats-interval 5` (a CUDA learner, 4 CPU actors, child processes)
   while `diag_imitation`, `return_curves --families
   impala_cartpole,r2d2_cartpole_pomdp,ximpala_cartpole --updates-scale
   0.005`, `stability_probe --updates 20` and `r2d2_cycle_probe
   --updates 20 --seeds 0 --baseline` run in this process. Each must
   exit 0 and print its JSON fields (and write its files), every actor's
   stats line must be read, no file may appear under `benchmarks/`, and
   each must launch exactly the kernels its path runs (K1 for the
   profilers and the demo's learner; K1, K2a/K2b and K3a/K3b/K3c for the
   three families; K2a/K2b for the two R2D2 probes; none for the
   imitation check), with the counts zeroed just before each.
50. A `{"kernels": [...]}` line with each kernel's numbers (the Ape-X
   paths launch none; K1 carries phases 27-33's, 35's, 38's, 44's-47's
   launches beside phase 4's, and its times at phase 38's, 46's and
   47's shapes; K2a and K2b phase 20's, 26's, 32's, 40's, 42's-47's
   beside phase 6's; K3a, K3b and K3c phase 23's, 45's, 46's and 48's
   beside phase 9's, with their times at phase 48's local shapes, and
   K3a phases 34's and 36's with its times at the served batch shapes;
   each kernel phase 49's launches by script).
51. The device line, then `{"ok": true, "device": {...}}` as the last line.

Before each phase from 3 on, the device memory still allocated is
logged, so that the peaks of phases 4, 6, 9, 15, 18, 21, 23, 24, 26-29,
38-40 and 44 are read net of it.
Every child process runs in its own process group and is killed whole
if its phase fails.

Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import threading
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
from distributed_reinforcement_learning_tpu_torch.parallel.learner import ShardedLearner
from distributed_reinforcement_learning_tpu_torch.runtime.launch import build_local
from distributed_reinforcement_learning_tpu_torch.utils.config import load_config

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "config.json"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM, non-tensor-core float32
MAIN_SHAPE = (18, 32)  # V-trace at the impala section: T = trajectory - 2, B = batch
ANAKIN_SHAPE = (18, 20)  # V-trace in Anakin IMPALA on the impala section: B = its 20 envs
BREAKOUT_DRIVER_SHAPE = (18, 128)  # V-trace in the Breakout driver (phase 44): its 128 envs
SHARDED_SHAPE = (18, 16)  # V-trace in a rank of the sharded impala learner at data 2 (phase 46)
ANAKIN_MESH_SHAPE = (18, 10)  # V-trace in a rank of Anakin IMPALA at data 2 (phase 47): 10 envs
SHAPES = [MAIN_SHAPE, ANAKIN_SHAPE, BREAKOUT_DRIVER_SHAPE, SHARDED_SHAPE, ANAKIN_MESH_SHAPE,
          (20, 256), (20, 65536)]
UPDATES = 3
R2D2_UPDATES = 3  # warm-up takes 6 rounds of 12 sequences, so 8 rounds in all
# LSTM (T, B, H): the r2d2 learn step and ingest (12 sequences padded to
# 16), the r2d2_pixel section's learn step (T is seq_len 20, the burn-in
# of 10 inside) and ingest, a larger batch, and T 30 (a burn-in of 10 on
# top of seq_len 20).
LSTM_MAIN = (10, 32, 512)
LSTM_INGEST = (10, 16, 512)
LSTM_PIXEL = (20, 32, 256)
# Anakin R2D2 scores each collect's new sequences, one an env: B = the
# sections' 12 envs (phase 40).
LSTM_ANAKIN_INGEST = [(10, 12, 512), (20, 12, 256)]
# The R2D2 driver's learn step (phase 44 (b)): batch 64 at H 256; its
# ingest of 32 envs' sequences is LSTM_PIXEL's shape.
LSTM_R2D2_DRIVER = (20, 64, 256)
# A rank's ingest of Anakin R2D2 at data 2 on the r2d2 section (phase 47):
# its 6 of the 12 envs. Its learn step is LSTM_INGEST's shape.
LSTM_ANAKIN_MESH_INGEST = (10, 6, 512)
LSTM_SHAPES = [LSTM_MAIN, LSTM_INGEST, LSTM_PIXEL, (20, 16, 256), (20, 256, 512),
               (30, 32, 256), *LSTM_ANAKIN_INGEST, LSTM_R2D2_DRIVER, LSTM_ANAKIN_MESH_INGEST]
# Flash attention (B, H, T, D): the ximpala section's act and learn
# shape, the served ximpala act's buckets of one row and of two actors'
# rows (phases 34 and 36), bench.py's ximpala_learn shape, and a long
# sequence.
ATTN_MAIN = (16, 2, 16, 32)
# Phase 48's local shapes: the whole batch at seq_len 32 (the expert axis),
# and one of its 2 microbatches (a pipeline stage).
MP_ATTN_SHAPES = [(32, 2, 32, 32), (16, 2, 32, 32)]
ATTN_SHAPES = [ATTN_MAIN, (1, 2, 16, 32), (32, 2, 16, 32), (64, 4, 32, 64), (1, 4, 8192, 64),
               *MP_ATTN_SHAPES]
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
    for T, B in (MAIN_SHAPE, ANAKIN_SHAPE, BREAKOUT_DRIVER_SHAPE, SHARDED_SHAPE,
                 ANAKIN_MESH_SHAPE, SHAPES[-1]):
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
              launcher_r2d2: dict, anakin: dict, devpath: dict, tier: dict) -> list[dict]:
    """The K2a and K2b entries of the kernels line: `launches` from the
    r2d2 path (phase 6), with the default multi-process r2d2 learner's
    own count (phase 20, K=2 calls), the r2d2_pixel path's (phase 26),
    the ring-fed r2d2 learner's (phase 32), Anakin R2D2's on both
    sections (phase 40), the device sample path's first K=2 call
    (phase 42) and the two async tier seats' learn steps (phase 43)
    beside it."""
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
                                 "launcher_r2d2_ring": launcher_r2d2["launches"][name],
                                 **{f"anakin_{section}": got["launches"][name]
                                    for section, got in anakin.items()},
                                 "r2d2_device_path_call": devpath["r2d2"]["launches"]["device"][name],
                                 "r2d2_tier_async_seats": tier["r2d2"]["launches"][name]},
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "shape": list(LSTM_MAIN),
            "graph_ms": t["graph_ms"], "plain_graph_ms": t["plain_graph_ms"],
            "other_shapes": [{"shape": list(shape), **k2["timings"][shape][tag]}
                             for shape in LSTM_SHAPES[1:]],
            # A rank of the sharded r2d2 learner at data 2 (phase 46): the
            # ingest's shape.
            "sharded_learner": {"shape": list(LSTM_INGEST), **k2["timings"][LSTM_INGEST][tag]},
            # A rank's ingest of Anakin R2D2 at data 2 (phase 47).
            "anakin_mesh_ingest": {"shape": list(LSTM_ANAKIN_MESH_INGEST),
                                   **k2["timings"][LSTM_ANAKIN_MESH_INGEST][tag]},
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


@contextlib.contextmanager
def relu_tape(tape: list, pin: list | None = None):
    """Within the block, every `torch.nn.functional.relu` call made on this
    thread appends its input (detached, on the host) to `tape`. With `pin`,
    the tape of an earlier run of the same code (on another device), the
    i-th call passes its input where `pin[i]` was positive and gives 0
    elsewhere: relu up to the units whose sign the two runs' rounding
    decides, with the earlier run's derivative at those units."""
    orig = torch.nn.functional.relu
    me = threading.get_ident()

    def relu(x, inplace=False):
        if threading.get_ident() != me:
            return orig(x, inplace)
        i = len(tape)
        tape.append(x.detach().cpu())
        if pin is None:
            return orig(x, inplace)
        if pin[i].shape != x.shape:
            raise RuntimeError(f"ReLU call {i}: {tuple(x.shape)} against the pinned "
                               f"{tuple(pin[i].shape)}")
        return torch.where(pin[i].to(x.device) > 0, x, torch.zeros((), dtype=x.dtype,
                                                                    device=x.device))

    torch.nn.functional.relu = relu
    try:
        yield
    finally:
        torch.nn.functional.relu = orig


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
    parameters.)

    The replay of a step runs under `relu_tape`: every ReLU input of the
    CPU replay must be within the gradients' bar of the CUDA step's (rtol
    1e-4, atol 1e-5 of the largest), and the replay passes a unit where the
    CUDA step's input was positive. A unit whose input the two devices'
    rounding puts on either side of 0 would otherwise take its gradient on
    one device and not on the other, a jump in the gradient that no float32
    bar covers; such units are counted. -> a log line."""
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
                      "batch": type(batch)(*(x.cpu() for x in batch)), "w": w.cpu(),
                      "relu": []}
            with relu_tape(before["relu"]):
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
    relu_margin, flips = 0.0, []
    for i, s in enumerate(cu["steps"]):
        b = s["before"]
        st = replay.state_from_params(b["params"])
        for name in st.params:
            st.target_params[name].copy_(b["target"][name])
            st.mu[name].copy_(b["mu"][name])
            st.nu[name].copy_(b["nu"][name])
        st.step = b["step"]
        tape: list = []
        with relu_tape(tape, pin=b["relu"]):
            grads, td, loss = replay.grads(st, b["batch"], b["w"])
        if len(tape) != len(b["relu"]):
            raise RuntimeError(f"K-call step {i}: {len(tape)} ReLU calls on the CPU, "
                               f"{len(b['relu'])} on CUDA")
        flips.append(0)
        for j, (x_cpu, x_cu) in enumerate(zip(tape, b["relu"])):
            atol = 1e-5 * float(x_cu.abs().max())
            torch.testing.assert_close(x_cpu, x_cu, rtol=1e-4, atol=atol,
                                       msg=lambda m: f"K-call step {i} ReLU input {j}: {m}")
            bar = atol + 1e-4 * x_cu.abs()
            relu_margin = max(relu_margin, float(((x_cpu - x_cu).abs() / bar).max()))
            flips[-1] += int(((x_cpu > 0) != (x_cu > 0)).sum())
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
        try:
            unsettled_steps += sum(
                adam_step_close(f"K-call step {i} {name}", s["params"][name], p.detach(),
                                s["grads"][name], grads[name], lr_i, t=b["step"] + 1)
                for name, p in st.params.items())
        except AssertionError as e:
            raise AssertionError(f"{e}\n({flips[-1]} ReLU units on the other side of 0 in "
                                 f"this step)") from e

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
            f"ReLU inputs at {relu_margin:.2f} of the same bar, ReLU units on the other side "
            f"of 0 a step {flips}, gradients at {grad_margin:.2f} of their bar, "
            f"{unsettled_steps} element-steps at the gradients' noise floor), losses "
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
                 extra: list[str] = (), during=None, expect_rc: int = 0,
                 config: Path | None = None) -> str:
    """`launch_local_cluster` from this checkout: the learner on CUDA, the
    actors on the CPU, in a process group of its own that is killed whole
    on failure or timeout. `during(proc, log_path)` runs while it does.
    Fails unless it exits `expect_rc` and leaves no `drl*` segment in
    /dev/shm. -> its output (each line prefixed by its role)."""
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
           "--config", str(config or CONFIG), "--section", section, "--actors", str(actors),
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
    if proc.returncode != expect_rc:
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
    (ii) with DRL_SHM_RING=1 and `--weights_sharded 1` (the segmented
    board, shard-scoped TCP pulls); logged beside phase 11's TCP-only run
    (`tcp`)."""
    agent_cfg, rt = load_config(CONFIG, "impala")
    out = {}
    log(f"[launcher] {shm_size()}; segments before: {shm_segments()}")
    for tag, env_set, extra in (
            ("defaults", {"DRL_SHM_RING": None, "DRL_SHM_WEIGHTS": None}, []),
            ("rings", {"DRL_SHM_RING": "1", "DRL_SHM_WEIGHTS": None}, ["--weights_sharded", "1"])):
        t0 = time.perf_counter()
        text = run_launcher("impala", MP_UPDATES, rt.num_actors, f"impala_{tag}", env_set,
                            extra=extra)
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
        shards = learner["weight_shards"]
        shard_pulls = [a["board"]["shard_pulls"] for a in actors]
        if (shards is not None) != bool(extra) or (extra and (
                shards["shard_publishes"] < MP_UPDATES or min(shard_pulls) < 1)):
            raise RuntimeError(f"launcher {tag}: shard publication {shards}, actors' shard "
                               f"pulls from the board {shard_pulls}")
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
            + (f"; sharded publication: {shards['shard_publishes']} publishes, "
               f"{shards['shards_changed']} shards changed, {shards['broadcast_bytes'] / 1e6:.1f} "
               f"MB broadcast, actors' shard pulls from the board {shard_pulls}" if shards else "")
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
    seen["pid"] = child_pid(proc, b"actor", b"0")
    os.kill(seen["pid"], signal.SIGKILL)


def child_pid(proc, mode: bytes, task: bytes) -> int:
    """The pid of the launcher's child `--mode <mode> --task <task>`."""
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
            cmdline = (entry / "cmdline").read_bytes().split(b"\0")
        except OSError:
            continue
        ppid = int(stat.rsplit(")", 1)[1].split()[1])
        if ppid == proc.pid and mode in cmdline and cmdline[cmdline.index(b"--task") + 1] == task:
            return int(entry.name)
    raise RuntimeError(f"no {mode.decode()} {task.decode()} process under the launcher")


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


# -- served acts on the card (phases 34-36) ------------------------------------

FAMILIES = ("impala", "apex", "r2d2", "xformer", "ximpala")
SERVED_ROWS = (1, 16, 32)  # rows a served batch: one env, one actor, two actors
SERVED_CALLS = 20  # timed submits at each size
SERVED_REPLICA_UPDATES = 60  # the replica drill's learner outlives a replica kill


def served_request(algo: str, cfg, n: int, rng, epsilon: float = 0.0) -> dict:
    """n rows of the family's act request at the section's shapes: frames
    as uint8 for the pixel sections, windows `[n, W, ...]` for the
    transformer families with leading pad slots marked done."""
    def step_obs(*lead):
        if len(cfg.obs_shape) == 3:
            return rng.randint(0, 256, (*lead, *cfg.obs_shape)).astype(np.uint8)
        return (rng.randn(*lead, *cfg.obs_shape) * 0.5).astype(np.float32)

    A = cfg.num_actions
    eps = np.full(n, epsilon, np.float32)
    if algo in ("impala", "r2d2"):
        h = (rng.randn(n, cfg.lstm_size) * 0.3).astype(np.float32)
        req = {"obs": step_obs(n), "prev_action": rng.randint(0, A, n).astype(np.int32),
               "h": h, "c": -h}
        return req if algo == "impala" else {**req, "epsilon": eps}
    if algo == "apex":
        return {"obs": step_obs(n), "prev_action": rng.randint(0, A, n).astype(np.int32),
                "epsilon": eps}
    w = cfg.seq_len if algo == "xformer" else cfg.trajectory
    done = np.zeros((n, w), bool)
    done[:, : w // 4] = True
    done[::3, w // 2] = True
    req = {"obs": step_obs(n, w), "prev_action": rng.randint(0, A, (n, w)).astype(np.int32),
           "done": done}
    return {**req, "epsilon": eps} if algo == "xformer" else req


def served_round_trip_ms(server, algo: str, cfg, n: int, rng, k3a_a_batch: int) -> float:
    """Median round trip of SERVED_CALLS n-row submits after 3 warm ones;
    fails unless the batches launched `k3a_a_batch` K3a each."""
    reqs = [served_request(algo, cfg, n, rng) for _ in range(3)]
    for r in reqs:  # warm this bucket
        server.submit(dict(r))
    batches, k3a = server.batches_run, kattn.flash_fwd_cuda.launches
    ms = []
    for i in range(SERVED_CALLS):
        t = time.perf_counter()
        server.submit(dict(reqs[i % 3]))
        ms.append((time.perf_counter() - t) * 1e3)
    got = kattn.flash_fwd_cuda.launches - k3a
    if got != k3a_a_batch * (server.batches_run - batches):
        raise RuntimeError(f"served {algo}: {got} K3a launches for "
                           f"{server.batches_run - batches} batches")
    return float(np.median(ms))


def phase_served_acts() -> dict:
    """(34) Each family's `InferenceServer` on CUDA at its config.json
    section's full width, over seeded random parameters: one 16-row batch
    against the same agent's act on the CPU on the same rows (TF32 off;
    policy, q, h and c at rtol 1e-4, atol 1e-5; greedy actions equal at
    epsilon 0), with the kernel counts zeroed just before and read just
    after (ximpala: 2 K3a a batch, one per layer; the others none); then
    the served act's round trip in process at 1, 16 and 32 rows (median of
    SERVED_CALLS submits, host clock), whose ximpala batches must launch 2
    K3a each too. K3a at the served batch shapes is phase 8's (ATTN_SHAPES)."""
    from distributed_reinforcement_learning_tpu_torch.runtime import launch
    from distributed_reinforcement_learning_tpu_torch.runtime.inference import (
        InferenceServer, make_act_adapter)
    from distributed_reinforcement_learning_tpu_torch.runtime.serving import (
        ContinuousInferenceServer)
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = {"families": {}}
    try:
        for algo in FAMILIES:
            agent_cfg, _ = load_config(CONFIG, algo)
            agent = launch.make_agent(algo, agent_cfg, device="cuda")
            params = agent.init_state(seed=13).params
            store = WeightStore()
            store.publish(params, 0)
            server = InferenceServer.for_agent(algo, agent, store, seed=21)
            try:
                rng = np.random.RandomState(31)
                req = served_request(algo, agent_cfg, 16, rng)
                zero_launch_counts()
                got = server.submit(dict(req))
                launches = all_launches()
                cpu_agent = launch.make_agent(algo, agent_cfg, device="cpu")
                with torch.no_grad():
                    want = make_act_adapter(algo, cpu_agent)(
                        {k: v.detach().cpu() for k, v in params.items()},
                        {k: torch.from_numpy(v) for k, v in req.items()},
                        torch.Generator().manual_seed(0))
                worst = 0.0
                for key in ("policy", "q", "h", "c"):
                    if key in want:
                        w = want[key].numpy()
                        np.testing.assert_allclose(got[key], w, rtol=1e-4, atol=1e-5,
                                                   err_msg=f"{algo} {key}")
                        worst = max(worst, float(np.abs(got[key] - w).max()))
                if algo in ("apex", "r2d2", "xformer"):  # epsilon 0: the argmax
                    if not np.array_equal(got["action"], want["action"].numpy()):
                        raise RuntimeError(f"served {algo}: greedy actions differ from the CPU "
                                           f"act: {got['action']} vs {want['action']}")
                want_k3a = 2 if algo == "ximpala" else 0
                if launches != {**{k: 0 for k in launches}, "attention_fwd": want_k3a}:
                    raise RuntimeError(f"served {algo}: launches {launches}, expected "
                                       f"{want_k3a} K3a and no other kernel")
                times = {"classic": {}, "continuous": {}}
                cont = ContinuousInferenceServer.for_agent(algo, agent, store, seed=21)
                try:
                    for kind, srv in (("classic", server), ("continuous", cont)):
                        for n in SERVED_ROWS:
                            times[kind][n] = served_round_trip_ms(srv, algo, agent_cfg, n, rng,
                                                                  want_k3a)
                finally:
                    cont.stop()
                # The classic server's dispatch-to-host latency over every
                # batch above, idle: phase 35 reads the learner's beside it.
                idle = server.stats()
                out["families"][algo] = {"max_abs_err": worst, "launches": launches,
                                         "act_ms": times["classic"],
                                         "continuous_act_ms": times["continuous"],
                                         "latency_ms_p50": idle["latency_ms_p50"],
                                         "latency_ms_p99": idle["latency_ms_p99"]}
                log(f"[served] {algo} ({agent_cfg.__class__.__name__}, section `{algo}`): one "
                    f"16-row batch on CUDA against the CPU act, max |diff| {worst:.3e}"
                    + (", greedy actions equal" if algo in ("apex", "r2d2", "xformer") else "")
                    + f"; launches {launches}; served act round trip in process, ms a batch "
                    f"(median of {SERVED_CALLS}), classic server (2 ms wait window) "
                    + ", ".join(f"{n} rows {t:.3f}" for n, t in times["classic"].items())
                    + "; continuous server "
                    + ", ".join(f"{n} rows {t:.3f}" for n, t in times["continuous"].items())
                    + f"; classic server's dispatch-to-host latency p50 "
                    f"{idle['latency_ms_p50']:.3f} / p99 {idle['latency_ms_p99']:.3f} ms")
            finally:
                server.stop()
            del agent, params, store, server
            gc.collect()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    out["seconds"] = time.perf_counter() - t0
    log(f"[served] phase 34 took {out['seconds']:.1f} s")
    return out


def phase_launcher_served_impala(base: dict, served: dict) -> dict:
    """(35) The `impala` section through the launcher with
    `--serve_inference --remote_act`: the learner on CUDA answers every
    act of 4 CPU actor processes, MP_UPDATES updates. Fails unless the
    learner logged its service on CUDA and served acts, no actor pulled a
    weight blob (board or TCP) and every actor acted through it, the
    learner took its steps with 2 K1 launches each, the launcher exited 0
    and left no segment. Logs beside `base`, phase 31 (i)'s numbers (the
    same launch with actors acting on their CPUs), and phase 34's idle
    service."""
    agent_cfg, rt = load_config(CONFIG, "impala")
    t0 = time.perf_counter()
    text = run_launcher("impala", MP_UPDATES, rt.num_actors, "impala_served",
                        {"DRL_SHM_RING": None, "DRL_SHM_WEIGHTS": None},
                        extra=["--serve_inference", "--remote_act"])
    seconds = time.perf_counter() - t0
    if "[learner] [learner] SEED-style inference service enabled on cuda" not in text:
        raise RuntimeError("served impala: the learner did not log its inference service")
    (learner,) = role_json(text, "learner")
    actors = [j for k in range(rt.num_actors) for j in role_json(text, f"actor{k}")]
    served_acts = learner["transport"]["acts_served"]
    inf = learner["inference"]
    bad = [a["task"] for a in actors
           if a["weight_pulls"]["pulls"] or a["transport"]["weight_pulls"]
           or (a["board"] or {}).get("board_pulls") or not (a["remote_act"] or {}).get("acts")]
    if (len(actors) != rt.num_actors or served_acts <= 0 or bad
            or learner["train_steps"] != MP_UPDATES
            or learner["launches"]["vtrace"] != 2 * MP_UPDATES):
        raise RuntimeError(f"served impala: {len(actors)} actors, {served_acts} acts served, "
                           f"actors that pulled weights or never acted {bad}, "
                           f"{learner['train_steps']} steps, launches {learner['launches']}")
    got = impala_rates(learner, actors, agent_cfg, rt)
    p50 = [a["remote_act"]["act_ms_p50"] for a in actors]
    p99 = [a["remote_act"]["act_ms_p99"] for a in actors]
    idle = served["families"]["impala"]
    got.update(acts_served=served_acts, inference=inf, act_ms_p50=p50, act_ms_p99=p99,
               seconds=seconds)
    log(f"[served] impala through the launcher, acts on the learner's card: "
        f"{learner['train_steps']} updates, launches {learner['launches']}, {served_acts} acts "
        f"served in {inf['batches_run']} batches of {inf['rows_served']} rows (occupancy "
        f"{inf['occupancy']:.3f}, {inf['rows_served'] / max(1, inf['batches_run']):.1f} rows a "
        f"batch), service latency p50 {inf['latency_ms_p50']:.3f} / p99 "
        f"{inf['latency_ms_p99']:.3f} ms (phase 34, the same server idle: "
        f"{idle['latency_ms_p50']:.3f} / {idle['latency_ms_p99']:.3f} ms; a round trip in "
        f"process at 16 rows {idle['act_ms'][16]:.3f}, 32 rows {idle['act_ms'][32]:.3f} ms); "
        f"actors' act round trip p50 "
        + ", ".join(f"{x:.2f}" for x in p50) + " ms, p99 " + ", ".join(f"{x:.2f}" for x in p99)
        + f" ms; env frames/s {got['env_frames_per_s']:.0f} (actors acting on their CPUs, "
        f"phase 31 (i): {base['env_frames_per_s']:.0f}); wall a step after the first "
        f"{got['wall_per_update_ms']:.1f} ms ({base['wall_per_update_ms']:.1f}); learn stage "
        f"{got['learn_ms']:.2f} ms ({base['learn_ms']:.2f}); busy "
        f"{100 * got['busy_share']:.1f}%; weight pulls {got['weight_pulls']}; stage ms "
        + ", ".join(f"{k} {v:.2f}" for k, v in learner["stage_ms"].items())
        + f"; phase {seconds:.1f} s")
    return got


REPLICA_KILL_ACTS = 64  # replica 0's acts before the kill (its stats line, once a second)


def kill_replica_mid_run(proc, log_path: Path, seen: dict) -> None:
    """SIGKILL replica 0 once its server's stats line (DRL_TRANSPORT_STATS_S)
    counts REPLICA_KILL_ACTS acts served: both actors, which alternate
    between the replicas, are then acting through it; record its pid."""
    import os
    import signal

    acts = re.compile(r"^\[infer0\] \[transport\] depth=\d+ acts=(\d+)", re.M)
    deadline = time.monotonic() + 150
    while time.monotonic() < deadline and proc.poll() is None:
        if max(map(int, acts.findall(log_path.read_text())), default=0) >= REPLICA_KILL_ACTS:
            break
        time.sleep(0.2)
    else:
        raise RuntimeError("replica drill: replica 0 never served its acts")
    seen["pid"] = child_pid(proc, b"inference", b"0")
    os.kill(seen["pid"], signal.SIGKILL)


def phase_launcher_replicas() -> dict:
    """(36) The `ximpala` section through the launcher with
    `--serve_inference --remote_act --inference_replicas 2`: 2 CPU actors
    act through 2 replicas on the card, each reading the learner's weight
    board; replica 0 is SIGKILLed once it has served REPLICA_KILL_ACTS
    acts (its server's stats line, DRL_TRANSPORT_STATS_S=1). Fails unless each replica
    attached the board, the actors demoted replica 0 and acted on (every
    act they made returned: none lost, none through the learner's
    fallback while the survivor served), the learner took its updates,
    and the survivor's summary shows acts served with 2 K3a launches a
    batch."""
    t0 = time.perf_counter()
    seen: dict = {}
    text = run_launcher("ximpala", SERVED_REPLICA_UPDATES, 2, "ximpala_replicas",
                        {"DRL_SHM_RING": None, "DRL_SHM_WEIGHTS": None,
                         "DRL_INFER_REPLICAS": None, "DRL_TRANSPORT_STATS_S": "1"},
                        extra=["--serve_inference", "--remote_act", "--inference_replicas", "2"],
                        during=lambda proc, path: kill_replica_mid_run(proc, path, seen))
    seconds = time.perf_counter() - t0
    want = ["[cluster] inference tier: 2 act-serving replica(s)",
            *(f"[infer{k}] [infer {k}] shm weight board attached: " for k in range(2)),
            *(f"[actor{k}] [actor {k}] remote act via 2 inference replica(s)" for k in range(2))]
    missing = [w for w in want if w not in text]
    (learner,) = role_json(text, "learner")
    actors = role_json(text, "actor0") + role_json(text, "actor1")
    survivors = role_json(text, "infer1")
    if missing or len(actors) != 2 or len(survivors) != 1 or role_json(text, "infer0"):
        raise RuntimeError(f"replica drill: missing {missing}, {len(actors)} actor and "
                           f"{len(survivors)} survivor summaries")
    (survivor,) = survivors
    services = [a["remote_act"]["service"] for a in actors]
    demoted = sum(s["replica_demotes"] for s in services)
    # A lost request raises out of the act (the actor's grace loop takes
    # it); a served one counts once, on a replica or the fallback.
    lost = [a["task"] for a in actors
            if a["remote_act"]["failed"] or a["remote_act"]["service"]["fallback_acts"]]
    if (learner["train_steps"] != SERVED_REPLICA_UPDATES or demoted < 1 or lost
            or any(s["replica_demotes"] > 1 for s in services)
            or any(a["weight_pulls"]["pulls"] or a["transport"]["weight_pulls"] for a in actors)
            or survivor["acts_served"] <= 0
            or survivor["launches"]["attention_fwd"] != 2 * survivor["batches_run"]):
        raise RuntimeError(f"replica drill: learner {learner['train_steps']} steps; actors' "
                           f"services {services}, lost {lost}; survivor {survivor}")
    log(f"[served] ximpala replica drill: replica 0 (pid {seen['pid']}) SIGKILLed; actors' "
        f"services {services}; act round trip p50 "
        + ", ".join(f"{a['remote_act']['act_ms_p50']:.2f}" for a in actors) + " / p99 "
        + ", ".join(f"{a['remote_act']['act_ms_p99']:.2f}" for a in actors)
        + f" ms; survivor: {survivor['acts_served']} acts in {survivor['batches_run']} batches "
        f"of {survivor['rows_served']} rows (occupancy {survivor['occupancy']:.3f}), K3a "
        f"{survivor['launches']['attention_fwd']}, latency p50 "
        f"{survivor['latency_ms_p50']:.3f} / p99 {survivor['latency_ms_p99']:.3f} ms, "
        f"{survivor['weight_versions_seen']} weight versions; learner "
        f"{learner['train_steps']} updates, launches {learner['launches']}, "
        f"{learner['transport']['acts_served']} fallback acts served; phase {seconds:.1f} s")
    return {"survivor": survivor, "services": services, "learner_launches": learner["launches"],
            "seconds": seconds}


# -- the on-device (Anakin) loops, phases 37-40 ----------------------------------

ANAKIN_ENV_STEPS = 64  # phase 37: steps of each device env on CUDA and the CPU
ANAKIN_PARITY_ENVS = 8  # phase 37: envs stepped on both devices (the CPU side sets the time)
ANAKIN_ENV_COUNTS = (20, 256)  # phase 37's throughput: the impala section's envs, and more
ANAKIN_UPDATES = 3  # phases 38-40: updates after the warm-up


def to_device(tree, device):
    """A tensor, or a tuple or NamedTuple of tensors, on `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    moved = [to_device(t, device) for t in tree]
    return type(tree)(*moved) if hasattr(tree, "_fields") else tuple(moved)


def eventful_start(name: str, state):
    """A device env's reset state with some games near their end (lives,
    scores, the step cap), so that 64 steps see life losses, game overs
    and auto-resets."""
    n = state[0].shape[0]
    ramp = torch.arange(n)
    if name == "cartpole":
        return state._replace(steps=torch.where(ramp % 3 == 0, 190, 0).to(torch.int32))
    if name == "breakout":
        return state._replace(lives=(1 + ramp % 5).to(torch.int32))
    if name == "pong":
        return state._replace(enemy_score=torch.where(ramp % 2 == 0, 20, 0).to(torch.int32),
                              player_score=torch.where(ramp % 3 == 0, 20, 0).to(torch.int32))
    return state._replace(lives=(1 + ramp % 3).to(torch.int32),
                          frames=torch.where(ramp % 4 == 0, 9_900, 0).to(torch.int32))


def device_env_modules() -> dict:
    from distributed_reinforcement_learning_tpu_torch.envs import (
        breakout_device, cartpole_device, invaders_device, pong_device)

    return {"cartpole": cartpole_device, "breakout": breakout_device, "pong": pong_device,
            "invaders": invaders_device}


def compare_env_outputs(name: str, t: int, cpu, cuda) -> None:
    """Step `t`'s outputs and state on the two devices: integers, booleans
    and frames equal (a frame mismatch is reported by its count of pixels
    and largest difference), floats within 1e-6."""
    (s_cpu, *out_cpu), (s_gpu, *out_gpu) = cpu, cuda
    pairs = list(zip(("obs", "reward", "done", "episode_return"), out_cpu, out_gpu))
    pairs += [(f"state.{k}", a, getattr(s_gpu, k)) for k, a in s_cpu._asdict().items()]
    for what, a, b in pairs:
        b = b.cpu()
        if a.dtype.is_floating_point:
            err = float((a - b).abs().max()) if a.numel() else 0.0
            if not err <= 1e-6:
                raise RuntimeError(f"{name} step {t}: {what} differs by {err:.3e} (bar 1e-6)")
        elif not torch.equal(a, b):
            diff = (a.to(torch.int32) - b.to(torch.int32)).abs()
            raise RuntimeError(f"{name} step {t}: {what} differs in {int((diff > 0).sum())} "
                               f"places, by at most {int(diff.max())}")


def phase_anakin_envs() -> dict:
    """(37) The device envs on the card: each stepped ANAKIN_ENV_STEPS
    steps of ANAKIN_PARITY_ENVS envs on CUDA and on the CPU from the same state with the same actions
    and draws; frames (the observation stacks and the raw frames in the
    state), rewards, dones and episode returns equal, float state within
    1e-6. Then env frames/s on CUDA at 20 and 256 envs (one frame is one
    observation, `frameskip` emulated frames for the pixel games)."""
    t0 = time.perf_counter()
    mods = device_env_modules()
    out = {"frames_per_s": {}, "events": {}}
    for name, mod in mods.items():
        n = ANAKIN_PARITY_ENVS
        gen = torch.Generator().manual_seed(7)
        state, _ = mod.reset(n, gen)
        state = eventful_start(name, state)
        gstate = to_device(state, "cuda")
        rng = np.random.RandomState(1)
        events = {"done": 0, "reward": 0, "episode_end": 0}
        t1 = time.perf_counter()
        for t in range(ANAKIN_ENV_STEPS):
            actions = torch.from_numpy(rng.randint(0, mod.NUM_ACTIONS, n))
            draws = mod.draws(gen, n)
            cpu = mod.step(state, actions, draws)
            cuda = mod.step(gstate, actions.cuda(), to_device(draws, "cuda"))
            compare_env_outputs(name, t, cpu, cuda)
            state, gstate = cpu[0], cuda[0]
            events["done"] += int(cpu[3].sum())
            events["reward"] += int((cpu[2] != 0).sum())
            events["episode_end"] += int((cpu[4] != 0).sum())
        if not events["done"]:
            raise RuntimeError(f"{name}: {ANAKIN_ENV_STEPS} steps of {n} envs saw no done")
        out["events"][name] = events
        parity_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        for count in ANAKIN_ENV_COUNTS:
            gen = torch.Generator(device="cuda").manual_seed(3)
            gstate, _ = mod.reset(count, gen)
            acts = [torch.randint(0, mod.NUM_ACTIONS, (count,), device="cuda", generator=gen)
                    for _ in range(32)]
            draws = [mod.draws(gen, count) for _ in range(32)]
            for i in range(3):
                gstate = mod.step(gstate, acts[i], draws[i])[0]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for i in range(32):
                gstate = mod.step(gstate, acts[i], draws[i])[0]
            torch.cuda.synchronize()
            out["frames_per_s"][(name, count)] = 32 * count / (time.perf_counter() - t1)
        log(f"[anakin envs] {name}: {ANAKIN_ENV_STEPS} steps of {n} envs on CUDA and the CPU "
            f"from one state with the same draws: frames, rewards, dones and returns equal, "
            f"float state within 1e-6 ({events}); env frames/s on CUDA "
            + ", ".join(f"{out['frames_per_s'][(name, c)]:.0f} at {c} envs"
                        for c in ANAKIN_ENV_COUNTS)
            + f" (parity {parity_s:.1f} s, rates {time.perf_counter() - t1:.1f} s)")
    out["seconds"] = time.perf_counter() - t0
    return out


def anakin_profile(what: str, fn) -> dict:
    """torch.profiler, device activity only (a CPU trace of ~24,000 ops
    takes the profiler ~20 s to reduce), over one synchronised call of
    `fn` -> device-kernel ms and device kernels launched; logs the
    largest device items."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    got = {"device_ms": sum(device_us(e) for e in events) / 1e3,
           "kernels": sum(e.count for e in events)}
    log(f"[profile] {what}: {got['kernels']} device kernels, {got['device_ms']:.2f} ms of them")
    for e in sorted(events, key=lambda e: -device_us(e))[:6]:
        log(f"[profile]   {device_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return got


def timed_chunk(loop, state, updates: int) -> tuple:
    """`loop.train_chunk` with the counts zeroed just before and read just
    after -> (state, metrics, synchronised seconds, launches)."""
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = loop.train_chunk(state, updates)
    torch.cuda.synchronize()
    return state, metrics, time.perf_counter() - t0, all_launches()


def check_finite(label: str, metrics: dict) -> None:
    bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v).all())]
    if bad:
        raise RuntimeError(f"{label}: metrics not finite: {bad}")


def anakin_impala_parity(loop, state) -> dict:
    """One CUDA collect replayed on the CPU from the same parameters and
    state, with the CUDA run's env draws and sampled actions forced: per
    step behaviour policy and stored (h, c) within 1e-5, frames, rewards,
    dones and the prev_action resets equal; then one learn step on the
    CUDA batch on both devices, loss terms and the gradient norm at rtol
    1e-4 (TF32 off)."""
    from distributed_reinforcement_learning_tpu_torch.runtime.anakin import (
        AnakinImpala, AnakinState)

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, env, n = loop.agent.cfg, loop.env, loop.num_envs
    cpu_loop = AnakinImpala(ImpalaAgent(cfg, device="cpu"), n, env=env)
    params = {k: v.detach().cpu() for k, v in state.train.params.items()}
    cpu_state = AnakinState(
        train=cpu_loop.agent.state_from_params(params), env=to_device(state.env, "cpu"),
        obs=state.obs.cpu(), prev_action=state.prev_action.cpu(), h=state.h.cpu(),
        c=state.c.cpu(), generator=torch.Generator().manual_seed(0))
    draws = [env.draws(state.generator, n) for _ in range(cfg.trajectory)]
    batch, _ = loop.collect(state, env_draws=draws)
    want, _ = cpu_loop.collect(cpu_state, actions=batch.action.transpose(0, 1).cpu(),
                               env_draws=[to_device(d, "cpu") for d in draws])
    errs = {}
    for name in want._fields:
        a, b = getattr(batch, name).cpu(), getattr(want, name)
        if a.dtype.is_floating_point:
            errs[name] = float((a - b).abs().max())
            if not errs[name] <= 1e-5:
                raise RuntimeError(f"anakin impala parity: {name} differs by {errs[name]:.3e}")
        elif not torch.equal(a, b):
            raise RuntimeError(f"anakin impala parity: {name} differs in "
                               f"{int((a != b).sum())} places")
    if not torch.equal(state.prev_action.cpu(), cpu_state.prev_action):
        raise RuntimeError("anakin impala parity: prev_action after the collect differs")
    gpu_train = loop.agent.state_from_params(state.train.params)
    _, m_gpu = loop.agent.learn(gpu_train, batch)
    _, m_cpu = cpu_loop.agent.learn(cpu_state.train, to_device(batch, "cpu"))
    rel = {}
    for k in ("pi_loss", "baseline_loss", "entropy", "total_loss", "grad_norm"):
        a, b = float(m_gpu[k]), float(m_cpu[k])
        rel[k] = abs(a - b) / max(abs(b), 1e-30)
        if not rel[k] <= 1e-4:
            raise RuntimeError(f"anakin impala learn parity: {k} {a} on CUDA, {b} on the CPU")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return {"collect_max_abs_err": errs, "learn_rel_err": rel}


def phase_anakin_impala(mem_start: int) -> dict:
    """(38) Anakin IMPALA on the `impala` section at full width: Breakout
    on the card (`envs/breakout_device.py`), NatureConv, LSTM 256, the
    18-way head aliased onto 4 actions, 20 envs, T 20. One update warms
    up; then ANAKIN_UPDATES updates with the counts zeroed just before:
    exactly 2 K1 launches an update, finite metrics, parameters that
    moved. Logs frames/s, the synchronised ms an update, the device busy
    share and kernels launched in one update (profiler), and the peak;
    then the device parity of `anakin_impala_parity`."""
    from distributed_reinforcement_learning_tpu_torch.runtime.anakin import (
        AnakinImpala, env_action)
    from distributed_reinforcement_learning_tpu_torch.runtime.launch import _device_env_for

    t0 = time.perf_counter()
    agent_cfg, rt = load_config(CONFIG, "impala")
    env, _ = _device_env_for(agent_cfg, rt)
    loop = AnakinImpala(ImpalaAgent(agent_cfg, device="cuda"),
                        rt.num_actors * rt.envs_per_actor, env=env)
    state = loop.init(0)
    state, _ = loop.train_chunk(state, 1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    before = {k: v.detach().clone() for k, v in state.train.params.items()}
    torch.cuda.reset_peak_memory_stats()
    state, m, wall, launches = timed_chunk(loop, state, ANAKIN_UPDATES)
    peak = torch.cuda.max_memory_allocated()
    check_finite("anakin impala", m)
    if launches["vtrace"] != 2 * ANAKIN_UPDATES or sum(launches.values()) != launches["vtrace"]:
        raise RuntimeError(f"anakin impala: launches {launches} in {ANAKIN_UPDATES} updates, "
                           f"expected {2 * ANAKIN_UPDATES} of K1 and no other kernel")
    still = [k for k, v in before.items() if torch.equal(state.train.params[k].detach(), v)]
    if still:
        raise RuntimeError(f"anakin impala: parameters did not move: {still}")
    frames = ANAKIN_UPDATES * loop.num_envs * agent_cfg.trajectory
    # Where an update's time goes: its collect, then its learn step.
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    batch, _ = loop.collect(state)
    torch.cuda.synchronize()
    collect_ms = (time.perf_counter() - t1) * 1e3
    state.train, _ = loop.agent.learn(state.train, batch)
    torch.cuda.synchronize()
    learn_ms = (time.perf_counter() - t1) * 1e3 - collect_ms
    # The profiler over a whole update (~24,000 kernels) takes ~18 s to
    # reduce, so it reads one act and env step and one learn step: an
    # update is T of the first and one of the second.
    t1 = time.perf_counter()
    T = agent_cfg.trajectory

    def act_and_step():
        out = loop.agent.act(state.train.params, state.obs, state.prev_action, state.h, state.c,
                             state.generator)
        loop.env.step(state.env, env_action(out.action, agent_cfg.num_actions, loop.env),
                      loop.env.draws(state.generator, loop.num_envs))

    step = anakin_profile("one act and env step of the anakin impala collect", act_and_step)
    learn = anakin_profile("one anakin impala learn step",
                           lambda: loop.agent.learn(state.train, batch))
    prof = {k: T * step[k] + learn[k] for k in step}
    prof_s = time.perf_counter() - t1
    parity = anakin_impala_parity(loop, state)
    parity_s = time.perf_counter() - t1 - prof_s
    got = {"launches": launches, "ms_per_update": wall / ANAKIN_UPDATES * 1e3,
           "frames_per_s": frames / wall, "peak_mib": (peak - mem_start) / 2**20,
           "kernels_per_update": prof["kernels"], "collect_ms": collect_ms, "learn_ms": learn_ms,
           "busy": prof["device_ms"] / (wall / ANAKIN_UPDATES * 1e3), **parity,
           "seconds": time.perf_counter() - t0}
    log(f"[anakin impala] {ANAKIN_UPDATES} updates of {loop.num_envs} Breakout envs x T "
        f"{agent_cfg.trajectory} on the card: {got['ms_per_update']:.1f} ms an update "
        f"synchronised ({collect_ms:.1f} ms its collect, {learn_ms:.1f} ms its learn step), "
        f"{got['frames_per_s']:.0f} frames/s, launches {launches}; one update T x "
        f"{step['kernels']} + {learn['kernels']} = {prof['kernels']} device kernels, "
        f"{prof['device_ms']:.2f} ms of them ({100 * got['busy']:.1f}% busy); own peak {got['peak_mib']:.1f} MiB; last metrics "
        + json.dumps({k: float(v[-1]) for k, v in m.items()})
        + f"; CPU replay of a CUDA collect: max abs diff {parity['collect_max_abs_err']}, "
        f"learn step relative diff {parity['learn_rel_err']}; phase {got['seconds']:.1f} s "
        f"(set-up and warm-up {warm_s:.1f}, profile {prof_s:.1f}, parity {parity_s:.1f})")
    return got


def phase_anakin_apex(mem_start: int) -> dict:
    """(39) Anakin Ape-X on the `apex` section at full width: 20 Breakout
    envs on the card, 16 steps a collect (W 320), the default ring of
    min(replay_capacity, 32768) transitions cut to a multiple of W, the
    warm-up of the launcher (ceil(3 x 32 / 320) collects), then
    ANAKIN_UPDATES updates with the counts zeroed just before: no kernel,
    finite loss, parameters that moved. Logs the ring's bytes, frames/s
    and the peak."""
    from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexAgent
    from distributed_reinforcement_learning_tpu_torch.runtime.anakin_apex import AnakinApex
    from distributed_reinforcement_learning_tpu_torch.runtime.launch import _device_env_for

    t0 = time.perf_counter()
    agent_cfg, rt = load_config(CONFIG, "apex")
    env, transform = _device_env_for(agent_cfg, rt)
    n, steps = rt.num_actors * rt.envs_per_actor, 16
    width = n * steps
    cap = min(rt.replay_capacity, 32768)
    cap -= cap % width
    torch.cuda.reset_peak_memory_stats()
    loop = AnakinApex(ApexAgent(agent_cfg, device="cuda"), num_envs=n, batch_size=rt.batch_size,
                      capacity=cap, steps_per_collect=steps,
                      target_sync_interval=rt.target_sync_interval,
                      updates_per_collect=rt.updates_per_call,
                      epsilon_floor=rt.epsilon_floor or 0.0, env=env, obs_transform=transform)
    state = loop.init(0)
    ring_bytes = state.replay.nbytes()
    warm = -(-rt.train_start_factor * rt.batch_size // width)
    state, _ = loop.collect_chunk(state, warm)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    before = {k: v.detach().clone() for k, v in state.train.params.items()}
    state, m, wall, launches = timed_chunk(loop, state, ANAKIN_UPDATES)
    peak = torch.cuda.max_memory_allocated()
    check_finite("anakin apex", m)
    if any(launches.values()):
        raise RuntimeError(f"anakin apex: kernels launched {launches}; Ape-X has none")
    still = [k for k, v in before.items() if torch.equal(state.train.params[k].detach(), v)]
    if still or state.train.step != ANAKIN_UPDATES * rt.updates_per_call:
        raise RuntimeError(f"anakin apex: step {state.train.step}, unmoved {still}")
    got = {"ring_bytes": ring_bytes, "capacity": cap, "warm": warm,
           "ms_per_update": wall / ANAKIN_UPDATES * 1e3,
           "frames_per_s": ANAKIN_UPDATES * width / wall, "peak_mib": (peak - mem_start) / 2**20,
           "seconds": time.perf_counter() - t0}
    log(f"[anakin apex] {n} Breakout envs x {steps} steps a collect, a ring of {cap} "
        f"transitions ({ring_bytes / 1e9:.3f} GB on the card), {warm} warm-up collect(s), then "
        f"{ANAKIN_UPDATES} updates: {got['ms_per_update']:.1f} ms an update synchronised, "
        f"{got['frames_per_s']:.0f} frames/s, launches {launches}; peak "
        f"{got['peak_mib']:.1f} MiB; last loss {float(m['loss'][-1]):.5f}; phase "
        f"{got['seconds']:.1f} s (set-up and warm-up {warm_s:.1f})")
    return got


def phase_anakin_r2d2(mem_start: int, section: str) -> dict:
    """(40) Anakin R2D2 on `section` (`r2d2`: CartPole-POMDP, LSTM 512,
    seq_len 10; `r2d2_pixel`: Breakout, Nature torso, LSTM 256, seq_len
    20) at full width, 12 envs on the card, the default ring of
    min(replay_capacity, 4096) sequences cut to a multiple of 12, the
    launcher's warm-up, then ANAKIN_UPDATES updates of K =
    `updates_per_call` learns with the counts zeroed just before: K2a
    2 + 2K and K2b K launches an update (PERF.md's prediction), no K1 or
    K3, finite loss and priorities, parameters that moved."""
    from distributed_reinforcement_learning_tpu_torch.runtime.anakin_r2d2 import AnakinR2D2
    from distributed_reinforcement_learning_tpu_torch.runtime.launch import _device_env_for

    t0 = time.perf_counter()
    agent_cfg, rt = load_config(CONFIG, section)
    env, transform = _device_env_for(agent_cfg, rt)
    n = rt.num_actors * rt.envs_per_actor
    cap = min(rt.replay_capacity, 4096)
    cap -= cap % n
    K = rt.updates_per_call
    torch.cuda.reset_peak_memory_stats()
    loop = AnakinR2D2(R2D2Agent(agent_cfg, device="cuda"), num_envs=n, batch_size=rt.batch_size,
                      capacity=cap, target_sync_interval=rt.target_sync_interval,
                      updates_per_collect=K, epsilon_floor=rt.epsilon_floor or 0.0, env=env,
                      obs_transform=transform)
    state = loop.init(0)
    ring_bytes = state.replay.nbytes()
    warm = -(-rt.train_start_factor * rt.batch_size // n)
    state, _ = loop.collect_chunk(state, warm)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    before = {k: v.detach().clone() for k, v in state.train.params.items()}
    state, m, wall, launches = timed_chunk(loop, state, ANAKIN_UPDATES)
    peak = torch.cuda.max_memory_allocated()
    check_finite(f"anakin {section}", m)
    want = {"lstm_fwd": (2 + 2 * K) * ANAKIN_UPDATES, "lstm_bwd": K * ANAKIN_UPDATES}
    if {k: launches[k] for k in want} != want or sum(launches.values()) != sum(want.values()):
        raise RuntimeError(f"anakin {section}: launches {launches}, expected {want}")
    if not bool(torch.isfinite(state.replay.priorities).all()):
        raise RuntimeError(f"anakin {section}: priorities not finite")
    still = [k for k, v in before.items() if torch.equal(state.train.params[k].detach(), v)]
    if still:
        raise RuntimeError(f"anakin {section}: parameters did not move: {still}")
    got = {"launches": launches, "ring_bytes": ring_bytes, "capacity": cap,
           "ms_per_update": wall / ANAKIN_UPDATES * 1e3,
           "frames_per_s": ANAKIN_UPDATES * n * agent_cfg.seq_len / wall,
           "peak_mib": (peak - mem_start) / 2**20, "seconds": time.perf_counter() - t0}
    log(f"[anakin {section}] {n} envs x seq_len {agent_cfg.seq_len}, a ring of {cap} sequences "
        f"({ring_bytes / 1e9:.3f} GB), {warm} warm-up collects, then {ANAKIN_UPDATES} updates of "
        f"K={K}: {got['ms_per_update']:.1f} ms an update synchronised, "
        f"{got['frames_per_s']:.0f} frames/s, launches {launches}; peak "
        f"{got['peak_mib']:.1f} MiB; last loss {float(m['loss'][-1]):.5f}; phase "
        f"{got['seconds']:.1f} s (set-up and warm-up {warm_s:.1f})")
    return got


SHARD_PUBLISHES = 20  # phase 41: timed publishes, a learn step before each
SHARD_BOARD_BYTES = 64 << 20  # phase 41: each segmented board's arena


def params_bit_equal(got: dict, want: dict) -> bool:
    return set(got) == set(want) and all(
        np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
        and np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes() for k in want)


def phase_sharded_publication() -> dict:
    """Sharded weight publication (`runtime/weight_shards.py`) on the
    `xformer_moe` section's agent at full width: CUDA learner stores
    publishing through `publish_async` per shard in float32 and in
    bfloat16, and a whole-blob store, each served over TCP, the sharded
    ones also onto a segmented board. CPU readers pull each version over
    TCP (`ShardedRemoteWeights`) and through the board (`BoardWeights`):
    bit for bit the whole-blob decode in float32, its bfloat16 round trip
    in bfloat16. Logs the bytes a version, the shards each publish
    memcpys and the pull p50 of each reader."""
    import os

    from distributed_reinforcement_learning_tpu_torch.data import bf16, codec
    from distributed_reinforcement_learning_tpu_torch.runtime.transport import (
        RemoteWeights, ShardedRemoteWeights, TransportClient, TransportServer)
    from distributed_reinforcement_learning_tpu_torch.runtime.weight_board import (
        BoardWeights, ShardedWeightBoard, attach_any)
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

    t_phase = time.perf_counter()
    agent_cfg, rt = load_config(CONFIG, "xformer_moe")
    agent = XformerAgent(agent_cfg, device="cuda")
    state = agent.init_state(seed=3)
    batch, is_weight = xformer_batch(agent_cfg, rt.batch_size, seed=5)
    stores = {"f32": WeightStore(sharded=True, quant=""),
              "bf16": WeightStore(sharded=True, quant="bf16"), "whole": WeightStore(sharded=False)}
    boards, servers, clients, readers = {}, {}, {}, {}
    try:
        for tag in ("f32", "bf16"):
            boards[tag] = ShardedWeightBoard.create(f"drlsmoke-wshard-{tag}-{os.getpid()}",
                                                    SHARD_BOARD_BYTES)
            stores[tag].attach_board(boards[tag])
        for tag, store in stores.items():
            servers[tag] = TransportServer(TrajectoryQueue(4), store, host="127.0.0.1",
                                           port=free_port()).start()
            clients[tag] = TransportClient("127.0.0.1", servers[tag].port)
        for tag in ("f32", "bf16"):
            readers[f"tcp_{tag}"] = ShardedRemoteWeights(clients[tag], "cpu")
            readers[f"board_{tag}"] = BoardWeights(attach_any(boards[tag].name), clients[tag],
                                                   device="cpu")
        readers["tcp_whole"] = RemoteWeights(clients["whole"], "cpu")
        changed: dict[str, list[int]] = {"f32": [], "bf16": []}
        pull_ms: dict[str, list[float]] = {tag: [] for tag in readers}

        def publish(version: int) -> None:
            before = {tag: stores[tag].shard_stat("shards_changed") for tag in changed}
            for store in stores.values():
                store.publish_async(state.params, version)
            for store in stores.values():
                if not store.flush_async(timeout=60.0):
                    raise RuntimeError(f"sharded publication: version {version} did not land")
            for tag in changed:
                changed[tag].append(stores[tag].shard_stat("shards_changed") - before[tag])

        def pull_and_check(version: int, timed: bool) -> None:
            want = codec.decode(stores["whole"].get_blob()[0], copy=True)
            want_bf16 = {k: bf16.bf16_u16_to_f32(bf16.f32_to_bf16_u16(v))
                         if v.dtype == np.float32 else v for k, v in want.items()}
            for tag, reader in readers.items():
                t0 = time.perf_counter()
                got = reader.get_if_newer(version - 1)
                ms = (time.perf_counter() - t0) * 1e3
                if got is None or got[1] != version:
                    raise RuntimeError(f"sharded publication: reader {tag} got {got and got[1]}, "
                                       f"expected version {version}")
                host = {k: v.numpy() for k, v in got[0].items()}
                ref = want_bf16 if tag.endswith("bf16") else want
                if not params_bit_equal(host, ref):
                    bad = [k for k in ref if host[k].tobytes() != ref[k].tobytes()]
                    raise RuntimeError(f"sharded publication: reader {tag} at version {version} "
                                       f"differs from the whole-blob decode"
                                       f"{' bfloat16 round trip' if ref is want_bf16 else ''}: "
                                       f"{bad[:4]}")
                if timed:
                    pull_ms[tag].append(ms)

        publish(0)
        manifest = json.loads(bytes(stores["f32"].get_sharded(-1)[1]))
        keys = [sh["key"] for sh in manifest["shards"]]
        if not {"expert", "-,model", "rep"} <= set(keys):
            raise RuntimeError(f"sharded publication: xformer_moe shards {keys}")
        pull_and_check(0, timed=False)
        experts = [k for k in state.params if ".moe.moe_w" in k]
        with torch.no_grad():
            for k in experts:
                state.params[k].add_(1e-3)
        publish(1)  # the expert tensors alone moved
        pull_and_check(1, timed=False)
        if changed["f32"][1] != 1:
            raise RuntimeError(f"sharded publication: {changed['f32'][1]} shards changed when only "
                               f"the experts moved")
        for v in range(2, 2 + SHARD_PUBLISHES):
            agent.learn(state, batch, is_weight)
            publish(v)
            pull_and_check(v, timed=True)
        sizes = {tag: sum(sh["nbytes"] for sh in json.loads(bytes(
            stores[tag].get_sharded(-1)[1]))["shards"]) for tag in ("f32", "bf16")}
        sizes["whole"] = len(stores["whole"].get_blob()[0])
        board_stats = {tag: stores[tag].board_stats() for tag in ("f32", "bf16")}
        shard_pulls = {tag: readers[f"board_{tag}"].stat("shard_pulls") for tag in ("f32", "bf16")}
        sent = {tag: servers[tag].snapshot_stats() for tag in ("f32", "bf16")}
        versions = 2 + SHARD_PUBLISHES
        if (any(n != versions for n in shard_pulls.values())
                or any(readers[f"tcp_{t}"].stat("shard_pulls") != versions for t in changed)
                or any(readers[f"board_{t}"].stat("tcp_fallbacks") for t in changed)):
            raise RuntimeError(f"sharded publication: board shard pulls {shard_pulls}, TCP "
                               f"{[readers[f'tcp_{t}'].snapshot_stats() for t in changed]}")
    finally:
        for reader in readers.values():
            if hasattr(reader, "close"):
                reader.close()
        for client in clients.values():
            client.close()
        for server in servers.values():
            server.stop()
        for store in stores.values():
            store.close()
        for board in boards.values():
            board.close()
            board.unlink()
    p50 = {tag: float(np.median(ms)) for tag, ms in pull_ms.items()}
    result = {"keys": keys, "bytes": sizes, "changed": changed, "pull_ms_p50": p50,
              "board": board_stats, "seconds": time.perf_counter() - t_phase}
    log(f"[wshard] xformer_moe ({sum(v.numel() for v in state.params.values()):,} parameters) "
        f"sharded {keys}: bytes a version whole {sizes['whole']:,}, sharded f32 "
        f"{sizes['f32']:,}, bf16 {sizes['bf16']:,} (manifest {len(bytes(stores['f32'].get_sharded(-1)[1])):,}); "
        f"shards memcpy'd a publish f32 {changed['f32']}, bf16 {changed['bf16']}; every reader "
        f"bit for bit the whole-blob decode (f32) or its bf16 round trip at "
        f"{2 + SHARD_PUBLISHES} versions; board shard pulls {shard_pulls}; TCP shard sends "
        f"{ {t: (s['shard_sends'], s['shard_full_sends']) for t, s in sent.items()} }; board "
        f"writes {[b['writes'] for b in board_stats.values()]}, "
        f"{[round(b['write_ms'], 3) for b in board_stats.values()]} ms each")
    log(f"[wshard] pull p50 over {SHARD_PUBLISHES} versions (ms): " + ", ".join(
        f"{tag} {ms:.3f}" for tag, ms in p50.items()) + f"; phase {result['seconds']:.1f} s")
    return result


DEVICE_PATH_CALLS = 6  # phase 42: timed train calls on each path
DEVICE_PATH_RUNS = (("r2d2", "r2d2", 2), ("apex", "apex", None))  # (algo, section, K)


def seeded_blobs(algo: str, agent_cfg, n: int) -> list[bytes]:
    """`n` codec blobs the sharded service ingests: a 32-transition Ape-X
    unroll or one R2D2 sequence each, seeded."""
    from distributed_reinforcement_learning_tpu_torch.data import codec

    if algo == "apex":
        return [bytes(codec.encode(apex_batch(agent_cfg, 32, seed=100 + i)[0])) for i in range(n)]
    batch, _ = r2d2_batch(agent_cfg, n, seed=100)
    return [bytes(codec.encode(tree_map(lambda x, i=i: x[i], batch))) for i in range(n)]


def record_writebacks(svc) -> list:
    """Wrap the service's `update_batch` to keep each (indices, priorities)."""
    calls = []
    update = svc.update_batch

    def recording(idxs, prio):
        calls.append((np.asarray(idxs).copy(), np.asarray(prio).copy()))
        return update(idxs, prio)

    svc.update_batch = recording
    return calls


def device_path_run(algo: str, section: str, k: int | None, ref) -> dict:
    """One family under the device path and on the host path: two
    learners over two default 2-shard services fed the same blobs, the
    same parameters and sampling seed."""
    import shutil
    import tempfile

    from distributed_reinforcement_learning_tpu_torch.runtime import launch, replay_shard
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

    agent_cfg, rt = load_config(CONFIG, section)
    if k is not None:
        rt = dataclasses.replace(rt, updates_per_call=k)
    k = rt.updates_per_call
    blobs = seeded_blobs(algo, agent_cfg, 3 * rt.batch_size)
    spill = tempfile.mkdtemp(prefix="smoke_devpath_")
    learners, services, writebacks = [], [], []
    try:
        for force in (True, False):
            svc = replay_shard.build_service(algo, rt, seed=0, spill_dir=spill)
            if svc is None or len(svc.shards) != 2:
                raise RuntimeError(f"device path {section}: the default service has "
                                   f"{svc and len(svc.shards)} shards, not 2")
            for i, blob in enumerate(blobs):
                svc.shards[i % 2].ingest_blob(blob)
            learner = launch.make_learner(algo, agent_cfg, rt, TrajectoryQueue(8), WeightStore(),
                                          seed=0, device="cuda", replay_service=svc)
            learner.device_path_force = force
            services.append(svc)
            learners.append(learner)
            writebacks.append(record_writebacks(svc))
        dev, host = learners
        host.state = host.agent.state_from_params(
            {n: t.detach() for n, t in dev.state.params.items()})
        before = {n: t.detach().clone() for n, t in dev.state.params.items()}

        launches, call_ms = {}, {}
        for tag, learner in (("device", dev), ("host", host)):
            torch.cuda.synchronize()
            zero_launch_counts()
            t0 = time.perf_counter()
            while learner.train_steps < k:
                learner.train()
                if time.perf_counter() - t0 > 60:
                    raise RuntimeError(f"device path {section}: the {tag} call never trained")
            torch.cuda.synchronize()
            launches[tag] = all_launches()
        path = dev._device_path
        if path is None or path.dead or host._device_path is not None:
            raise RuntimeError(f"device path {section}: path {path and path.dead_reason}, host "
                               f"path's {host._device_path}")
        want = {"lstm_fwd": 2 * k, "lstm_bwd": k} if algo == "r2d2" else {}
        for tag, got in launches.items():
            if {n: c for n, c in got.items() if c} != want:
                raise RuntimeError(f"device path {section}: {tag} call launched {got}, "
                                   f"expected {want}")
        lr = float(getattr(agent_cfg, "learning_rate", None)
                   or getattr(agent_cfg, "start_learning_rate"))
        bound = sum(2 * adam_ratio_bound(t) for t in range(1, k + 1)) * lr
        noise, worst = 0, 0.0
        for name, want_p in host.state.params.items():
            got_p = dev.state.params[name].detach()
            want_p = want_p.detach()
            diff = (got_p - want_p).abs()
            settled = diff <= 1e-4 * want_p.abs() + 1e-2 * lr
            worst = max(worst, float(diff.max()))
            if float(diff.max()) > bound * (1 + 1e-5):
                raise RuntimeError(f"device path {section}: {name} differs by "
                                   f"{float(diff.max())} from the host path, beyond Adam's {bound}")
            noise += int((~settled).sum())
            if float((got_p - before[name]).abs().max()) == 0.0:
                raise RuntimeError(f"device path {section}: {name} did not move")
        for svc in services:
            if not svc.flush_updates(timeout=30.0):
                raise RuntimeError(f"device path {section}: priority updates did not land")
        first = [wb[:k] for wb in writebacks]
        for (di, dp), (hi, hp) in zip(*first):
            if not np.array_equal(di, hi):
                raise RuntimeError(f"device path {section}: the two paths sampled other indices")
            np.testing.assert_allclose(dp, hp, rtol=1e-4, atol=1e-6,
                                       err_msg=f"device path {section} priorities")

        # The learn windows: events on the learn stream around each call of
        # the agent's learn step that `device_train_call` makes, the wait on
        # the entry's copy outside them.
        learn_events = []
        step_name = "learn_many" if k > 1 else "learn"

        def windowed(fn):
            def call(*args, **kwargs):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(*args, **kwargs)
                b.record()
                learn_events.append((a, b))
                return out
            return call

        for tag, learner in (("device", dev), ("host", host)):
            times = []
            if tag == "device":
                setattr(dev.agent, step_name, windowed(getattr(dev.agent, step_name)))
            for _ in range(DEVICE_PATH_CALLS):
                steps = learner.train_steps
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                while learner.train_steps == steps:
                    learner.train()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            call_ms[tag] = float(np.median(times))
        delattr(dev.agent, step_name)
        windows = [(ref.elapsed_time(a), ref.elapsed_time(b)) for a, b in learn_events]
        copies = [(ref.elapsed_time(s), ref.elapsed_time(d)) for s, d in path._transfer.timing]
        h2d = [d - s for s, d in copies]
        timed = [(s, d) for s, d in copies if s >= windows[0][0]]
        overlap = sum(max(0.0, min(d, b) - max(s, a)) for s, d in timed for a, b in windows)
        share = overlap / max(sum(d - s for s, d in timed), 1e-9)
        stats = path.stats()
        stage_ms = {"device": dev.timer.run_means_ms(), "host": host.timer.run_means_ms()}
        result = {"k": k, "launches": launches, "call_ms": call_ms, "stage_ms": stage_ms,
                  "h2d_ms": float(np.median(h2d)), "h2d_overlap": share,
                  "entries": stats["entries_out"], "h2d_mb": stats["h2d_bytes"] / 1e6,
                  "noise_floor": noise, "worst": worst, "lr": lr}
    finally:
        for learner in learners:
            learner.close()
        for svc in services:
            svc.close()
        shutil.rmtree(spill, ignore_errors=True)
    n = sum(v.numel() for v in before.values())
    log(f"[devpath] {section} K={k} over the default 2-shard service: launches a call device "
        f"{ {n_: c for n_, c in launches['device'].items() if c} }, host "
        f"{ {n_: c for n_, c in launches['host'].items() if c} }; parameters after one call "
        f"within {result['worst']:.2e} of the host path's ({result['worst'] / lr:.1e} of lr), "
        f"{noise} of {n:,} elements past rtol 1e-4 at Adam's noise floor; priorities and "
        f"indices the host path's; H2D {result['h2d_ms']:.3f} ms device time an entry "
        f"({result['h2d_mb'] / max(stats['entries_out'], 1):.2f} MB), "
        f"{100 * share:.1f}% of it inside the learn steps' device windows; ms a call "
        f"(synchronised) device "
        f"path {call_ms['device']:.2f}, host path {call_ms['host']:.2f}; stage means (ms) "
        + "; ".join(f"{tag} " + ", ".join(f"{k_} {v:.2f}" for k_, v in st.items())
                    for tag, st in stage_ms.items()))
    return result


def phase_device_path() -> dict:
    """The fused device sample path (`data/device_path.py`,
    `replay_train.device_train_call`) under `device_path_force`: `r2d2`
    with K = 2 (K2a and K2b through `learn_many`) and `apex` at its
    section's K. Each path's first call from the same parameters on the
    same sampled batches: the same launches a call, the same indices,
    priorities at rtol 1e-4 and parameters at phase 16's bar; then the
    H2D copy's device ms, the share of it inside the learn steps' device
    windows (events around the agent's learn call, the wait on the next
    copy outside), and the ms a call on both paths."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    ref = torch.cuda.Event(enable_timing=True)
    ref.record()
    runs = {section: device_path_run(algo, section, k, ref)
            for algo, section, k in DEVICE_PATH_RUNS}
    runs["seconds"] = time.perf_counter() - t_phase
    log(f"[devpath] phase {runs['seconds']:.1f} s")
    return runs


# -- the learner tier on the card (phase 43) ---------------------------------------

TIER_STEPS = 3  # (a), (b): tier steps held to the union learner / the merge
TIER_TIMED_STEPS = 12  # (a): further allreduce steps for the round times
TIER_UPDATES = 80  # (c): seat 1 trains on alone well after seat 0's death
TIER_KILL_STEP = 20  # (c): seat 0 is SIGKILLed once it logged this step
TIER_ENV = {"DRL_LEARNER_WAIT_S": "3", "DRL_SHM_WEIGHTS": "1", "DRL_SHM_RING": None}


def tier_seats(n: int, sync: str) -> list:
    """`n` started LearnerTiers over loopback in this process."""
    from distributed_reinforcement_learning_tpu_torch.runtime.learner_tier import LearnerTier

    addrs = [f"127.0.0.1:{free_port()}" for _ in range(n)]
    tiers = [LearnerTier(r, addrs, sync=sync, probe_interval_s=60.0) for r in range(n)]
    for t in tiers:
        t.collective.wait_s = 20.0
        t.start()
    return tiers


def on_threads(fns, timeout: float = 120.0) -> list:
    """Run each of `fns` on its own thread; -> their results, or raise the
    first error (or a wedge)."""
    out, errs = [None] * len(fns), [None] * len(fns)

    def run(i):
        try:
            out[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001 — raised below
            errs[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a tier seat wedged")
    for e in errs:
        if e is not None:
            raise e
    return out


def close_seats(tiers, learners) -> None:
    for learner in learners:
        learner.close()
    on_threads([t.close for t in tiers], timeout=30.0)


def clone_train_state(agent, state):
    """A copy of `state` (parameters, target, Adam moments, step) for
    `agent`."""
    out = agent.state_from_params({k: v.detach() for k, v in state.params.items()})
    for mine, theirs in ((out.target_params, state.target_params), (out.mu, state.mu),
                         (out.nu, state.nu)):
        for k, v in theirs.items():
            mine[k].copy_(v)
    out.step = state.step
    return out


def tier_apex_allreduce() -> dict:
    """(a) Two `apex` seats (ApexLearners on CUDA, threads of this
    process) under allreduce over loopback, each on one half of a
    seeded batch of 32. At each of TIER_STEPS steps both seats must hold
    the same bits, and each must be at phase 16's bar of one CUDA learner
    that took the step on the union batch from the same state (the merged
    gradient against the union's, `adam_step_close`). Then
    TIER_TIMED_STEPS more steps time the rounds; the flat vector's D2H
    (`flatten_tree`) and H2D (`unflatten_tree`) are timed apart."""
    from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexAgent
    from distributed_reinforcement_learning_tpu_torch.runtime.apex_runner import ApexLearner
    from distributed_reinforcement_learning_tpu_torch.runtime.learner_tier import (
        flatten_tree, unflatten_tree)
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

    agent_cfg, rt = load_config(CONFIG, "apex")
    batch, isw = apex_batch(agent_cfg, rt.batch_size, seed=21)
    half = rt.batch_size // 2
    halves = [tree_map(lambda x: x[:half], batch), tree_map(lambda x: x[half:], batch)]
    weights = [isw[:half], isw[half:]]
    tiers = tier_seats(2, "allreduce")
    learners, merged = [], [[], []]
    try:
        for r in range(2):
            agent = ApexAgent(agent_cfg, device="cuda")
            apply = agent.apply_grads

            def recording_apply(state, grads, loss, r=r, apply=apply):
                merged[r].append({k: v.detach().clone() for k, v in grads.items()})
                return apply(state, grads, loss)

            agent.apply_grads = recording_apply
            learner = ApexLearner(agent, TrajectoryQueue(8), WeightStore(), batch_size=half,
                                  replay_capacity=1024, init_seed=11)
            tiers[r].attach(learner)
            learners.append(learner)
        plan = tiers[0]._plan
        on_threads([lambda t=t: t.await_peers(30.0) for t in tiers])
        union = ApexAgent(agent_cfg, device="cuda")
        lr = agent_cfg.start_learning_rate
        unsettled = 0

        def step_all():
            return on_threads([lambda r=r: learners[r]._learn(learners[r].state, halves[r],
                                                              weights[r])
                               for r in range(2)])

        for t in range(1, TIER_STEPS + 1):
            ustate = clone_train_state(union, learners[0].state)
            ugrads, _, uloss = union.grads(ustate, batch, isw)
            ugrads = {k: v.detach().clone() for k, v in ugrads.items()}
            union.apply_grads(ustate, ugrads, uloss)
            step_all()
            p0, p1 = learners[0].state.params, learners[1].state.params
            differ = [k for k in p0 if not bit_equal(p0[k].detach(), p1[k].detach())]
            if differ or not all(bit_equal(merged[0][-1][k], merged[1][-1][k]) for k in p0):
                raise RuntimeError(f"tier (a) step {t}: the seats differ in {differ}")
            for k, v in ustate.params.items():
                unsettled += adam_step_close(f"tier (a) step {t} {k}", p0[k].detach(),
                                             v.detach(), merged[0][-1][k], ugrads[k], lr, t)
        round_ms: list[float] = []
        inner = tiers[0]._merged_rounds

        def timed_rounds(vec):
            t0 = time.perf_counter()
            out = inner(vec)
            round_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        tiers[0]._merged_rounds = timed_rounds
        step_ms = []
        for _ in range(TIER_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_all()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        agent = learners[0].agent
        d2h, h2d = [], []
        for _ in range(TIER_TIMED_STEPS):
            grads, _, _ = agent.grads(learners[0].state, halves[0], weights[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vec, meta = flatten_tree(grads)
            d2h.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            unflatten_tree(vec, meta)
            torch.cuda.synchronize()
            h2d.append((time.perf_counter() - t0) * 1e3)
        stats = [t.snapshot_stats() for t in tiers]
        coll = [t.collective.snapshot_stats() for t in tiers]
        if any(s["round_giveups"] or s["round_retries"] for s in stats):
            raise RuntimeError(f"tier (a): rounds gave up or retried: {stats}")
        if any(c["rounds_ok"] != TIER_STEPS + TIER_TIMED_STEPS for c in coll):
            raise RuntimeError(f"tier (a): rounds {[c['rounds_ok'] for c in coll]}")
        n = sum(v.numel() for v in learners[0].state.params.values())
        got = {"rounds": [s["rounds"] for s in stats],
               "round_retries": [s["round_retries"] for s in stats],
               "round_giveups": [s["round_giveups"] for s in stats],
               "round_ms_p50": float(np.median(round_ms)),
               "round_ms_max": float(np.max(round_ms)),
               "step_ms_p50": float(np.median(step_ms)),
               "bytes_a_round": [c["bytes_sent"] / c["rounds_ok"] for c in coll],
               "bytes_by_class": {k[len("coll_bytes_"):]: v / coll[0]["rounds_ok"]
                                  for k, v in coll[0].items()
                                  if k.startswith("coll_bytes_") and v},
               "d2h_ms_p50": float(np.median(d2h)), "h2d_ms_p50": float(np.median(h2d)),
               "elements": n + 1, "classes": plan.classes, "unsettled": unsettled}
    finally:
        close_seats(tiers, learners)
    log(f"[tier] (a) apex allreduce, 2 seats x {half} of one batch of {rt.batch_size}: "
        f"{TIER_STEPS} steps bit for bit equal across the seats and at phase 16's bar of the "
        f"union learner ({unsettled} elements at the gradients' noise floor); exchange plan "
        f"{plan.classes} over {n + 1:,} f32 elements (the loss last); rounds "
        f"{got['rounds']}, retries {got['round_retries']}, giveups {got['round_giveups']}; "
        f"round ms p50 {got['round_ms_p50']:.3f} (max {got['round_ms_max']:.3f}), tier step "
        f"ms p50 {got['step_ms_p50']:.3f}; bytes a round a seat {got['bytes_a_round']} "
        f"(seat 0 by class {got['bytes_by_class']}); flat vector D2H p50 "
        f"{got['d2h_ms_p50']:.3f} ms, H2D p50 {got['h2d_ms_p50']:.3f} ms")
    return got


def tier_r2d2_async() -> dict:
    """(b) Two `r2d2` seats (R2D2Learners on CUDA from different seeds)
    under async with a merge every step, stepped in turns on one thread
    (so the process-wide launch counts are exact): each learn step must
    launch 2 K2a and 1 K2b, as the solo learner's; each seat must merge
    at least once; seat 1's first merge must be, bit for bit, the mean of
    its own parameters and seat 0's push."""
    from distributed_reinforcement_learning_tpu_torch.runtime.learner_tier import flatten_tree
    from distributed_reinforcement_learning_tpu_torch.runtime.r2d2_runner import R2D2Learner
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

    agent_cfg, rt = load_config(CONFIG, "r2d2")
    tiers = tier_seats(2, "async")
    learners, pushed = [], [[], []]
    try:
        for r in range(2):
            tiers[r].merge_steps = 1
            push = tiers[r].collective.push_merge

            def recording_push(vec, step, r=r, push=push):
                pushed[r].append(np.array(vec, np.float32))
                return push(vec, step)

            tiers[r].collective.push_merge = recording_push
            learner = R2D2Learner(R2D2Agent(agent_cfg, device="cuda"), TrajectoryQueue(8),
                                  WeightStore(), batch_size=rt.batch_size, replay_capacity=1024,
                                  init_seed=11 + r)
            tiers[r].attach(learner)
            learners.append(learner)
        batches = [r2d2_batch(agent_cfg, rt.batch_size, seed=31 + r) for r in range(2)]
        zero_launch_counts()
        merge_ok = None
        step_ms = []
        for step in range(TIER_STEPS):
            for r in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                learners[r]._learn(learners[r].state, *batches[r])
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                if step == 0 and r == 1:
                    want = (pushed[1][0] + pushed[0][0]) / np.float32(2)
                    merge_ok = np.array_equal(flatten_tree(learners[1].state.params)[0], want)
        launches = {"lstm_fwd": klstm.lstm_fwd_cuda.launches,
                    "lstm_bwd": klstm.lstm_bwd_cuda.launches}
        stats = [t.snapshot_stats() for t in tiers]
        n_steps = 2 * TIER_STEPS
        if launches != {"lstm_fwd": 2 * n_steps, "lstm_bwd": n_steps}:
            raise RuntimeError(f"tier (b): launches {launches} in {n_steps} learn steps")
        if not merge_ok or any(s["merges_applied"] < 1 for s in stats):
            raise RuntimeError(f"tier (b): the merge (seat 1's first equal to the mean: "
                               f"{merge_ok}); {stats}")
        if any(s["round_giveups"] or s["round_retries"] for s in stats):
            raise RuntimeError(f"tier (b): rounds gave up or retried: {stats}")
        finite = all(torch.isfinite(v).all() for lrn in learners
                     for v in lrn.state.params.values())
        if not finite:
            raise RuntimeError("tier (b): non-finite parameters")
        got = {"launches": launches, "merges_applied": [s["merges_applied"] for s in stats],
               "merge_rounds": [s["merge_rounds"] for s in stats],
               "round_giveups": [s["round_giveups"] for s in stats],
               "round_retries": [s["round_retries"] for s in stats],
               "step_ms_p50": float(np.median(step_ms)),
               "bytes_a_merge": pushed[0][0].nbytes}
    finally:
        close_seats(tiers, learners)
    log(f"[tier] (b) r2d2 async, 2 seats, a merge every step, {TIER_STEPS} steps each: "
        f"launches {launches} (2 K2a + 1 K2b a learn step, as the solo learner's); merges "
        f"applied {got['merges_applied']} of {got['merge_rounds']} merge rounds; seat 1's "
        f"first merge the mean of both, bit for bit; retries {got['round_retries']}, giveups "
        f"{got['round_giveups']}; tier step ms p50 {got['step_ms_p50']:.3f} (learn, push and "
        f"merge); {got['bytes_a_merge']:,} bytes a push")
    return got


def seat_pid(proc, rank: int) -> int:
    """The pid of the launcher's learner seat `rank`."""
    want = f"DRL_LEARNER_RANK={rank}".encode()
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
            environ = (entry / "environ").read_bytes().split(b"\0")
            cmdline = (entry / "cmdline").read_bytes().split(b"\0")
        except OSError:
            continue
        ppid = int(stat.rsplit(")", 1)[1].split()[1])
        if ppid == proc.pid and b"learner" in cmdline and want in environ:
            return int(entry.name)
    raise RuntimeError(f"no learner seat {rank} under the launcher")


def wait_for_line(proc, log_path: Path, mark: str, what: str) -> str:
    """Wait until the launcher's log holds `mark`; -> the log so far."""
    deadline = time.monotonic() + LAUNCH_TIMEOUT_S
    while time.monotonic() < deadline and proc.poll() is None:
        text = log_path.read_text()
        if mark in text:
            return text
        time.sleep(0.1)
    raise RuntimeError(f"tier (c): {what} never came")


def read_board_versions(name: str, stop, versions: list) -> None:
    """A fresh reader of the shared board `name`: its committed version
    every 0.1 s until `stop` is set or the board is gone."""
    from distributed_reinforcement_learning_tpu_torch.runtime import weight_board

    board = weight_board.attach_any(name)
    try:
        while not stop.is_set():
            versions.append(board.version())
            stop.wait(0.1)
    except (weight_board.BoardClosed, OSError):
        pass
    finally:
        board.close()


def kill_seat_mid_run(proc, log_path: Path, seat1_port: int, seen: dict) -> None:
    """SIGKILL seat 0 once it logged TIER_KILL_STEP tier steps. Then, as
    an actor of seat 1 would, pull seat 1's weights over TCP, and, once
    seat 1 logged its takeover, read the shared board afresh, each on a
    thread of this process that ends with the launch."""
    import os
    import signal

    text = wait_for_line(proc, log_path, f"[learner0] [learner] tier seat 0: step "
                         f"{TIER_KILL_STEP},", "seat 0's kill step")
    seen["board"] = re.search(r"shm weight board attached: (\S+)", text).group(1)
    seen["pid"] = seat_pid(proc, 0)
    os.kill(seen["pid"], signal.SIGKILL)
    seen["stop"] = stop = threading.Event()
    seen["tcp"], seen["board_versions"] = [], []
    seen["threads"] = [threading.Thread(target=probe_weights, args=(seat1_port, stop,
                                                                    seen["tcp"]))]
    seen["threads"][0].start()
    wait_for_line(proc, log_path, "[learner1] [learner] tier takeover: shm weight board "
                  "re-created", "seat 1's board takeover")
    seen["threads"].append(threading.Thread(target=read_board_versions, args=(
        seen["board"], stop, seen["board_versions"])))
    seen["threads"][1].start()


def tier_launcher_kill() -> dict:
    """(c) The launcher with `--learners 2 --learner_sync allreduce` on the
    `apex` section (seats on CUDA, 2 CPU actors, the shared board): seat
    0 is SIGKILLed at TIER_KILL_STEP. Seat 1 must finish its TIER_UPDATES
    updates alone as the publisher (peer_deaths 1, promotions 1, the board
    re-created and written), with no round given up, and the launcher
    exits 137 (the killed seat). Pulls must go on landing new versions: an
    Ape-X actor pulls when its step count is a multiple of 100 at the
    start of a 64-step round, once in 1,600 steps, so a TCP client of seat
    1 and a fresh reader of the shared board in this process pull as
    actor 1 would, and each must see a version past the kill."""
    import socket

    seen: dict = {}
    base = free_port()
    while True:  # two consecutive free ports: the seats' data ports
        try:
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", base + 1))
            break
        except OSError:
            base = free_port()
    t0 = time.perf_counter()
    try:
        text = run_launcher("apex", TIER_UPDATES, 2, "tier",
                            dict(TIER_ENV, DRL_LEARNER_ADDR=f"127.0.0.1:{base}"),
                            extra=["--learners", "2", "--learner_sync", "allreduce"],
                            during=lambda proc, path: kill_seat_mid_run(proc, path, base + 1,
                                                                        seen),
                            expect_rc=137)
    finally:
        if "stop" in seen:
            seen["stop"].set()
            for t in seen["threads"]:
                t.join(30.0)
    seconds = time.perf_counter() - t0
    (seat1,) = role_json(text, "learner1")
    actor1 = role_json(text, "actor1")
    tier, coll = seat1["tier"], seat1["tier"]["collective"]
    takeover = "[learner1] [learner] tier takeover: shm weight board re-created" in text
    if (seat1["train_steps"] != TIER_UPDATES or not tier["publisher"] or tier["live"] != [1]
            or tier["promotions"] != 1 or coll["peer_deaths"] != 1 or tier["round_giveups"]
            or not takeover or not seat1["board"] or seat1["board"]["writes"] < 1):
        raise RuntimeError(f"tier (c): seat 1 {seat1['train_steps']} steps, tier {tier}, "
                           f"board {seat1['board']}, takeover logged {takeover}")
    after = TIER_KILL_STEP + 10
    tcp = [v for v, _ in seen["tcp"]]
    if (len(actor1) != 1 or not tcp or max(tcp) <= after or not seen["board_versions"]
            or max(seen["board_versions"]) <= after):
        raise RuntimeError(f"tier (c): versions pulled past the kill, TCP {tcp}, board "
                           f"{seen['board_versions']}; actor 1 {actor1}")
    steps = seat1["step_s"]
    got = {"seconds": seconds, "round_retries": tier["round_retries"],
           "rounds_ok": coll["rounds_ok"], "solo_rounds": coll["solo_rounds"],
           "actor1_version": actor1[0]["weight_version"],
           "tcp_versions": [tcp[0], tcp[-1], len(tcp)],
           "board_versions": [seen["board_versions"][0], seen["board_versions"][-1]],
           "board": seat1["board"], "first_step_s": steps[0],
           "solo_ms_a_step": (steps[-1] - steps[coll["rounds_ok"]]) / max(
               1, len(steps) - 1 - coll["rounds_ok"]) * 1e3,
           "paired_ms_a_step": (steps[coll["rounds_ok"] - 1] - steps[0]) / max(
               1, coll["rounds_ok"] - 1) * 1e3}
    log(f"[tier] (c) launcher, apex, 2 seats on CUDA + 2 CPU actors under allreduce: seat 0 "
        f"(pid {seen['pid']}) SIGKILLed at step {TIER_KILL_STEP}; seat 1 finished "
        f"{seat1['train_steps']} updates as the publisher ({coll['rounds_ok']} paired rounds, "
        f"{coll['solo_rounds']} solo, retries {tier['round_retries']}, giveups "
        f"{tier['round_giveups']}, peer_deaths {coll['peer_deaths']}, promotions "
        f"{tier['promotions']}); its board re-created ({seat1['board']}); after the kill a "
        f"TCP client of seat 1 pulled versions {tcp[0]}..{tcp[-1]} ({len(tcp)} pulls) and a "
        f"fresh board reader saw {seen['board_versions'][0]}..{seen['board_versions'][-1]}; "
        f"actor 1 ended at weight version {got['actor1_version']} (one pull a 1,600 steps); "
        f"first step at {steps[0]:.2f} s, "
        f"{got['paired_ms_a_step']:.1f} ms a paired step, {got['solo_ms_a_step']:.1f} ms a "
        f"solo one (host clock); phase {seconds:.1f} s")
    return got


def phase_learner_tier() -> dict:
    """Phase 43: the learner tier, (a) `apex` under allreduce in process,
    (b) `r2d2` under async in process, (c) the launcher's two seats with
    seat 0 SIGKILLed. TF32 off for the parity parts."""
    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = {"apex": tier_apex_allreduce(), "r2d2": tier_r2d2_async()}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    got["launcher"] = tier_launcher_kill()
    got["seconds"] = time.perf_counter() - t_phase
    log(f"[tier] phase 43 {got['seconds']:.1f} s")
    return got


# -- the run drivers and the synthetic batches (phases 44-45) ------------------

# (a) the Breakout driver at its defaults: envs, T, updates a chunk (3 chunks, then 1
# resumed), and the greedy evals' envs and steps.
BREAKOUT_DRIVER = {"envs": 128, "T": 20, "updates": 5, "eval_envs": 32, "eval_steps": 300}
# (b) the R2D2 driver on Breakout: K learns a collect, U updates a chunk, warm-up collects.
R2D2_DRIVER = {"envs": 32, "T": 20, "burn_in": 10, "lstm": 256, "capacity": 1024, "batch": 64,
               "K": 2, "U": 4, "warm": 4, "eval_envs": 8, "eval_steps": 150}
REPLAY_EVAL = {"envs": 16, "steps": {"apex": 100, "r2d2": 200}}  # (c)
LONG_RUN_ARGV = ["--section", "impala_cartpole", "--chunk", "4", "--max-updates", "8",
                 "--checkpoint-interval", "4"]  # (e)
LONG_RUN_TIMEOUT_S = 240


@contextlib.contextmanager
def wrapped(cls, attr: str, hook):
    """`cls.attr` replaced by `hook(original, *args, **kwargs)` inside the
    context."""
    orig = getattr(cls, attr)
    setattr(cls, attr, lambda *args, **kwargs: hook(orig, *args, **kwargs))
    try:
        yield
    finally:
        setattr(cls, attr, orig)


def recording_restores(restored: list):
    """A context in which every checkpoint `Checkpointer.restore` returns
    appends (its parameters cloned, its step) to `restored`."""
    from distributed_reinforcement_learning_tpu_torch.utils.checkpoint import Checkpointer

    def hook(orig, self, template, step=None):
        got = orig(self, template, step)
        if got is not None:
            restored.append(({k: v.detach().clone() for k, v in got[0].params.items()}, got[2]))
        return got

    return wrapped(Checkpointer, "restore", hook)


def serving_evals(cls, head: str, seeds: list):
    """A context in which `cls.greedy_eval` appends its seed to `seeds`
    and plays a policy that always serves: the output layer `head` with
    its weight zeroed and its bias one-hot at FIRE, so that the argmax is
    FIRE at every step and a game ends once its 5 balls are lost, inside
    the phase's evals. The drivers' own policy, untrained, rarely serves,
    and its games then run to the 10,000-frame cap (2,500 steps)."""
    from distributed_reinforcement_learning_tpu_torch.envs import breakout_device

    def hook(orig, self, params, num_envs, num_steps, seed=0):
        seeds.append(seed)
        weight, bias = params[f"{head}.weight"], params[f"{head}.bias"]
        fire = torch.zeros_like(bias)
        fire[breakout_device.sim.FIRE] = 1.0
        serving = {**params, f"{head}.weight": torch.zeros_like(weight), f"{head}.bias": fire}
        return orig(self, serving, num_envs, num_steps, seed)

    return wrapped(cls, "greedy_eval", hook)


def check_evals(label: str, rows: list, seeds: list, chunks: list, least_episodes: int) -> None:
    """The eval rows are those of `chunks`, each seeded 1000 + its chunk
    (the default `--seed` 0), with at least `least_episodes` games and a
    finite mean."""
    evals = [r for r in rows if "eval_s" in r]
    if ([r["chunk"] for r in evals] != chunks or seeds != [1000 + c for c in chunks]
            or any(r["eval_episodes"] < least_episodes or not math.isfinite(r["eval_mean_return"])
                   for r in evals)):
        raise RuntimeError(f"{label}: evals {evals} seeded {seeds}, expected chunks {chunks} "
                           f"seeded 1000 + the chunk with at least {least_episodes} games each")


def tensors_bit_equal(got: dict, want: dict) -> bool:
    """Two dicts of tensors hold the same names, dtypes and bits."""
    return set(got) == set(want) and all(
        got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in want)


def driver_rows_finite(label: str, rows: list, loss: str) -> None:
    bad = [r["chunk"] for r in rows
           if not (math.isfinite(r[loss]) and math.isfinite(r["grad_norm"]))]
    if bad:
        raise RuntimeError(f"{label}: loss or grad norm not finite at chunks {bad}")


def driver_breakout(tmp: Path, mem_start: int) -> dict:
    """(44a) `anakin_breakout_train` at its defaults (Nature CNN on 84x84x4
    uint8, LSTM 256, 128 envs, T 20, bfloat16) with BREAKOUT_DRIVER: 5
    updates a chunk, 3 chunks, greedy evals of 32 envs x 300 steps every
    2 chunks, a checkpoint every 2 and at the end; then `--resume` for a
    4th chunk. With the counts zeroed around each run: 2 K1 launches an
    update and no other kernel; rows 1-3, then chunk 4 at 20 updates; the
    restored parameters the first run's bit for bit; finite losses. The
    evals play a serving policy (`serving_evals`): each must be seeded by
    its chunk (2, then 4 after the resume) and end a game in every env."""
    from distributed_reinforcement_learning_tpu_torch import anakin_breakout_train as driver
    from distributed_reinforcement_learning_tpu_torch.runtime.anakin import AnakinImpala

    t0 = time.perf_counter()
    d = BREAKOUT_DRIVER
    U = d["updates"]
    fpc = d["envs"] * d["T"] * U
    argv = ["--out", str(tmp / "breakout"), "--num-envs", str(d["envs"]), "--trajectory",
            str(d["T"]), "--updates-per-chunk", str(U), "--eval-every", "2", "--eval-envs",
            str(d["eval_envs"]), "--eval-steps", str(d["eval_steps"]), "--checkpoint-every", "2"]
    torch.cuda.reset_peak_memory_stats()
    seeds = []
    zero_launch_counts()
    with serving_evals(AnakinImpala, "policy_head.layers.2", seeds):
        first = driver.main([*argv, "--total-frames", str(3 * fpc)])
    torch.cuda.synchronize()
    launches = [all_launches()]
    rows = first["rows"]
    first_cfg = first["config"]
    if (first_cfg["dtype"], first_cfg["platform"]) != ("bfloat16", "cuda"):
        raise RuntimeError(f"breakout driver: config {first_cfg}")
    want = [(1, U, fpc, False), (2, 2 * U, 2 * fpc, True), (3, 3 * U, 3 * fpc, True)]
    if [(r["chunk"], r["updates"], r["frames"], "checkpoint" in r) for r in rows] != want:
        raise RuntimeError(f"breakout driver: rows {rows}")
    saved = {k: v.detach().clone() for k, v in first["state"].train.params.items()}
    del first
    restored = []
    zero_launch_counts()
    with recording_restores(restored), serving_evals(AnakinImpala, "policy_head.layers.2", seeds):
        again = driver.main([*argv, "--total-frames", str(4 * fpc), "--resume"])
    torch.cuda.synchronize()
    launches.append(all_launches())
    peak = torch.cuda.max_memory_allocated()
    rows += again["rows"]
    if [(r["chunk"], r["updates"], r["frames"]) for r in again["rows"]] != [(4, 4 * U, 4 * fpc)]:
        raise RuntimeError(f"breakout driver: resumed rows {again['rows']}")
    if (len(restored) != 1 or restored[0][1] != 3 * U
            or not tensors_bit_equal(restored[0][0], saved)):
        raise RuntimeError(f"breakout driver: the resume did not restore step {3 * U}'s "
                           "parameters bit for bit")
    for got, updates in zip(launches, (3 * U, U)):
        if got["vtrace"] != 2 * updates or sum(got.values()) != got["vtrace"]:
            raise RuntimeError(f"breakout driver: launches {got} in {updates} updates, "
                               f"expected {2 * updates} of K1 and no other kernel")
    driver_rows_finite("breakout driver", rows, "total_loss")
    check_evals("breakout driver", rows, seeds, [2, 4], d["eval_envs"])
    evals = [r for r in rows if "eval_s" in r]
    got = {"launches": launches, "fps": [r["fps"] for r in rows],
           "chunk_s": [r["chunk_s"] for r in rows], "eval_s": [r["eval_s"] for r in evals],
           "peak_mib": (peak - mem_start) / 2**20, "seconds": time.perf_counter() - t0}
    log(f"[drivers] (a) anakin_breakout_train, {d['envs']} Breakout envs x T {d['T']}, "
        f"{first_cfg['dtype']}, {U} updates "
        f"a chunk: chunks 1-3, then chunk 4 resumed from step {3 * U} bit for bit; env frames/s "
        f"a chunk {got['fps']} (chunk 1 holds the first calls), chunk s {got['chunk_s']}; "
        f"serving evals of {d['eval_envs']} envs x {d['eval_steps']} steps at chunks 2 and 4, "
        f"seeds {seeds}: {got['eval_s']} s, games {[r['eval_episodes'] for r in evals]}, mean "
        f"returns {[r['eval_mean_return'] for r in evals]}; launches {launches}; total_loss "
        f"{[r['total_loss'] for r in rows]}; peak {got['peak_mib']:.1f} MiB; "
        f"{got['seconds']:.1f} s")
    return got


def driver_r2d2(tmp: Path) -> dict:
    """(44b) `anakin_r2d2_train` on Breakout with R2D2_DRIVER (LSTM 256, 32
    envs, seq_len 20, burn-in 10, a ring of 1024 sequences, batch 64, K 2,
    4 updates a chunk, 4 warm-up collects) for 2 chunks, then `--resume`
    for a 3rd. With the counts zeroed around each run: K2a 2 a warm-up
    collect and 2 + 2K an update, K2b K an update, nothing else; the
    restored parameters bit for bit; the episode counters restored, the
    warm-up run again from them (the ring is not checkpointed); finite
    losses; the eval at chunk 2, a serving policy's (`serving_evals`),
    seeded 1002 and ending a game."""
    from distributed_reinforcement_learning_tpu_torch import anakin_r2d2_train as driver
    from distributed_reinforcement_learning_tpu_torch.runtime.anakin_r2d2 import AnakinR2D2

    t0 = time.perf_counter()
    d = R2D2_DRIVER
    K, U, warm, n = d["K"], d["U"], d["warm"], d["envs"]
    fpu = n * d["T"]
    argv = ["--out", str(tmp / "r2d2"), "--env", "breakout", "--lstm", str(d["lstm"]),
            "--num-envs", str(n), "--seq-len", str(d["T"]), "--burn-in", str(d["burn_in"]),
            "--capacity", str(d["capacity"]), "--batch-size", str(d["batch"]),
            "--updates-per-collect", str(K), "--updates-per-chunk", str(U),
            "--warmup-collects", str(warm), "--eval-every", "2", "--eval-envs",
            str(d["eval_envs"]), "--eval-steps", str(d["eval_steps"])]
    seeds = []
    zero_launch_counts()
    with serving_evals(AnakinR2D2, "value", seeds):
        first = driver.main([*argv, "--total-frames", str((warm + 2 * U) * fpu)])
    torch.cuda.synchronize()
    launches = [all_launches()]
    rows = first["rows"]
    if [(r["chunk"], r["updates"], r["frames"]) for r in rows] != [
            (1, K * U, (warm + U) * fpu), (2, 2 * K * U, (warm + 2 * U) * fpu)]:
        raise RuntimeError(f"r2d2 driver: rows {rows}")
    episodes = first["state"].episodes.cpu()
    saved = {k: v.detach().clone() for k, v in first["state"].train.params.items()}
    del first
    restored, warm_from = [], []

    def before_warmup(orig, self, state, n):
        warm_from.append(state.episodes.cpu())
        return orig(self, state, n)

    zero_launch_counts()
    with recording_restores(restored), wrapped(AnakinR2D2, "collect_chunk", before_warmup):
        again = driver.main([*argv, "--total-frames", str((2 * warm + 3 * U) * fpu), "--resume"])
    torch.cuda.synchronize()
    launches.append(all_launches())
    rows += again["rows"]
    (row,) = again["rows"]
    if (row["chunk"], row["updates"], row["replay_size"]) != (3, 3 * K * U, (warm + U) * n):
        raise RuntimeError(f"r2d2 driver: resumed row {row}")
    if (len(restored) != 1 or restored[0][1] != 2 * K * U
            or not tensors_bit_equal(restored[0][0], saved)):
        raise RuntimeError("r2d2 driver: the resume did not restore the parameters bit for bit")
    if len(warm_from) != 1 or not torch.equal(warm_from[0], episodes):
        raise RuntimeError(f"r2d2 driver: the warm-up after the resume started from episodes "
                           f"{warm_from}, the first run ended at {episodes.tolist()}")
    for got, u in zip(launches, (2 * U, U)):
        want = {"lstm_fwd": 2 * warm + (2 + 2 * K) * u, "lstm_bwd": K * u}
        if {k: got[k] for k in want} != want or sum(got.values()) != sum(want.values()):
            raise RuntimeError(f"r2d2 driver: launches {got}, expected {want}")
    driver_rows_finite("r2d2 driver", rows, "loss")
    check_evals("r2d2 driver", rows, seeds, [2], 1)
    got = {"launches": launches, "fps": [r["fps"] for r in rows],
           "episodes_restored": int(episodes.sum()), "seconds": time.perf_counter() - t0}
    log(f"[drivers] (b) anakin_r2d2_train on Breakout, {n} envs x seq_len {d['T']}, K={K}: "
        f"chunks 1-2, "
        f"then chunk 3 resumed bit for bit, its {warm} warm-up collects run again from the "
        f"restored counters ({got['episodes_restored']} episodes over {n} envs; replay "
        f"{row['replay_size']}); env frames/s a chunk {got['fps']}; launches {launches} (K2a 2 "
        f"a warm-up collect and {2 + 2 * K} an update, K2b {K} an update); serving eval of "
        f"{d['eval_envs']} envs x {d['eval_steps']} steps at chunk 2, seed {seeds}: "
        f"{[(r['eval_episodes'], r['eval_mean_return'], r['eval_s']) for r in rows if 'eval_s' in r]} "
        f"(games, mean return, s); loss {[r['loss'] for r in rows]}; {got['seconds']:.1f} s")
    return got


def driver_replay_eval(tmp: Path) -> dict:
    """(44c) `eval_anakin_replay` on checkpoints that the port's
    `train_apex` / `train_r2d2 --mode anakin --checkpoint_dir` wrote 2
    updates earlier on the card (`apex`: 20 Breakout envs; `r2d2`:
    CartPole-POMDP, 12 envs): the restored `train_step` is the saved one
    and the JSON has the JAX script's keys, with as many seeds as asked
    and the episodes they completed."""
    from distributed_reinforcement_learning_tpu_torch import (
        eval_anakin_replay, train_apex, train_r2d2)
    from distributed_reinforcement_learning_tpu_torch.utils.checkpoint import Checkpointer

    t0 = time.perf_counter()
    keys = {"algo", "section", "train_step", "greedy_mean_return", "per_seed", "episodes",
            "eval_envs", "eval_steps"}
    got = {}
    for algo, train in (("apex", train_apex), ("r2d2", train_r2d2)):
        ckpt = tmp / f"ckpt_{algo}"
        train.main(["--config", str(CONFIG), "--section", algo, "--mode", "anakin", "--updates",
                    "2", "--checkpoint_dir", str(ckpt)])
        saved = Checkpointer(ckpt).latest_step()
        out = eval_anakin_replay.main(["--algo", algo, "--config", str(CONFIG), "--section", algo,
                                       "--checkpoint_dir", str(ckpt), "--eval-envs",
                                       str(REPLAY_EVAL["envs"]), "--eval-steps",
                                       str(REPLAY_EVAL["steps"][algo]), "--seeds", "2"])
        if (set(out) != keys or out["train_step"] != saved or not saved
                or len(out["per_seed"]) != 2 or not math.isfinite(out["greedy_mean_return"])):
            raise RuntimeError(f"eval_anakin_replay {algo}: {out} (checkpoint step {saved})")
        got[algo] = out
    got["seconds"] = time.perf_counter() - t0
    log(f"[drivers] (c) eval_anakin_replay: " + "; ".join(
        f"{a} train_step {o['train_step']}, greedy mean {o['greedy_mean_return']} over "
        f"{o['episodes']} episodes, per seed {o['per_seed']}"
        for a, o in got.items() if a != "seconds") + f"; {got['seconds']:.1f} s")
    return got


def driver_evaluate(tmp: Path) -> dict:
    """(44d) `evaluate` on a `train_local` checkpoint of `impala_cartpole`
    on the card (4 updates, a checkpoint every 2): step 4 restored, 2
    episodes, a finite mean return."""
    from distributed_reinforcement_learning_tpu_torch import evaluate
    from distributed_reinforcement_learning_tpu_torch.runtime.launch import train_local

    t0 = time.perf_counter()
    ckpt = tmp / "ckpt_impala_cartpole"
    train_local(str(CONFIG), "impala_cartpole", 4, checkpoint_dir=str(ckpt), checkpoint_interval=2)
    out = evaluate.main(["--config", str(CONFIG), "--section", "impala_cartpole",
                         "--checkpoint_dir", str(ckpt), "--episodes", "2", "--max_unrolls", "200"])
    if out["checkpoint_step"] != 4 or out["episodes"] != 2 or not math.isfinite(out["return_mean"]):
        raise RuntimeError(f"evaluate: {out}")
    out["seconds"] = time.perf_counter() - t0
    log(f"[drivers] (d) evaluate impala_cartpole at step 4: {json.dumps(out)}")
    return out


def driver_long_run(tmp: Path) -> dict:
    """(44e) `long_run` on `impala_cartpole`, 2 chunks of 4 updates, one
    child interpreter each on the card, the driver in its own process
    group: records 4 then 8 updates with the JAX records' keys and
    `max_rss_mb`, and 1024 frames each, so the second child resumed
    from the first's checkpoint (it trained 4 updates, not 8)."""
    import os
    import signal

    t0 = time.perf_counter()
    out = tmp / "longrun" / "impala_cartpole.jsonl"
    log_path = ROOT / "chiprun_out" / "smoke_long_run.log"
    log_path.parent.mkdir(exist_ok=True)
    with open(log_path, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "distributed_reinforcement_learning_tpu_torch.long_run",
             "--config", str(CONFIG), "--out", str(out), *LONG_RUN_ARGV],
            cwd=ROOT, stdout=f, stderr=subprocess.STDOUT, text=True, start_new_session=True)
        try:
            rc = proc.wait(timeout=LONG_RUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise RuntimeError(f"long_run: no exit in {LONG_RUN_TIMEOUT_S} s (log {log_path})")
    recs = [json.loads(line) for line in out.read_text().splitlines()] if out.exists() else []
    keys = {"updates", "frames_total", "chunk_frames", "wall_s", "frames_per_s", "max_rss_mb",
            "episodes", "mean_return", "last20", "returns", "t"}
    if (rc != 0 or [r.get("updates") for r in recs] != [4, 8]
            or any(set(r) != keys or not r["max_rss_mb"] for r in recs)
            or [r["chunk_frames"] for r in recs] != [1024, 1024]):
        raise RuntimeError(f"long_run: rc {rc}, records {recs} (log {log_path})")
    got = {"records": [{k: r[k] for k in ("updates", "chunk_frames", "wall_s", "frames_per_s",
                                          "max_rss_mb")} for r in recs],
           "seconds": time.perf_counter() - t0}
    log(f"[drivers] (e) long_run impala_cartpole, 2 child processes on the card: "
        f"{got['records']}; {got['seconds']:.1f} s")
    return got


def phase_drivers(mem_start: int) -> dict:
    """Phase 44: the run drivers on the card, (a)-(e); their files in a
    temporary directory, removed after."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="smoke_drivers_"))
    try:
        got = {"breakout": driver_breakout(tmp, mem_start), "r2d2": driver_r2d2(tmp),
               "replay_eval": driver_replay_eval(tmp), "evaluate": driver_evaluate(tmp),
               "long_run": driver_long_run(tmp)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got["seconds"] = time.perf_counter() - t0
    log(f"[drivers] phase 44 {got['seconds']:.1f} s on {nvidia_smi_line()}")
    return got


SYNTHETIC_LAUNCHES = {  # a learn step's launches on each section (PERF.md's kernel table)
    "impala": {"vtrace": 2},
    "r2d2": {"lstm_fwd": 2, "lstm_bwd": 1},
    "apex": {},
    "ximpala": {"vtrace": 2, "attention_fwd": 2, "attention_dq": 2, "attention_dkv": 2},
    "xformer": {},
}


def synthetic_learn(section: str):
    """One `utils/synthetic.py` batch at `section`'s shapes in config.json
    (batch_size x trajectory or seq_len, its obs shape and head) on the
    card -> a callable that takes one learn step on it from fresh
    parameters and returns the step's metrics."""
    from distributed_reinforcement_learning_tpu_torch.runtime.launch import make_agent
    from distributed_reinforcement_learning_tpu_torch.utils import synthetic

    agent_cfg, rt = load_config(CONFIG, section)
    agent = make_agent(section, agent_cfg, device="cuda")
    state = agent.init_state(0)
    dev = agent.device
    B, obs, A = rt.batch_size, agent_cfg.obs_shape, agent_cfg.num_actions
    pixels = len(obs) == 3
    if section == "impala":
        batch = synthetic.synthetic_impala_batch(B, agent_cfg.trajectory, obs, A,
                                                 agent_cfg.lstm_size, seed=1, device=dev)
        return lambda: agent.learn(state, batch)[1]
    if section == "ximpala":
        batch = synthetic.synthetic_ximpala_batch(B, agent_cfg.trajectory, obs, A, seed=1,
                                                  device=dev)
        return lambda: agent.learn(state, batch)[1]
    if section == "apex":
        batch, w = synthetic.synthetic_apex_batch(
            B, obs, A, seed=1, obs_dtype=np.uint8 if pixels else np.float32, device=dev)
    elif section == "r2d2":
        batch, w = synthetic.synthetic_r2d2_batch(B, agent_cfg.seq_len, obs, A,
                                                  agent_cfg.lstm_size, seed=1, device=dev)
    else:
        batch, w = synthetic.synthetic_xformer_batch(B, agent_cfg.seq_len, obs, A, seed=1,
                                                     device=dev)
    return lambda: agent.learn(state, batch, w)[-1]


def phase_synthetic() -> dict:
    """Phase 45: one learn step on a `utils/synthetic.py` batch at each of
    the `impala`, `r2d2`, `apex`, `ximpala` and `xformer` sections' own
    shapes, with the counts zeroed just before: the launches of
    SYNTHETIC_LAUNCHES and no other, finite metrics."""
    t0 = time.perf_counter()
    got = {"launches": {}, "ms": {}}
    for section, want in SYNTHETIC_LAUNCHES.items():
        step = synthetic_learn(section)
        zero_launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics = step()
        torch.cuda.synchronize()
        got["ms"][section] = (time.perf_counter() - t1) * 1e3
        launches = all_launches()
        if launches != {k: want.get(k, 0) for k in launches}:
            raise RuntimeError(f"synthetic {section}: launches {launches}, expected {want}")
        bad = [k for k, v in metrics.items() if not bool(torch.isfinite(torch.as_tensor(v)).all())]
        if bad:
            raise RuntimeError(f"synthetic {section}: metrics not finite: {bad}")
        got["launches"][section] = launches
    got["seconds"] = time.perf_counter() - t0
    log(f"[synthetic] one learn step a section on a utils/synthetic.py batch: launches "
        + ", ".join(f"{s} {json.dumps({k: n for k, n in l.items() if n})}"
                    for s, l in got["launches"].items())
        + "; first-call ms " + ", ".join(f"{s} {ms:.1f}" for s, ms in got["ms"].items())
        + f"; phase 45 {got['seconds']:.1f} s")
    return got


# -- the sharded learner (phase 46) --------------------------------------------

SHARDED_STEPS = 3  # learn steps of each family held to the plain learner
SHARDED_TIMEOUT_S = 240  # each rank process, and the launcher's group
# (a) a world of one over NCCL: the families at their sections' full widths.
SHARDED_WORLD_ONE = ("impala", "r2d2", "ximpala", "apex")
# (b) two ranks on the one card: (section, model axis); data = 2 / model.
SHARDED_WORLD_TWO = (("impala", 1), ("r2d2", 1), ("apex", 2))
SHARDED_LAUNCHER_UPDATES = 20


def sharded_batch(algo: str, cfg, B: int, seed: int):
    """A seeded union batch of the family (with IS weights for the replay
    families, as a tuple)."""
    return {"impala": seeded_batch, "ximpala": ximpala_batch, "r2d2": r2d2_batch,
            "apex": apex_batch}[algo](cfg, B, seed)


def params_digest(params: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def timed_steps(learn, state, batches) -> tuple:
    """`learn` over `batches`, each step synchronised -> (state, ms a step)."""
    ms = []
    for data in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = learn(state, *data)[0]
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, ms


def sharded_case(section: str, model: int, bar: str) -> dict:
    """One family's sharded learner in this rank: SHARDED_STEPS steps on
    its rows of seeded union batches, with the counts zeroed just before;
    with `bar` ("bitwise" or "learn") rank 0 also runs the plain learner
    on the union batches and holds the parameters to it."""
    from distributed_reinforcement_learning_tpu_torch.parallel import make_mesh
    from distributed_reinforcement_learning_tpu_torch.runtime import launch

    agent_cfg, rt = load_config(CONFIG, section)
    algo = launch.algo_of(agent_cfg)
    agent = launch.make_agent(algo, agent_cfg, device=torch.cuda.current_device())
    n = 1 if algo in ("impala", "ximpala") else 2
    sl = ShardedLearner(agent, make_mesh(model_parallel=model), n, n)
    sl.reducer.timed = True
    union = [sharded_batch(algo, agent_cfg, rt.batch_size, seed=46 + i)
             for i in range(SHARDED_STEPS)]
    mine = [(sl.shard_batch(b),) if n == 1 else sl.shard_batch(b) for b in union]
    state = sl.init_state(seed=1)
    zero_launch_counts()
    state, ms = timed_steps(sl.learn, state, mine)
    got = {"launches": all_launches(), "ms": ms, "bytes_local": sl.state_bytes(state),
           "reduce_ms": [r[0] for r in sl.reducer.records],
           "reduce_bytes": [r[1] for r in sl.reducer.records]}
    whole = sl.gather_state(state)
    got["bytes_whole"] = sl.state_bytes(whole)
    got["digest"] = params_digest(whole.params)
    if bar is None or sl.mesh.rank != 0:
        return got
    plain = agent.init_state(seed=1)
    zero_launch_counts()
    steps = [(b,) if n == 1 else b for b in union]
    plain, got["plain_ms"] = timed_steps(agent.learn, plain, steps)
    got["plain_launches"] = all_launches()
    if bar == "bitwise":
        # A control: the plain learner again. Bit for bit needs the card's
        # deterministic algorithms (`sharded_rank` turns them on).
        again, _ = timed_steps(agent.learn, agent.init_state(seed=1), steps)
        differ = [k for k, p in plain.params.items() if not torch.equal(p, whole.params[k])]
        control = [k for k, p in plain.params.items() if not torch.equal(p, again.params[k])]
        got.update(max_rel_err=0.0, control_differs=len(control))
        if differ:
            raise RuntimeError(f"{section}: a world of one differs from the plain learner in "
                               f"{len(differ)} leaves ({differ[:3]}); the plain learner from "
                               f"itself in {len(control)} ({control[:3]})")
        return got
    # The card's learn-step bar (PERF.md §2): rtol 1e-4; an Adam element at
    # float32's noise floor moves by up to ~lr a step either way.
    lr = float(getattr(agent_cfg, "learning_rate", 0) or agent_cfg.start_learning_rate)
    adam = algo in ("apex", "r2d2")
    atol = 2 * SHARDED_STEPS * adam_ratio_bound(SHARDED_STEPS) * lr if adam else 1e-6
    worst, beyond = 0.0, 0
    for k, p in plain.params.items():
        q, p = whole.params[k].detach(), p.detach()
        torch.testing.assert_close(q, p, rtol=1e-4, atol=atol,
                                   msg=lambda m, k=k: f"{section} {k}: {m}")
        # The largest difference against the leaf's largest magnitude.
        worst = max(worst, float((q - p).abs().max() / p.abs().max().clamp_min(1e-30)))
        beyond += int(((q - p).abs() > 1e-4 * p.abs() + 1e-2 * lr).sum())
    got.update(max_rel_err=worst, beyond_rtol=beyond, atol=atol)
    return got


def join_world() -> dict:
    """A rank child's start (phases 46-47): TF32 off and the card's
    deterministic algorithms on (cuDNN's and cuBLAS's fastest ones may
    sum in another order on each call; the bit-for-bit bars need the
    deterministic ones), then the join from the DRL_* env names. -> the
    rank's backend, device and rank."""
    from distributed_reinforcement_learning_tpu_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    assert distributed.initialize()
    return {"backend": distributed.backend(), "device": str(distributed.device()),
            "rank": distributed.process_info()[0]}


def sharded_rank(cases: list) -> None:
    """One rank of phase 46 (a child process): join the world from the
    DRL_* env names, run `cases` ((section, model axis, bar)), print one
    JSON line."""
    from distributed_reinforcement_learning_tpu_torch.parallel import distributed

    out = join_world()
    for section, model, bar in cases:
        out[f"{section}/{model}"] = sharded_case(section, model, bar)
    print(json.dumps(out), flush=True)
    distributed.shutdown()


def start_ranks(world: int, call: str, tag: str, env_set: dict | None = None) -> list:
    """`world` rank processes running `chip_smoke.<call>` in one world
    (`DRL_COORDINATOR` on a free port), each in its own process group,
    all on this card. -> [(process, log file)] for `join_ranks`."""
    import os

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    env = dict(os.environ, DRL_COORDINATOR=f"localhost:{free_port()}",
               DRL_NUM_PROCESSES=str(world), CUBLAS_WORKSPACE_CONFIG=":4096:8",
               **(env_set or {}))
    procs = []
    for rank in range(world):
        f = open(out_dir / f"smoke_sharded_{tag}_rank{rank}.log", "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.{call}"],
            cwd=ROOT, env={**env, "DRL_PROCESS_ID": str(rank)}, stdout=f,
            stderr=subprocess.STDOUT, text=True, start_new_session=True), f))
    return procs


def join_ranks(procs: list, tag: str, timeout_s: float = SHARDED_TIMEOUT_S) -> list[dict]:
    """Wait for `start_ranks`' processes, each within `timeout_s` -> their
    JSON lines; a rank that fails, names no backend or hangs fails the
    phase, and every rank left is killed whole."""
    import os
    import signal

    results = []
    try:
        for proc, f in procs:
            proc.wait(timeout=timeout_s)
            f.seek(0)
            text = f.read()
            if proc.returncode != 0:
                raise RuntimeError(f"sharded {tag} rank: exit {proc.returncode}:\n{text[-4000:]}")
            # torch's own c10d warnings ("[W...") may come first on stderr.
            first = next(line for line in text.splitlines() if not line.startswith("[W"))
            if "[distributed] rank" not in first:
                raise RuntimeError(f"sharded {tag}: the rank's first line names no backend: "
                                   f"{first!r}")
            results.append(last_json(text))
    finally:
        for proc, f in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=30)
            f.close()
    return results


def run_ranks(world: int, cases: list, tag: str, rank_fn: str = "sharded_rank") -> list[dict]:
    """`world` rank processes of `rank_fn(cases)` (`sharded_rank`, or
    `anakin_mesh_rank` for phase 47) -> their JSON lines."""
    return join_ranks(start_ranks(world, f"{rank_fn}({cases!r})", tag), tag)


def poll_plane_versions(base: int, proc, seen: list) -> None:
    """Both learners' weight versions (ports base, base + 1), every 0.25 s,
    while the launcher runs, until both pass 3."""
    from distributed_reinforcement_learning_tpu_torch.runtime.transport import (
        _I64, OP_GET_WEIGHTS, TransportClient)

    clients = {}
    deadline = time.monotonic() + SHARDED_TIMEOUT_S
    try:
        while proc.poll() is None and time.monotonic() < deadline:
            try:
                pair = []
                for k in range(2):
                    if k not in clients:
                        clients[k] = TransportClient("127.0.0.1", base + k, connect_retries=2,
                                                     retry_interval=0.2)
                    resp = clients[k]._call(OP_GET_WEIGHTS, _I64.pack(-2))
                    pair.append(_I64.unpack(resp[:_I64.size])[0])
                seen.append(tuple(pair))
                if min(pair) >= 3:
                    return
            except (ConnectionError, OSError):
                pass  # the learners are still starting
            time.sleep(0.25)
    finally:
        for c in clients.values():
            c.close()


def phase_sharded_learner() -> dict:
    """Phase 46: the sharded learner. (a) A world of one over NCCL:
    `impala`, `r2d2`, `ximpala` and `apex` at full width, 3 steps each,
    bit for bit the plain learner, with its launches. (b) Two ranks on
    this one card (gloo, both on cuda:0): `impala` and `r2d2` at data 2,
    each rank on half of each union batch, the ranks bit for bit equal
    and within the learn-step bar of the union-batch learner; `apex` at
    model 2, each rank holding half of each sharded leaf and its moments.
    (c) `launch_local_cluster --learners 2` on `impala_cartpole`: both
    learners on cuda:0, their data planes' versions in lockstep, every
    role exits 0 and no segment is left."""
    from distributed_reinforcement_learning_tpu_torch.launch_local_cluster import _free_port_run

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    got = {}
    one = run_ranks(1, [(s, 1, "bitwise") for s in SHARDED_WORLD_ONE], "world1")[0]
    if one["backend"] != "nccl" or one["device"] != "cuda:0":
        raise RuntimeError(f"a world of one on {one['device']} over {one['backend']}, "
                           "expected cuda:0 over nccl")
    for section in SHARDED_WORLD_ONE:
        case = one[f"{section}/1"]
        if case["launches"] != case["plain_launches"]:
            raise RuntimeError(f"{section}: sharded launches {case['launches']} != plain "
                               f"{case['plain_launches']}")
    got["world1"] = one
    log(f"[sharded] (a) world of one, rank 0 backend {one['backend']} on {one['device']}; "
        "learn-step ms p50 sharded / plain (3 steps, the first warm): "
        + ", ".join(f"{s} {np.median(one[f'{s}/1']['ms']):.2f} / "
                    f"{np.median(one[f'{s}/1']['plain_ms']):.2f}" for s in SHARDED_WORLD_ONE)
        + "; parameters bit for bit (deterministic algorithms on; the plain learner "
        "against itself differs in " + ", ".join(
            f"{s} {one[f'{s}/1']['control_differs']}" for s in SHARDED_WORLD_ONE)
        + " leaves), launches "
        + ", ".join(f"{s} {json.dumps({k: v for k, v in one[f'{s}/1']['launches'].items() if v})}"
                    for s in SHARDED_WORLD_ONE) + f" as the plain step's ({smi})")

    two = run_ranks(2, [(s, m, "learn") for s, m in SHARDED_WORLD_TWO], "world2")
    for rank in two:
        if rank["backend"] != "gloo" or rank["device"] != "cuda:0":
            raise RuntimeError(f"rank {rank['rank']} on {rank['device']} over "
                               f"{rank['backend']}, expected cuda:0 over gloo")
    per_step = {"impala": {"vtrace": 2}, "r2d2": {"lstm_fwd": 2, "lstm_bwd": 1}, "apex": {}}
    for section, model in SHARDED_WORLD_TWO:
        key = f"{section}/{model}"
        if two[0][key]["digest"] != two[1][key]["digest"]:
            raise RuntimeError(f"{section}: the two ranks' parameters differ")
        want = {k: SHARDED_STEPS * per_step[section].get(k, 0) for k in two[0][key]["launches"]}
        for rank in two:
            if rank[key]["launches"] != want:
                raise RuntimeError(f"{section} rank {rank['rank']}: launches "
                                   f"{rank[key]['launches']}, expected {want}")
    apex = two[0]["apex/2"]
    if not 0.4 * apex["bytes_whole"] < apex["bytes_local"] < 0.6 * apex["bytes_whole"]:
        raise RuntimeError(f"apex at model 2: {apex['bytes_local']} bytes a rank of "
                           f"{apex['bytes_whole']}")
    got["world2"] = two
    log("[sharded] (b) two ranks on one card, backends "
        + ", ".join(f"rank {r['rank']} {r['backend']} on {r['device']}" for r in two)
        + "; ranks bit for bit equal; "
        + "; ".join(
            f"{s} at data {2 // m}, model {m}: learn-step ms p50 {np.median(c['ms']):.2f} "
            f"(union-batch plain {np.median(c['plain_ms']):.2f}), reduction ms p50 "
            f"{np.median(c['reduce_ms']) if c['reduce_ms'] else 0.0:.3f} for "
            f"{(c['reduce_bytes'] or [0])[0]} bytes a step, largest |difference| "
            f"{c['max_rel_err']:.2e} of a leaf's largest parameter "
            f"({c['beyond_rtol']} elements past rtol 1e-4 + 1% lr), bytes a rank "
            f"{c['bytes_local']} of {c['bytes_whole']}, launches a rank "
            f"{json.dumps({k: v for k, v in c['launches'].items() if v})}"
            for (s, m), c in ((sm, two[0][f"{sm[0]}/{sm[1]}"]) for sm in SHARDED_WORLD_TWO))
        + f" ({smi})")

    base = _free_port_run(2)
    seen: list = []
    out = run_launcher("impala_cartpole", SHARDED_LAUNCHER_UPDATES, 2, "group",
                       {"DRL_LEARNER_ADDR": f"127.0.0.1:{base}"}, extra=["--learners", "2"],
                       during=lambda proc, _: poll_plane_versions(base, proc, seen))
    learners = [role_json(out, f"learner{k}") for k in range(2)]
    actors = [role_json(out, f"actor{k}") for k in range(2)]
    if not all(learners) or not all(actors):
        raise RuntimeError(f"launcher group: a role printed no summary:\n{out[-4000:]}")
    for k, (summary,) in enumerate(learners):
        mh = summary["multihost"]
        if (summary["device"] != "cuda:0" or mh["backend"] != "gloo" or mh["rank"] != k
                or summary["train_steps"] != SHARDED_LAUNCHER_UPDATES):
            raise RuntimeError(f"launcher group learner{k}: {summary['device']}, {mh}, "
                               f"{summary['train_steps']} steps")
    if not seen or min(seen[-1]) < 3 or any(abs(a - b) > 4 for a, b in seen):
        raise RuntimeError(f"launcher group: weight versions {seen}")
    got["launcher"] = {"versions": seen, "learners": [s for (s,) in learners]}
    red = [learners[k][0]["multihost"] for k in range(2)]
    log(f"[sharded] (c) launch_local_cluster --learners 2: both learners on cuda:0 over "
        f"gloo, {SHARDED_LAUNCHER_UPDATES} updates each, versions (plane 0, plane 1) {seen}, "
        f"reduction ms p50 " + ", ".join(f"rank {r['rank']} {np.median(r['reduce_ms']):.3f}"
                                         for r in red)
        + f" for {red[0]['reduce_bytes'][0]} bytes a step; every role exited 0, no segment "
        f"left ({smi})")
    got["seconds"] = time.perf_counter() - t0
    log(f"[sharded] phase 46 {got['seconds']:.1f} s")
    return got


# -- the Anakin mesh (phase 47) -----------------------------------------------------

ANAKIN_MESH_UPDATES = 3  # updates of each family in each world
# (a) a world of one over NCCL; (b) two ranks on this card at data 2, and
# impala at data 1 x model 2: (section, model axis, bar against the plain
# loop from the same seed, in rank 0).
ANAKIN_MESH_WORLD_ONE = (("impala", 1, "bitwise"), ("apex", 1, "bitwise"),
                         ("r2d2", 1, "bitwise"))
ANAKIN_MESH_WORLD_TWO = (("impala", 1, None), ("apex", 1, None), ("r2d2", 1, None),
                         ("impala", 2, "learn"))
ANAKIN_MESH_LAUNCHES = {"impala": lambda K: {"vtrace": 2},  # a K = 1 update's
                        "apex": lambda K: {},
                        "r2d2": lambda K: {"lstm_fwd": 2 + 2 * K, "lstm_bwd": K}}
TIER_SEAT_STEPS = 3  # (c): allreduce steps of the two mesh seats
TIER_SEAT_ENV = {"DRL_COLL_PARTITION": "1", "DRL_COLL_QUANT": "f32", "DRL_COLL_OVERLAP": "0"}


def anakin_loop(section: str, mesh):
    """Phases 38-40's loop on `section` at full width (impala: 20 Breakout
    envs; apex: 20 envs x 16 steps, a ring of 32,640; r2d2: 12 envs, a
    ring of 4,092), over `mesh` or on one device -> (loop, warm-up
    collects)."""
    from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexAgent
    from distributed_reinforcement_learning_tpu_torch.runtime.anakin import AnakinImpala
    from distributed_reinforcement_learning_tpu_torch.runtime.anakin_apex import AnakinApex
    from distributed_reinforcement_learning_tpu_torch.runtime.anakin_r2d2 import AnakinR2D2
    from distributed_reinforcement_learning_tpu_torch.runtime.launch import _device_env_for

    agent_cfg, rt = load_config(CONFIG, section)
    env, transform = _device_env_for(agent_cfg, rt)
    n = rt.num_actors * rt.envs_per_actor
    dev = torch.cuda.current_device()
    if section == "impala":
        return AnakinImpala(ImpalaAgent(agent_cfg, device=dev), n, mesh=mesh, env=env), 0
    common = dict(batch_size=rt.batch_size, target_sync_interval=rt.target_sync_interval,
                  updates_per_collect=rt.updates_per_call,
                  epsilon_floor=rt.epsilon_floor or 0.0, env=env, obs_transform=transform,
                  mesh=mesh)
    if section == "apex":
        width = n * 16
        cap = min(rt.replay_capacity, 32768)
        loop = AnakinApex(ApexAgent(agent_cfg, device=dev), num_envs=n,
                          capacity=cap - cap % width, steps_per_collect=16, **common)
    else:
        width = n
        cap = min(rt.replay_capacity, 4096)
        loop = AnakinR2D2(R2D2Agent(agent_cfg, device=dev), num_envs=n,
                          capacity=cap - cap % width, **common)
    return loop, -(-rt.train_start_factor * rt.batch_size // width)


def anakin_run(section: str, mesh) -> tuple:
    """`section`'s loop from seed 0: its warm-up collects and one warm
    update (the first in a process pays the card's lazy start-up), then
    ANAKIN_MESH_UPDATES updates with the counts zeroed just before,
    synchronised -> (its readings, its whole parameters)."""
    loop, warm = anakin_loop(section, mesh)
    state = loop.init(0)
    if warm:
        state, _ = loop.collect_chunk(state, warm)
    state, _ = loop.train_chunk(state, 1)
    sharded = getattr(loop, "_sharded", None)
    if sharded is not None:
        sharded.reducer.timed = True
        sharded.reducer.records.clear()
    state, m, wall, launches = timed_chunk(loop, state, ANAKIN_MESH_UPDATES)
    check_finite(f"anakin mesh {section}", m)
    whole = state.train if sharded is None else sharded.gather_state(state.train)
    got = {"launches": launches, "ms_per_update": wall / ANAKIN_MESH_UPDATES * 1e3,
           "digest": params_digest(whole.params),
           "bytes_local": ShardedLearner.state_bytes(state.train),
           "bytes_whole": ShardedLearner.state_bytes(whole),
           "last": {k: float(v[-1]) for k, v in m.items()}}
    if sharded is not None:
        got.update(reduce_ms=[r[0] for r in sharded.reducer.records],
                   reduce_bytes=[r[1] for r in sharded.reducer.records])
    if hasattr(state, "replay"):
        got.update(ring_bytes=state.replay.nbytes(), ring_size=state.replay.size,
                   capacity=loop.capacity)
    params = {k: v.detach().clone() for k, v in whole.params.items()}
    del loop, state, whole
    gc.collect()
    torch.cuda.empty_cache()
    return got, params


def anakin_mesh_case(section: str, model: int, bar: str | None) -> dict:
    """One family's loop over this world's mesh; with `bar` rank 0 also
    runs the plain loop from the same seed and holds the mesh loop's
    gathered parameters to it: "bitwise", or "learn" (the card's
    learn-step bar, rtol 1e-4 plus 1% of lr)."""
    from distributed_reinforcement_learning_tpu_torch.parallel import make_mesh

    mesh = make_mesh(model_parallel=model)
    got, params = anakin_run(section, mesh)
    if bar is None or mesh.rank != 0:
        return got
    plain, want = anakin_run(section, None)
    got.update(plain_ms_per_update=plain["ms_per_update"], plain_launches=plain["launches"],
               plain_ring_bytes=plain.get("ring_bytes"))
    if bar == "bitwise":
        differ = [k for k, p in want.items() if not torch.equal(p, params[k])]
        if differ:
            raise RuntimeError(f"anakin mesh {section}: a world of one differs from the plain "
                               f"loop in {len(differ)} leaves ({differ[:3]})")
        if got["launches"] != plain["launches"]:
            raise RuntimeError(f"anakin mesh {section}: launches {got['launches']}, the plain "
                               f"loop's {plain['launches']}")
        got["max_rel_err"] = 0.0
        return got
    agent_cfg, _ = load_config(CONFIG, section)
    lr = float(agent_cfg.start_learning_rate)
    worst, beyond = 0.0, 0
    for k, p in want.items():
        q = params[k]
        torch.testing.assert_close(q, p, rtol=1e-4, atol=1e-2 * lr,
                                   msg=lambda m, k=k: f"anakin mesh {section} model {model} "
                                   f"{k}: {m}")
        worst = max(worst, float((q - p).abs().max() / p.abs().max().clamp_min(1e-30)))
        beyond += int(((q - p).abs() > 1e-4 * p.abs() + 1e-2 * lr).sum())
    got.update(max_rel_err=worst, beyond_rtol=beyond)
    return got


def anakin_mesh_rank(cases: list) -> None:
    """One rank of phase 47 (a), (b) (a child process): join the world,
    run `cases` ((section, model axis, bar)), print one JSON line."""
    from distributed_reinforcement_learning_tpu_torch.parallel import distributed

    out = join_world()
    for section, model, bar in cases:
        out[f"{section}/{model}"] = anakin_mesh_case(section, model, bar)
    print(json.dumps(out), flush=True)
    distributed.shutdown()


def tier_seat_rank(seat: int, addrs: list, union_reference: bool) -> None:
    """One rank of phase 47 (c): a seat of two ranks at model 2 on the
    `apex` section. Its learner is an ApexLearner over the seat's mesh
    (through `runner_learner`); rank 0 holds the LearnerTier, rank 1
    follows. TIER_SEAT_STEPS allreduce steps on the seat's half of a
    seeded union batch, then one publish; seat 0 first runs the
    union-batch sharded learner at model 2 and holds its parameters to
    it. Prints one JSON line."""
    from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexAgent
    from distributed_reinforcement_learning_tpu_torch.parallel import (
        distributed, make_mesh, runner_learner)
    from distributed_reinforcement_learning_tpu_torch.runtime import learner_tier
    from distributed_reinforcement_learning_tpu_torch.runtime.apex_runner import ApexLearner
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

    out = join_world()
    agent_cfg, rt = load_config(CONFIG, "apex")
    agent = ApexAgent(agent_cfg, device=torch.cuda.current_device())
    mesh = make_mesh(model_parallel=2)
    union, isw = apex_batch(agent_cfg, 2 * rt.batch_size, seed=47)
    b = rt.batch_size
    half = (tree_map(lambda x: x[seat * b:(seat + 1) * b], union), isw[seat * b:(seat + 1) * b])
    ref = None
    if union_reference:
        sl = runner_learner(agent, mesh, 2)
        s = agent.sync_target(sl.init_state(0))
        for _ in range(TIER_SEAT_STEPS):
            s, _, _ = sl.learn(s, *sl.shard_batch((union, isw)))
        ref = sl.gather_params(s.params)
    weights = WeightStore()
    learner = ApexLearner(agent, TrajectoryQueue(8), weights, batch_size=b, replay_capacity=1024,
                          mesh=mesh, init_seed=0)
    tier = None
    if mesh.rank == 0:
        tier = learner_tier.LearnerTier(seat, addrs, sync="allreduce", probe_interval_s=60.0)
        tier.collective.wait_s = 60.0
        tier.start()
        tier.attach(learner)
        out.update(classes=tier._plan.classes, plan_hash=tier._plan.plan_hash,
                   peers=tier.await_peers(60.0))
    else:
        learner_tier.follow_seat(learner)
    try:
        step_ms = []
        for _ in range(TIER_SEAT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            learner.state, _, _ = learner._learn(learner.state, *half)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        learner.train_steps = TIER_SEAT_STEPS
        learner.sync_publish = True
        learner.maybe_publish()
        published, version = weights.get()
        whole = learner._sharded.gather_params(learner.state.params)
        out.update(
            step_ms=step_ms, version=version, digest=params_digest(whole),
            published_whole=all(tuple(published[k].shape) == tuple(v.shape)
                                and torch.equal(published[k].to(v.device), v)
                                for k, v in whole.items()),
            bytes_local=ShardedLearner.state_bytes(learner.state),
            bytes_whole=ShardedLearner.state_bytes(
                learner._sharded.gather_state(learner.state)))
        if ref is not None and mesh.rank == 0:
            lr = float(agent_cfg.start_learning_rate)
            worst, beyond = 0.0, 0
            for k, p in ref.items():
                q = whole[k]
                worst = max(worst, float((q - p).abs().max() / p.abs().max().clamp_min(1e-30)))
                beyond += int(((q - p).abs() > 1e-3 * p.abs() + 1e-6).sum())
            # An Adam element at the gradients' noise floor may move by up
            # to its ratio bound x lr a step either way (phase 46's bar).
            atol = 2 * TIER_SEAT_STEPS * adam_ratio_bound(TIER_SEAT_STEPS) * lr
            for k, p in ref.items():
                torch.testing.assert_close(whole[k], p, rtol=1e-3, atol=atol,
                                           msg=lambda m, k=k: f"tier seat {k}: {m}")
            out.update(max_rel_err=worst, beyond_rtol=beyond, adam_atol=atol)
        if tier is not None:
            out["coll"] = tier.collective.snapshot_stats()
            out["tier"] = tier.snapshot_stats()
    finally:
        if tier is not None:
            tier.close()
        learner.close()
    print(json.dumps(out), flush=True)
    distributed.shutdown()


def phase_anakin_mesh() -> dict:
    """Phase 47: the Anakin mesh and the mesh-sharded seat, each rank a
    child process in its own group with its own timeout. (a) A world of
    one over NCCL: Anakin IMPALA (20 envs), Ape-X and R2D2 at phases
    38-40's widths, ANAKIN_MESH_UPDATES updates each, the parameters bit
    for bit the plain loop's from the same seed and the launches equal.
    (b) Two ranks on cuda:0 over gloo at data 2 (10 IMPALA envs a rank,
    K1 at (18, 10); 160 Ape-X transitions a collect into a ring shard of
    16,320; 6 R2D2 envs into 2,046 sequences, K2a at (10, 6, 512) on
    ingest and (10, 16, 512) on learn): the ranks bit for bit equal,
    `replay_size` the global count, each rank half the ring's bytes, the
    launches an update of the plain loop; IMPALA at data 1 x model 2
    holding about half its state a rank, within the learn-step bar of the
    plain loop. (c) Two tier seats, each two ranks at model 2 (4
    processes): the seats bit for bit equal, within the bar of the
    union-batch learner, the plan's `-,model` class owner-scoped, each
    seat's publish whole."""
    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    got = {}
    t_part = time.perf_counter()
    one = run_ranks(1, list(ANAKIN_MESH_WORLD_ONE), "anakin_world1", "anakin_mesh_rank")[0]
    if one["backend"] != "nccl" or one["device"] != "cuda:0":
        raise RuntimeError(f"anakin mesh: a world of one on {one['device']} over "
                           f"{one['backend']}, expected cuda:0 over nccl")
    for section, _, _ in ANAKIN_MESH_WORLD_ONE:
        case = one[f"{section}/1"]
        K = 1 if section == "impala" else load_config(CONFIG, section)[1].updates_per_call
        want = {k: ANAKIN_MESH_UPDATES * v for k, v in ANAKIN_MESH_LAUNCHES[section](K).items()}
        if {k: v for k, v in case["launches"].items() if v} != want:
            raise RuntimeError(f"anakin mesh {section}: launches {case['launches']}, "
                               f"expected {want}")
    got["world1"] = one
    log(f"[anakin mesh] (a) world of one, backend {one['backend']} on {one['device']}: "
        + "; ".join(f"{s} ms an update {one[f'{s}/1']['ms_per_update']:.1f} (plain "
                    f"{one[f'{s}/1']['plain_ms_per_update']:.1f}), launches "
                    f"{json.dumps({k: v for k, v in one[f'{s}/1']['launches'].items() if v})}"
                    for s, _, _ in ANAKIN_MESH_WORLD_ONE)
        + f"; parameters bit for bit the plain loop's, launches equal; "
        f"{time.perf_counter() - t_part:.1f} s ({smi})")

    t_part = time.perf_counter()
    two = run_ranks(2, list(ANAKIN_MESH_WORLD_TWO), "anakin_world2", "anakin_mesh_rank")
    for rank in two:
        if rank["backend"] != "gloo" or rank["device"] != "cuda:0":
            raise RuntimeError(f"anakin mesh rank {rank['rank']} on {rank['device']} over "
                               f"{rank['backend']}, expected cuda:0 over gloo")
    for section, model, _ in ANAKIN_MESH_WORLD_TWO:
        key = f"{section}/{model}"
        if two[0][key]["digest"] != two[1][key]["digest"]:
            raise RuntimeError(f"anakin mesh {key}: the two ranks' parameters differ")
        K = 1 if section == "impala" else load_config(CONFIG, section)[1].updates_per_call
        want = {k: ANAKIN_MESH_UPDATES * v for k, v in ANAKIN_MESH_LAUNCHES[section](K).items()}
        for rank in two:
            c = rank[key]
            if {k: v for k, v in c["launches"].items() if v} != want:
                raise RuntimeError(f"anakin mesh {key} rank {rank['rank']}: launches "
                                   f"{c['launches']}, expected {want}")
            if "ring_bytes" in c:
                whole = one[f"{section}/1"]["ring_bytes"]
                if 2 * c["ring_bytes"] != whole or c["last"]["replay_size"] != 2 * c["ring_size"]:
                    raise RuntimeError(f"anakin mesh {key} rank {rank['rank']}: ring "
                                       f"{c['ring_bytes']} bytes of {whole}, replay_size "
                                       f"{c['last']['replay_size']}, local size {c['ring_size']}")
    tp = two[0]["impala/2"]
    if not 0.4 * tp["bytes_whole"] < tp["bytes_local"] < 0.6 * tp["bytes_whole"]:
        raise RuntimeError(f"anakin mesh impala at model 2: {tp['bytes_local']} bytes a rank "
                           f"of {tp['bytes_whole']}")
    got["world2"] = two
    single = {s: one[f"{s}/1"]["plain_ms_per_update"] for s, _, _ in ANAKIN_MESH_WORLD_ONE}
    log("[anakin mesh] (b) two ranks on one card, backends "
        + ", ".join(f"rank {r['rank']} {r['backend']} on {r['device']}" for r in two)
        + "; ranks bit for bit equal; "
        + "; ".join(
            f"{s} at data {2 // m}, model {m}: ms an update {c['ms_per_update']:.1f} (single "
            f"device {single[s]:.1f}), reduction ms p50 "
            f"{np.median(c['reduce_ms']) if c['reduce_ms'] else 0.0:.3f} for "
            f"{(c['reduce_bytes'] or [0])[0]} bytes ({len(c['reduce_ms'])} in "
            f"{ANAKIN_MESH_UPDATES} updates), launches a rank "
            f"{json.dumps({k: v for k, v in c['launches'].items() if v})}"
            + (f", ring {c['ring_bytes']} bytes a rank, replay_size {c['last']['replay_size']:.0f}"
               if "ring_bytes" in c else "")
            + (f", bytes a rank {c['bytes_local']} of {c['bytes_whole']}, largest |difference| "
               f"{c['max_rel_err']:.2e} of a leaf's largest parameter against the plain loop "
               f"({c['beyond_rtol']} elements past rtol 1e-4 + 1% lr)" if m == 2 else "")
            for (s, m, _), c in ((smb, two[0][f"{smb[0]}/{smb[1]}"])
                                 for smb in ANAKIN_MESH_WORLD_TWO))
        + f"; {time.perf_counter() - t_part:.1f} s ({smi})")

    t_part = time.perf_counter()
    addrs = [f"127.0.0.1:{free_port()}" for _ in range(2)]
    procs = [start_ranks(2, f"tier_seat_rank({seat}, {addrs!r}, {seat == 0})",
                         f"tier_seat{seat}", TIER_SEAT_ENV) for seat in range(2)]
    seats = [join_ranks(p, f"tier_seat{k}") for k, p in enumerate(procs)]
    leads = [seat[0] for seat in seats]
    digests = {r["digest"] for seat in seats for r in seat}
    if len(digests) != 1:
        raise RuntimeError("anakin mesh (c): the seats' parameters differ")
    for k, lead in enumerate(leads):
        coll = lead["coll"]
        if (lead["plan_hash"] != leads[0]["plan_hash"] or "-,model" not in lead["classes"]
                or not lead["peers"] or coll["coll_rounds_part"] != TIER_SEAT_STEPS
                or coll["coll_bytes_model"] <= 0):
            raise RuntimeError(f"anakin mesh (c) seat {k}: plan {lead['classes']}, peers "
                               f"{lead['peers']}, collective {coll}")
    for seat in seats:
        for r in seat:
            if not r["published_whole"] or r["version"] != TIER_SEAT_STEPS:
                raise RuntimeError(f"anakin mesh (c): rank {r['rank']} published "
                                   f"version {r['version']}, whole {r['published_whole']}")
            if not 0.4 * r["bytes_whole"] < r["bytes_local"] < 0.6 * r["bytes_whole"]:
                raise RuntimeError(f"anakin mesh (c): {r['bytes_local']} bytes a rank of "
                                   f"{r['bytes_whole']}")
    got["tier"] = seats
    lead = leads[0]
    log(f"[anakin mesh] (c) two apex tier seats, each two ranks at model 2 on cuda:0 (4 "
        f"processes): {TIER_SEAT_STEPS} allreduce steps bit for bit equal across the seats "
        f"and their ranks; against the union-batch sharded learner largest |difference| "
        f"{lead['max_rel_err']:.2e} of a leaf's largest parameter, {lead['beyond_rtol']} "
        f"elements past rtol 1e-3 / atol 1e-6 (all within Adam's {lead['adam_atol']:.2e}); "
        f"plan {lead['classes']}, rounds_part {lead['coll']['coll_rounds_part']}, bytes by "
        f"class a round " + json.dumps({key[len("coll_bytes_"):]: v / TIER_SEAT_STEPS
                                         for key, v in lead["coll"].items()
                                         if key.startswith("coll_bytes_") and v})
        + "; step ms " + ", ".join(f"seat {k} {np.median(s[0]['step_ms']):.1f}"
                                   for k, s in enumerate(seats))
        + f"; each seat published version {TIER_SEAT_STEPS} whole, bytes a rank "
        f"{lead['bytes_local']} of {lead['bytes_whole']}; {time.perf_counter() - t_part:.1f} s "
        f"({smi})")
    got["seconds"] = time.perf_counter() - t0
    log(f"[anakin mesh] phase 47 {got['seconds']:.1f} s")
    return got


# -- the model-parallel transformer body (phase 48) ----------------------------------

MP_STEPS = 3  # learn steps of each case
MP_T = 32  # seq_len of (a)-(d): dense attention takes the flash route at head dim 32
MP_B = 32  # the xformer sections' batch
# (b)-(d): (tag, section, config changes, mesh axes).
MP_CASES = (("ring_zigzag_seq2", "xformer", {"attention": "ring_zigzag"}, {"seq_parallel": 2}),
            ("moe_expert2", "xformer_moe", {}, {"expert_parallel": 2}),
            ("pipeline_pipe2", "xformer", {"pipeline": True, "pipeline_microbatches": 2},
             {"pipe_parallel": 2}))
MP_LAUNCHER_UPDATES = 3
MP_TIMEOUT_S = 180


def mp_attention(mesh) -> dict:
    """(a): each kind on this rank against dense attention on its device
    (B 32, T 32, 2 heads of 32, ~10% episode ends), the values and the q,
    k, v gradients of sum(out * w); the ms of a forward and backward
    (median of 5 after a warm one) and the bytes each collective moved."""
    from distributed_reinforcement_learning_tpu_torch.parallel import sequence as sp

    g = torch.Generator(device="cuda").manual_seed(480)
    shape = (MP_B, MP_T, 2, 32)
    q, k, v, w = (torch.randn(shape, generator=g, device="cuda") for _ in range(4))
    done = torch.rand((MP_B, MP_T), generator=g, device="cuda") < 0.1
    segs = torch.cat([torch.zeros_like(done[:, :1], dtype=torch.int32),
                      torch.cumsum(done.to(torch.int32), 1)[:, :-1]], 1).to(torch.int32)

    def fwd_bwd(fn):
        qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*qkv)
        return out.detach(), torch.autograd.grad((out * w).sum(), qkv)

    want, want_g = fwd_bwd(lambda a, b, c: dense_attention(a, b, c, causal=True, q_seg=segs,
                                                           k_seg=segs))
    fns = {"ring": lambda *a: sp.ring_attention(mesh, *a, segment_ids=segs),
           "zigzag": lambda *a: sp.ring_attention(mesh, *a, segment_ids=segs,
                                                  schedule="zigzag"),
           "ulysses": lambda *a: sp.ulysses_attention(mesh, *a, segment_ids=segs)}
    got = {}
    for kind, fn in fns.items():
        b0 = dict(mesh.bytes_by)
        out, grads = fwd_bwd(fn)
        moved = {key: n - b0.get(key, 0) for key, n in mesh.bytes_by.items() if n > b0.get(key, 0)}
        val_err = float((out - want).abs().max())
        grad_err = max(float((a - b).abs().max()) for a, b in zip(grads, want_g))
        if val_err > 1e-5 or grad_err > 1e-4:
            raise RuntimeError(f"(a) {kind}: value error {val_err:.2e}, gradient error "
                               f"{grad_err:.2e} against dense attention")
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fwd_bwd(fn)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        got[kind] = {"val_err": val_err, "grad_err": grad_err, "bytes": moved,
                     "ms": float(np.median(ms))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        fwd_bwd(lambda a, b, c: dense_attention(a, b, c, causal=True, q_seg=segs, k_seg=segs))
    torch.cuda.synchronize()
    got["dense_ms"] = (time.perf_counter() - t0) * 1e3 / 5
    return got


def mp_step(learn, state, data) -> tuple:
    """One synchronised step of `learn` with the launch counts zeroed just
    before -> (state, ms, (loss, grad norm, priorities), launches)."""
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    state, prio, m = learn(state, *data)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = all_launches()
    return state, ms, (float(m["loss"]), float(m["grad_norm"]), prio.detach().cpu().numpy()), \
        launches


def mp_copy(state):
    """A train state's tensors, detached copies (a gathered state shares its
    replicated leaves with the live one, which a step updates in place)."""
    return dataclasses.replace(state, **{f: {k: v.detach().clone() for k, v in
                                             getattr(state, f).items()}
                                         for f in ("params", "target_params", "mu", "nu")})


def mp_load(state, whole):
    """`whole`'s numbers written into `state`, the single-device agent's."""
    with torch.no_grad():
        for f in ("params", "target_params", "mu", "nu"):
            for k, t in getattr(state, f).items():
                t.copy_(getattr(whole, f)[k])
    return dataclasses.replace(state, step=whole.step)


def mp_bar(section: str, t: int, before, got, want, got_out: tuple, want_out: tuple,
           lr: float) -> tuple:
    """Learn step `t` of the sharded learner against the single-device
    agent's step from the same whole state (`before`) on the union batch:
    the loss, gradient norm and priorities within ROADMAP F14's bar (rtol
    2e-4, atol 2e-5), and each leaf at phase 46's bar (`adam_step_close`:
    its gradient, read off Adam's first moment, at rtol 1e-4; the
    parameters it settles at rtol 1e-4, atol 1% of lr; only the elements
    whose gradient is float32 noise within Adam's bound of one step) ->
    (the noise-floor elements, the largest gradient difference of a
    leaf's largest)."""
    (g_loss, g_norm, g_prio), (w_loss, w_norm, w_prio) = got_out, want_out
    np.testing.assert_allclose([g_loss, g_norm], [w_loss, w_norm], rtol=2e-4, atol=2e-5,
                               err_msg=f"{section}: step {t}'s loss and gradient norm")
    np.testing.assert_allclose(g_prio, w_prio, rtol=2e-4, atol=2e-5,
                               err_msg=f"{section}: step {t}'s priorities")
    grad = lambda s, k: (s.mu[k] - 0.9 * before.mu[k]) / 0.1
    unsettled, grad_err = 0, 0.0
    for k in want.params:
        g_got, g_want = grad(got, k), grad(want, k).detach()
        unsettled += adam_step_close(f"{section} step {t} {k}", got.params[k],
                                     want.params[k].detach(), g_got, g_want, lr, t)
        grad_err = max(grad_err, float((g_got - g_want).abs().max()
                                       / g_want.abs().max().clamp_min(1e-30)))
    return unsettled, grad_err


def mp_case(tag: str, section: str, change: dict, mesh_kw: dict) -> dict:
    """(b)-(d) in this rank: MP_STEPS learn steps of the section at seq_len
    MP_T over the mesh, the ranks' digest, and in rank 0 each step held to
    the single-device agent's step from the same whole state on the union
    batch (`mp_bar`). The whole state is gathered around every step (its
    bytes are not a step's); the launch counts are zeroed just before
    each step and read just after."""
    from distributed_reinforcement_learning_tpu_torch.parallel import make_mesh

    agent_cfg, _ = load_config(CONFIG, section)
    agent_cfg = dataclasses.replace(agent_cfg, seq_len=MP_T, **change)
    mesh = make_mesh(**mesh_kw)
    agent = XformerAgent(agent_cfg, device=torch.cuda.current_device(), mesh=mesh)
    sl = ShardedLearner(agent, mesh, 2, 2)
    sl.reducer.timed = True
    union = [xformer_batch(agent_cfg, MP_B, seed=48 + i) for i in range(MP_STEPS)]
    state = sl.init_state(seed=1)
    lead = mesh.rank == 0
    if lead:
        plain_cfg = dataclasses.replace(agent_cfg, attention="dense", pipeline=False,
                                        stacked=agent_cfg.pipeline or agent_cfg.stacked)
        plain = XformerAgent(plain_cfg, device=torch.cuda.current_device())
        pstate = plain.init_state(seed=1)
    got = {"ms": [], "plain_ms": [], "launches": {}, "plain_launches": {}, "bytes_by": {},
           "unsettled": [], "grad_rel_err": [], "losses": []}
    add = lambda into, counts: into.update({k: into.get(k, 0) + v for k, v in counts.items()})
    for t, batch in enumerate(union, 1):
        before = mp_copy(sl.gather_state(state))
        # Rank 0 checked the last step meanwhile: start the timed step together.
        torch.distributed.barrier()
        b0 = dict(mesh.bytes_by)
        state, ms, out, launches = mp_step(sl.learn, state, sl.shard_batch(batch))
        add(got["bytes_by"], {key: n - b0.get(key, 0) for key, n in mesh.bytes_by.items()})
        got["ms"].append(ms)
        add(got["launches"], launches)
        after = mp_copy(sl.gather_state(state))
        if not lead:
            continue
        pstate, pms, pout, plaunches = mp_step(plain.learn, mp_load(pstate, before), batch)
        got["plain_ms"].append(pms)
        add(got["plain_launches"], plaunches)
        unsettled, grad_err = mp_bar(section, t, before, after, pstate, out, pout,
                                     agent_cfg.learning_rate)
        got["unsettled"].append(unsettled)
        got["grad_rel_err"].append(grad_err)
        got["losses"].append([out[0], pout[0]])
    got["bytes_by"] = {key: n // MP_STEPS for key, n in got["bytes_by"].items() if n > 0}
    got["reduce_ms"] = [r[0] for r in sl.reducer.records + sl.reducer.seq_records]
    got["bytes_local"] = sl.state_bytes(state)
    whole = sl.gather_state(state)
    got["bytes_whole"] = sl.state_bytes(whole)
    got["digest"] = params_digest(whole.params)
    return got


def mp_world_one() -> dict:
    """A world of one over NCCL: `xformer_moe` at seq_len MP_T over a mesh
    of one, bit for bit the plain agent (deterministic algorithms on)."""
    from distributed_reinforcement_learning_tpu_torch.parallel import make_mesh

    agent_cfg, _ = load_config(CONFIG, "xformer_moe")
    agent_cfg = dataclasses.replace(agent_cfg, seq_len=MP_T)
    mesh = make_mesh()
    sl = ShardedLearner(XformerAgent(agent_cfg, device=torch.cuda.current_device(), mesh=mesh),
                        mesh, 2, 2)
    union = [xformer_batch(agent_cfg, MP_B, seed=48 + i) for i in range(MP_STEPS)]
    zero_launch_counts()
    state, ms = timed_steps(sl.learn, sl.init_state(seed=1), [sl.shard_batch(b) for b in union])
    launches = all_launches()
    plain = XformerAgent(agent_cfg, device=torch.cuda.current_device())
    zero_launch_counts()
    pstate, plain_ms = timed_steps(plain.learn, plain.init_state(seed=1), union)
    differ = [k for k, p in pstate.params.items() if not torch.equal(p, state.params[k])]
    if differ:
        raise RuntimeError(f"xformer_moe: a world of one differs from the plain agent in "
                           f"{len(differ)} leaves ({differ[:3]})")
    return {"launches": launches, "plain_launches": all_launches(), "ms": ms,
            "plain_ms": plain_ms}


def mp_rank(world_one: bool = False) -> None:
    """One rank of phase 48 (a child process): join the world from the
    DRL_* env names, run (a)-(d) (or the world of one's case), print one
    JSON line."""
    from distributed_reinforcement_learning_tpu_torch.parallel import distributed, make_mesh

    out = join_world()
    if world_one:
        out["moe_world1"] = mp_world_one()
    else:
        out["attention"] = mp_attention(make_mesh(seq_parallel=2))
        print(json.dumps({"attention": out["attention"]}), flush=True)
        for tag, section, change, mesh_kw in MP_CASES:
            out[tag] = mp_case(tag, section, change, mesh_kw)
            print(json.dumps({tag: out[tag]}), flush=True)
    print(json.dumps(out), flush=True)
    distributed.shutdown()


def mp_launcher_config() -> Path:
    """config.json with the `xformer` section at seq_parallel 2 under the
    zigzag ring and seq_len MP_T, beside the smoke's logs."""
    cfg = json.loads(CONFIG.read_text())
    cfg["xformer"].update(attention="ring_zigzag", seq_parallel=2, seq_len=MP_T)
    path = ROOT / "chiprun_out" / "smoke_model_parallel_config.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(cfg))
    return path


def phase_model_parallel() -> dict:
    """Phase 48: the model-parallel transformer body. The world of two
    (gloo on cuda:0), the world of one (NCCL) and the launcher's learner
    group at seq 2 run at once, each rank a child process in its own
    group with its own timeout (their host work shares the cores, so the
    ms a step are read beside the others)."""
    from distributed_reinforcement_learning_tpu_torch.launch_local_cluster import _free_port_run

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    two = start_ranks(2, "mp_rank()", "mp_world2")
    one = start_ranks(1, "mp_rank(world_one=True)", "mp_world1")
    worlds = {}

    def join_worlds(proc, log_path) -> None:
        worlds["two"] = join_ranks(two, "mp_world2", MP_TIMEOUT_S)
        (worlds["one"],) = join_ranks(one, "mp_world1", MP_TIMEOUT_S)

    base = _free_port_run(2)
    out = run_launcher("xformer", MP_LAUNCHER_UPDATES, 2, "model_parallel",
                       {"DRL_LEARNER_ADDR": f"127.0.0.1:{base}"}, extra=["--learners", "2"],
                       config=mp_launcher_config(), during=join_worlds)
    launcher_s = time.perf_counter() - t0
    two, one = worlds["two"], worlds["one"]
    for rank in two:
        if rank["backend"] != "gloo" or rank["device"] != "cuda:0":
            raise RuntimeError(f"rank {rank['rank']} on {rank['device']} over "
                               f"{rank['backend']}, expected cuda:0 over gloo")
    if one["backend"] != "nccl" or one["device"] != "cuda:0":
        raise RuntimeError(f"a world of one on {one['device']} over {one['backend']}")
    for tag, _, _, _ in MP_CASES:
        if two[0][tag]["digest"] != two[1][tag]["digest"]:
            raise RuntimeError(f"{tag}: the two ranks' parameters differ")
        if two[0][tag]["launches"] != two[1][tag]["launches"]:
            raise RuntimeError(f"{tag}: the ranks' launches differ")
    att = two[0]["attention"]
    log("[model-parallel] (a) seq 2, B 32, T 32, 2 heads of 32, both ranks gloo on cuda:0: "
        + ", ".join(f"{kind} value err {att[kind]['val_err']:.2e}, grad err "
                    f"{att[kind]['grad_err']:.2e}, forward+backward {att[kind]['ms']:.2f} ms, "
                    f"bytes {att[kind]['bytes']}" for kind in ("ring", "zigzag", "ulysses"))
        + f"; dense on one device {att['dense_ms']:.2f} ms ({smi})")
    for tag, _, _, mesh_kw in MP_CASES:
        c = two[0][tag]
        log(f"[model-parallel] {tag} ({mesh_kw}): ranks bit for bit equal; learn-step ms p50 "
            f"{np.median(c['ms']):.2f} (rank 1 {np.median(two[1][tag]['ms']):.2f}; one device "
            f"{np.median(c['plain_ms']):.2f}); each step against one device's from the same "
            f"whole state: losses (sharded, one device) {c['losses']}, loss, grad norm and "
            f"priorities within rtol 2e-4 / atol 2e-5, every leaf at phase 46's Adam bar "
            f"(largest gradient difference a step "
            f"{['%.2e' % e for e in c['grad_rel_err']]} of the leaf's largest, noise-floor "
            f"elements {c['unsettled']}), "
            f"bytes a step by collective {c['bytes_by']}, data/seq reductions ms "
            f"{[round(x, 3) for x in c['reduce_ms']]}, bytes a rank {c['bytes_local']} of "
            f"{c['bytes_whole']}, launches a rank "
            f"{json.dumps({k: v for k, v in c['launches'].items() if v})} (one device "
            f"{json.dumps({k: v for k, v in c['plain_launches'].items() if v})}) ({smi})")
    w1 = one["moe_world1"]
    log(f"[model-parallel] world of one over nccl: xformer_moe bit for bit the plain agent, "
        f"ms p50 {np.median(w1['ms']):.2f} / {np.median(w1['plain_ms']):.2f}, launches "
        f"{json.dumps({k: v for k, v in w1['launches'].items() if v})} ({smi})")

    learners = [role_json(out, f"learner{k}") for k in range(2)]
    if not all(learners):
        raise RuntimeError(f"launcher group: a learner printed no summary:\n{out[-4000:]}")
    for k, (summary,) in enumerate(learners):
        mh = summary["multihost"]
        if (summary["device"] != "cuda:0" or mh["backend"] != "gloo" or mh["rank"] != k
                or mh["mesh"]["seq"] != 2 or summary["train_steps"] != MP_LAUNCHER_UPDATES):
            raise RuntimeError(f"launcher group learner{k}: {summary['device']}, {mh}, "
                               f"{summary['train_steps']} steps")
    log(f"[model-parallel] launch_local_cluster --learners 2, xformer at seq_parallel 2 "
        f"(ring_zigzag, seq_len {MP_T}): both learners on cuda:0 over gloo, mesh "
        f"{learners[0][0]['multihost']['mesh']}, {MP_LAUNCHER_UPDATES} updates each, every "
        f"role exited 0, no segment left ({launcher_s:.1f} s, beside the worlds; {smi})")
    got = {"world2": two, "world1": one, "launcher_s": launcher_s,
           "seconds": time.perf_counter() - t0}
    log(f"[model-parallel] phase 48 {got['seconds']:.1f} s")
    return got


# Phase 49: each of the seven scripts' modules, its argv, and the kernels
# its run must launch (PERF.md's kernel table); diag_imitation runs none.
SCRIPT_ARGV = {
    "profile_learn_decomp": ["128"],
    "profile_nature_learn": [],
    "diag_imitation": [],
    "return_curves": ["--families", "impala_cartpole,r2d2_cartpole_pomdp,ximpala_cartpole",
                      "--updates-scale", "0.005"],
    "stability_probe": ["--updates", "20"],
    "r2d2_cycle_probe": ["--updates", "20", "--seeds", "0", "--baseline"],
}
SCRIPT_KERNELS = {
    "profile_learn_decomp": {"vtrace"},
    "profile_nature_learn": {"vtrace"},
    "diag_imitation": set(),
    "return_curves": {"vtrace", "lstm_fwd", "lstm_bwd", "attention_fwd", "attention_dq",
                      "attention_dkv"},
    "stability_probe": {"lstm_fwd", "lstm_bwd"},
    "r2d2_cycle_probe": {"lstm_fwd", "lstm_bwd"},
    "actor_scale_demo": {"vtrace"},
}
DEMO_ARGV = ["--actors", "4", "--minutes", "0.5", "--stats-interval", "5"]
DEMO_TIMEOUT_S = 180
SCRIPT_TIMEOUT_S = 300


def json_lines(text: str) -> list[dict]:
    out = []
    for line in text.splitlines():
        if line.startswith("{"):
            with contextlib.suppress(json.JSONDecodeError):
                out.append(json.loads(line))
    return out


def benchmarks_files() -> dict[str, float]:
    return {str(p): p.stat().st_mtime for p in (ROOT / "benchmarks").rglob("*") if p.is_file()}


def run_script_module(name: str, tmp: Path) -> dict:
    """`<name>.main(argv)` in this process, from `tmp`, on the card, its
    stdout kept apart (its JSON would mix with this script's lines): ->
    its seconds, its launches (counts zeroed just before), the JSON it
    printed. Fails on a non-zero exit or on launches other than the
    kernels `SCRIPT_KERNELS` names, or none of one it names."""
    import importlib
    import io
    import os

    mod = importlib.import_module(f"distributed_reinforcement_learning_tpu_torch.{name}")
    env = {k: os.environ.get(k) for k in ("DRL_R2D2_RECENT_FRACTION", "DRL_R2D2_RECENT_WINDOW")}
    cwd = os.getcwd()
    buf = io.StringIO()
    zero_launch_counts()
    t0 = time.perf_counter()
    try:
        os.chdir(tmp)
        with contextlib.redirect_stdout(buf):
            mod.main(SCRIPT_ARGV[name])
    except SystemExit as e:
        if e.code not in (None, 0):
            raise RuntimeError(f"{name}: exit {e.code}:\n{buf.getvalue()[-3000:]}") from None
    finally:
        os.chdir(cwd)
        for k, v in env.items():  # r2d2_cycle_probe sets them for its variants
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = all_launches()
    ran = {k for k, n in launches.items() if n}
    if ran != SCRIPT_KERNELS[name]:
        raise RuntimeError(f"{name}: launched {launches}, expected {sorted(SCRIPT_KERNELS[name])}")
    printed = json_lines(buf.getvalue())
    return {"seconds": seconds, "launches": launches, "json": printed, "stdout": buf.getvalue()}


def run_script_process(name: str, tmp: Path) -> dict:
    """`python -m <name> <argv>` from `tmp` in a child process (its own
    group) on the card, as an operator runs it: -> its seconds, the
    launches its JSON reports (`ops/kernels.launch_counts`), its JSON,
    its stdout. The profilers run so: torch.profiler, used by many phases
    before, lost device events when this process profiled them again (a
    whole smoke's phase 49 read 0.0 ms of kernels for variants that run
    2.6 ms alone). Fails as `run_script_module` does."""
    import os
    import signal

    log_path = ROOT / "chiprun_out" / f"smoke_{name}.log"
    log_path.parent.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", f"distributed_reinforcement_learning_tpu_torch.{name}",
         *SCRIPT_ARGV[name]], cwd=tmp, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=SCRIPT_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        log_path.write_text(out)
        raise RuntimeError(f"{name}: no exit in {SCRIPT_TIMEOUT_S} s (log {log_path})") from None
    log_path.write_text(out)
    printed = json_lines(out)
    if proc.returncode != 0 or not printed:
        raise RuntimeError(f"{name}: exit {proc.returncode} (log {log_path})")
    launches = printed[-1]["launches"]
    if {k for k, n in launches.items() if n} != SCRIPT_KERNELS[name]:
        raise RuntimeError(f"{name}: launched {launches}, expected {sorted(SCRIPT_KERNELS[name])}")
    return {"seconds": time.perf_counter() - t0, "launches": launches, "json": printed,
            "stdout": out}


def check_script_outputs(got: dict, tmp: Path) -> None:
    """Each module's JSON fields and files (phase 49)."""
    ld = got["profile_learn_decomp"]["json"][-1]
    if (ld["B"] != 128 or sorted(v[0] for v in ld["variants"]) != list("ABCDEFGHI")
            or not all(v["wall_ms"] > 0 and v["device_ms"] and v["device_ms"] > 0
                       for v in ld["variants"].values())):
        raise RuntimeError(f"profile_learn_decomp: {ld}")
    nat = got["profile_nature_learn"]["json"][-1]
    saved = json.loads((tmp / "runs" / "nature_cnn_profile" / "RESULTS.json").read_text())
    keys = {"B", "K", "dtype", "bwd_ms_derived", "sum_grad_opt_ms", "sum_over_learn",
            "fwd_minus_conv_ms", "loss_minus_fwd_ms",
            *(f"{part}_{what}" for part in ("conv", "fwd", "post", "loss", "grad", "opt", "learn")
              for what in ("ms", "device_ms", "busy"))}
    if saved != nat or not keys <= set(nat) or nat["B"] != 32 or nat["K"] != 16:
        raise RuntimeError(f"profile_nature_learn: {nat}")
    di = got["diag_imitation"]["json"][-1]
    if (set(di) != {"final_acc", "marginal_acc", "steps", "pairs", "seconds"}
            or di["pairs"] != 255 * 64 or di["steps"] != 300
            or not 0 <= di["marginal_acc"] <= 1 or not 0 <= di["final_acc"] <= 1):
        raise RuntimeError(f"diag_imitation: {di}")
    rc = got["return_curves"]["json"][-1]
    want = {f"{f}_smoke" for f in SCRIPT_ARGV["return_curves"][1].split(",")}
    if set(rc) != want or any("error" in v or v["episodes"] <= 0 for v in rc.values()):
        raise RuntimeError(f"return_curves: {rc}")
    for name in want:
        lines = (tmp / "runs" / "curves" / f"{name}.jsonl").read_text().splitlines()
        if json.loads(lines[0])["meta"] != rc[name] or len(lines) != rc[name]["episodes"] + 1:
            raise RuntimeError(f"return_curves: {name}.jsonl does not match its summary")
    sp = got["stability_probe"]["json"][-1]
    if (sp["section"] != "r2d2" or sp["updates"] != 20 or sp["episodes"] <= 0
            or len(sp["roll_curve"]) != 40):
        raise RuntimeError(f"stability_probe: {sp}")
    summary = json.loads((tmp / "runs" / "r2d2_recent" / "summary.json").read_text())
    if (sorted(summary["runs"]) != ["baseline_seed0", "recent_seed0"]
            or any(r["episodes"] <= 0 for r in summary["runs"].values())):
        raise RuntimeError(f"r2d2_cycle_probe: {summary}")


def run_actor_scale_demo(tmp: Path):
    """Start `actor_scale_demo` as an operator runs it, a child process (in
    its own group) spawning the CUDA learner and 4 CPU actors; -> `finish`,
    which waits for it (or, with `kill`, kills its group) and returns its
    summary, the learner's summary (launches in its process) and seconds.
    `finish` fails unless the demo exits 0, every actor's stats line was
    read, the learner learned and launched K1 and nothing else."""
    import os
    import signal

    t0 = time.perf_counter()
    log_path = ROOT / "chiprun_out" / "smoke_actor_scale_demo.log"
    log_path.parent.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    f = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_reinforcement_learning_tpu_torch.actor_scale_demo",
         *DEMO_ARGV], cwd=tmp, env=env, stdout=f, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)

    def finish(kill: bool = False) -> dict:
        if kill:
            os.killpg(proc.pid, signal.SIGKILL)
        try:
            rc = proc.wait(timeout=DEMO_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise RuntimeError(f"actor_scale_demo: no exit in {DEMO_TIMEOUT_S} s (log {log_path})")
        finally:
            f.close()
        out_dir = tmp / "runs" / "actor_scale"
        if rc != 0 or not (out_dir / "summary.json").exists():
            raise RuntimeError(f"actor_scale_demo: rc {rc} (log {log_path})")
        summary = json.loads((out_dir / "summary.json").read_text())
        learner = json_lines((out_dir / "learner_tail.log").read_text())
        series = (out_dir / "depth_series.jsonl").read_text().splitlines()
        actors = int(DEMO_ARGV[1])
        if (sorted(summary["per_actor_unrolls"]) != [str(k) for k in range(actors)]
                or summary["learner_updates"] <= 0 or not series or not learner):
            raise RuntimeError(f"actor_scale_demo: {summary} (log {log_path})")
        launches = learner[-1]["launches"]
        if {k for k, n in launches.items() if n} != SCRIPT_KERNELS["actor_scale_demo"]:
            raise RuntimeError(f"actor_scale_demo: the learner launched {launches}")
        return {"summary": summary, "learner": learner[-1], "launches": launches,
                "seconds": time.perf_counter() - t0}

    return finish


def phase_scripts() -> dict:
    """Phase 49: the seven modules of the JAX package's scripts on the card,
    each from a temporary directory removed after: the two profilers
    first, alone on the card, each a child process; then
    `actor_scale_demo` as a child process while the other four run in
    this process."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    before = benchmarks_files()
    tmp = Path(tempfile.mkdtemp(prefix="smoke_scripts_"))
    got: dict = {}
    try:
        for name in ("profile_learn_decomp", "profile_nature_learn"):
            got[name] = run_script_process(name, tmp)
        finish_demo = run_actor_scale_demo(tmp)
        try:
            for name in ("diag_imitation", "return_curves", "stability_probe",
                         "r2d2_cycle_probe"):
                got[name] = run_script_module(name, tmp)
        except BaseException:
            with contextlib.suppress(Exception):
                finish_demo(kill=True)
            raise
        got["actor_scale_demo"] = finish_demo()
        check_script_outputs(got, tmp)
        if benchmarks_files() != before or (tmp / "benchmarks").exists():
            raise RuntimeError("a script wrote under benchmarks/")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name in ("profile_learn_decomp", "profile_nature_learn"):
        for line in got[name]["stdout"].splitlines():
            if not line.startswith("{"):
                log(f"[scripts] {name}: {line}")
    ld = got["profile_learn_decomp"]["json"][-1]
    log(f"[scripts] profile_learn_decomp B 128 bfloat16: " + "; ".join(
        f"{label} wall {v['wall_ms']:.3f} ms, device {v['device_ms']:.3f} ms, "
        f"{100 * v['busy']:.1f}% busy" for label, v in ld["variants"].items()) + f" ({smi})")
    log(f"[scripts] profile_nature_learn B 32: {json.dumps(got['profile_nature_learn']['json'][-1])}"
        f" ({smi})")
    for name in ("diag_imitation", "return_curves", "stability_probe", "r2d2_cycle_probe"):
        g = got[name]
        log(f"[scripts] {name}: "
            + (json.dumps(g["json"][-1]) if g["json"] else g["stdout"].strip())[:1500])
    demo = got["actor_scale_demo"]
    log(f"[scripts] actor_scale_demo {' '.join(DEMO_ARGV)}: {json.dumps(demo['summary'])}; the "
        f"learner on {demo['learner']['device']}, {demo['learner']['train_steps']} steps, "
        f"launches {json.dumps({k: v for k, v in demo['launches'].items() if v})}")
    log("[scripts] seconds and launches: " + "; ".join(
        f"{name} {g['seconds']:.1f} s, "
        f"{json.dumps({k: v for k, v in g['launches'].items() if v})}" for name, g in got.items()))
    got["seconds"] = time.perf_counter() - t0
    log(f"[scripts] phase 49 {got['seconds']:.1f} s; no file under benchmarks/ ({smi})")
    return got


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
    phase_memory("served acts")
    t_served = time.perf_counter()
    served = phase_served_acts()
    served_impala = phase_launcher_served_impala(launcher["defaults"], served)
    replicas = phase_launcher_replicas()
    served_s = time.perf_counter() - t_served
    t_anakin = time.perf_counter()
    phase_memory("anakin envs")
    anakin_envs = phase_anakin_envs()
    anakin_impala = phase_anakin_impala(phase_memory("anakin impala"))
    anakin_apex = phase_anakin_apex(phase_memory("anakin apex"))
    anakin_r2d2 = {section: phase_anakin_r2d2(phase_memory(f"anakin {section}"), section)
                   for section in ("r2d2", "r2d2_pixel")}
    anakin_s = time.perf_counter() - t_anakin
    t_planes = time.perf_counter()
    phase_memory("sharded publication")
    wshard = phase_sharded_publication()
    phase_memory("device sample path")
    devpath = phase_device_path()
    planes_s = time.perf_counter() - t_planes
    phase_memory("learner tier")
    tier = phase_learner_tier()
    t_drivers = time.perf_counter()
    drivers = phase_drivers(phase_memory("run drivers"))
    phase_memory("synthetic batches")
    synth = phase_synthetic()
    drivers_s = time.perf_counter() - t_drivers
    phase_memory("sharded learner")
    sharded = phase_sharded_learner()
    phase_memory("anakin mesh")
    anakin_mesh = phase_anakin_mesh()
    phase_memory("model-parallel body")
    model_parallel = phase_model_parallel()
    phase_memory("scripts")
    scripts = phase_scripts()

    t = k1["timings"][MAIN_SHAPE]
    big = k1["timings"][SHAPES[-1]]
    anakin_k1 = k1["timings"][ANAKIN_SHAPE]
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
                             "impala_cartpole_respawn": respawn["launches"]["vtrace"],
                             "impala_served_acts": served_impala["launches"]["vtrace"],
                             "anakin_impala": anakin_impala["launches"]["vtrace"]},
        "shape": list(MAIN_SHAPE), "graph_ms": t["graph_ms"],
        "plain_graph_ms": t["plain_graph_ms"],
        "large": {"shape": list(SHAPES[-1]), "ms": big["ms"], "plain_ms": big["plain_ms"],
                  "graph_ms": big["graph_ms"], "plain_graph_ms": big["plain_graph_ms"],
                  "bound_ms": big["bound_ms"], "bound_by": big["bound_by"]},
        "anakin": {"shape": list(ANAKIN_SHAPE), **anakin_k1},
        "breakout_driver": {"shape": list(BREAKOUT_DRIVER_SHAPE),
                            **k1["timings"][BREAKOUT_DRIVER_SHAPE]},
        "sharded_learner": {"shape": list(SHARDED_SHAPE), **k1["timings"][SHARDED_SHAPE]},
        "anakin_mesh": {"shape": list(ANAKIN_MESH_SHAPE), **k1["timings"][ANAKIN_MESH_SHAPE]},
    }, *lstm_rows(k2, r2d2, r2d2_default, r2d2_pixel, launcher_r2d2, anakin_r2d2, devpath,
                  tier),
        *attention_rows(k3, ximpala, xformer_long)]
    k3a = next(row for row in kernels if row["name"] == "attention_fwd")
    k3a["launches_by_path"].update(
        ximpala_served_in_process=served["families"]["ximpala"]["launches"]["attention_fwd"],
        ximpala_replica_survivor=replicas["survivor"]["launches"]["attention_fwd"])
    # Phases 44-45: the drivers' runs (first, resumed) and the synthetic learn steps.
    # Phase 46: each family's sharded steps in a world of one and on each
    # of the two ranks.
    by_path = {"anakin_breakout_driver": drivers["breakout"]["launches"],
               "anakin_r2d2_driver": drivers["r2d2"]["launches"],
               **{f"synthetic_{section}": [n] for section, n in synth["launches"].items()},
               **{f"sharded_world1_{s}": [sharded["world1"][f"{s}/1"]["launches"]]
                  for s in SHARDED_WORLD_ONE},
               **{f"sharded_world2_{s}_model{m}_rank{r['rank']}": [r[f"{s}/{m}"]["launches"]]
                  for r in sharded["world2"] for s, m in SHARDED_WORLD_TWO},
               # Phase 47: each family's Anakin loop in a world of one and on
               # each of the two ranks.
               **{f"anakin_mesh_world1_{s}": [anakin_mesh["world1"][f"{s}/1"]["launches"]]
                  for s, _, _ in ANAKIN_MESH_WORLD_ONE},
               **{f"anakin_mesh_world2_{s}_model{m}_rank{r['rank']}": [r[f"{s}/{m}"]["launches"]]
                  for r in anakin_mesh["world2"] for s, m, _ in ANAKIN_MESH_WORLD_TWO},
               # Phase 48: each case's 3 learn steps on each of the two
               # ranks, and the world of one.
               **{f"model_parallel_{tag}_rank{r['rank']}": [r[tag]["launches"]]
                  for r in model_parallel["world2"] for tag, _, _, _ in MP_CASES},
               "model_parallel_moe_world1": [model_parallel["world1"]["moe_world1"]["launches"]],
               # Phase 49: each script module's run.
               **{f"script_{name}": [got["launches"]] for name, got in scripts.items()
                  if name != "seconds"}}
    for row in kernels:
        for path, runs in by_path.items():
            counts = [got[row["name"]] for got in runs]
            if any(counts):
                row["launches_by_path"][path] = counts if len(counts) > 1 else counts[0]
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
        f"served acts: in process " + ", ".join(
            f"{a} {got['act_ms'][16]:.3f}" for a, got in served["families"].items())
        + f" ms a 16-row batch ({served['seconds']:.1f} s), impala through the learner "
        f"{served_impala['env_frames_per_s']:.0f} env frames/s, act p50 "
        f"{np.median(served_impala['act_ms_p50']):.2f} ms ({served_impala['seconds']:.1f} s), "
        f"replica drill {replicas['seconds']:.1f} s; phases 34-36 {served_s:.1f} s; "
        f"anakin: envs ({anakin_envs['seconds']:.1f} s), impala "
        f"{anakin_impala['frames_per_s']:.0f} frames/s, {anakin_impala['ms_per_update']:.1f} "
        f"ms an update, {100 * anakin_impala['busy']:.1f}% busy, "
        f"{anakin_impala['kernels_per_update']} kernels an update "
        f"({anakin_impala['seconds']:.1f} s), apex {anakin_apex['frames_per_s']:.0f} frames/s, "
        f"ring {anakin_apex['ring_bytes'] / 1e9:.3f} GB ({anakin_apex['seconds']:.1f} s), "
        + ", ".join(f"{section} {got['frames_per_s']:.0f} frames/s, "
                    f"{got['ms_per_update']:.1f} ms an update ({got['seconds']:.1f} s)"
                    for section, got in anakin_r2d2.items())
        + f"; phases 37-40 {anakin_s:.1f} s; sharded publication: bytes a version "
        f"{wshard['bytes']}, pull p50 " + ", ".join(
            f"{tag} {ms:.3f}" for tag, ms in wshard["pull_ms_p50"].items())
        + f" ms ({wshard['seconds']:.1f} s); device path: " + ", ".join(
            f"{section} ms a call {got['call_ms']['device']:.2f} / host {got['call_ms']['host']:.2f}, "
            f"H2D {got['h2d_ms']:.3f} ms ({100 * got['h2d_overlap']:.0f}% in the learn)"
            for section, got in devpath.items() if section != "seconds")
        + f" ({devpath['seconds']:.1f} s); phases 41-42 {planes_s:.1f} s; learner tier: apex "
        f"allreduce round p50 {tier['apex']['round_ms_p50']:.3f} ms, "
        f"{tier['apex']['bytes_a_round'][0]:.0f} bytes a round a seat, D2H "
        f"{tier['apex']['d2h_ms_p50']:.3f} / H2D {tier['apex']['h2d_ms_p50']:.3f} ms; r2d2 async "
        f"merges {tier['r2d2']['merges_applied']}; seat 0 killed, seat 1 solo "
        f"{tier['launcher']['solo_rounds']} rounds; phase 43 {tier['seconds']:.1f} s; "
        f"drivers: breakout {drivers['breakout']['fps']} env frames/s a chunk, peak "
        f"{drivers['breakout']['peak_mib']:.1f} MiB ({drivers['breakout']['seconds']:.1f} s), "
        f"r2d2 {drivers['r2d2']['fps']} ({drivers['r2d2']['seconds']:.1f} s), replay eval "
        f"({drivers['replay_eval']['seconds']:.1f} s), evaluate "
        f"({drivers['evaluate']['seconds']:.1f} s), long_run "
        f"({drivers['long_run']['seconds']:.1f} s); phase 44 {drivers['seconds']:.1f} s; "
        f"synthetic steps phase 45 {synth['seconds']:.1f} s; phases 44-45 {drivers_s:.1f} s; "
        f"sharded learner phase 46 {sharded['seconds']:.1f} s; "
        f"anakin mesh phase 47 {anakin_mesh['seconds']:.1f} s; "
        f"model-parallel body phase 48 {model_parallel['seconds']:.1f} s; "
        f"scripts phase 49 {scripts['seconds']:.1f} s; "
        f"smoke took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
