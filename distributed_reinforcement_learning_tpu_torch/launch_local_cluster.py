"""Launch the port's local topology (one learner + N actors) in one command.

    python -m distributed_reinforcement_learning_tpu_torch.launch_local_cluster \\
        --section impala --actors 4 --updates 100

Counterpart of the JAX package's `scripts/launch_local_cluster.py` with
`--learners 1`: the same arguments and the same section -> family
mapping (`--algo`, default the section name's prefix). It spawns the
learner through the port's `train_<algo> --mode learner` on the card
(its default device; `--device cpu`, or `--platform cpu` as the JAX
launcher spells it, moves the learner) and each actor as `train_<algo>
--mode actor --task k --device cpu` with `CUDA_VISIBLE_DEVICES` empty,
so that no actor takes the card (and `OMP_NUM_THREADS=1` unless the
caller set it). Every role's output is prefixed with its name; Ctrl-C,
or the learner's exit, tears the topology down.

The learner listens on a free loopback port handed to every role as
`DRL_LEARNER_ADDR` (unless the caller set it), where the JAX launcher
uses the section's `server_port`: two launches on one host never
collide.

Shared-memory planes, named per launch through the port's gates
(`runtime/shm_ring.ring_enabled`, `runtime/weight_board.board_enabled`:
the env forces, unset defers to the JAX package's verdicts, which the
port holds as constants, on x86-64 only): one ring per actor
(`DRL_SHM_RING_CREATE` to the learner, `DRL_SHM_RING_NAME` to the
actor; off by default) and one weight board per learner
(`DRL_SHM_WEIGHTS_CREATE` / `DRL_SHM_WEIGHTS_NAME`; on by default on
x86-64). The launcher logs /dev/shm's size at start: the board takes
2 x `DRL_SHM_WEIGHTS_MB` (64 MB default) and each ring `DRL_SHM_RING_MB`
(64 MB) of address space, and a segment that cannot be created leaves
its plane on TCP with a warning. Segments a dead learner leaves behind
are reaped by their creator pid (the header word at offset 24), before
a respawn and after the run.

Fleet options: `--respawn on-exit` re-spawns a role that died mid-run
with the same command and environment (a respawned learner re-creates
its segments under the same names and restores from
`--checkpoint_dir`); `--chaos` SIGKILLs one actor and then the learner,
`--chaos_interval` apart, and implies `--respawn chaos`;
`--max_respawns` caps each role's respawns; `--staleness_budget N` sets
`DRL_PUBLISH_INTERVAL` to N // 4. `--replay_shards` passes
`DRL_REPLAY_SHARDS` through.

Served acts: `--serve_inference` makes the learner answer acts on its
device, and `--remote_act` (which needs it) starts the actors with
`--remote_act`, so that they act through it and pull no weights. With
`--inference_replicas N` (which needs `--remote_act`; unset,
`DRL_INFER_REPLICAS` or `runtime/serving.py`'s verdict constant decides,
0 by default) the launcher spawns N act-serving replicas (`train_<algo>
--mode inference --task k`, on the learner's device) between the learner
and the actors, each on a free port handed to it as `DRL_INFER_PORT`
and reading the learner's weight board when there is one, and hands the
actors their addresses as `DRL_INFER_ADDRS`: the actors then act through
the replicas, with the learner as the fallback. Replicas are respawned
and stopped as actors are; `--chaos` kills actor 0, then replica 0, then
the learner.

When the learner has finished, each actor, then each replica, gets
SIGINT: it stops, prints its JSON summary and exits 0 (after
`--actor_grace` seconds without a learner an actor or a replica ends by
itself, as `train_<algo>` does). `--weights_sharded 1` exports
`DRL_WEIGHTS_SHARDED=1` to every role: the learner publishes per shard
onto the segmented board, and the actors' and replicas' TCP pulls are
shard-scoped.

The learner tier: `--learners N --learner_sync allreduce|async` spawns
N learner seats (`runtime/learner_tier.py`), resolved as the JAX
launcher resolves them (`--learner_sync`, else `DRL_LEARNER_SEATS` with
`DRL_LEARNER_SYNC`, else the tier verdict constant, off). Each seat gets
the roster of collective endpoints (one free port a seat) as
`DRL_LEARNER_PEERS`, its rank, the seat count and the sync; seat k
serves its data plane on the base port + k (`DRL_LEARNER_ADDR`, N
consecutive free ports), actor t feeds seat t % N
(`DRL_LEARNER_INDEX`), its ring goes to that seat, and every role
shares ONE board name, which only the publishing seat writes. Refused
at parse time, as in the JAX launcher: `allreduce` for a family other
than `apex` (only Ape-X has the split learn step), `--respawn` or
`--chaos` with more than one seat (a tier restarts only whole). Refused
by name, with the ROADMAP item: `--learner_sync` with one learner.

The multi-process learner (ROADMAP item 13b): `--learners N` with no tier
sync (or `--learner_sync multihost`) spawns N learner processes that run
one learn step together over a data mesh (`parallel/distributed.py`,
`parallel/learner.py`), as the JAX launcher's `jax.distributed` group:
every role gets `DRL_COORDINATOR` (a free loopback port) and
`DRL_NUM_PROCESSES`, each learner its `DRL_PROCESS_ID`; learner k serves
its data plane on the base port + k, creates its own weight board and
takes `batch_size / N` rows a step; actor t feeds learner t % N. On one
card the learners share it (over gloo). `--respawn` needs `--learners 1`
(a group restarts only whole), and a learner of the group that fails
takes the others down with it.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "distributed_reinforcement_learning_tpu_torch"
FAMILIES = ("impala", "apex", "r2d2", "xformer", "ximpala")


def reap_segments(names, why: str) -> None:
    """Unlink the named shm segments whose creator pid is dead — keyed
    by the header's creator-pid word, never by the name alone: a
    respawned learner re-creating segments under the same names must not
    lose them to a sweep aimed at the dead incarnation's leftovers."""
    from multiprocessing import shared_memory

    from distributed_reinforcement_learning_tpu_torch.runtime.shm_ring import (
        pid_alive, segment_owner_pid)

    for name in names:
        if pid_alive(segment_owner_pid(name)):
            continue  # a live (respawned) owner: not ours to reap
        try:
            seg = shared_memory.SharedMemory(name=name)
            seg.close()
            seg.unlink()
            print(f"[cluster] reaped leaked shm segment {name} ({why})", file=sys.stderr)
        except (FileNotFoundError, OSError):
            pass  # the owner cleaned up, as it should


def shm_size_line(path: str = "/dev/shm") -> str:
    try:
        st = os.statvfs(path)
    except OSError as e:
        return f"{path}: unavailable ({e})"
    return (f"{path}: {st.f_bavail * st.f_frsize / 1e6:.0f} MB free of "
            f"{st.f_blocks * st.f_frsize / 1e6:.0f} MB")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _free_port_run(n: int) -> int:
    """The first of `n` consecutive free loopback ports (the seats' data
    ports, base + rank)."""
    for _ in range(100):
        base = _free_port()
        try:
            for k in range(1, n):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", base + k))
        except OSError:
            continue
        return base
    raise RuntimeError(f"no run of {n} free loopback ports")


def _pump(prefix: str, proc: subprocess.Popen) -> None:
    for line in proc.stdout:  # type: ignore[union-attr]
        sys.stdout.write(f"[{prefix}] {line}")
        sys.stdout.flush()


class Role:
    """One respawnable seat of the topology: the command and environment
    it was (re)launched with, its live process and, for the learner, the
    shm segment names it creates."""

    def __init__(self, name: str, cmd: list[str], env: dict, kind: str,
                 segments: tuple = ()):
        self.name, self.cmd, self.env, self.kind = name, cmd, env, kind
        self.segments = list(segments)
        self.proc: subprocess.Popen | None = None
        self.respawns = 0
        self.done = False  # finished normally, or its respawn budget is spent


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default=os.path.join(REPO, "config.json"))
    p.add_argument("--section", default="impala_cartpole")
    p.add_argument("--algo", default=None, help="family (default: section-name prefix)")
    p.add_argument("--actors", type=int, default=2)
    p.add_argument("--learners", type=int, default=1,
                   help="learner processes: N > 1 learner-tier seats with a tier sync, "
                        "else one multi-process learner group over a data mesh")
    p.add_argument("--learner_sync", choices=("allreduce", "async", "multihost"),
                   default=None,
                   help="with --learners N > 1: the learner tier's exchange, lockstep "
                        "gradient allreduce (apex) or bounded-staleness parameter merging; "
                        "or multihost, the learner group (DRL_COORDINATOR)")
    p.add_argument("--updates", type=int, default=500)
    p.add_argument("--run_dir", default=None,
                   help="the learner's metrics.jsonl and every process's telemetry "
                        "shards (<run_dir>/telemetry)")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--device", "--platform", dest="device", default=None,
                   help="the learner's and the replicas' torch device (default: cuda); "
                        "actors run on the CPU")
    p.add_argument("--actor_grace", type=float, default=30.0,
                   help="seconds an actor rides out a learner outage before it exits")
    p.add_argument("--serve_inference", action="store_true",
                   help="the learner also serves acts on its device")
    p.add_argument("--remote_act", action="store_true",
                   help="actors act through the service and pull no weights "
                        "(needs --serve_inference)")
    p.add_argument("--inference_replicas", type=int, default=None,
                   help="act-serving replicas for --remote_act actors (default: "
                        "DRL_INFER_REPLICAS, else the serving verdict: 0)")
    p.add_argument("--replay_shards", type=int, default=None,
                   help="replay learners: N >= 1 ingest shards, 0 the monolithic replay "
                        "(DRL_REPLAY_SHARDS; unset: the default of 2)")
    p.add_argument("--weights_sharded", type=int, default=None, choices=(0, 1),
                   help="force per-shard weight publication on (1) or off (0) for every "
                        "role (DRL_WEIGHTS_SHARDED: shard blobs and a manifest on the "
                        "board and the shard-scoped TCP pull; unset: the gate's default, "
                        "off)")
    p.add_argument("--respawn", choices=("off", "on-exit", "chaos"), default=None,
                   help="on-exit re-spawns a role that dies mid-run with the same command "
                        "and environment; chaos = on-exit plus the --chaos kills "
                        "(default off, or chaos with --chaos)")
    p.add_argument("--chaos", action="store_true",
                   help="SIGKILL one actor, then the learner, --chaos_interval apart, and "
                        "respawn them")
    p.add_argument("--chaos_interval", type=float, default=20.0)
    p.add_argument("--max_respawns", type=int, default=5,
                   help="per-role respawn budget; an exhausted role stays down")
    p.add_argument("--staleness_budget", type=int, default=None,
                   help="derive publish_interval = budget // 4 (DRL_PUBLISH_INTERVAL)")
    args = p.parse_args(argv)

    args.algo = args.algo or args.section.split("_")[0]
    if args.algo not in FAMILIES:
        p.error(f"unknown algorithm {args.algo!r} (from --section/--algo); one of "
                f"{sorted(FAMILIES)}")
    args.tier_sync = learner_tier_sync(args, p)
    if args.remote_act and not args.serve_inference:
        # The actors would fail at once while the learner idles.
        p.error("--remote_act needs the learner to serve inference; pass --serve_inference too")
    args.infer_replicas = infer_replicas(args, p)
    args.respawn = args.respawn or ("chaos" if args.chaos else "off")
    if args.chaos and args.respawn == "off":
        p.error("--chaos needs a respawn policy; drop --respawn off")
    if args.respawn != "off" and args.learners > 1:
        # Seats cannot rejoin a live collective (dead ranks stay dead),
        # and a respawned ex-publisher would race the promoted survivor
        # for the shared board name: a tier restarts only whole.
        p.error("--respawn needs --learners 1 (a learner tier, or a multi-process learner "
                "group, ROADMAP item 13b, can only restart wholesale)")
    return args


def learner_tier_sync(args: argparse.Namespace, p: argparse.ArgumentParser) -> str | None:
    """The tier's sync for `--learners N`, or None for one learner and
    for the multi-process learner group: `--learner_sync` forces it
    (`multihost` forces the group); else `DRL_LEARNER_SEATS` >= 2 turns
    the tier on with `DRL_LEARNER_SYNC` (default allreduce), as the tier
    verdict constant would (off). N > 1 with no sync is the group."""
    from distributed_reinforcement_learning_tpu_torch.runtime import learner_tier

    if args.learners <= 1:
        if args.learner_sync is not None:
            p.error("--learner_sync needs --learners N >= 2 (the learner tier, ROADMAP "
                    "item 13a, or the multi-process learner group, item 13b)")
        return None
    if args.learner_sync == "multihost":
        return None
    sync = args.learner_sync
    if sync is None:
        try:
            seats = learner_tier.seat_count()
        except ValueError as e:
            p.error(str(e))
        if seats >= 2:
            sync = (os.environ.get("DRL_LEARNER_SYNC", "").strip().lower()
                    or learner_tier.VERDICT_SYNC)
    if sync is None:
        return None
    if sync == "allreduce" and args.algo != "apex":
        # attach would refuse it too, but only after every seat built its
        # learner.
        p.error(f"learner-tier allreduce needs the apex family's split learn step "
                f"(agent.grads/apply_grads); use --learner_sync async for {args.algo!r}")
    return sync


def infer_replicas(args: argparse.Namespace, p: argparse.ArgumentParser) -> int:
    """The replica count: `--inference_replicas` forces it; without
    `--remote_act` none; else `serving.replica_count()` (DRL_INFER_REPLICAS,
    then the verdict constant). Replicas serve remote-act actors only."""
    if args.inference_replicas is not None:
        n = max(0, args.inference_replicas)
    elif not args.remote_act:
        n = 0
    else:
        from distributed_reinforcement_learning_tpu_torch.runtime import serving

        try:
            n = serving.replica_count()
        except ValueError as e:
            p.error(str(e))
    if n and not args.remote_act:
        p.error("--inference_replicas needs remote-act actors; pass --remote_act too")
    return n


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    from distributed_reinforcement_learning_tpu_torch.runtime import shm_ring, weight_board

    print(f"[cluster] {shm_size_line()}", file=sys.stderr)
    env = dict(os.environ)
    env.setdefault("DRL_LEARNER_ADDR", f"127.0.0.1:{_free_port_run(args.learners)}")
    if args.run_dir:
        env["DRL_TELEMETRY_DIR"] = os.path.join(os.path.abspath(args.run_dir), "telemetry")
    if args.replay_shards is not None:
        env["DRL_REPLAY_SHARDS"] = str(max(0, args.replay_shards))
        print(f"[cluster] replay shards: "
              f"{'off (monolithic)' if args.replay_shards <= 0 else args.replay_shards}",
              file=sys.stderr)
    if args.weights_sharded is not None:
        # Every role reads the same gate (the learner decides what it
        # publishes and creates, the readers follow the board's magic or
        # demote on the TCP op), so it is exported to all of them.
        env["DRL_WEIGHTS_SHARDED"] = str(args.weights_sharded)
        print(f"[cluster] sharded weight publication "
              f"{'on' if args.weights_sharded else 'off (whole-blob)'}", file=sys.stderr)
    if args.staleness_budget is not None:
        # The observable staleness is ~4 x publish_interval: the cadence
        # itself plus the async publication's bounded lag of up to 3
        # intervals (runtime/publishing.py), as the JAX launcher derives.
        interval = max(1, args.staleness_budget // 4)
        env["DRL_PUBLISH_INTERVAL"] = str(interval)
        print(f"[cluster] staleness_budget {args.staleness_budget} -> publish_interval "
              f"{interval} (cadence + 3x async-lag bound)", file=sys.stderr)

    tag = f"{os.getpid()}-{os.urandom(4).hex()}"
    ring_names: dict[int, str] = {}
    board_names: dict[int, str] = {}
    if shm_ring.ring_enabled():
        ring_names = {task: f"drlring-{tag}-{task}" for task in range(args.actors)}
        print(f"[cluster] shm rings enabled for {args.actors} co-hosted actor(s)",
              file=sys.stderr)
    if weight_board.board_enabled():
        # One name for a whole tier: only the publishing seat creates and
        # writes it; a promoted seat re-creates it by creator-pid reclaim.
        # A learner group publishes from every rank: one board a learner.
        board_names = {rank: f"drlwboard-{tag}-{'tier' if args.tier_sync else rank}"
                       for rank in range(args.learners)}
        print(f"[cluster] shm weight board enabled for {args.actors} co-hosted actor(s)",
              file=sys.stderr)

    base = [sys.executable, "-m", f"{PACKAGE}.train_{args.algo}", "--config", args.config,
            "--section", args.section]
    learner_cmd = base + ["--mode", "learner", "--updates", str(args.updates)]
    if args.run_dir:
        learner_cmd += ["--run_dir", args.run_dir]
    if args.checkpoint_dir:
        learner_cmd += ["--checkpoint_dir", args.checkpoint_dir]
    if args.device:
        learner_cmd += ["--device", args.device]
    if args.serve_inference:
        learner_cmd += ["--serve_inference"]
    n_seats = args.learners
    group = n_seats > 1 and not args.tier_sync
    if group:
        env.update(DRL_COORDINATOR=f"localhost:{_free_port()}", DRL_NUM_PROCESSES=str(n_seats))
        print(f"[cluster] multi-process learner: {n_seats} ranks over one data mesh",
              file=sys.stderr)
    coll_peers = ""
    if args.tier_sync:
        # One collective endpoint a seat; the roster (index = rank) goes to
        # every seat, so that the ring and the probes agree.
        coll_peers = ",".join(f"127.0.0.1:{_free_port()}" for _ in range(n_seats))
        print(f"[cluster] learner tier: {n_seats} seat(s), sync={args.tier_sync}",
              file=sys.stderr)
    roles = []
    for rank in range(n_seats):
        lenv = dict(env)
        if args.tier_sync:
            lenv.update(DRL_LEARNER_SEATS=str(n_seats), DRL_LEARNER_RANK=str(rank),
                        DRL_LEARNER_PEERS=coll_peers, DRL_LEARNER_SYNC=args.tier_sync)
        if group:
            lenv["DRL_PROCESS_ID"] = str(rank)
        mine = [ring_names[t] for t in sorted(ring_names) if t % n_seats == rank]
        if mine:
            lenv["DRL_SHM_RING_CREATE"] = ",".join(mine)
        board = board_names.get(rank)
        if board:
            lenv["DRL_SHM_WEIGHTS_CREATE"] = board
        roles.append(Role(f"learner{rank}" if n_seats > 1 else "learner", learner_cmd, lenv,
                          "learner", segments=(*mine, *((board,) if board else ()))))
    # Act-serving replicas between the learner and the actors: each on
    # its own port, reading the learner's board (read-only) when there is
    # one, on the learner's device.
    infer_addrs = []
    for k in range(args.infer_replicas):
        iport = _free_port()
        infer_cmd = base + ["--mode", "inference", "--task", str(k),
                            "--actor_grace", str(args.actor_grace)]
        if args.run_dir:
            infer_cmd += ["--run_dir", args.run_dir]
        if args.device:
            infer_cmd += ["--device", args.device]
        ienv = dict(env, DRL_INFER_PORT=str(iport), DRL_LEARNER_INDEX=str(k % n_seats))
        if board_names:
            ienv["DRL_SHM_WEIGHTS_NAME"] = board_names[k % n_seats]
        roles.append(Role(f"infer{k}", infer_cmd, ienv, "infer"))
        infer_addrs.append(f"127.0.0.1:{iport}")
    if infer_addrs:
        env["DRL_INFER_ADDRS"] = ",".join(infer_addrs)
        print(f"[cluster] inference tier: {len(infer_addrs)} act-serving replica(s)",
              file=sys.stderr)
    for task in range(args.actors):
        aenv = dict(env, CUDA_VISIBLE_DEVICES="", DRL_LEARNER_INDEX=str(task % n_seats))
        aenv.setdefault("OMP_NUM_THREADS", "1")
        if task in ring_names:
            aenv["DRL_SHM_RING_NAME"] = ring_names[task]
        if board_names:
            aenv["DRL_SHM_WEIGHTS_NAME"] = board_names[task % n_seats]
        roles.append(Role(f"actor{task}", base + [
            "--mode", "actor", "--task", str(task), "--device", "cpu",
            "--actor_grace", str(args.actor_grace),
            *(["--remote_act"] if args.remote_act else [])], aenv, "actor"))

    pumps: list[threading.Thread] = []

    def spawn(role: Role) -> None:
        role.proc = subprocess.Popen(role.cmd, cwd=REPO, env=role.env, text=True,
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        t = threading.Thread(target=_pump, args=(role.name, role.proc), daemon=True)
        t.start()
        pumps.append(t)

    for role in roles:
        spawn(role)
    learners = [r for r in roles if r.kind == "learner"]
    learner = learners[0]
    replicas = [r for r in roles if r.kind == "infer"]
    actors = [r for r in roles if r.kind == "actor"]
    stop_evt = threading.Event()

    def signal_roles(kinds) -> None:
        for role in roles:
            if role.kind in kinds and role.proc is not None and role.proc.poll() is None:
                # Actors and replicas stop on SIGINT and print their summaries.
                role.proc.send_signal(signal.SIGTERM if role.kind == "learner"
                                      else signal.SIGINT)

    def shutdown(*_):
        stop_evt.set()
        signal_roles(("learner", "infer", "actor"))

    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)

    if args.chaos:
        # SIGKILL on purpose: preemption, not a polite stop. No atexit
        # runs, the segments stay until the pid-keyed reap, and the fleet
        # supervisor sees the death by missed heartbeats alone.
        def chaos_loop() -> None:
            for role in actors[:1] + replicas[:1] + [learner]:
                if stop_evt.wait(args.chaos_interval):
                    return
                if role.proc is not None and role.proc.poll() is None:
                    print(f"[cluster] chaos: SIGKILL {role.name} (pid {role.proc.pid})",
                          file=sys.stderr)
                    role.proc.kill()

        threading.Thread(target=chaos_loop, daemon=True, name="chaos").start()

    rc = 0
    tally = {"learner": 0, "actor": 0, "infer": 0}
    while not stop_evt.is_set():
        for role in roles:
            code = role.proc.poll() if role.proc is not None else None
            if code is None or role.done:
                continue
            if code == 0:  # a clean exit is completion, not a death
                role.done = True
                continue
            if (args.respawn != "off" and role.respawns < args.max_respawns
                    and not all(r.done for r in learners)):
                role.respawns += 1
                tally[role.kind] += 1
                if role.kind == "learner":
                    reap_segments(role.segments, "pre-respawn")
                print(f"[cluster] respawning {role.name} (exit {code}, attempt "
                      f"{role.respawns}/{args.max_respawns})", file=sys.stderr)
                spawn(role)
            else:
                role.done = True
                if role.kind == "learner":
                    rc = max(rc, 128 - code if code < 0 else code)
                    if group:  # the other ranks would wait in a collective
                        print(f"[cluster] {role.name} failed; stopping the learner group",
                              file=sys.stderr)
                        signal_roles(("learner",))
        if all(r.done for r in learners):
            break
        if actors and all(r.done for r in actors):
            print("[cluster] all actors exited; shutting down", file=sys.stderr)
            rc = 1
            break
        stop_evt.wait(0.5)
    # Actors first, so that no act is cut short by a replica going down,
    # then the replicas and the learner.
    stop_evt.set()
    for kinds in (("actor",), ("infer", "learner")):
        signal_roles(kinds)
        for role in roles:
            if role.kind not in kinds or role.proc is None:
                continue
            try:
                role.proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                role.proc.kill()
                # Reap the killed child: a zombie still passes the sweep's
                # liveness check below and would keep its segments.
                role.proc.wait(timeout=10)
    for role in learners:
        code = role.proc.poll() if role.proc is not None else None
        if code is not None and code != 0:  # an interrupted or failed learner seat
            rc = max(rc, 128 - code if code < 0 else code)
    for t in pumps:
        t.join(timeout=5.0)  # the children's last lines before exit
    if sum(tally.values()):
        print(f"[cluster] respawn tally: {tally}", file=sys.stderr)
    reap_segments([*ring_names.values(), *set(board_names.values())], "final sweep")
    return rc


if __name__ == "__main__":
    sys.exit(main())
