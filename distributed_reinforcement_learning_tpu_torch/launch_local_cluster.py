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

When the learner has finished, each actor gets SIGINT: it stops, prints
its JSON summary and exits 0 (after `--actor_grace` seconds without a
learner an actor ends by itself, as `train_<algo>` does). Refused by
name, with the ROADMAP item: `--learners` > 1 and `--learner_sync`
(item 13), `--serve_inference`, `--remote_act` and
`--inference_replicas` (item 12d), `--weights_sharded 1` (item 12e).
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
                   help="learner processes: only 1 is ported (ROADMAP item 13)")
    p.add_argument("--learner_sync", default=None,
                   help="the learner tier's sync: not ported (ROADMAP item 13)")
    p.add_argument("--updates", type=int, default=500)
    p.add_argument("--run_dir", default=None,
                   help="the learner's metrics.jsonl and every process's telemetry "
                        "shards (<run_dir>/telemetry)")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--device", "--platform", dest="device", default=None,
                   help="the LEARNER's torch device (default: cuda); actors run on the CPU")
    p.add_argument("--actor_grace", type=float, default=30.0,
                   help="seconds an actor rides out a learner outage before it exits")
    p.add_argument("--serve_inference", action="store_true",
                   help="not ported (ROADMAP item 12d)")
    p.add_argument("--remote_act", action="store_true", help="not ported (ROADMAP item 12d)")
    p.add_argument("--inference_replicas", type=int, default=None,
                   help="not ported (ROADMAP item 12d)")
    p.add_argument("--replay_shards", type=int, default=None,
                   help="replay learners: N >= 1 ingest shards, 0 the monolithic replay "
                        "(DRL_REPLAY_SHARDS; unset: the default of 2)")
    p.add_argument("--weights_sharded", type=int, default=None, choices=(0, 1),
                   help="1 is not ported (ROADMAP item 12e); 0 is the port's only mode")
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
    if args.learners != 1 or args.learner_sync is not None:
        p.error("--learners > 1 and --learner_sync (the learner tier, multi-host learners) "
                "are not ported (ROADMAP item 13)")
    if args.serve_inference or args.remote_act or args.inference_replicas:
        p.error("--serve_inference, --remote_act and --inference_replicas (serving acts) "
                "are not ported (ROADMAP item 12d)")
    if args.weights_sharded == 1:
        p.error("--weights_sharded 1: sharded weight publication is not ported "
                "(ROADMAP item 12e)")
    args.respawn = args.respawn or ("chaos" if args.chaos else "off")
    if args.chaos and args.respawn == "off":
        p.error("--chaos needs a respawn policy; drop --respawn off")
    return args


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    from distributed_reinforcement_learning_tpu_torch.runtime import shm_ring, weight_board

    print(f"[cluster] {shm_size_line()}", file=sys.stderr)
    env = dict(os.environ)
    env.setdefault("DRL_LEARNER_ADDR", f"127.0.0.1:{_free_port()}")
    if args.run_dir:
        env["DRL_TELEMETRY_DIR"] = os.path.join(os.path.abspath(args.run_dir), "telemetry")
    if args.replay_shards is not None:
        env["DRL_REPLAY_SHARDS"] = str(max(0, args.replay_shards))
        print(f"[cluster] replay shards: "
              f"{'off (monolithic)' if args.replay_shards <= 0 else args.replay_shards}",
              file=sys.stderr)
    if args.weights_sharded is not None:
        env["DRL_WEIGHTS_SHARDED"] = str(args.weights_sharded)
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
    board_name = None
    if shm_ring.ring_enabled():
        ring_names = {task: f"drlring-{tag}-{task}" for task in range(args.actors)}
        print(f"[cluster] shm rings enabled for {args.actors} co-hosted actor(s)",
              file=sys.stderr)
    if weight_board.board_enabled():
        board_name = f"drlwboard-{tag}-0"
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
    lenv = dict(env)
    if ring_names:
        lenv["DRL_SHM_RING_CREATE"] = ",".join(ring_names[t] for t in sorted(ring_names))
    if board_name:
        lenv["DRL_SHM_WEIGHTS_CREATE"] = board_name
    roles = [Role("learner", learner_cmd, lenv, "learner",
                  segments=(*ring_names.values(), *((board_name,) if board_name else ())))]
    for task in range(args.actors):
        aenv = dict(env, CUDA_VISIBLE_DEVICES="")
        aenv.setdefault("OMP_NUM_THREADS", "1")
        if task in ring_names:
            aenv["DRL_SHM_RING_NAME"] = ring_names[task]
        if board_name:
            aenv["DRL_SHM_WEIGHTS_NAME"] = board_name
        roles.append(Role(f"actor{task}", base + [
            "--mode", "actor", "--task", str(task), "--device", "cpu",
            "--actor_grace", str(args.actor_grace)], aenv, "actor"))

    pumps: list[threading.Thread] = []

    def spawn(role: Role) -> None:
        role.proc = subprocess.Popen(role.cmd, cwd=REPO, env=role.env, text=True,
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        t = threading.Thread(target=_pump, args=(role.name, role.proc), daemon=True)
        t.start()
        pumps.append(t)

    for role in roles:
        spawn(role)
    learner = roles[0]
    actors = roles[1:]
    stop_evt = threading.Event()

    def shutdown(*_):
        stop_evt.set()
        for role in roles:
            if role.proc is not None and role.proc.poll() is None:
                # Actors stop on SIGINT and print their summaries.
                role.proc.send_signal(signal.SIGINT if role.kind == "actor"
                                      else signal.SIGTERM)

    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)

    if args.chaos:
        # SIGKILL on purpose: preemption, not a polite stop. No atexit
        # runs, the segments stay until the pid-keyed reap, and the fleet
        # supervisor sees the death by missed heartbeats alone.
        def chaos_loop() -> None:
            for role in actors[:1] + [learner]:
                if stop_evt.wait(args.chaos_interval):
                    return
                if role.proc is not None and role.proc.poll() is None:
                    print(f"[cluster] chaos: SIGKILL {role.name} (pid {role.proc.pid})",
                          file=sys.stderr)
                    role.proc.kill()

        threading.Thread(target=chaos_loop, daemon=True, name="chaos").start()

    rc = 0
    tally = {"learner": 0, "actor": 0}
    while not stop_evt.is_set():
        for role in roles:
            code = role.proc.poll() if role.proc is not None else None
            if code is None or role.done:
                continue
            if code == 0:  # a clean exit is completion, not a death
                role.done = True
                continue
            if (args.respawn != "off" and role.respawns < args.max_respawns
                    and not learner.done):
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
        if learner.done:
            break
        if actors and all(r.done for r in actors):
            print("[cluster] all actors exited; shutting down", file=sys.stderr)
            rc = 1
            break
        stop_evt.wait(0.5)
    shutdown()
    for role in roles:
        if role.proc is None:
            continue
        try:
            role.proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            role.proc.kill()
            # Reap the killed child: a zombie still passes the sweep's
            # liveness check below and would keep its segments.
            role.proc.wait(timeout=10)
    code = learner.proc.poll() if learner.proc is not None else None
    if code is not None and code != 0:  # an interrupted or failed learner
        rc = max(rc, 128 - code if code < 0 else code)
    for t in pumps:
        t.join(timeout=5.0)  # the children's last lines before exit
    if sum(tally.values()):
        print(f"[cluster] respawn tally: {tally}", file=sys.stderr)
    reap_segments([*ring_names.values(), *((board_name,) if board_name else ())],
                  "final sweep")
    return rc


if __name__ == "__main__":
    sys.exit(main())
