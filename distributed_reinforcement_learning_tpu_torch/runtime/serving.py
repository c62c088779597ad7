"""The act-serving tier: replicas with continuous batching.

Counterpart of the JAX package's `runtime/serving.py`:

- **Replica host** (`run_replica`, `--mode inference --task k`): a
  process that reads the learner's weight board read-only (with TCP
  pulls as the fallback, to which the board demotes itself on failure),
  mirrors each new version into a local WeightStore, and serves OP_ACT on
  its own port through a queue-less `TransportServer` (trajectory ops
  answer ST_UNAVAILABLE). Its acts run on CUDA unless `device` names
  another device.
- **Continuous batcher** (`ContinuousInferenceServer`): a dispatch
  thread takes whatever rows are pending the moment a pipeline slot
  frees and enqueues the act; a completion thread waits for each batch
  and scatters it. The next batch assembles while the previous act is in
  flight, so batches grow with load without a wait window. On CUDA "in
  flight" is an act enqueued on the stream with a recorded
  `torch.cuda.Event`, and the completion thread waits on that event
  only.
- **Admission control**: a bounded pending-rows budget
  (`DRL_INFER_BUDGET`, default 4 x max_batch). A submit past it raises
  `InferenceBusy`; the transport answers ST_BUSY, and the client retries
  with jitter or fails over to another replica
  (`transport.RemoteActService`).

The replica count of a `--remote_act` topology: `--inference_replicas N`
forces it, `DRL_INFER_REPLICAS` overrides, and unset takes
`INFERENCE_VERDICT`, this module's copy of the JAX package's
`benchmarks/inference_verdict.json` (replicas off by default).
"""

from __future__ import annotations

import json
import os
import queue as _queuemod
import threading
import time

from distributed_reinforcement_learning_tpu_torch.observability import TELEMETRY as _OBS
from distributed_reinforcement_learning_tpu_torch.observability import maybe_configure
from distributed_reinforcement_learning_tpu_torch.runtime.inference import (
    InferenceServer, make_act_adapter)

# The JAX package's benchmarks/inference_verdict.json as it stands: the
# client-swarm A/B's median 0.75x of the learner-hosted actions/s, below
# its 1.2x bar, so replicas ship off; `replicas` is the count it names.
INFERENCE_VERDICT = {"auto_enable": False, "replicas": 2}

_DEFAULT_REPLICAS = 2  # the auto-enabled count when a verdict names none


def replicas_auto_enabled(verdict: dict | None = None) -> bool:
    """Whether the verdict ships replicas on for --remote_act topologies."""
    return bool((INFERENCE_VERDICT if verdict is None else verdict).get("auto_enable", False))


def replica_count(verdict: dict | None = None) -> int:
    """The replica count for --remote_act topologies; 0 keeps acts on the
    learner's in-process service. `DRL_INFER_REPLICAS=N` forces N; unset
    defers to the verdict (its `replicas`, default 2, when it enables
    them)."""
    env = os.environ.get("DRL_INFER_REPLICAS", "").strip()
    if env:
        try:
            return max(0, int(env))
        except ValueError as e:
            raise ValueError(f"DRL_INFER_REPLICAS must be an integer, got {env!r}") from e
    verdict = INFERENCE_VERDICT if verdict is None else verdict
    if not replicas_auto_enabled(verdict):
        return 0
    try:
        return max(1, int(verdict.get("replicas", _DEFAULT_REPLICAS)))
    except (TypeError, ValueError):
        return _DEFAULT_REPLICAS


def _env_int(name: str, default: int) -> int:
    """An integer knob whose malformed value fails with its name."""
    env = os.environ.get(name, "").strip()
    if not env:
        return default
    try:
        return int(env)
    except ValueError as e:
        raise ValueError(f"{name} must be an integer, got {env!r}") from e


def admission_budget(max_batch: int) -> int:
    """The serving tier's pending-rows budget: `DRL_INFER_BUDGET`, else 4
    x max_batch (enough to keep a two-deep pipeline full, small enough
    that a rejected client's retry lands a batch or two later)."""
    return _env_int("DRL_INFER_BUDGET", 4 * max_batch)


class ContinuousInferenceServer(InferenceServer):
    """InferenceServer with the run-at-max_batch barrier replaced by a
    two-stage pipeline:

        submitters -> pending deque -> [dispatch thread] -> in-flight
        queue (bounded, `depth`) -> [completion thread] -> waiters

    The dispatch thread blocks on the in-flight queue's put while `depth`
    batches are outstanding, which is when arriving rows coalesce into
    bigger batches. Same pending-state locking as the base class; the
    generator and device cache stay dispatch-thread-only, and the
    cumulative counters move to the completion thread (one writer)."""

    def __init__(self, act_fn, weights, max_batch: int = 256, seed: int = 0,
                 admission_rows: int | None = None, depth: int | None = None,
                 device=None):
        # No max_wait_ms: this batcher has no wait window.
        if depth is None:
            depth = _env_int("DRL_INFER_DEPTH", 2)
        self._inflight: _queuemod.Queue = _queuemod.Queue(maxsize=max(1, depth))
        self._completer: threading.Thread | None = None
        # The base __init__ starts the dispatch thread (this class's
        # _loop), so the in-flight queue must exist first.
        super().__init__(act_fn, weights, max_batch=max_batch, seed=seed,
                         admission_rows=admission_rows, device=device)
        self._completer = threading.Thread(target=self._complete_loop, daemon=True,
                                           name="inference-complete")
        self._completer.start()

    @classmethod
    def for_agent(cls, algo: str, agent, weights, **kwargs) -> "ContinuousInferenceServer":
        return cls(make_act_adapter(algo, agent), weights, **kwargs)

    def _take_batch(self) -> list[dict]:
        """Pending requests as soon as any exist (up to max_batch rows)."""
        with self._batch_ready:
            while not self._stop:
                if self._pending:
                    return self._take_whole_requests()
                # Bounded wait: a lost notify must not park the thread.
                self._batch_ready.wait(timeout=0.5)
            return []

    def _loop(self) -> None:
        while True:
            reqs = self._take_batch()
            if not reqs:
                # Stopped: the sentinel reaches the completion thread
                # behind any batches still in flight.
                self._inflight.put(None)
                return
            try:
                item = self._dispatch(reqs)
            except Exception as e:  # noqa: BLE001 — deliver to every waiter
                self._fail(reqs, e)
                continue
            self._inflight.put((reqs, item))

    def _complete_loop(self) -> None:
        while True:
            got = self._inflight.get()
            if got is None:
                return
            reqs, (host, n, event, t0) = got
            try:
                out = self._materialize(host, event, t0)
            except Exception as e:  # noqa: BLE001 — deliver to every waiter
                self._fail(reqs, e)
                continue
            self._scatter(reqs, out, n)

    def stop(self) -> None:
        super().stop()  # the dispatch thread enqueues the sentinel on its way out
        if self._completer is not None:
            self._completer.join(timeout=5.0)


def run_replica(algo: str, config_path: str, section: str, task: int = 0, seed: int = 0,
                run_dir: str | None = None, grace: float = 120.0,
                device=None) -> dict:
    """One act-serving replica process (`--mode inference --task k`).

    Weights: the learner's shm board when `DRL_SHM_WEIGHTS_NAME` names
    one, TCP pulls otherwise (a failed attach or a dead board demotes to
    TCP). The first version is in before the replica serves: a replica
    answering ST_ERROR while the learner warms up would be demoted as dead.
    It serves OP_ACT (and GET_WEIGHTS from its local store) on
    `DRL_INFER_PORT`, else `server_port + 1000 + task`, registers with
    the learner's fleet supervisor, refreshes weights every
    `DRL_INFER_PULL_S` seconds, and acts with the seed `seed + 7777 + 131
    * task` (replicas must not explore in lockstep). It stops on SIGINT
    (the launcher's stop request) or once the learner has been gone for
    `grace` seconds, and prints one JSON line: acts served, batches,
    rows, admission rejects, weight versions seen and the kernels'
    launches in its process. -> that dict.

    Its TCP pulls are shard-scoped when the learner publishes per shard
    (`ShardedRemoteWeights` demotes itself to the whole-blob op
    otherwise), and `DRL_WEIGHTS_KEYS` scopes its refreshes to the named
    shards (`weight_shards.role_keys`)."""
    from distributed_reinforcement_learning_tpu_torch.runtime import fleet as fleet_mod
    from distributed_reinforcement_learning_tpu_torch.runtime import launch, weight_shards
    from distributed_reinforcement_learning_tpu_torch.runtime.transport import (
        RECONNECT_RETRIES, ShardedRemoteWeights, TransportClient, TransportError, TransportServer,
        _kernel_launches, resolve_learner_addr)
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore
    from distributed_reinforcement_learning_tpu_torch.utils.config import load_config
    from distributed_reinforcement_learning_tpu_torch.utils.device import resolve_device

    task = max(task, 0)
    device = resolve_device(device)
    agent_cfg, rt = load_config(config_path, section)
    if launch.algo_of(agent_cfg) != algo:
        raise ValueError(f"section {section!r} is a {launch.algo_of(agent_cfg)} section, "
                         f"not {algo}")
    port = _env_int("DRL_INFER_PORT", 0) or (rt.server_port + 1000 + task)
    host, lport = resolve_learner_addr(rt)
    agent = launch.make_agent(algo, agent_cfg, device=device, rt=rt, actor=True)
    # The first connect keeps the client's 60 retries (the learner may
    # start after the replica); from then on the grace loops own the
    # deadline.
    client = TransportClient(host, lport, reconnect_retries=RECONNECT_RETRIES)
    tcp_weights = ShardedRemoteWeights(client, "cpu", keys=weight_shards.role_keys())
    weights_src = tcp_weights
    board_name = os.environ.get("DRL_SHM_WEIGHTS_NAME", "").strip()
    if board_name:
        from distributed_reinforcement_learning_tpu_torch.runtime import weight_board

        bw = weight_board.attach_board_weights(board_name, client, fallback=tcp_weights,
                                               device="cpu")
        if bw is not None:
            weights_src = bw
            print(f"[infer {task}] shm weight board attached: {board_name}" if bw.attached else
                  f"[infer {task}] shm weight board {board_name} unavailable; starting "
                  f"demoted to TCP pulls (reattach ladder armed)", flush=True)
    local = WeightStore()
    versions_seen = 0
    version = -1
    deadline = time.monotonic() + grace
    while True:
        try:
            got = weights_src.get_if_newer(version)
        except (ConnectionError, OSError):
            got = None
        if got is not None:
            local.publish(got[0], got[1])
            version, versions_seen = got[1], versions_seen + 1
            break
        if time.monotonic() >= deadline:
            client.close()
            raise TransportError(f"learner at {host}:{lport} published no weights in "
                                 f"{grace:.0f}s")
        time.sleep(0.2)
    max_batch = _env_int("DRL_INFER_MAX_BATCH", 256)
    inference = ContinuousInferenceServer.for_agent(
        algo, agent, local, max_batch=max_batch, admission_rows=admission_budget(max_batch),
        seed=seed + 7777 + 131 * task)
    server = TransportServer(None, local, host="0.0.0.0", port=port,
                             inference=inference).start()
    heartbeats = fleet_mod.start_member_loop(
        rt, "inference", task,
        surfaces=[s for s in (weights_src, None if tcp_weights is weights_src else tcp_weights)
                  if hasattr(s, "reattach")],
        version_fn=lambda: local.version)
    if maybe_configure("inference", task, run_dir):
        _OBS.sample("inference/rows_served", lambda: inference.rows_served, kind="counter")
        _OBS.sample("inference/batches_run", lambda: inference.batches_run, kind="counter")
        _OBS.sample("inference/admission_rejects", inference.admission_reject_count,
                    kind="counter")
        _OBS.sample("inference/weight_version", lambda: local.version)
        for key in server.snapshot_stats():
            _OBS.sample(f"transport/{key}", lambda k=key: server.stat(k), kind="counter")
        if hasattr(weights_src, "snapshot_stats"):
            wprefix = getattr(weights_src, "telemetry_prefix", "board")
            for key in weights_src.snapshot_stats():
                _OBS.sample(f"{wprefix}/{key}", lambda k=key: weights_src.stat(k),
                            kind="counter")
        if heartbeats is not None:
            fleet_mod.register_member_telemetry(heartbeats)
    pull_s = float(os.environ.get("DRL_INFER_PULL_S", "0.2"))
    print(f"[infer {task}] serving acts on :{port} on {device} (weights v{version} from "
          f"{host}:{lport}, max_batch {max_batch}, budget {inference.admission_rows} rows)",
          flush=True)
    down_since: float | None = None
    try:
        while True:
            # Versions are identities (a rollback republish lands like
            # any other); the service's device cache follows them.
            try:
                got = weights_src.get_if_newer(version)
                if got is not None:
                    local.publish(got[0], got[1])
                    version, versions_seen = got[1], versions_seen + 1
                down_since = None
            except (ConnectionError, OSError):
                now = time.monotonic()
                down_since = down_since or now
                if now - down_since > grace:
                    print(f"[infer {task}] learner gone >{grace:.0f}s; exiting "
                          f"({inference.rows_served} rows served)", flush=True)
                    break
            time.sleep(pull_s)
    except KeyboardInterrupt:  # the cluster launcher's stop request
        print(f"[infer {task}] interrupted; stopping", flush=True)
    finally:
        if heartbeats is not None:  # stop probes before the surfaces close
            heartbeats.stop()
        server.stop()
        inference.stop()
        if hasattr(weights_src, "close"):
            weights_src.close()
        client.close()
        _OBS.close()
    summary = {"role": "inference", "task": task, "device": str(device), "port": port,
               "acts_served": server.stat("acts_served"),
               "act_busy_replies": server.stat("act_busy_replies"),
               **inference.stats(), "weight_versions_seen": versions_seen,
               "weight_version": version, "launches": _kernel_launches()}
    print(json.dumps(summary), flush=True)
    return summary
