"""The port's Anakin mesh and mesh-sharded tier seat against the JAX
package's (ROADMAP item 13b-ii): the twins of `tests/test_anakin_mesh.py`,
`tests/test_learner_tier.py:377` and `tests/test_parallel.py:162`.

The JAX side runs in this process on the conftest's virtual CPU devices,
from parameters that `models/convert.py` hands to the port. The port's
side is three worlds of gloo ranks on the CPU, each rank with its own
timeout, started once for the module (this file's `__main__` block is
one rank):

- a world of 2 ("w2"): the first seat of the tier twin at model 2, the
  Anakin loops at data 2 (IMPALA; Ape-X and R2D2 learning from JAX's
  ring shards with JAX's uniforms), the same-batch, count and guard
  twins, and an IMPALA runner over data 1 x model 2;
- a second world of 2 ("seat1"): the tier twin's other seat;
- a world of 4 ("w4"): Anakin IMPALA at data 2 x model 2, the "data
  axis only" guard, and the Ape-X runner's ingest over a model axis.

Tolerances are ROADMAP F14's (rtol 2e-4, atol 2e-5 after the steps), the
ring's indices exact, the IS weights within 1e-6; the tier seats within
rtol 1e-3 / atol 1e-6 of JAX's union-batch learner, as in JAX. The ranks of
a world hold bit for bit equal parameters.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-4, 2e-5
RANK_TIMEOUT_S = 170

# Anakin IMPALA: CartPole with a 5-way head aliased onto its 2 actions, 4
# envs (2 a data coordinate); LSTM 64 in the world of 4, so the model
# axis splits the fused gates kernel.
IMPALA_B = 4
IMPALA_CFG = dict(obs_shape=(4,), num_actions=5, trajectory=8, lstm_size=32,
                  start_learning_rate=5e-3, end_learning_rate=5e-3, entropy_coef=0.01,
                  baseline_loss_coef=0.5, learning_frame=10**9)
IMPALA_CASES = {"w2": dict(IMPALA_CFG), "w4": dict(IMPALA_CFG, lstm_size=64)}
IMPALA_MODEL = {"w2": 1, "w4": 2}
# Ape-X and R2D2 learning from a filled ring: 64 slots (32 a shard), a
# global batch of 8 (4 a rank).
RING_C, RING_B = 64, 8
APEX_CFG = dict(obs_shape=(4,), num_actions=2)
R2D2_CFG = dict(obs_shape=(4,), num_actions=2, seq_len=6, burn_in=2, lstm_size=16)
TIER_STEPS = 3
# The IMPALA runner over data 1 x model 2 (LSTM 64: the model axis splits
# the fused gates kernel).
RUNNER_CFG = dict(obs_shape=(4,), num_actions=2, trajectory=4, lstm_size=64,
                  start_learning_rate=1e-3, learning_frame=10**6)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ring_inputs(algo: str, seed: int) -> dict:
    """A full ring (global `[RING_C, ...]`, numpy), its priorities, beta
    and the per-shard uniforms' keys' seed."""
    rng = np.random.default_rng(seed)
    C, A = RING_C, 2
    if algo == "apex":
        storage = dict(
            state=rng.standard_normal((C, 4)).astype(np.float32),
            next_state=rng.standard_normal((C, 4)).astype(np.float32),
            previous_action=rng.integers(0, A, C).astype(np.int32),
            action=rng.integers(0, A, C).astype(np.int32),
            reward=rng.standard_normal(C).astype(np.float32),
            done=rng.random(C) < 0.2)
    else:
        T, H = R2D2_CFG["seq_len"], R2D2_CFG["lstm_size"]
        storage = dict(
            state=rng.standard_normal((C, T, 4)).astype(np.float32),
            previous_action=rng.integers(0, A, (C, T)).astype(np.int32),
            action=rng.integers(0, A, (C, T)).astype(np.int32),
            reward=rng.standard_normal((C, T)).astype(np.float32),
            done=rng.random((C, T)) < 0.1,
            initial_h=(0.1 * rng.standard_normal((C, H))).astype(np.float32),
            initial_c=(0.1 * rng.standard_normal((C, H))).astype(np.float32))
    return {"storage": storage, "priorities": rng.uniform(0.05, 2.0, C).astype(np.float32),
            "beta": np.float32(0.45)}


def _tier_fixture(obs_dim: int = 12, b: int = 16):
    """The union Ape-X batch of `tests/test_learner_tier.py`'s fixture,
    its halves and IS weights (numpy)."""
    from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexBatch

    rng = np.random.RandomState(0)
    union = ApexBatch(
        state=rng.rand(2 * b, obs_dim).astype(np.float32),
        next_state=rng.rand(2 * b, obs_dim).astype(np.float32),
        previous_action=rng.randint(0, 3, 2 * b).astype(np.int32),
        action=rng.randint(0, 3, 2 * b).astype(np.int32),
        reward=rng.randn(2 * b).astype(np.float32),
        done=(rng.rand(2 * b) < 0.1))
    halves = [ApexBatch(*(x[:b] for x in union)), ApexBatch(*(x[b:] for x in union))]
    return union, halves, np.ones(2 * b, np.float32)


# -- one rank (this file's __main__ block) ---------------------------------------
def _digest(params: dict) -> bytes:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode() + _np(params[k]).tobytes())
    return h.digest()


def _impala_case(inp: dict, kw: dict, model: int) -> dict:
    """One Anakin IMPALA update on this rank's rows of JAX's start, with
    its rows of JAX's actions and env draws."""
    from distributed_reinforcement_learning_tpu_torch.agents.impala import (
        ImpalaAgent, ImpalaConfig)
    from distributed_reinforcement_learning_tpu_torch.envs.cartpole_device import CartPoleState
    from distributed_reinforcement_learning_tpu_torch.parallel import make_mesh
    from distributed_reinforcement_learning_tpu_torch.runtime.anakin import AnakinImpala

    loop = AnakinImpala(ImpalaAgent(ImpalaConfig(**kw), device="cpu"), IMPALA_B,
                        mesh=make_mesh(model_parallel=model))
    st = loop.init(0)
    st.train = loop._sharded.init_state(params=inp["params"])
    c, n = loop.mesh.coords["data"], loop.num_envs_local
    rows = slice(c * n, (c + 1) * n)
    st.env = CartPoleState(**{k: torch.from_numpy(v[rows]) for k, v in inp["env"].items()})
    st.obs = torch.from_numpy(inp["obs"][rows])
    m = loop.update(st, actions=torch.from_numpy(inp["actions"][:, rows]),
                    env_draws=[torch.from_numpy(d[rows]) for d in inp["draws"]])
    whole = loop._sharded.gather_state(st.train)
    return {"params": {k: _np(v) for k, v in whole.params.items()},
            "metrics": {k: float(v) for k, v in m.items()},
            "obs": _np(st.obs), "local_bytes": loop._sharded.state_bytes(st.train),
            "whole_bytes": loop._sharded.state_bytes(whole), "digest": _digest(whole.params)}


def _replay_loop(algo: str, mesh, **kw):
    from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexAgent, ApexConfig
    from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Agent, R2D2Config
    from distributed_reinforcement_learning_tpu_torch.runtime.anakin_apex import AnakinApex
    from distributed_reinforcement_learning_tpu_torch.runtime.anakin_r2d2 import AnakinR2D2

    if algo == "apex":
        agent = ApexAgent(ApexConfig(**APEX_CFG), device="cpu")
        return AnakinApex(agent, mesh=mesh, **kw)
    return AnakinR2D2(R2D2Agent(R2D2Config(**kw.pop("cfg", R2D2_CFG)), device="cpu"),
                      mesh=mesh, **kw)


def _ring_case(algo: str, inp: dict, mesh) -> dict:
    """This rank's shard of JAX's ring: a sample with JAX's uniforms, then
    one learn with its write-back (`DataMeshReplayMixin._learn`)."""
    from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexBatch
    from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Batch
    from distributed_reinforcement_learning_tpu_torch.data import device_replay

    kw = dict(num_envs=2, batch_size=RING_B, capacity=RING_C)
    if algo == "apex":
        kw["steps_per_collect"] = 4
    loop = _replay_loop(algo, mesh, **kw)
    st = loop.init(0)
    st.train = loop.agent.sync_target(loop._sharded.init_state(params=inp["params"]))
    c, n = mesh.coords["data"], loop.capacity_local
    rows = slice(c * n, (c + 1) * n)
    cls = ApexBatch if algo == "apex" else R2D2Batch
    fields = {k: torch.from_numpy(np.ascontiguousarray(v[rows])) for k, v in inp["storage"].items()}
    for k in ("action", "previous_action"):
        fields[k] = fields[k].long()
    st.replay = device_replay.DeviceReplay(
        storage=cls(**fields), priorities=torch.from_numpy(inp["priorities"][rows].copy()),
        ptr=0, size=n, beta=np.float32(inp["beta"]))
    u = torch.from_numpy(inp["uniforms"][c])
    _, idx, weights = device_replay.sample(dataclasses.replace(st.replay), u, mesh)
    m = loop._learn(st, u)
    return {"idx": _np(idx), "weights": _np(weights),
            "params": {k: _np(v) for k, v in st.train.params.items()},
            "priorities": _np(st.replay.priorities), "loss": float(m["loss"]),
            "digest": _digest(st.train.params)}


def _same_batch_case(algo: str, mesh) -> dict:
    """Twin of `TestLearnAxisNameEquivalence`: the same batch on every
    rank through the sharded learner against the plain learn."""
    from distributed_reinforcement_learning_tpu_torch.agents.apex import (
        ApexAgent, ApexBatch, ApexConfig)
    from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import (
        R2D2Agent, R2D2Batch, R2D2Config)
    from distributed_reinforcement_learning_tpu_torch.parallel import ShardedLearner

    rng = np.random.default_rng(1)
    if algo == "apex":
        agent = ApexAgent(ApexConfig(**APEX_CFG), device="cpu")
        B = 8
        batch = ApexBatch(state=rng.standard_normal((B, 4)).astype(np.float32),
                          next_state=rng.standard_normal((B, 4)).astype(np.float32),
                          previous_action=np.zeros(B, np.int32), action=np.ones(B, np.int32),
                          reward=np.linspace(-1, 1, B).astype(np.float32),
                          done=np.arange(B) % 3 == 0)
        w = np.linspace(0.5, 1.0, B).astype(np.float32)
    else:
        agent = R2D2Agent(R2D2Config(**R2D2_CFG), device="cpu")
        B, T, H = 4, R2D2_CFG["seq_len"], R2D2_CFG["lstm_size"]
        batch = R2D2Batch(state=rng.standard_normal((B, T, 4)).astype(np.float32),
                          previous_action=np.zeros((B, T), np.int32),
                          action=np.ones((B, T), np.int32), reward=np.ones((B, T), np.float32),
                          done=np.zeros((B, T), bool), initial_h=np.zeros((B, H), np.float32),
                          initial_c=np.zeros((B, H), np.float32))
        w = np.ones(B, np.float32)
    plain, td, pm = agent.learn(agent.sync_target(agent.init_state(0)), batch, w)
    sl = ShardedLearner(agent, mesh, 2, 2)
    st, std, sm = sl.learn(agent.sync_target(sl.init_state(0)), batch, w)
    return {"param_err": max(float((st.params[k] - p).abs().max().detach())
                             for k, p in plain.params.items()),
            "td_err": float((std[:B] - td).abs().max()), "td_rows": int(std.shape[0]),
            "loss_err": abs(float(sm["loss"]) - float(pm["loss"])),
            "digest": _digest(st.params)}


def _counts_case(algo: str, mesh) -> dict:
    """Twin of `test_counts_and_finiteness` at the JAX test's local sizes,
    and what a rank holds: its rows of the ring and of the envs."""
    if algo == "apex":
        loop = _replay_loop("apex", mesh, num_envs=4, batch_size=8, capacity=256,
                            steps_per_collect=8, target_sync_interval=10,
                            updates_per_collect=2)
        collects, updates, width = 4, 5, loop.write_width
        local = loop.write_width_local
    else:
        loop = _replay_loop("r2d2", mesh, cfg=dict(R2D2_CFG, lstm_size=32), num_envs=4,
                            batch_size=4, capacity=64, target_sync_interval=10,
                            updates_per_collect=2)
        collects, updates, width = 3, 4, loop.num_envs
        local = loop.num_envs_local
    st = loop.init(0)
    st, _ = loop.collect_chunk(st, collects)
    size_after_collects = st.replay.size
    local_rows = {"priorities": st.replay.priorities.shape[0],
                  **{f: getattr(st.replay.storage, f).shape[0]
                     for f in st.replay.storage._fields},
                  "obs": st.obs.shape[0], "prev_action": st.prev_action.shape[0],
                  "episodes": st.episodes.shape[0]}
    want_rows = {k: loop.num_envs_local if k in ("obs", "prev_action", "episodes")
                 else loop.capacity_local for k in local_rows}
    st, m = loop.train_chunk(st, updates)
    return {"size": size_after_collects, "want_size": collects * local,
            "replay_size": float(m["replay_size"][-1]),
            "want_replay_size": min((collects + updates) * width, loop.capacity),
            "step": st.train.step, "want_step": updates * 2,
            "finite": bool(torch.isfinite(m["loss"]).all()
                           and torch.isfinite(m["grad_norm"]).all()),
            "local_rows": local_rows,
            "want_rows": want_rows, "capacity_local": loop.capacity_local,
            "digest": _digest(st.train.params)}


def _guard(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _runner_case(tmp: Path, rank: int, start: dict) -> dict:
    """Twin of `tests/test_parallel.py:162` over data 1 x model 2, from
    JAX's parameters `start`: the runner trains, publishes whole tensors,
    checkpoints them whole and restores a fresh learner to its slices.
    The batches it learned on go back for JAX's learner."""
    from distributed_reinforcement_learning_tpu_torch.agents.impala import (
        ImpalaAgent, ImpalaConfig)
    from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
    from distributed_reinforcement_learning_tpu_torch.envs.cartpole import VectorCartPole
    from distributed_reinforcement_learning_tpu_torch.parallel import make_mesh
    from distributed_reinforcement_learning_tpu_torch.runtime import impala_runner
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore
    from distributed_reinforcement_learning_tpu_torch.utils.checkpoint import Checkpointer

    mesh = make_mesh(model_parallel=2)
    agent = ImpalaAgent(ImpalaConfig(**RUNNER_CFG), device="cpu")
    weights = WeightStore()
    learner = impala_runner.ImpalaLearner(agent, TrajectoryQueue(capacity=64), weights,
                                          batch_size=4, mesh=mesh)
    learner.state = learner._sharded.init_state(params=start)
    weights.publish(learner.published_params(), 0)
    batches, learn = [], learner._learn

    def capture(state, batch):
        batches.append({k: (_np(v) if torch.is_tensor(v) else np.asarray(v))
                        for k, v in batch._asdict().items()})
        return learn(state, batch)

    learner._learn = capture
    # Both ranks share the data coordinate, so both see the same batches.
    actor = impala_runner.ImpalaActor(agent, VectorCartPole(num_envs=4, seed=0), learner.queue,
                                      weights, seed=1)
    result = impala_runner.run_sync(learner, [actor], num_updates=3)
    published, version = weights.get()
    whole = learner._sharded.gather_state(learner.state)
    out = {"train_steps": learner.train_steps, "version": version,
           "loss": float(result["last_metrics"]["total_loss"]),
           "sharded": sorted(learner._sharded.reducer.model_dims),
           "published_whole": all(torch.equal(torch.as_tensor(published[k]), v)
                                  for k, v in whole.params.items()),
           "local_shapes": {k: list(v.shape) for k, v in learner.state.params.items()},
           "whole_shapes": {k: list(v.shape) for k, v in whole.params.items()},
           "params": {k: _np(v) for k, v in whole.params.items()}, "batches": batches,
           "digest": _digest(whole.params)}
    ckpt = Checkpointer(tmp / f"ckpt_rank{rank}")
    learner.save_checkpoint(ckpt)
    saved = torch.load(ckpt.directory / f"ckpt_{3:010d}.pt", weights_only=True)
    out["saved_shapes"] = {k: list(v.shape) for k, v in saved["params"].items()}
    fresh = impala_runner.ImpalaLearner(agent, TrajectoryQueue(capacity=4), WeightStore(),
                                        batch_size=4, mesh=mesh, seed=5)
    out["restored"] = fresh.restore_checkpoint(ckpt)
    out["restored_step"] = fresh.train_steps
    out["restored_equal"] = all(
        torch.equal(getattr(fresh.state, f.name)[k], v)
        for f in dataclasses.fields(learner.state)
        if isinstance(getattr(learner.state, f.name), dict)
        for k, v in getattr(learner.state, f.name).items())
    out["restored_grad"] = all(p.requires_grad for p in fresh.state.params.values())
    got, version = fresh.weights.get()
    out["republished"] = version == 3 and all(torch.equal(torch.as_tensor(got[k]), v)
                                              for k, v in whole.params.items())
    learner.close()
    fresh.close()
    return out


def _apex_runner_case(start: dict) -> dict:
    """The Ape-X runner over data 2 x model 2 from JAX's parameters
    `start`: its ingest scores new unrolls under the whole parameters
    and target as of its last train call (each rank ingests at its own
    pace, so no collective runs there). The batches it learned on, its
    parameters after and the last scored unroll go back for JAX's
    learner."""
    from distributed_reinforcement_learning_tpu_torch.agents.apex import (
        ApexAgent, ApexBatch, ApexConfig)
    from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
    from distributed_reinforcement_learning_tpu_torch.parallel import make_mesh
    from distributed_reinforcement_learning_tpu_torch.runtime.apex_runner import ApexLearner
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

    agent = ApexAgent(ApexConfig(obs_shape=(12,), num_actions=3), device="cpu")
    weights = WeightStore()
    learner = ApexLearner(agent, TrajectoryQueue(capacity=16), weights, batch_size=8,
                          replay_capacity=256, train_start_unrolls=2,
                          mesh=make_mesh(model_parallel=2), init_seed=0)
    learner.state = agent.sync_target(learner._sharded.init_state(params=start))
    learner._refresh_whole(learner.state)
    learned, learn = [], learner._learn

    def capture(state, batch, is_weight):
        learned.append(({k: _np(torch.as_tensor(v)) for k, v in batch._asdict().items()},
                        _np(torch.as_tensor(is_weight))))
        return learn(state, batch, is_weight)

    learner._learn = capture
    rng = np.random.RandomState(3)

    def put(n: int) -> None:
        for _ in range(n):
            learner.queue.put(ApexBatch(
                state=rng.rand(8, 12).astype(np.float32),
                next_state=rng.rand(8, 12).astype(np.float32),
                previous_action=rng.randint(0, 3, 8).astype(np.int32),
                action=rng.randint(0, 3, 8).astype(np.int32),
                reward=rng.randn(8).astype(np.float32), done=rng.rand(8) < 0.1))

    scored = []
    add = learner._replay_add
    learner._replay_add = lambda td, flat: (scored.append((td, flat)), add(td, flat))
    put(3)
    while learner.ingest():
        pass
    steps = [learner.train() is not None for _ in range(2)]
    put(1)
    learner.ingest()
    sharded = learner._sharded
    whole = dataclasses.replace(learner.state, params=sharded.gather_params(learner.state.params),
                                target_params=sharded.gather_params(learner.state.target_params))
    td, flat = scored[-1]
    want = agent.td_error(whole, flat).numpy()
    published, version = weights.get()
    learner.close()
    return {"steps": steps, "ingested": learner.ingested_unrolls, "td_err": float(
        np.abs(td - want).max()), "version": version,
        "published_whole": all(torch.equal(published[k], v) for k, v in whole.params.items()),
        "learned": learned, "td": td, "flat": {k: np.asarray(v) for k, v in flat._asdict().items()},
        "params": {k: _np(v) for k, v in whole.params.items()}}


def _tier_seat(seat: int, addrs: list[str], start: dict) -> dict:
    """One rank of a mesh-sharded tier seat (a world of 2 at model 2,
    the learner an `ApexLearner` through `runner_learner`) from JAX's
    parameters `start`: TIER_STEPS allreduce steps on its half of the
    union batch, then one publish."""
    from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexAgent, ApexConfig
    from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
    from distributed_reinforcement_learning_tpu_torch.parallel import make_mesh
    from distributed_reinforcement_learning_tpu_torch.runtime import learner_tier
    from distributed_reinforcement_learning_tpu_torch.runtime.apex_runner import ApexLearner
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

    agent = ApexAgent(ApexConfig(obs_shape=(12,), num_actions=3), device="cpu")
    mesh = make_mesh(model_parallel=2)
    _, halves, isw = _tier_fixture()
    b = len(isw) // 2
    out = {}
    weights = WeightStore()
    learner = ApexLearner(agent, TrajectoryQueue(capacity=4), weights, batch_size=b,
                          replay_capacity=64, mesh=mesh, init_seed=0)
    learner.state = agent.sync_target(learner._sharded.init_state(params=start))
    learner._refresh_whole(learner.state)
    tier = None
    if mesh.rank == 0:
        tier = learner_tier.LearnerTier(seat, addrs, sync="allreduce", probe_interval_s=60.0)
        tier.collective.wait_s = 60.0
        tier.start()
        tier.attach(learner)
        out["plan_hash"] = tier._plan.plan_hash
        out["classes"] = sorted(tier._plan.classes)
        out["peers"] = tier.await_peers(60.0)
    else:
        learner_tier.follow_seat(learner)
    try:
        for _ in range(TIER_STEPS):
            learner.state, _, _ = learner._learn(learner.state, halves[seat], isw[:b])
        learner.train_steps = TIER_STEPS
        learner.sync_publish = True
        learner.maybe_publish()
        published, version = weights.get()
        whole = learner._sharded.gather_params(learner.state.params)
        out.update(params={k: _np(v) for k, v in whole.items()}, version=version,
                   published_whole=all(
                       list(torch.as_tensor(published[k]).shape) == list(v.shape)
                       and torch.equal(torch.as_tensor(published[k]), v)
                       for k, v in whole.items()),
                   local_bytes=sum(v.numel() for v in learner.state.params.values()),
                   whole_bytes=sum(v.numel() for v in whole.values()))
        if tier is not None:
            out["coll"] = tier.collective.snapshot_stats()
    finally:
        if tier is not None:
            tier.close()
    return out


def _rank_main(argv: list[str]) -> None:
    role, rank, world, port, in_path, out_path = (argv[0], int(argv[1]), int(argv[2]),
                                                  int(argv[3]), Path(argv[4]), argv[5])
    from distributed_reinforcement_learning_tpu_torch.parallel import distributed, make_mesh

    torch.set_num_threads(1)
    assert distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    inp = torch.load(in_path, weights_only=False)
    out = {"backend": distributed.backend()}
    if role in ("w2", "seat1"):
        out["tier"] = _tier_seat(0 if role == "w2" else 1, inp["addrs"], inp["tier_start"])
    if role == "w2":
        mesh = make_mesh()
        out["impala"] = _impala_case(inp["impala"], IMPALA_CASES[role], IMPALA_MODEL[role])
        for algo in ("apex", "r2d2"):
            out[f"{algo}_ring"] = _ring_case(algo, inp[algo], mesh)
            out[f"{algo}_same"] = _same_batch_case(algo, mesh)
            out[f"{algo}_counts"] = _counts_case(algo, mesh)
        out["divide_guard"] = _guard(lambda: _replay_loop(
            "apex", mesh, num_envs=3, batch_size=8, capacity=48, steps_per_collect=4))
        out["runner"] = _runner_case(in_path.parent, rank, inp["runner_start"])
    if role == "w4":
        out["impala"] = _impala_case(inp["impala"], IMPALA_CASES[role], IMPALA_MODEL[role])
        out["axis_guard"] = _guard(lambda: _replay_loop(
            "r2d2", make_mesh(model_parallel=2), num_envs=4, batch_size=4, capacity=64))
        out["apex_runner"] = _apex_runner_case(inp["apex_runner_start"])
    torch.save(out, out_path)
    distributed.shutdown()


# -- the JAX side --------------------------------------------------------------------
def _jax_impala_start(name: str) -> tuple:
    """JAX's Anakin IMPALA over its mesh from PRNGKey(1), with two carts
    near the 200-step cap; T steps of `_env_step` give the actions and
    env draws the port's ranks replay. -> (the port's inputs, the JAX
    loop, its state)."""
    import functools

    import jax
    import jax.numpy as jnp

    from distributed_reinforcement_learning_tpu import parallel as jpar
    from distributed_reinforcement_learning_tpu.agents.impala import ImpalaAgent, ImpalaConfig
    from distributed_reinforcement_learning_tpu.envs import cartpole_jax
    from distributed_reinforcement_learning_tpu.runtime.anakin import AnakinImpala, AnakinState
    from distributed_reinforcement_learning_tpu_torch.models.convert import impala_params_from_jax

    kw, model = IMPALA_CASES[name], IMPALA_MODEL[name]
    jan = AnakinImpala(ImpalaAgent(ImpalaConfig(**kw)), IMPALA_B,
                       mesh=jpar.make_mesh(2 * model, model_parallel=model))
    k_train, k_env, k_run = jax.random.split(jax.random.PRNGKey(1), 3)
    env, obs = jax.jit(cartpole_jax.reset, static_argnums=1)(k_env, IMPALA_B)
    env = env._replace(steps=jnp.asarray([197, 0, 192, 0], jnp.int32))
    h, c = jan.agent.initial_lstm_state(IMPALA_B)
    jst = AnakinState(jax.jit(jan.agent.init_state)(k_train), env, obs,
                      jnp.zeros(IMPALA_B, jnp.int32), h, c, k_run)
    step = jax.jit(functools.partial(jan._env_step, jst.train.params))
    carry, actions, draws = (env, obs, jst.prev_action, h, c, k_run), [], []
    for _ in range(kw["trajectory"]):
        _, _, k_e = jax.random.split(carry[-1], 3)  # `_env_step`'s own split
        draws.append(np.asarray(cartpole_jax._fresh(k_e, IMPALA_B)))
        carry, rec = step(carry, None)
        actions.append(np.asarray(rec["action"]))
    inp = {"params": impala_params_from_jax(jax.tree.map(np.asarray, jst.train.params)),
           "env": {k: np.asarray(v) for k, v in env._asdict().items()}, "obs": np.asarray(obs),
           "actions": np.stack(actions), "draws": draws}
    return inp, jan, jax.device_put(jst, jan._state_sharding), np.asarray(carry[1])


def _jax_impala_update(jan, jst) -> dict:
    """One update of JAX's mesh loop -> its parameters (the port's layout)
    and metrics."""
    import jax

    from distributed_reinforcement_learning_tpu_torch.models.convert import impala_params_from_jax

    state, m = jan.train_chunk(jst, 1)
    return {"params": {k: v.numpy() for k, v in impala_params_from_jax(
                jax.tree.map(np.asarray, jax.device_get(state.train.params))).items()},
            "metrics": {k: float(np.asarray(v)[-1]) for k, v in m.items()},
            "obs": np.asarray(state.obs)}


def _jax_ring(algo: str) -> tuple:
    """JAX's agent, ring and per-shard keys for a data-2 mesh. -> (the
    port's inputs, a thunk running JAX's sample + learn + write-back)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from distributed_reinforcement_learning_tpu import parallel as jpar
    from distributed_reinforcement_learning_tpu.agents import apex as japex
    from distributed_reinforcement_learning_tpu.agents import r2d2 as jr2d2
    from distributed_reinforcement_learning_tpu.data import device_replay as jdr
    from distributed_reinforcement_learning_tpu.runtime.anakin_mesh import replay_specs
    from distributed_reinforcement_learning_tpu_torch.models import convert

    if algo == "apex":
        agent, cls = japex.ApexAgent(japex.ApexConfig(**APEX_CFG)), japex.ApexBatch
        conv = convert.apex_params_from_jax
    else:
        agent, cls = jr2d2.R2D2Agent(jr2d2.R2D2Config(**R2D2_CFG)), jr2d2.R2D2Batch
        conv = convert.r2d2_params_from_jax
    state = jax.jit(lambda k: agent.sync_target(agent.init_state(k)))(jax.random.PRNGKey(2))
    inp = _ring_inputs(algo, 7 if algo == "apex" else 8)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    n = RING_B // 2
    inp["uniforms"] = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys])
    inp["params"] = conv(jax.tree.map(np.asarray, state.params))
    replay = jdr.DeviceReplay(storage=cls(**{k: jnp.asarray(v) for k, v in inp["storage"].items()}),
                              priorities=jnp.asarray(inp["priorities"]), ptr=jnp.int32(0),
                              size=jnp.int32(RING_C // 2), beta=jnp.float32(inp["beta"]))
    mesh = jpar.make_mesh(2)
    specs = replay_specs(cls(*([0] * len(cls._fields))))

    def body(train, rep, key):
        rep, batch, idx, w = jdr.sample(rep, key[0], n, axis_name="data")
        train, td, _ = agent._learn(train, batch, w, axis_name="data")
        rep = jdr.update_priorities(rep, idx, td)
        return train.params, rep.priorities, idx, w

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(), specs, P("data")),
                              out_specs=(P(), P("data"), P("data"), P("data")),
                              check_vma=False))

    def run() -> dict:
        params, prio, idx, w = f(state, replay, keys)
        return {"params": {k: v.numpy() for k, v in conv(jax.tree.map(np.asarray, params)).items()},
                "priorities": np.asarray(prio), "idx": np.asarray(idx), "weights": np.asarray(w)}

    return inp, run


def _jax_tier_union() -> tuple[dict, dict]:
    """The union-batch learner of `tests/test_learner_tier.py:377`: JAX's
    `ShardedLearner` at data 1 x model 2, TIER_STEPS steps on
    `_tier_fixture`'s union batch. -> (its start parameters and its
    parameters after, in the port's layout)."""
    import jax

    from distributed_reinforcement_learning_tpu import parallel as jpar
    from distributed_reinforcement_learning_tpu.agents import apex as japex
    from distributed_reinforcement_learning_tpu_torch.models.convert import apex_params_from_jax

    agent = japex.ApexAgent(japex.ApexConfig(obs_shape=(12,), num_actions=3))
    sl = jpar.ShardedLearner(agent, jpar.make_mesh(2, model_parallel=2), num_data_args=2,
                             num_aux_outputs=2)
    s = sl.place_state(agent.sync_target(agent.init_state(jax.random.PRNGKey(0))))
    # np.array copies: the learn step donates the state's buffers.
    start = apex_params_from_jax(jax.tree.map(np.array, s.params))
    union, _, isw = _tier_fixture()
    batch = japex.ApexBatch(**union._asdict())
    for _ in range(TIER_STEPS):
        s, _, _ = sl.learn(s, *sl.shard_batch((batch, isw)))
    after = apex_params_from_jax(jax.tree.map(np.array, s.params))
    return start, {k: v.numpy() for k, v in after.items()}


def _jax_runner_start() -> tuple:
    """JAX's IMPALA agent and train state for the runner twin. -> (its
    parameters in the port's layout, the agent, the state)."""
    import jax

    from distributed_reinforcement_learning_tpu.agents.impala import ImpalaAgent, ImpalaConfig
    from distributed_reinforcement_learning_tpu_torch.models.convert import impala_params_from_jax

    agent = ImpalaAgent(ImpalaConfig(**RUNNER_CFG))
    state = jax.jit(agent.init_state)(jax.random.PRNGKey(4))
    return impala_params_from_jax(jax.tree.map(np.array, state.params)), agent, state


def _jax_runner_learn(agent, state, batches: list[dict]) -> dict:
    """JAX's runner learner (`ShardedLearner` at data 1 x model 2) on
    the port runner's batches -> its parameters in the port's layout."""
    import jax

    from distributed_reinforcement_learning_tpu import parallel as jpar
    from distributed_reinforcement_learning_tpu.agents.impala import ImpalaBatch
    from distributed_reinforcement_learning_tpu_torch.models.convert import impala_params_from_jax

    sl = jpar.ShardedLearner(agent, jpar.make_mesh(2, model_parallel=2))
    s = sl.place_state(state)
    for b in batches:
        b = {k: v.astype(np.int32) if v.dtype == np.int64 else v for k, v in b.items()}
        s, _ = sl.learn(s, *sl.shard_batch((ImpalaBatch(**b),)))
    return {k: v.numpy() for k, v in impala_params_from_jax(
        jax.tree.map(np.array, s.params)).items()}


def _jax_apex_runner_start() -> tuple:
    """JAX's Ape-X agent and train state for the Ape-X runner at data 2
    x model 2. -> (its parameters in the port's layout, the agent, the
    state)."""
    import jax

    from distributed_reinforcement_learning_tpu.agents import apex as japex
    from distributed_reinforcement_learning_tpu_torch.models.convert import apex_params_from_jax

    agent = japex.ApexAgent(japex.ApexConfig(obs_shape=(12,), num_actions=3))
    state = jax.jit(lambda k: agent.sync_target(agent.init_state(k)))(jax.random.PRNGKey(5))
    return apex_params_from_jax(jax.tree.map(np.array, state.params)), agent, state


def _jax_apex_runner_learn(agent, state, ranks: list[dict]) -> dict:
    """JAX's `ShardedLearner` at data 2 x model 2 on the union of the
    port runner's batches (data coordinate c is rank 2c's) and JAX's
    |TD| of its last scored unroll. -> (parameters in the port's
    layout, |TD|)."""
    import jax

    from distributed_reinforcement_learning_tpu import parallel as jpar
    from distributed_reinforcement_learning_tpu.agents.apex import ApexBatch
    from distributed_reinforcement_learning_tpu_torch.models.convert import apex_params_from_jax

    i32 = lambda b: ApexBatch(**{k: v.astype(np.int32) if v.dtype == np.int64 else v
                                 for k, v in b.items()})
    sl = jpar.ShardedLearner(agent, jpar.make_mesh(4, model_parallel=2), num_data_args=2,
                             num_aux_outputs=2)
    s = sl.place_state(state)
    for step in zip(*(ranks[c]["learned"] for c in (0, 2))):
        batch = jax.tree.map(lambda *x: np.concatenate(x), *(b for b, _ in step))
        w = np.concatenate([w for _, w in step])
        s, _, _ = sl.learn(s, *sl.shard_batch((i32(batch), w)))
    td = np.asarray(agent.td_error(jax.device_get(s), i32(ranks[0]["flat"])))
    return {"params": {k: v.numpy() for k, v in apex_params_from_jax(
        jax.tree.map(np.array, s.params)).items()}, "td": td}


def _start_world(role: str, world: int, tmp: Path, inp: dict) -> list:
    in_path = tmp / f"in_{role}.pt"
    torch.save(inp, in_path)
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "DRL_NO_GYMNASIUM": "1",
           "DRL_COLL_PARTITION": "1", "DRL_COLL_QUANT": "f32", "DRL_COLL_OVERLAP": "0",
           "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))}
    env.pop("DRL_ASYNC_PUBLISH", None)
    procs = []
    for r in range(world):
        out = tmp / f"out_{role}_{r}.pt"
        procs.append((subprocess.Popen(
            [sys.executable, __file__, role, str(r), str(world), str(port), str(in_path),
             str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), out))
    return procs


def _join(procs: list) -> list[dict]:
    outs = []
    for proc, path in procs:
        try:
            log, _ = proc.communicate(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p, _ in procs:
                p.kill()
            raise
        assert proc.returncode == 0, log[-4000:]
        outs.append(torch.load(path, weights_only=False))
    return outs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three worlds' rank results and the JAX results; JAX's steps
    run while the ranks do."""
    from threadpoolctl import threadpool_limits

    tmp = tmp_path_factory.mktemp("anakin_mesh")
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            starts = {name: _jax_impala_start(name) for name in IMPALA_CASES}
            rings = {algo: _jax_ring(algo) for algo in ("apex", "r2d2")}
            tier_start, tier_union = _jax_tier_union()
            runner_start, runner_agent, runner_state = _jax_runner_start()
            apex_start, apex_agent, apex_state = _jax_apex_runner_start()
            addrs = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
            seat = {"addrs": addrs, "tier_start": tier_start}
            # At most four ranks at a time: the worlds of 2 first, then w4.
            procs = {
                "w2": _start_world("w2", 2, tmp, {**seat, "impala": starts["w2"][0],
                                                  "runner_start": runner_start,
                                                  **{a: r[0] for a, r in rings.items()}}),
                "seat1": _start_world("seat1", 2, tmp, seat)}
            jax_out = {f"impala_{name}": _jax_impala_update(jan, jst)
                       for name, (_, jan, jst, _) in starts.items()}
            jax_out.update({f"{algo}_ring": run() for algo, (_, run) in rings.items()})
            jax_out["rollout_obs"] = {name: s[3] for name, s in starts.items()}
            jax_out["tier_union"] = tier_union
            ranks = {role: _join(p) for role, p in procs.items()}
            ranks["w4"] = _join(_start_world("w4", 4, tmp, {"impala": starts["w4"][0],
                                                            "apex_runner_start": apex_start}))
            jax_out["apex_runner"] = _jax_apex_runner_learn(
                apex_agent, apex_state, [r["apex_runner"] for r in ranks["w4"]])
            jax_out["runner"] = _jax_runner_learn(runner_agent, runner_state,
                                                  ranks["w2"][0]["runner"]["batches"])
    finally:
        torch.set_num_threads(n_threads)
    return types.SimpleNamespace(ranks=ranks, jax=jax_out)


def _close(got: dict, want: dict, what: str, rtol: float = RTOL, atol: float = ATOL) -> None:
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=f"{what} {k}")


# -- Anakin IMPALA ----------------------------------------------------------------------
@pytest.mark.parametrize("role", ["w2", "w4"])
def test_anakin_impala_matches_jax_mesh(worlds, role):
    """One update at data 2 (w2) and data 2 x model 2 (w4): every rank's
    gathered parameters and the summed metrics at JAX's mesh loop's, the
    ranks bit for bit equal, and the rows each stepped JAX's."""
    want = worlds.jax[f"impala_{role}"]
    # JAX's mesh loop stepped the same carts as its one-device rollout.
    np.testing.assert_array_equal(want["obs"], worlds.jax["rollout_obs"][role])
    ranks = worlds.ranks[role]
    n = IMPALA_B // 2
    for r, got in enumerate(ranks):
        assert got["backend"] == "gloo"
        g = got["impala"]
        _close(g["params"], want["params"], f"{role} rank {r} params")
        c = r // IMPALA_MODEL[role]
        np.testing.assert_allclose(g["obs"], want["obs"][c * n:(c + 1) * n], rtol=0, atol=1e-6)
        for k in ("total_loss", "pi_loss", "baseline_loss", "entropy", "episode_return_sum",
                  "episodes_done", "boundaries_done"):
            np.testing.assert_allclose(g["metrics"][k], want["metrics"][k], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{role} {k}")
        assert g["digest"] == ranks[0]["impala"]["digest"]
    assert want["metrics"]["boundaries_done"] > 0  # resets inside the collect


def test_anakin_impala_model_axis_holds_slices(worlds):
    """At model 2 a rank holds about half of the state's bytes."""
    g = worlds.ranks["w4"][0]["impala"]
    assert 0.45 * g["whole_bytes"] < g["local_bytes"] < 0.6 * g["whole_bytes"], g
    g = worlds.ranks["w2"][0]["impala"]
    assert g["local_bytes"] == g["whole_bytes"]


# -- Ape-X and R2D2 over a data axis --------------------------------------------------------
@pytest.mark.parametrize("algo", ["apex", "r2d2"])
def test_ring_shards_sample_learn_and_write_back_as_jax(worlds, algo):
    """Each rank's shard of JAX's ring with JAX's uniforms: the indices
    exact, the IS weights (normalised by the global maximum) within 1e-6,
    the parameters after the learn within F14's tolerance, each shard's
    priorities after the write-back of its own rows at JAX's."""
    want = worlds.jax[f"{algo}_ring"]
    n, cap = RING_B // 2, RING_C // 2
    ranks = [r[f"{algo}_ring"] for r in worlds.ranks["w2"]]
    for c, got in enumerate(ranks):
        np.testing.assert_array_equal(got["idx"], want["idx"][c * n:(c + 1) * n])
        np.testing.assert_allclose(got["weights"], want["weights"][c * n:(c + 1) * n],
                                   rtol=0, atol=1e-6)
        _close(got["params"], want["params"], f"{algo} rank {c} params")
        np.testing.assert_allclose(got["priorities"], want["priorities"][c * cap:(c + 1) * cap],
                                   rtol=RTOL, atol=ATOL, err_msg=f"{algo} rank {c} priorities")
        assert got["digest"] == ranks[0]["digest"]
    # The global maximum: the largest weight over both ranks is 1.
    assert max(r["weights"].max() for r in ranks) == pytest.approx(1.0, abs=1e-7)


@pytest.mark.parametrize("algo", ["apex", "r2d2"])
def test_same_batch_on_every_rank_matches_single_device(worlds, algo):
    """Twin of `TestLearnAxisNameEquivalence`: the mean of identical
    gradients is the identity, so the step is the plain one."""
    ranks = [r[f"{algo}_same"] for r in worlds.ranks["w2"]]
    for got in ranks:
        assert got["param_err"] <= 1e-6 and got["td_err"] <= 1e-6 and got["loss_err"] <= 1e-6
        assert got["digest"] == ranks[0]["digest"]
    assert ranks[0]["td_rows"] == 2 * (8 if algo == "apex" else 4)  # the global rows


@pytest.mark.parametrize("algo", ["apex", "r2d2"])
def test_counts_local_sizes_and_global_replay_size(worlds, algo):
    """Twin of `test_counts_and_finiteness`: a rank's ring holds its
    shard's count, the metric the global one, the step count K a
    collect; each rank holds half the ring; the ranks stay equal."""
    ranks = [r[f"{algo}_counts"] for r in worlds.ranks["w2"]]
    for got in ranks:
        assert got["size"] == got["want_size"]
        assert got["replay_size"] == got["want_replay_size"]
        assert got["step"] == got["want_step"] and got["finite"]
        assert got["digest"] == ranks[0]["digest"]
        assert got["local_rows"] == got["want_rows"]
        assert 2 * got["capacity_local"] == (256 if algo == "apex" else 64)


def test_replay_guards(worlds):
    """The JAX guards, word for word: a non-data axis, a size that does
    not divide."""
    assert "data axis only" in worlds.ranks["w4"][0]["axis_guard"]
    assert "must divide over the data axis (2)" in worlds.ranks["w2"][0]["divide_guard"]


def test_validate_data_mesh_without_a_world():
    from distributed_reinforcement_learning_tpu_torch.parallel import make_mesh
    from distributed_reinforcement_learning_tpu_torch.runtime.anakin_mesh import (
        rank_generator, validate_data_mesh)

    assert validate_data_mesh(None, num_envs=3) == 1
    assert validate_data_mesh(make_mesh(), num_envs=3) == 1
    with pytest.raises(TypeError, match="RankMesh"):
        validate_data_mesh(object())
    # Data coordinate 0 draws the plain loop's stream.
    a = rank_generator(4, "cpu", make_mesh())
    b = torch.Generator().manual_seed(4)
    assert torch.equal(torch.rand(3, generator=a), torch.rand(3, generator=b))


# -- the runner over a model axis --------------------------------------------------------------
def test_runner_over_a_model_axis_publishes_and_checkpoints_whole(worlds):
    """Twin of `tests/test_parallel.py:162` at data 1 x model 2; and the
    Ape-X runner's ingest scoring under the whole parameters at data 2 x
    model 2. Both runners' parameters at JAX's learner's on the batches
    they learned on, and the scored |TD| at JAX's."""
    runs = [r["runner"] for r in worlds.ranks["w2"]]
    for run in runs:
        assert run["train_steps"] == 3 and run["version"] == 3 and np.isfinite(run["loss"])
        # Both ranks share the data coordinate, so both learned JAX's batches.
        assert len(run["batches"]) == 3
        _close(run["params"], worlds.jax["runner"], "runner params")
        assert "lstm.gates_kernel" in run["sharded"]
        assert run["published_whole"]
        assert run["saved_shapes"] == run["whole_shapes"]
        assert run["local_shapes"] != run["whole_shapes"]
        assert run["restored"] and run["restored_step"] == 3
        assert run["restored_equal"] and run["restored_grad"] and run["republished"]
    assert runs[0]["digest"] == runs[1]["digest"]
    want = worlds.jax["apex_runner"]
    for rank in worlds.ranks["w4"]:
        apex = rank["apex_runner"]
        assert apex["steps"] == [True, True] and apex["ingested"] == 4 and apex["version"] == 2
        assert apex["td_err"] == 0.0 and apex["published_whole"]
        _close(apex["params"], want["params"], "apex runner params")
        np.testing.assert_allclose(apex["td"], want["td"], rtol=RTOL, atol=ATOL)


# -- the mesh-sharded tier seat ------------------------------------------------------------
def test_mesh_seats_track_union_sharded_learner(worlds):
    """Twin of `tests/test_learner_tier.py:377`: two seats, each a world
    of 2 at model 2, 3 allreduce steps on their halves; the seats bit
    for bit equal, within rtol 1e-3 / atol 1e-6 of the union-batch
    `ShardedLearner` of JAX from the same parameters; the plan's `-,model`
    class owner-scoped; each seat's publish whole."""
    seat0, seat1 = worlds.ranks["w2"], worlds.ranks["seat1"]
    leads = [seat0[0]["tier"], seat1[0]["tier"]]
    assert leads[0]["plan_hash"] == leads[1]["plan_hash"]
    assert "-,model" in leads[0]["classes"]
    assert all(lead["peers"] for lead in leads)
    union = worlds.jax["tier_union"]
    first = seat0[0]["tier"]["params"]
    for rank in seat0 + seat1:
        t = rank["tier"]
        for k, v in first.items():
            assert np.array_equal(t["params"][k], v), k
        _close(t["params"], union, "tier seat", rtol=1e-3, atol=1e-6)
        assert t["published_whole"] and t["version"] == TIER_STEPS
        assert 0.45 * t["whole_bytes"] < t["local_bytes"] < 0.6 * t["whole_bytes"]
    for lead in leads:
        assert lead["coll"]["coll_rounds_part"] == TIER_STEPS
        assert lead["coll"]["coll_bytes_model"] > 0


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
