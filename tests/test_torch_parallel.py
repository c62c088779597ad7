"""The port's mesh of ranks and sharded learner against the JAX package's
(`tests/test_parallel.py`'s twins, ROADMAP item 13b's learner half).

The JAX side runs in this process: `ShardedLearner` on the conftest's
8-device CPU mesh, from parameters that `models/convert.py` hands to the
port. The port's side is a world of ranks over gloo on the CPU: this
file's `__main__` block is one rank (`_rank_main`); a module fixture
starts a world of 2 and a world of 4, each rank with its own timeout,
and every case below reads their results. Held at JAX's own tolerance
after 3 steps (rtol 2e-4, atol 2e-5, `tests/test_parallel.py:31-32`):

- data parallelism (IMPALA, Ape-X, R2D2 at data 2), the model axis
  (R2D2 at model 2) and both (IMPALA and R2D2 at data 2 x model 2),
  with the ranks bit for bit equal to each other;
- the model axis really splitting the kernels and moments: the leaves
  JAX shards, along the dimension that holds the flax kernel's last
  (`models/convert.py:flax_last_dim`), and the bytes a rank holds;
- the mesh's shape and refusals, `distributed.initialize`'s no-op,
  the mesh-wired IMPALA learner training, `learn_many` over the mesh
  with and without the prefetcher;
- the agents' reduction seam alone (sum for IMPALA, mean for the replay
  families), and what each package writes back to the replay from a
  step's global priorities (ROADMAP F15).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_reinforcement_learning_tpu_torch.agents.apex import (
    ApexAgent, ApexBatch, ApexConfig)
from distributed_reinforcement_learning_tpu_torch.agents.impala import (
    ImpalaAgent, ImpalaConfig)
from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import (
    R2D2Agent, R2D2Batch, R2D2Config)
from distributed_reinforcement_learning_tpu_torch.parallel import (
    MODEL_AXIS, ShardedLearner, distributed, make_mesh)
from distributed_reinforcement_learning_tpu_torch.parallel.mesh import mesh_shape
from distributed_reinforcement_learning_tpu_torch.utils.synthetic import synthetic_impala_batch

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-4, 2e-5
STEPS = 3
RANK_TIMEOUT_S = 150

# The cases, by world size: (family, config kwargs, batch rows, model axis).
CASES = {
    2: {
        "impala_dp": ("impala", dict(obs_shape=(4,), num_actions=3, lstm_size=32, trajectory=6),
                      8, 1),
        "apex_dp": ("apex", dict(obs_shape=(5,), num_actions=3), 16, 1),
        "r2d2_dp": ("r2d2", dict(obs_shape=(2,), num_actions=2, seq_len=6, burn_in=2,
                                 lstm_size=64), 8, 1),
        "r2d2_tp": ("r2d2", dict(obs_shape=(2,), num_actions=2, seq_len=6, burn_in=2,
                                 lstm_size=64), 8, 2),
    },
    4: {
        "impala_dptp": ("impala", dict(obs_shape=(4,), num_actions=3, lstm_size=64,
                                       trajectory=6), 8, 2),
        "r2d2_dptp": ("r2d2", dict(obs_shape=(2,), num_actions=2, seq_len=6, burn_in=2,
                                   lstm_size=64), 8, 2),
    },
}
_AGENTS = {"impala": (ImpalaAgent, ImpalaConfig), "apex": (ApexAgent, ApexConfig),
           "r2d2": (R2D2Agent, R2D2Config)}


def _batch(algo: str, kw: dict, B: int, seed: int):
    """One union batch (numpy) and its IS weights (None for IMPALA)."""
    if algo == "impala":
        return synthetic_impala_batch(B, kw["trajectory"], kw["obs_shape"], kw["num_actions"],
                                      kw["lstm_size"], seed=seed, obs_dtype=np.float32), None
    rng = np.random.default_rng(seed)
    A = kw["num_actions"]
    if algo == "apex":
        batch = ApexBatch(
            state=rng.random((B, *kw["obs_shape"]), dtype=np.float32),
            next_state=rng.random((B, *kw["obs_shape"]), dtype=np.float32),
            previous_action=rng.integers(0, A, (B,)).astype(np.int32),
            action=rng.integers(0, A, (B,)).astype(np.int32),
            reward=rng.random((B,), dtype=np.float32),
            done=rng.random((B,)) < 0.1)
    else:
        T, H = kw["seq_len"], kw["lstm_size"]
        batch = R2D2Batch(
            state=rng.integers(0, 255, (B, T, *kw["obs_shape"])).astype(np.int32),
            previous_action=rng.integers(0, A, (B, T)).astype(np.int32),
            action=rng.integers(0, A, (B, T)).astype(np.int32),
            reward=rng.random((B, T), dtype=np.float32),
            done=rng.random((B, T)) < 0.1,
            initial_h=rng.standard_normal((B, H)).astype(np.float32) * 0.1,
            initial_c=rng.standard_normal((B, H)).astype(np.float32) * 0.1)
    return batch, rng.random((B,), dtype=np.float32)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


# -- one rank (this file's __main__ block) ---------------------------------
def _run_case(algo, kw, B, model, params, seed0):
    """STEPS sharded steps from `params` -> the rank's results."""
    agent_cls, cfg_cls = _AGENTS[algo]
    agent = agent_cls(cfg_cls(**kw), device="cpu")
    mesh = make_mesh(model_parallel=model)
    sl = ShardedLearner(agent, mesh, *(2, 2) if algo != "impala" else (1, 1))
    state = sl.init_state(params=params)
    out = {"metrics": [], "rows": [], "bytes": (sl.state_bytes(state),
                                                sl.state_bytes(sl.gather_state(state))),
           "specs": {k: list(p.spec) for k, p in sl.state_sharding.items()}}
    for step in range(STEPS):
        batch, w = _batch(algo, kw, B, seed0 + step)
        if algo == "impala":
            state, m = sl.learn(state, sl.shard_batch(batch))
        else:
            state, rows, m = sl.learn(state, *sl.shard_batch((batch, w)))
            out["rows"].append(_np(rows))
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["params"] = {k: _np(v) for k, v in sl.gather_state(state).params.items()}
    return out


def _runner_cases(rank: int) -> dict:
    """The mesh-wired IMPALA learner: run_sync with an actor, and K = 2
    calls over the mesh without and with the prefetcher."""
    from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
    from distributed_reinforcement_learning_tpu_torch.envs.cartpole import VectorCartPole
    from distributed_reinforcement_learning_tpu_torch.runtime import impala_runner
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

    out = {}
    mesh = make_mesh()
    cfg = ImpalaConfig(obs_shape=(4,), num_actions=2, trajectory=4, lstm_size=16,
                       start_learning_rate=1e-3, learning_frame=10**6)
    agent = ImpalaAgent(cfg, device="cpu")
    weights = WeightStore()
    queue = TrajectoryQueue(capacity=64)
    learner = impala_runner.ImpalaLearner(agent, queue, weights, batch_size=4, mesh=mesh)
    actor = impala_runner.ImpalaActor(agent, VectorCartPole(num_envs=4, seed=rank), queue,
                                      weights, seed=1 + rank)
    result = impala_runner.run_sync(learner, [actor], num_updates=3)
    _, version = weights.get()
    out["runner"] = {"train_steps": learner.train_steps, "version": version,
                     "loss": float(result["last_metrics"]["total_loss"]),
                     "placed": learner._batch_sharding is not None,
                     "param0": float(next(iter(learner.state.params.values())).sum())}
    # learn_many over the mesh against K sequential sharded steps.
    kw = dict(obs_shape=(4,), num_actions=3, lstm_size=32, trajectory=6)
    agent = ImpalaAgent(ImpalaConfig(**kw), device="cpu")
    sl = ShardedLearner(agent, mesh)
    batches = [_batch("impala", kw, 8, 10 + i)[0] for i in range(STEPS)]
    seq = sl.init_state(1)
    for b in batches:
        seq, _ = sl.learn(seq, sl.shard_batch(b))
    from distributed_reinforcement_learning_tpu_torch.data.fifo import stack_pytrees

    stacked = sl.shard_batch(type(batches[0])(*(np.swapaxes(x, 0, 1) for x in stack_pytrees(
        batches))))  # rows are split on the batch dim: [B, K, ...] -> this rank's rows
    stacked = type(stacked)(*(x.transpose(0, 1) for x in stacked))
    many, metrics = sl.learn_many(sl.init_state(1), stacked)
    out["learn_many"] = {"step": many.step, "k": int(metrics["total_loss"].shape[0]),
                         "seq": {k: _np(v) for k, v in seq.params.items()},
                         "many": {k: _np(v) for k, v in many.params.items()}}
    for prefetch in (False, True):
        queue = TrajectoryQueue(capacity=64)
        for i in range(16):
            b, _ = _batch("impala", kw, 1, 50 + 16 * rank + i)
            queue.put(type(b)(*(x[0] for x in b)))
        learner = impala_runner.ImpalaLearner(agent, queue, WeightStore(), batch_size=4,
                                              mesh=mesh, updates_per_call=2, prefetch=prefetch)
        try:
            ok = learner.step(timeout=20.0) is not None
            out[f"k2_prefetch_{prefetch}"] = {"ok": ok, "train_steps": learner.train_steps}
        finally:
            learner.close()
    try:
        make_mesh(1)
    except ValueError as e:
        out["smaller_mesh"] = str(e)
    return out


def _rank_main(argv: list[str]) -> None:
    rank, world, port, in_path, out_path = (int(argv[0]), int(argv[1]), int(argv[2]),
                                            argv[3], argv[4])
    torch.set_num_threads(1)
    assert distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    params = torch.load(in_path)
    results = {name: _run_case(algo, kw, B, model, params[name], seed0=100 * i)
               for i, (name, (algo, kw, B, model)) in enumerate(CASES[world].items())}
    if world == 2:
        results.update(_runner_cases(rank))
    results["backend"] = distributed.backend()
    torch.save(results, out_path)
    distributed.shutdown()


# -- the JAX side ------------------------------------------------------------
def _jax_run(name: str, algo: str, kw: dict, B: int, model: int, seed0: int):
    """The JAX ShardedLearner on the 8-device mesh: (initial params in the
    port's layout, the results after STEPS steps, JAX's param specs)."""
    import jax
    import jax.numpy as jnp

    from distributed_reinforcement_learning_tpu import parallel as jpar
    from distributed_reinforcement_learning_tpu.agents import apex as japex
    from distributed_reinforcement_learning_tpu.agents import impala as jimpala
    from distributed_reinforcement_learning_tpu.agents import r2d2 as jr2d2
    from distributed_reinforcement_learning_tpu_torch.models import convert

    mod, conv = {"impala": (jimpala, convert.impala_params_from_jax),
                 "apex": (japex, convert.apex_params_from_jax),
                 "r2d2": (jr2d2, convert.r2d2_params_from_jax)}[algo]
    names = {"impala": "Impala", "apex": "Apex", "r2d2": "R2D2"}[algo]
    agent = getattr(mod, f"{names}Agent")(getattr(mod, f"{names}Config")(**kw))
    jbatch_cls = getattr(mod, f"{names}Batch")
    mesh = jpar.make_mesh(8, model_parallel=model)
    n = 1 if algo == "impala" else 2
    learner = jpar.ShardedLearner(agent, mesh, num_data_args=n, num_aux_outputs=n)
    state = learner.init_state(jax.random.PRNGKey(1))
    to_np = lambda tree: jax.tree.map(np.asarray, jax.device_get(tree))
    init = conv(to_np(state.params))
    flags = conv(jax.tree.map(lambda s, x: np.full(np.shape(x), float(MODEL_AXIS in tuple(s.spec))),
                              jax.tree.map(lambda x: x.sharding, state.params), state.params))
    out = {"metrics": [], "rows": []}
    for step in range(STEPS):
        batch, w = _batch(algo, kw, B, seed0 + step)
        jb = jbatch_cls(**{k: jnp.asarray(v) for k, v in batch._asdict().items()})
        if algo == "impala":
            state, m = learner.learn(state, learner.shard_batch(jb))
        else:
            state, rows, m = learner.learn(state, *learner.shard_batch((jb, w)))
            out["rows"].append(np.asarray(rows))
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["params"] = {k: v.numpy() for k, v in conv(to_np(state.params)).items()}
    return init, out, {k: bool(v.numpy().ravel()[0]) for k, v in flags.items()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_world(world: int, tmp: Path, params: dict) -> list:
    in_path = tmp / f"params_{world}.pt"
    torch.save(params, in_path)
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "DRL_NO_GYMNASIUM": "1",
           "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))}
    return [(subprocess.Popen([sys.executable, __file__, str(r), str(world), str(port),
                               str(in_path), str(tmp / f"out_{world}_{r}.pt")],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True), tmp / f"out_{world}_{r}.pt") for r in range(world)]


def _join_world(procs: list) -> list[dict]:
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
    """{world: [rank results]} for the worlds of 2 and 4, and the JAX
    results of every case; the JAX steps run while the ranks do."""
    tmp = tmp_path_factory.mktemp("worlds")
    jax_out, flags, procs = {}, {}, {}
    inits = {}
    for world, cases in CASES.items():
        for i, (name, (algo, kw, B, model)) in enumerate(cases.items()):
            inits[name], jax_out[name], flags[name] = _jax_run(name, algo, kw, B, model, 100 * i)
        procs[world] = _start_world(world, tmp, {name: inits[name] for name in cases})
    ranks = {world: _join_world(p) for world, p in procs.items()}
    return types.SimpleNamespace(ranks=ranks, jax=jax_out, flags=flags)


def _close(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")


# -- the mesh ------------------------------------------------------------------
def test_mesh_shape():
    shape = mesh_shape(8, model_parallel=2)
    assert shape["data"] == 4 and shape["model"] == 2
    assert list(shape) == ["pipe", "data", "seq", "expert", "model"]
    mesh = make_mesh()
    assert mesh.shape["data"] == 1 and mesh.world == 1 and mesh.coords["data"] == 0


def test_too_many_devices():
    with pytest.raises(ValueError, match="requested 1024 devices"):
        make_mesh(1024)


def test_indivisible():
    with pytest.raises(ValueError, match="not divisible"):
        mesh_shape(8, model_parallel=3)


@pytest.mark.parametrize("axis", ["seq_parallel", "pipe_parallel", "expert_parallel"])
def test_item_13c_sizes_are_refused_by_name(axis):
    # Item 13c is ported: each axis is carved as JAX's make_mesh carves it,
    # and refused only for JAX's own reason (the axes must divide the
    # devices).
    from distributed_reinforcement_learning_tpu import parallel as jpar

    assert mesh_shape(4, **{axis: 2}) == dict(jpar.make_mesh(4, **{axis: 2}).shape)
    with pytest.raises(ValueError, match="3 devices not divisible by pipe\\*seq\\*expert\\*model=2"):
        mesh_shape(3, **{axis: 2})


def test_a_mesh_smaller_than_the_world_is_refused(worlds):
    for rank in worlds.ranks[2]:
        assert "every rank of the world" in rank["smaller_mesh"]


def test_single_host_noop(monkeypatch):
    for name in ("DRL_COORDINATOR", "DRL_NUM_PROCESSES", "DRL_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize() is False
    assert not distributed.is_initialized() and not distributed.requested()
    assert distributed.process_info() == (0, 1) and distributed.device() is None


def test_backend_rule():
    cpu = ["h/cpu", "h/cpu"]
    assert distributed.choose_backend(cpu) == "gloo"
    assert distributed.choose_backend(["h/cuda/a", "h/cuda/b"]) == "nccl"
    assert distributed.choose_backend(["h/cuda/a", "h/cuda/a"]) == "gloo"  # one GPU, two ranks
    assert distributed.choose_backend(["h/cuda/a", "h/cpu"]) == "gloo"
    assert distributed.choose_backend(["h/cuda/a", "g/cuda/a"]) == "nccl"  # two hosts


# -- the sharded learner against JAX --------------------------------------------
@pytest.mark.parametrize("world, name", [(w, n) for w, cases in CASES.items() for n in cases])
def test_sharded_learner_matches_jax(worlds, world, name):
    ranks = worlds.ranks[world]
    assert all(r["backend"] == "gloo" for r in ranks)
    want = worlds.jax[name]
    got = ranks[0][name]
    for step, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        _close({k: g[k] for k in w}, w, f"{name} step {step} metrics")
    for step, (g, w) in enumerate(zip(got["rows"], want["rows"])):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"{name} rows {step}")
    _close(got["params"], want["params"], f"{name} params")


@pytest.mark.parametrize("world, name", [(w, n) for w, cases in CASES.items() for n in cases])
def test_ranks_are_bit_identical(worlds, world, name):
    first = worlds.ranks[world][0][name]
    for other in worlds.ranks[world][1:]:
        for k, v in first["params"].items():
            assert np.array_equal(v, other[name]["params"][k]), (name, k)
        assert first["metrics"] == other[name]["metrics"]


@pytest.mark.parametrize("world, name", [(2, "r2d2_tp"), (4, "impala_dptp"),
                                         (4, "r2d2_dptp")])
def test_model_axis_shards_the_kernels_and_moments(worlds, world, name):
    """JAX's leaves, split along the port's dimension of the flax kernel's
    last one; a rank holds about half the state's bytes."""
    from distributed_reinforcement_learning_tpu_torch.models.convert import flax_last_dim

    specs = worlds.ranks[world][0][name]["specs"]
    sharded = {k for k, s in specs.items() if MODEL_AXIS in s}
    assert sharded == {k for k, f in worlds.flags[name].items() if f}, name
    assert sharded
    for k in sharded:
        ndim = len(specs[k])
        assert specs[k].index(MODEL_AXIS) == flax_last_dim(k, ndim), k
    assert "lstm.gates_kernel" in sharded or "cell.gates_kernel" in sharded
    local, whole = worlds.ranks[world][0][name]["bytes"]
    assert 0.45 * whole < local < 0.6 * whole, (local, whole)


def test_flax_last_dim_follows_the_converter():
    """The dimension `flax_last_dim` names is the one the converter moved
    the flax leaf's last dimension to, for every leaf of the three
    families."""
    import jax

    from distributed_reinforcement_learning_tpu.agents import apex as japex
    from distributed_reinforcement_learning_tpu.agents import impala as jimpala
    from distributed_reinforcement_learning_tpu.agents import r2d2 as jr2d2
    from distributed_reinforcement_learning_tpu_torch.models import convert

    for agent, conv in (
            (jimpala.ImpalaAgent(jimpala.ImpalaConfig(obs_shape=(84, 84, 4), num_actions=4)),
             convert.impala_params_from_jax),
            (japex.ApexAgent(japex.ApexConfig(obs_shape=(84, 84, 4), num_actions=4)),
             convert.apex_params_from_jax),
            (jr2d2.R2D2Agent(jr2d2.R2D2Config()), convert.r2d2_params_from_jax)):
        shapes = jax.eval_shape(agent.init_state, jax.random.PRNGKey(0)).params
        # Each leaf counts up along its last dimension only.
        ramps = jax.tree.map(lambda s: np.broadcast_to(
            np.arange(s.shape[-1], dtype=np.float32), s.shape).copy(), shapes)
        for name, t in conv(ramps).items():
            d = convert.flax_last_dim(name, t.ndim)
            assert torch.equal(t.movedim(d, -1)[..., :].reshape(-1, t.shape[d])[0],
                               torch.arange(t.shape[d], dtype=torch.float32)), name


# -- the runners over the mesh ------------------------------------------------------
def test_impala_learner_over_mesh_trains(worlds):
    runs = [r["runner"] for r in worlds.ranks[2]]
    for run in runs:
        assert run["train_steps"] == 3 and run["version"] == 3 and run["placed"]
        assert np.isfinite(run["loss"])
    assert runs[0]["param0"] == runs[1]["param0"]  # one state on both ranks


def test_sharded_learn_many_matches_sequential(worlds):
    for rank in worlds.ranks[2]:
        many = rank["learn_many"]
        assert many["step"] == STEPS and many["k"] == STEPS
        _close(many["many"], many["seq"], "learn_many")


@pytest.mark.parametrize("prefetch", [False, True])
def test_learner_updates_per_call_with_mesh(worlds, prefetch):
    for rank in worlds.ranks[2]:
        assert rank[f"k2_prefetch_{prefetch}"] == {"ok": True, "train_steps": 2}


def test_prefetcher_needs_a_stack_placement_over_a_mesh():
    from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
    from distributed_reinforcement_learning_tpu_torch.data.prefetch import DevicePrefetcher
    from distributed_reinforcement_learning_tpu_torch.parallel.mesh import data_sharding

    mesh = make_mesh()
    with pytest.raises(ValueError, match="needs stack_sharding"):
        DevicePrefetcher(TrajectoryQueue(4), 2, "cpu", stack_calls=2,
                         sharding=data_sharding(mesh))
    pre = DevicePrefetcher(TrajectoryQueue(4), 2, "cpu", sharding=data_sharding(mesh))
    try:
        with pytest.raises(ValueError, match="needs stack_sharding"):
            pre.reconfigure(2)
    finally:
        pre.close()


def test_runners_refuse_a_model_axis():
    """No longer refused: a learner runner takes a model axis (it publishes
    and checkpoints the whole tensors; `tests/test_torch_anakin_mesh.py`
    trains one). Its sharded learner splits the large kernels over
    `model`; building it runs no collective."""
    from distributed_reinforcement_learning_tpu_torch.parallel.learner import runner_learner

    shape = dict(mesh_shape(2, model_parallel=2))
    mesh = types.SimpleNamespace(shape=shape, size=shape.get, coords=dict.fromkeys(shape, 0),
                                 device=torch.device("cpu"))
    kw = dict(CASES[4]["impala_dptp"][1])
    sl = runner_learner(ImpalaAgent(ImpalaConfig(**kw), device="cpu"), mesh, 1)
    assert isinstance(sl, ShardedLearner)
    assert "lstm.gates_kernel" in sl.reducer.model_dims


# -- the reduction seam alone -----------------------------------------------------
class _Recorder:
    """A reducer over two halves that records the seam's calls: the
    gradients handed to it are this half's; it returns the union's, as
    an all-reduce across two ranks would."""

    def __init__(self, other: dict):
        self.other, self.ops = other, []

    def gather(self, params, grad=True):
        return params

    def reduce(self, grads, op, metrics=None):
        self.ops.append(op)
        scale = 0.5 if op == "mean" else 1.0
        g = {k: (v + self.other["grads"][k]) * scale for k, v in grads.items()}
        m = {k: (v + self.other["metrics"][k]) * scale for k, v in (metrics or {}).items()}
        return g, m

    def norm(self, grads):
        return torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))

    def gather_rows(self, t):
        return torch.cat([t, self.other["rows"]])


def _halves(algo: str):
    agent_cls, cfg_cls = _AGENTS[algo]
    kw = dict(CASES[2][f"{algo}_dp"][1])
    agent = agent_cls(cfg_cls(**kw), device="cpu")
    batch, w = _batch(algo, kw, 8, 7)
    cut = lambda x, h: x[:4] if h == 0 else x[4:]
    halves = [(type(batch)(*(cut(x, h) for x in batch)), None if w is None else cut(w, h))
              for h in (0, 1)]
    return agent, batch, w, halves


def _grads(agent, algo, state, batch, w):
    from distributed_reinforcement_learning_tpu_torch.agents.common import batch_to_device

    names = list(state.params)
    b = batch_to_device(batch, agent.device)
    if algo == "impala":
        loss, m = agent.loss(state.params, b)
        rows = torch.zeros(0)
    elif algo == "apex":
        tv, sav = agent._targets(state.params, state.target_params, b)
        loss = torch.mean(torch.square(tv - sav) * torch.as_tensor(w))
        m, rows = {"loss": loss.detach()}, torch.abs(tv - sav).detach()
    else:
        loss, rows = agent._loss(state.params, state.target_params, b, torch.as_tensor(w))
        m = {"loss": loss.detach()}
    g = torch.autograd.grad(loss, [state.params[k] for k in names])
    return {"grads": dict(zip(names, g)), "metrics": m, "rows": rows}


@pytest.mark.parametrize("algo, op", [("impala", "sum"), ("apex", "mean"), ("r2d2", "mean")])
def test_reduction_seam_follows_the_loss(algo, op):
    """The union batch's gradient is the sum (IMPALA: losses summed over
    rows) or the mean (replay: a mean over rows) of the halves', and the
    seam reduces by that op; the step through it equals the union's."""
    agent, batch, w, halves = _halves(algo)
    state = agent.init_state(3)
    union = _grads(agent, algo, state, batch, w)
    parts = [_grads(agent, algo, state, b, hw) for b, hw in halves]
    scale = 0.5 if op == "mean" else 1.0
    for k, g in union["grads"].items():
        torch.testing.assert_close((parts[0]["grads"][k] + parts[1]["grads"][k]) * scale, g,
                                   rtol=1e-5, atol=1e-6)
    # One step through the seam on half 0 (the recorder adds half 1's
    # gradients) against the plain step on the union batch.
    plain, seam = agent.init_state(3), agent.init_state(3)
    rec = _Recorder(parts[1])
    if algo == "impala":
        plain, want = agent.learn(plain, batch)
        seam, got = agent.learn(seam, halves[0][0], reducer=rec)
    else:
        plain, want_rows, want = agent.learn(plain, batch, w)
        seam, got_rows, got = agent.learn(seam, *halves[0], reducer=rec)
        torch.testing.assert_close(got_rows, want_rows, rtol=1e-5, atol=1e-6)
    assert rec.ops == [op]
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    for k, p in plain.params.items():
        torch.testing.assert_close(seam.params[k], p, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("algo", ["impala", "apex", "r2d2"])
def test_no_reducer_is_the_plain_step_bit_for_bit(algo):
    """A mesh of one rank goes through the seam and changes nothing: no
    collective, no copy, the parameters bit for bit the plain step's."""
    agent, batch, w, _ = _halves(algo)
    sl = ShardedLearner(agent, make_mesh(), *(1, 1) if algo == "impala" else (2, 2))
    plain, seam = agent.init_state(5), sl.init_state(5)
    for _ in range(2):
        if algo == "impala":
            plain, want = agent.learn(plain, batch)
            seam, got = sl.learn(seam, sl.shard_batch(batch))
        else:
            plain, _, want = agent.learn(plain, batch, w)
            seam, _, got = sl.learn(seam, *sl.shard_batch((batch, w)))
    for k, p in plain.params.items():
        assert torch.equal(seam.params[k], p), k
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}


# -- the replay write-back (F15) ------------------------------------------------------
def test_priority_writeback_takes_this_ranks_rows():
    """A rank's learn step returns the global [B] priorities, rank-major;
    the port's replay learner writes its own rows back against its own
    sampled indices. The JAX learner hands the global [B] to
    `update_batch` beside its [B_local] indices (`runtime/r2d2_runner.py:
    515-522`), and its backends then write the FIRST B_local values, rank
    0's, on every process: rank 1's samples get rank 0's priorities
    (ROADMAP F15)."""
    from distributed_reinforcement_learning_tpu.data import replay as jreplay
    from distributed_reinforcement_learning_tpu_torch.runtime.replay_train import (
        ReplayTrainMixin)

    B_local, world = 4, 2
    global_prio = np.arange(1, B_local * world + 1, dtype=np.float32)  # rank 0: 1-4, rank 1: 5-8
    for backend in ("python", "array"):
        jr = jreplay.make_replay(64, backend=backend)
        x = np.arange(48, dtype=np.float32).reshape(16, 3)
        if backend == "array":
            jr.add_batch_stacked(np.ones(16), {"x": x})
        else:
            jr.add_batch(np.ones(16), [{"x": row} for row in x])
        _, idxs, _ = jr.sample(B_local, np.random.RandomState(0))
        jr.update_batch(idxs, global_prio)  # what a JAX process does
        written = dict(zip(np.asarray(idxs).tolist(), global_prio[:B_local]))  # last wins
        prio = np.asarray(jr.snapshot()["priorities"])
        for idx, err in written.items():
            np.testing.assert_allclose(prio[idx - (jr.tree.capacity - 1)],
                                       (abs(err) + jr.EPS) ** jr.ALPHA, rtol=1e-6,
                                       err_msg=backend)
    learner = types.SimpleNamespace(
        _sharded=types.SimpleNamespace(mesh=types.SimpleNamespace(coords={"data": 1})),
        batch_size=B_local)
    own = ReplayTrainMixin._own_rows(learner, torch.from_numpy(global_prio))
    assert own.tolist() == [5.0, 6.0, 7.0, 8.0]


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
