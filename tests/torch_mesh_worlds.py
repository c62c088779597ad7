"""Gloo worlds of port ranks for the model-parallel tests
(`test_torch_sequence.py`, `test_torch_pipeline.py`, `test_torch_expert.py`).

A test module starts each world once (`start_world`), hands every rank
the same payload file, and reads each rank's results back (`join_world`);
the rank processes run that module's own `__main__` block, which calls
`rank_main` with its case function. Each rank runs one torch thread on
the CPU, and every rank of a world is killed if one fails or outlives
its timeout.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 150


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_world(module_file: str, name: str, world: int, tmp: Path, payload) -> list:
    """`world` rank processes of `module_file`'s `__main__` block -> the
    handles `join_world` takes."""
    in_path = tmp / f"in_{name}.pt"
    torch.save(payload, in_path)
    port = free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "DRL_NO_GYMNASIUM": "1",
           "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))}
    procs = []
    for r in range(world):
        out = tmp / f"out_{name}_{r}.pt"
        procs.append((subprocess.Popen(
            [sys.executable, module_file, name, str(r), str(world), str(port), str(in_path),
             str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), out))
    return procs


def join_world(procs: list) -> list[dict]:
    """Every rank's results, in rank order."""
    outs = []
    try:
        for proc, path in procs:
            log, _ = proc.communicate(timeout=RANK_TIMEOUT_S)
            assert proc.returncode == 0, log[-6000:]
            outs.append(torch.load(path, weights_only=False))
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def rank_main(argv: list[str], run) -> None:
    """One rank: join the world on the CPU, `run(world_name, payload)`,
    save what it returns."""
    from distributed_reinforcement_learning_tpu_torch.parallel import distributed

    name, rank, world, port, in_path, out_path = argv
    torch.set_num_threads(1)
    assert distributed.initialize(f"127.0.0.1:{port}", int(world), int(rank), device="cpu")
    results = run(name, torch.load(in_path, weights_only=False))
    results["backend"] = distributed.backend()
    torch.save(results, out_path)
    distributed.shutdown()


# -- learn steps of the transformer families over a mesh ------------------------
STEPS = 3


def _batch(algo: str, kw: dict, B: int, seed: int):
    """A seeded union batch (numpy; with IS weights for xformer), the same
    numbers as the JAX package's synthetic batches."""
    from distributed_reinforcement_learning_tpu_torch.utils import synthetic

    if algo == "xformer":
        return synthetic.synthetic_xformer_batch(B, kw["seq_len"], kw["obs_shape"],
                                                 kw["num_actions"], seed=seed)
    return synthetic.synthetic_ximpala_batch(B, kw["trajectory"], kw["obs_shape"],
                                             kw["num_actions"], seed=seed), None


def port_learn(algo: str, kw: dict, mesh_kw: dict, params: dict, B: int, seed0: int) -> dict:
    """STEPS steps of the port's ShardedLearner over a mesh of this world's
    ranks, from `params` -> the rank's results (whole parameters after,
    metrics, global per-row outputs, bytes a collective moved, state bytes
    a rank holds and whole); rank 0 also runs `port_plain` ("plain"),
    while the test's process runs the JAX side."""
    from distributed_reinforcement_learning_tpu_torch.agents.xformer import (
        XformerAgent, XformerConfig)
    from distributed_reinforcement_learning_tpu_torch.agents.ximpala import (
        XImpalaAgent, XImpalaConfig)
    from distributed_reinforcement_learning_tpu_torch.parallel import ShardedLearner, make_mesh

    cls, cfg_cls = ((XformerAgent, XformerConfig) if algo == "xformer"
                    else (XImpalaAgent, XImpalaConfig))
    mesh = make_mesh(**mesh_kw)
    agent = cls(cfg_cls(**kw), device="cpu", mesh=mesh)
    n = 2 if algo == "xformer" else 1
    sl = ShardedLearner(agent, mesh, n, n)
    state = sl.init_state(params=params)
    out = {"metrics": [], "rows": [], "bytes_local": sl.state_bytes(state),
           "specs": {k: list(p.spec) for k, p in sl.state_sharding.items()}}
    b0 = dict(mesh.bytes_by)
    for step in range(STEPS):
        batch, w = _batch(algo, kw, B, seed0 + step)
        if algo == "xformer":
            state, rows, m = sl.learn(state, *sl.shard_batch((batch, w)))
            out["rows"].append(rows.detach().numpy())
        else:
            state, m = sl.learn(state, sl.shard_batch(batch))
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["bytes_by"] = {k: v - b0.get(k, 0) for k, v in mesh.bytes_by.items()}
    whole = sl.gather_state(state)
    out["bytes_whole"] = sl.state_bytes(whole)
    out["params"] = {k: v.detach().numpy() for k, v in whole.params.items()}
    if mesh.rank == 0:
        out["plain"] = port_plain(algo, kw, params, B, seed0)
    return out


def _plain_cfg(algo: str, kw: dict):
    """(the port's agent class, the config of its single-device twin: dense
    attention, a pipelined config's stacked layers scanned plainly)."""
    import dataclasses

    from distributed_reinforcement_learning_tpu_torch.agents.xformer import (
        XformerAgent, XformerConfig)
    from distributed_reinforcement_learning_tpu_torch.agents.ximpala import (
        XImpalaAgent, XImpalaConfig)

    cls, cfg_cls = ((XformerAgent, XformerConfig) if algo == "xformer"
                    else (XImpalaAgent, XImpalaConfig))
    cfg = cfg_cls(**kw)
    return cls, dataclasses.replace(cfg, attention="dense", pipeline=False,
                                    stacked=cfg.pipeline or cfg.stacked)


def params_to_jax(abstract, params: dict, head: str):
    """The port's `{name: tensor}` -> a JAX parameter tree shaped as
    `abstract`: `models/convert.py`'s mapping run backwards. The mapping
    is read off by converting a tree whose elements are their own flat
    indices (exact in float32 below 2**24), so each port element lands
    where the forward conversion took it from."""
    import jax

    from distributed_reinforcement_learning_tpu_torch.models import convert

    leaves, treedef = jax.tree.flatten(abstract)
    sizes = [int(np.prod(leaf.shape)) for leaf in leaves]
    offsets = np.cumsum([0] + sizes)
    assert offsets[-1] < 2 ** 24
    coded = [np.arange(o, o + n, dtype=np.float64).reshape(leaf.shape)
             for o, n, leaf in zip(offsets, sizes, leaves)]
    where = convert.transformer_params_from_jax(jax.tree.unflatten(treedef, coded), head=head)
    assert set(where) == set(params)
    flat = np.full(offsets[-1], np.nan, np.float32)
    for name, idx in where.items():
        flat[idx.numpy().astype(np.int64).ravel()] = params[name].detach().numpy().ravel()
    assert not np.isnan(flat).any()
    return jax.tree.unflatten(treedef, [flat[o:o + n].reshape(leaf.shape).astype(leaf.dtype)
                                        for o, n, leaf in zip(offsets, sizes, leaves)])


def jax_setup(algo: str, kw: dict, mesh_kw: dict, agent_mesh: bool = True,
              n_devices: int = 2):
    """The JAX ShardedLearner on a mesh of `n_devices` of the conftest's
    virtual CPU devices and its initial state, from the port's
    single-device agent's initial parameters (seed 1) -> (its handle for
    `jax_learn`, those parameters). JAX's state is built and placed
    eagerly (`place_state`): its jitted init would compile a program as
    large as the learn step's, for numbers the test does not need."""
    import jax

    from distributed_reinforcement_learning_tpu import parallel as jpar
    from distributed_reinforcement_learning_tpu.agents import xformer as jxf
    from distributed_reinforcement_learning_tpu.agents import ximpala as jxi

    mod, names = (jxf, ("XformerAgent", "XformerConfig", "XformerBatch")) if algo == "xformer" \
        else (jxi, ("XImpalaAgent", "XImpalaConfig", "XImpalaBatch"))
    agent_cls, cfg_cls, batch_cls = (getattr(mod, n) for n in names)
    mesh = jpar.make_mesh(n_devices, **mesh_kw)
    agent = agent_cls(cfg_cls(**kw), mesh=mesh if agent_mesh else None)
    n = 2 if algo == "xformer" else 1
    learner = jpar.ShardedLearner(agent, mesh, num_data_args=n, num_aux_outputs=n)
    head = "dueling_q" if algo == "xformer" else "actor_critic"
    cls, cfg = _plain_cfg(algo, kw)
    init = {k: v.detach().clone() for k, v in cls(cfg, device="cpu").init_state(1).params.items()}
    abstract = jax.eval_shape(agent.init_state, jax.random.PRNGKey(1))
    params = params_to_jax(abstract.params, init, head)
    state = learner.place_state(type(abstract).create(params, agent.tx))
    handle = types.SimpleNamespace(algo=algo, kw=kw, learner=learner, state=state, head=head,
                                   batch_cls=batch_cls)
    return handle, init


def jax_learn(handle, B: int, seed0: int) -> dict:
    """STEPS steps of `jax_setup`'s learner -> its results."""
    import jax
    import jax.numpy as jnp

    from distributed_reinforcement_learning_tpu_torch.models import convert

    learner, state = handle.learner, handle.state
    out = {"metrics": [], "rows": []}
    for step in range(STEPS):
        batch, w = _batch(handle.algo, handle.kw, B, seed0 + step)
        jb = handle.batch_cls(**{k: jnp.asarray(v) for k, v in batch._asdict().items()})
        if handle.algo == "xformer":
            state, rows, m = learner.learn(state, *learner.shard_batch((jb, w)))
            out["rows"].append(np.asarray(rows))
        else:
            state, m = learner.learn(state, learner.shard_batch(jb))
        out["metrics"].append({k: float(v) for k, v in m.items()})
    params = jax.tree.map(np.asarray, jax.device_get(state.params))
    out["params"] = {k: v.numpy() for k, v in
                     convert.transformer_params_from_jax(params, head=handle.head).items()}
    return out


_PLAIN: dict = {}


def port_plain(algo: str, kw: dict, params: dict, B: int, seed0: int) -> dict:
    """The port's single-device agent (no mesh: dense attention, the plain
    scan over a pipelined config's stacked layers, every expert here) on
    the union batches from the same `params` -> `port_learn`'s results.
    Cases whose plain agent is the same (a ring and a zigzag ring, two
    meshes of one MoE config) share one run."""
    cls, cfg = _plain_cfg(algo, kw)
    key = (algo, repr(cfg), id(params), B, seed0)
    if key not in _PLAIN:
        _PLAIN[key] = _run_plain(cls(cfg, device="cpu"), algo, kw, params, B, seed0)
    return _PLAIN[key]


def _run_plain(agent, algo: str, kw: dict, params: dict, B: int, seed0: int) -> dict:
    state = (agent.sync_target if algo == "xformer" else (lambda s: s))(
        agent.state_from_params(params))
    out = {"metrics": [], "rows": []}
    for step in range(STEPS):
        batch, w = _batch(algo, kw, B, seed0 + step)
        if algo == "xformer":
            state, rows, m = agent.learn(state, batch, w)
            out["rows"].append(rows.detach().numpy())
        else:
            state, m = agent.learn(state, batch)
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["params"] = {k: v.detach().numpy() for k, v in state.params.items()}
    return out


def _beyond(got: np.ndarray, want: np.ndarray, rtol: float, atol: float) -> np.ndarray:
    return np.abs(got - want) > atol + rtol * np.abs(want)


def assert_learn_close(got: dict, want: dict, plain: dict, rtol: float, atol: float,
                       what: str) -> None:
    """The port's sharded learn steps (`got`) against JAX's ShardedLearner
    (`want`) and the port's single-device agent on the union batches
    (`plain`): the metrics and per-row outputs within the bar of JAX's at
    every step; every parameter within the bar of the plain agent's; and
    within the bar of JAX's wherever the plain agent is. Adam moves an
    element whose gradient is float32 noise by about the learning rate a
    step either way, so a few such elements miss JAX's bar in both the
    plain and the sharded port: the mesh may add no miss of its own."""
    assert set(got["params"]) == set(want["params"]) == set(plain["params"]), what
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], plain["params"][k], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k} against the plain agent")
        miss = _beyond(got["params"][k], v, rtol, atol)
        plain_miss = _beyond(plain["params"][k], v, rtol, atol)
        assert not (miss & ~plain_miss).any(), f"{what} {k}: misses JAX where the plain does not"
        assert plain_miss.sum() <= max(2, v.size // 10_000), f"{what} {k}: {plain_miss.sum()}"
    for step, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for k in set(g) & set(w):
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                       err_msg=f"{what} step {step} {k}")
    for g, w in zip(got["rows"], want["rows"]):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=f"{what} rows")


def on_threads(calls: list) -> list:
    """`[fn() for fn in calls]`, run on threads: the JAX side's compiles
    overlap (XLA compiles outside the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(calls)) as pool:
        return [f.result() for f in [pool.submit(fn) for fn in calls]]


def assert_ranks_equal(ranks: list[dict], what: str) -> None:
    for r in ranks[1:]:
        for k, v in ranks[0]["params"].items():
            assert np.array_equal(r["params"][k], v), f"{what}: ranks differ in {k}"
