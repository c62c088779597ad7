"""The port's sequence parallelism against the JAX package's (ROADMAP item
13c): `parallel/sequence.py`'s ring, zigzag ring and Ulysses attention,
their refusals, and the Transformer-R2D2 learn step with its stream
split over a `seq` axis (the twins of `tests/test_sequence.py` and
`tests/test_xformer.py:TestCompositeMesh`).

The JAX side runs in this process on 4 of the conftest's virtual CPU
devices: the attention at seq 2 (over data 2 x seq 2) and seq 4 in one
program, and one ShardedLearner over seq 2 x model 2 with the zigzag
ring, whose numbers are the union batch's on any mesh and under either
schedule, so it is the reference of every learn step below; its initial
parameters reach the port through `models/convert.py`. The port's side
is two worlds of gloo ranks on the CPU, started once for the module
(this file's `__main__` block is one rank, `tests/torch_mesh_worlds.py`
starts them):

- "w2": the attention at seq 2, the refusals, and three learn steps of
  `xformer` at seq 2 with `attention: ring_zigzag` and with `ring`;
- "w4": the attention at seq 4 and at data 2 x seq 2, and three learn
  steps of `xformer` with the ring at seq 2 x model 2.

Rank 0 of each world also runs the port's single-device agent on the
union batches (`torch_mesh_worlds.port_plain`).

Tolerances: the attention's values within 1e-5 and its gradients within
1e-4 of JAX's; the learn steps within ROADMAP F14's bar (rtol 2e-4, atol
2e-5); the ranks of a world bit for bit equal.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_worlds as worlds_lib  # noqa: E402

VAL_TOL, GRAD_TOL = 1e-5, 1e-4
RTOL, ATOL = 2e-4, 2e-5
B, T, H, D = 4, 16, 4, 8
KINDS = ("ring", "zigzag", "ulysses")
# The attention meshes of each world: (name, mesh kwargs, JAX's seq axis).
ATTN_MESHES = {"w2": [("seq2", dict(seq_parallel=2), 2)],
               "w4": [("seq4", dict(seq_parallel=4), 4),
                      ("data2_seq2", dict(seq_parallel=2), 2)]}
XF = dict(obs_shape=(2,), num_actions=3, seq_len=8, burn_in=2, d_model=32, num_heads=2,
          num_layers=1)
# The port's learn steps of each world: [(tag, attention, mesh kwargs)].
LEARN = {"w2": [("zigzag_seq2", "ring_zigzag", dict(seq_parallel=2)),
                ("ring_seq2", "ring", dict(seq_parallel=2))],
         "w4": [("ring_seq2_model2", "ring", dict(seq_parallel=2, model_parallel=2))]}
# JAX's learn steps, the reference of every case above: its numbers are the
# union batch's on any mesh and under either ring schedule, so one
# ShardedLearner over seq 2 x model 2 (4 devices) serves them all.
JAX_LEARN = (dict(XF, attention="ring_zigzag"), dict(seq_parallel=2, model_parallel=2), 4)
LEARN_B = 8


def _inputs():
    rng = np.random.default_rng(7)
    q, k, v, w = (rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(4))
    done = rng.random((B, T)) < 0.15
    segs = np.concatenate([np.zeros((B, 1), np.int32), np.cumsum(done, 1)[:, :-1]], 1)
    return q, k, v, w, segs.astype(np.int32)


# -- one rank (this file's __main__ block) ---------------------------------
def _port_attention(mesh_kw: dict) -> dict:
    """Each kind on this rank's rows: the values and the q, k, v gradients
    of sum(out * w)."""
    import torch

    from distributed_reinforcement_learning_tpu_torch.parallel import make_mesh
    from distributed_reinforcement_learning_tpu_torch.parallel import sequence as sp
    from distributed_reinforcement_learning_tpu_torch.parallel.mesh import DATA_AXIS

    mesh = make_mesh(**mesh_kw)
    d, i = mesh.size(DATA_AXIS), mesh.coords[DATA_AXIS]
    rows = slice(i * B // d, (i + 1) * B // d)
    q, k, v, w, segs = (torch.from_numpy(x[rows]) for x in _inputs())
    fns = {"ring": lambda *a: sp.ring_attention(mesh, *a, segment_ids=segs),
           "zigzag": lambda *a: sp.ring_attention(mesh, *a, segment_ids=segs,
                                                  schedule="zigzag"),
           "ulysses": lambda *a: sp.ulysses_attention(mesh, *a, segment_ids=segs)}
    out = {}
    for kind, fn in fns.items():
        qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
        val = fn(*qkv)
        grads = torch.autograd.grad((val * w).sum(), qkv)
        out[kind] = (val.detach().numpy(), [g.numpy() for g in grads])
    out["rows"] = (rows.start, rows.stop)
    return out


def _port_refusals() -> dict:
    """The messages of `_check`'s refusals and the zigzag's, on a seq 2 mesh."""
    import torch

    from distributed_reinforcement_learning_tpu_torch.parallel import make_mesh
    from distributed_reinforcement_learning_tpu_torch.parallel import sequence as sp

    mesh = make_mesh(seq_parallel=2)
    x = lambda t, h: torch.zeros(2, t, h, 8)
    cases = {"indivisible_t": lambda: sp.ring_attention(mesh, x(7, 4), x(7, 4), x(7, 4)),
             "heads": lambda: sp.ulysses_attention(mesh, x(8, 3), x(8, 3), x(8, 3)),
             "zigzag_causal": lambda: sp.ring_attention(mesh, x(8, 4), x(8, 4), x(8, 4),
                                                        causal=False, schedule="zigzag"),
             "zigzag_t": lambda: sp.ring_attention(mesh, x(6, 4), x(6, 4), x(6, 4),
                                                   schedule="zigzag"),
             "no_seq_axis": lambda: sp.ring_attention(
                 types.SimpleNamespace(shape={"data": 1}), x(8, 4), x(8, 4), x(8, 4))}
    out = {}
    for name, call in cases.items():
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _run(name: str, payload: dict) -> dict:
    out = {tag: _port_attention(kw) for tag, kw, _ in ATTN_MESHES[name]}
    if name == "w2":
        out["refusals"] = _port_refusals()
    for tag, attention, mesh_kw in LEARN[name]:
        out[tag] = worlds_lib.port_learn("xformer", dict(XF, attention=attention), mesh_kw,
                                         payload, LEARN_B, seed0=50)
    return out


# -- the JAX side ------------------------------------------------------------
def _jax_attention() -> dict:
    """{seq: each kind's values and q, k, v gradients} at seq 2 (over data
    2 x seq 2) and seq 4, one compiled program over the same 4 devices."""
    import jax
    import jax.numpy as jnp

    from distributed_reinforcement_learning_tpu import parallel as jpar
    from distributed_reinforcement_learning_tpu.parallel import sequence as jsp

    q, k, v, w, segs = (jnp.asarray(x) for x in _inputs())

    def kinds(mesh):
        return {"ring": lambda *a: jsp.ring_attention(mesh, *a, batch_axis="data",
                                                      segment_ids=segs),
                "zigzag": lambda *a: jsp.ring_attention(mesh, *a, batch_axis="data",
                                                        segment_ids=segs, schedule="zigzag"),
                "ulysses": lambda *a: jsp.ulysses_attention(mesh, *a, batch_axis="data",
                                                            segment_ids=segs)}

    meshes = {seq: jpar.make_mesh(4, seq_parallel=seq) for seq in (2, 4)}

    def run(q, k, v):
        out = {}
        for seq, mesh in meshes.items():
            for kind, fn in kinds(mesh).items():
                val, vjp = jax.vjp(fn, q, k, v)  # the gradients of sum(out * w)
                out[(seq, kind)] = (val, vjp(w))
        return out

    got = jax.jit(run)(q, k, v)
    return {seq: {kind: (np.asarray(got[(seq, kind)][0]),
                         [np.asarray(g) for g in got[(seq, kind)][1]]) for kind in KINDS}
            for seq in meshes}


def _jax_refusals() -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from distributed_reinforcement_learning_tpu import parallel as jpar
    from distributed_reinforcement_learning_tpu.parallel import sequence as jsp

    mesh = jpar.make_mesh(2, seq_parallel=2)
    bare = Mesh(np.array(jax.devices()[:1]), ("data",))
    x = lambda t, h: jnp.zeros((2, t, h, 8))
    cases = {"indivisible_t": lambda: jsp.ring_attention(mesh, x(7, 4), x(7, 4), x(7, 4)),
             "heads": lambda: jsp.ulysses_attention(mesh, x(8, 3), x(8, 3), x(8, 3)),
             "zigzag_causal": lambda: jsp.ring_attention(mesh, x(8, 4), x(8, 4), x(8, 4),
                                                         causal=False, schedule="zigzag"),
             "zigzag_t": lambda: jsp.ring_attention(mesh, x(6, 4), x(6, 4), x(6, 4),
                                                    schedule="zigzag"),
             "no_seq_axis": lambda: jsp.ring_attention(bare, x(8, 4), x(8, 4), x(8, 4))}
    out = {}
    for name, call in cases.items():
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The ranks' results of both worlds, and JAX's; the JAX side runs
    while the ranks do, and hands them its initial parameters first."""
    tmp = tmp_path_factory.mktemp("seq_worlds")
    kw, mesh_kw, n = JAX_LEARN
    handle, init = worlds_lib.jax_setup("xformer", kw, mesh_kw, n_devices=n)
    procs = {name: worlds_lib.start_world(__file__, name, size, tmp, init)
             for name, size in (("w2", 2), ("w4", 4))}
    learned, attn, refusals = worlds_lib.on_threads(
        [lambda: worlds_lib.jax_learn(handle, LEARN_B, seed0=50), _jax_attention,
         _jax_refusals])
    ranks = {name: worlds_lib.join_world(p) for name, p in procs.items()}
    return types.SimpleNamespace(ranks=ranks, attn=attn, learn=learned, refusals=refusals)


CASES = [(name, tag, seq) for name, meshes in ATTN_MESHES.items() for tag, _, seq in meshes]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name, tag, seq", CASES)
def test_attention_matches_jax(worlds, name, tag, seq, kind):
    want_val, want_grads = worlds.attn[seq][kind]
    for rank in worlds.ranks[name]:
        got_val, got_grads = rank[tag][kind]
        lo, hi = rank[tag]["rows"]
        np.testing.assert_allclose(got_val, want_val[lo:hi], atol=VAL_TOL, rtol=0)
        for g, w, which in zip(got_grads, want_grads, "qkv"):
            np.testing.assert_allclose(g, w[lo:hi], atol=GRAD_TOL, rtol=0,
                                       err_msg=f"{tag} {kind} d{which}")


@pytest.mark.parametrize("case", ["indivisible_t", "heads", "zigzag_causal", "zigzag_t",
                                  "no_seq_axis"])
def test_refusals_match_jax(worlds, case):
    want = worlds.refusals[case]
    assert want is not None
    for rank in worlds.ranks["w2"]:
        assert rank["refusals"][case] == want


@pytest.mark.parametrize("name", sorted(LEARN))
def test_learn_steps_match_jax(worlds, name):
    for tag, _, mesh_kw in LEARN[name]:
        ranks = [r[tag] for r in worlds.ranks[name]]
        worlds_lib.assert_ranks_equal(ranks, tag)
        worlds_lib.assert_learn_close(ranks[0], worlds.learn, ranks[0]["plain"], RTOL, ATOL,
                                      tag)
        # The sequence axis moved the ring's blocks; the model axis split
        # the kernels (each rank holds part of the state).
        assert ranks[0]["bytes_by"].get("shift/seq", 0) > 0
        if mesh_kw.get("model_parallel", 1) > 1:
            assert ranks[0]["bytes_local"] < ranks[0]["bytes_whole"]
            assert any("model" in spec for spec in ranks[0]["specs"].values())


def test_launcher_group_trains_over_the_sequence_axis(tmp_path):
    """The config path: `launch_local_cluster --learners 2` on an `xformer`
    section with `attention: ring_zigzag` and `seq_parallel: 2` (small
    widths), 3 updates. Both learners are one mesh (data 1 x seq 2; each
    learns on seq rank 0's rows), exit 0 at the same step and leave no
    segment."""
    cfg = json.loads((worlds_lib.REPO / "config.json").read_text())
    section = dict(cfg["xformer"], batch_size=8, seq_len=8, burn_in=2, d_model=32,
                   attention="ring_zigzag", seq_parallel=2, num_actors=2,
                   env=["CartPole-v0"] * 2, available_action=[2, 2], envs_per_actor=2)
    path = tmp_path / "config.json"
    path.write_text(json.dumps({"xformer": section}))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "DRL_NO_GYMNASIUM": "1",
           "PYTHONPATH": os.pathsep.join(filter(None, [str(worlds_lib.REPO),
                                                        os.environ.get("PYTHONPATH")]))}
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_reinforcement_learning_tpu_torch.launch_local_cluster",
         "--config", str(path), "--section", "xformer", "--actors", "2", "--learners", "2",
         "--updates", "3", "--device", "cpu", "--actor_grace", "5"],
        cwd=worlds_lib.REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=150)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    assert proc.returncode == 0, out[-4000:]
    summaries = [json.loads(line.split("] ", 1)[1]) for line in out.splitlines()
                 if line.startswith("[learner") and '"role": "learner"' in line]
    assert sorted(s["multihost"]["rank"] for s in summaries) == [0, 1]
    assert {s["train_steps"] for s in summaries} == {3}
    assert all(s["multihost"]["mesh"]["seq"] == 2 for s in summaries)
    assert not [f for f in os.listdir("/dev/shm") if f"-{proc.pid}-" in f]


@pytest.mark.parametrize("coords, writes", [({"data": 1, "seq": 0}, True),
                                            ({"data": 1, "seq": 1}, False),
                                            ({"data": 0, "pipe": 1}, False),
                                            ({"data": 0, "expert": 1}, False)])
def test_only_a_lines_lead_writes_priorities_back(coords, writes):
    """Under run_role each rank samples its own replay, and a seq, pipe or
    expert line learns on its lead's rows (`runner_learner`): the lead
    writes its data coordinate's rows back, the others nothing (their
    sampled indices were not learned on)."""
    import torch

    from distributed_reinforcement_learning_tpu_torch.runtime.replay_train import (
        ReplayTrainMixin)

    b_local = 4
    coords = {"data": 0, "seq": 0, "pipe": 0, "expert": 0, "model": 0, **coords}
    learner = types.SimpleNamespace(
        _sharded=types.SimpleNamespace(mesh=types.SimpleNamespace(coords=coords)),
        batch_size=b_local)
    learner._own_rows = types.MethodType(ReplayTrainMixin._own_rows, learner)
    written = []
    replay = types.SimpleNamespace(update_batch=lambda idxs, p: written.append((idxs, p)))
    prio = torch.arange(2 * b_local, dtype=torch.float32)
    ReplayTrainMixin._write_back(learner, replay, [7, 8, 9, 10], prio)
    i = coords["data"]
    want = [([7, 8, 9, 10], prio[i * b_local:(i + 1) * b_local].tolist())] if writes else []
    assert [(idxs, p.tolist()) for idxs, p in written] == want


def test_ranks_run_gloo(worlds):
    assert all(r["backend"] == "gloo" for ranks in worlds.ranks.values() for r in ranks)


if __name__ == "__main__":
    worlds_lib.rank_main(sys.argv[1:], _run)
