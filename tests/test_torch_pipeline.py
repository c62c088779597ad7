"""The port's pipeline parallelism against the JAX package's (ROADMAP item
13c): `parallel/pipeline.py`'s GPipe schedule, the pipelined
Transformer-R2D2 learn step, and the pipeline's refusals (the twins of
`tests/test_pipeline.py` and `tests/test_xformer.py`'s pipeline cases).

The JAX side runs in this process on the conftest's virtual CPU devices
(a mesh of as many as the port's world has ranks). The port's side is two worlds of gloo ranks on the CPU, started
once for the module (this file's `__main__` block is one rank):

- "w2": `pipeline_apply` at 2 stages, three learn steps of `xformer`
  with `pipeline: true`, 4 layers in 2 stages (virtual stages) and 2
  microbatches, and the agent-level refusals on a pipe-2 mesh;
- "w4": `pipeline_apply` at 4 stages and at pipe 2 x data 2.

Tolerances: `pipeline_apply`'s values within 1e-5 and its gradients
within 1e-4 of JAX's; the learn steps within ROADMAP F14's bar (rtol
2e-4, atol 2e-5); the ranks of a world bit for bit equal.
"""

from __future__ import annotations

import sys
import types
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_worlds as worlds_lib  # noqa: E402

VAL_TOL, GRAD_TOL = 1e-5, 1e-4
RTOL, ATOL = 2e-4, 2e-5
D, B, M = 16, 16, 2
# The pipeline_apply meshes of each world: (tag, port mesh kwargs, JAX's stages).
APPLY = {"w2": [("pipe2", dict(pipe_parallel=2), 2)],
         "w4": [("pipe4", dict(pipe_parallel=4), 4),
                ("pipe2_data2", dict(pipe_parallel=2), 2)]}
XF = dict(obs_shape=(2,), num_actions=3, seq_len=8, burn_in=2, d_model=32, num_heads=2,
          num_layers=2, pipeline=True, pipeline_microbatches=2)
# 4 layers in 2 stages: virtual stages, each rank scanning its 2 layers a tick.
LEARN = {"w2": ("learn_pipe2_virtual", dict(XF, num_layers=4, pipeline_stages=2),
                dict(pipe_parallel=2))}
LEARN_B = 8
# Agent-level refusals: (config changes, mesh pipe axis) -> JAX's message.
REFUSALS = {"stages_divide": (dict(num_layers=3, pipeline_stages=2), 2),
            "stages_one": (dict(pipeline_stages=1), 2),
            "stages_mesh": (dict(num_layers=4), 2),
            "with_ring": (dict(attention="ring"), 2),
            "with_moe": (dict(num_experts=4), 2),
            "no_mesh": ({}, None)}


def _stage_params(stages: int) -> dict:
    rng = np.random.default_rng(stages)
    return {"w1": 0.3 * rng.standard_normal((stages, D, 2 * D)).astype(np.float32),
            "b1": np.zeros((stages, 2 * D), np.float32),
            "w2": 0.3 * rng.standard_normal((stages, 2 * D, D)).astype(np.float32)}


def _acts():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((B, D)).astype(np.float32),
            0.1 * rng.standard_normal((B, D)).astype(np.float32),
            rng.standard_normal((B, D)).astype(np.float32))  # the cotangent


# -- one rank (this file's __main__ block) ---------------------------------
def _stage_fn_torch(p, act):
    import torch

    x, side = act
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return x + h @ p["w2"] + side, side


def _port_apply(mesh_kw: dict, stages: int) -> dict:
    """pipeline_apply on this rank's rows and stage: the values, the
    gradients of sum(out * cot) for this rank's stage and rows."""
    import torch

    from distributed_reinforcement_learning_tpu_torch.parallel import make_mesh, pipeline_apply
    from distributed_reinforcement_learning_tpu_torch.parallel.mesh import DATA_AXIS, PIPE_AXIS

    mesh = make_mesh(**mesh_kw)
    d, i, s = mesh.size(DATA_AXIS), mesh.coords[DATA_AXIS], mesh.coords[PIPE_AXIS]
    rows = slice(i * B // d, (i + 1) * B // d)
    params = {k: torch.from_numpy(v[s:s + 1]).requires_grad_(True)
              for k, v in _stage_params(stages).items()}
    x, side, cot = (torch.from_numpy(a[rows]) for a in _acts())
    x, side = x.requires_grad_(True), side.requires_grad_(True)
    out = pipeline_apply(mesh, _stage_fn_torch, params, (x, side), num_microbatches=M)
    grads = torch.autograd.grad((out[0] * cot).sum(), [*params.values(), x, side])
    return {"out": out[0].detach().numpy(), "stage": s, "rows": (rows.start, rows.stop),
            "grads": {k: g.numpy() for k, g in zip([*params, "x", "side"], grads)}}


def _port_refusals() -> dict:
    from distributed_reinforcement_learning_tpu_torch.agents.xformer import (
        XformerAgent, XformerConfig)
    from distributed_reinforcement_learning_tpu_torch.parallel import make_mesh

    mesh = make_mesh(pipe_parallel=2)
    out = {}
    for name, (change, pipe) in REFUSALS.items():
        try:
            XformerAgent(XformerConfig(**dict(XF, **change)), device="cpu",
                         mesh=mesh if pipe else None)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _run(name: str, payload: dict) -> dict:
    out = {tag: _port_apply(kw, stages) for tag, kw, stages in APPLY[name]}
    if name == "w2":
        out["refusals"] = _port_refusals()
    if name in LEARN:
        tag, kw, mesh_kw = LEARN[name]
        out[tag] = worlds_lib.port_learn("xformer", kw, mesh_kw, payload[tag], LEARN_B,
                                         seed0=70)
    return out


# -- the JAX side ------------------------------------------------------------
def _stage_fn_jax(p, act):
    import jax.numpy as jnp

    x, side = act
    h = jnp.tanh(x @ p["w1"] + p["b1"])
    return x + h @ p["w2"] + side, side


def _jax_apply(stages: int) -> dict:
    import jax
    import jax.numpy as jnp

    from distributed_reinforcement_learning_tpu import parallel as jpar

    mesh = jpar.make_mesh(stages, pipe_parallel=stages)
    params = {k: jnp.asarray(v) for k, v in _stage_params(stages).items()}
    x, side, cot = (jnp.asarray(a) for a in _acts())

    def run(p, x, side):
        return jpar.pipeline_apply(mesh, _stage_fn_jax, p, (x, side), num_microbatches=M,
                                   batch_axis="data")[0]

    out = jax.jit(run)(params, x, side)
    gp, gx, gs = jax.jit(jax.grad(lambda *a: jnp.sum(run(*a) * cot), argnums=(0, 1, 2)))(
        params, x, side)
    return {"out": np.asarray(out), "grads": {**{k: np.asarray(v) for k, v in gp.items()},
                                              "x": np.asarray(gx), "side": np.asarray(gs)}}


def _jax_refusals() -> dict:
    from distributed_reinforcement_learning_tpu import parallel as jpar
    from distributed_reinforcement_learning_tpu.agents.xformer import (
        XformerAgent, XformerConfig)

    mesh = jpar.make_mesh(8, pipe_parallel=2)
    out = {}
    for name, (change, pipe) in REFUSALS.items():
        try:
            XformerAgent(XformerConfig(**dict(XF, **change)), mesh=mesh if pipe else None)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe_worlds")
    names = [(name, size) for name, size in (("w2", 2), ("w4", 4)) if name in LEARN]
    setups = worlds_lib.on_threads([
        lambda n=n, size=size: worlds_lib.jax_setup("xformer", LEARN[n][1], LEARN[n][2],
                                                    n_devices=size) for n, size in names])
    handles, inits = {}, {}
    for (name, _), (handle, init) in zip(names, setups):
        handles[LEARN[name][0]], inits[LEARN[name][0]] = handle, init
    procs = {name: worlds_lib.start_world(__file__, name, size, tmp,
                                        {LEARN[name][0]: inits[LEARN[name][0]]}
                                        if name in LEARN else {})
             for name, size in (("w2", 2), ("w4", 4))}
    *learned, apply2, apply4, refusals = worlds_lib.on_threads(
        [lambda h=h: worlds_lib.jax_learn(h, LEARN_B, seed0=70) for h in handles.values()]
        + [lambda: _jax_apply(2), lambda: _jax_apply(4), _jax_refusals])
    jax_learn = dict(zip(handles, learned))
    ranks = {name: worlds_lib.join_world(p) for name, p in procs.items()}
    return types.SimpleNamespace(ranks=ranks, apply={2: apply2, 4: apply4}, learn=jax_learn,
                                 refusals=refusals)


CASES = [(name, tag, stages) for name, meshes in APPLY.items() for tag, _, stages in meshes]


@pytest.mark.parametrize("name, tag, stages", CASES)
def test_pipeline_apply_matches_jax(worlds, name, tag, stages):
    """Values and input gradients for each rank's rows; a stage's parameter
    gradient summed over the data ranks that hold it (the learner's data
    reduction)."""
    want = worlds.apply[stages]
    stage_grads: dict[int, dict] = {}
    for rank in worlds.ranks[name]:
        got, (lo, hi), s = rank[tag], rank[tag]["rows"], rank[tag]["stage"]
        np.testing.assert_allclose(got["out"], want["out"][lo:hi], atol=VAL_TOL, rtol=0)
        for k in ("x", "side"):
            np.testing.assert_allclose(got["grads"][k], want["grads"][k][lo:hi], atol=GRAD_TOL,
                                       rtol=0, err_msg=f"{tag} d{k}")
        mine = stage_grads.setdefault(s, {})
        for k in ("w1", "b1", "w2"):
            mine[k] = mine.get(k, 0) + got["grads"][k]
    assert sorted(stage_grads) == list(range(stages))
    for s, grads in stage_grads.items():
        for k, g in grads.items():
            np.testing.assert_allclose(g, want["grads"][k][s:s + 1], atol=GRAD_TOL, rtol=0,
                                       err_msg=f"{tag} stage {s} d{k}")


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_jax(worlds, case):
    want = worlds.refusals[case]
    assert want is not None
    for rank in worlds.ranks["w2"]:
        assert rank["refusals"][case] == want


@pytest.mark.parametrize("name", sorted(LEARN))
def test_learn_steps_match_jax(worlds, name):
    tag = LEARN[name][0]
    ranks = [r[tag] for r in worlds.ranks[name]]
    worlds_lib.assert_ranks_equal(ranks, tag)
    worlds_lib.assert_learn_close(ranks[0], worlds.learn[tag], ranks[0]["plain"], RTOL,
                                  ATOL, tag)
    # Each rank holds its stage's layers: the stacked leaves split over pipe.
    assert ranks[0]["bytes_by"].get("shift/pipe", 0) > 0
    assert ranks[0]["bytes_local"] < ranks[0]["bytes_whole"]
    assert {tuple(s) for k, s in ranks[0]["specs"].items() if "blocks_stacked" in k} == {
        ("pipe",)}


def test_pipeline_apply_refuses_bad_shapes():
    """pipeline_apply's own checks, on a mesh without a pipe axis and on
    this rank's stage slices."""
    import torch

    from distributed_reinforcement_learning_tpu_torch.parallel import make_mesh, pipeline_apply

    mesh = make_mesh(device="cpu")
    x = torch.zeros(4, D)
    with pytest.raises(ValueError, match="has no 'pipe' axis > 1"):
        pipeline_apply(mesh, _stage_fn_torch, {"w1": torch.zeros(1, D, D)}, (x, x),
                       num_microbatches=2)
    mesh.shape["pipe"] = 2  # the shape checks come before any collective
    with pytest.raises(ValueError, match="leading dims"):
        pipeline_apply(mesh, _stage_fn_torch, {"w1": torch.zeros(2, D, D)}, (x, x),
                       num_microbatches=2)
    with pytest.raises(ValueError, match="disagree on batch dim"):
        pipeline_apply(mesh, _stage_fn_torch, {"w1": torch.zeros(1, D, D)},
                       (x, torch.zeros(3, D)), num_microbatches=2)
    with pytest.raises(ValueError, match="per-device batch 4 not divisible by "
                                         "num_microbatches=3"):
        pipeline_apply(mesh, _stage_fn_torch, {"w1": torch.zeros(1, D, D)}, (x, x),
                       num_microbatches=3)


def test_stack_stage_params_stacks_the_stages_in_order():
    """The `[n_stages, ...]` layout `pipeline_apply`'s stages are cut from
    (JAX's `stack_stage_params`): stage i is the i-th draw."""
    import torch

    from distributed_reinforcement_learning_tpu_torch.parallel import stack_stage_params

    init = lambda g: {"w": torch.rand(2, 3, generator=g), "b": torch.zeros(3)}
    got = stack_stage_params(init, 3, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(0)
    want = [init(g) for _ in range(3)]
    assert got["w"].shape == (3, 2, 3) and got["b"].shape == (3, 3)
    for i in range(3):
        assert torch.equal(got["w"][i], want[i]["w"])


def test_a_non_writing_rank_joins_the_checkpoints_gather(tmp_path):
    """Under run_role only rank 0 writes checkpoints; over a pipe axis the
    others hold a `writes=False` store, whose save joins the gather of
    the whole state (a collective) and writes nothing."""
    from distributed_reinforcement_learning_tpu_torch.utils.checkpoint import Checkpointer

    gathered = []

    class Sharded:
        def gather_state(self, state):
            gathered.append(state)
            return state

    Checkpointer(tmp_path, writes=False).save(3, {"w": 1}, {"x": 1}, sharded=Sharded())
    assert gathered == [{"w": 1}] and not list(tmp_path.iterdir())


def test_microbatch_split_is_refused_by_run_role():
    """run_role's mesh sizing refuses a per-rank batch that does not split
    into the microbatches, as the JAX learner's does."""
    from distributed_reinforcement_learning_tpu_torch.agents.xformer import XformerConfig
    from distributed_reinforcement_learning_tpu_torch.runtime.transport import _multihost_mesh
    from distributed_reinforcement_learning_tpu_torch.utils.config import RuntimeConfig

    cfg = XformerConfig(**dict(XF, pipeline_microbatches=4))
    rt = RuntimeConfig(batch_size=6)
    with pytest.raises(ValueError, match=r"pipeline needs the per-device batch \(6/1\) "
                                         r"divisible by pipeline_microbatches=4"):
        _multihost_mesh("xformer", cfg, rt, 2)


if __name__ == "__main__":
    worlds_lib.rank_main(sys.argv[1:], _run)
