"""The port's mixture of experts over a mesh against the JAX package's
(ROADMAP item 13c): `ops/moe.py` at expert 2 and at data 2, and the MoE
transformers' learn steps over those axes (the twins of
`tests/test_moe.py:TestExpertParallel` and of JAX's `ShardedLearner`
over an MoE transformer, the half of ROADMAP F14 the port refused).

The routing is the union batch's, as under GSPMD in JAX: the capacity
counts every rank's tokens and the slots go in the global (choice,
token) order, so at capacity factor 1 (where tokens are dropped) a
rank's own routing would drop others. The JAX side runs in this process
on the conftest's virtual CPU devices: `moe_mlp` over data 2 x expert 2,
and one ShardedLearner a family (`JAX_LEARN`), whose numbers are the
union batch's on any mesh. The port's side is one world of 2 gloo ranks
on the CPU, started once for the module (this file's `__main__` block
is one rank; rank 0 also runs the port's single-device agent), which
runs every case:

- `moe_mlp` at expert 2 (each rank holds 2 of the 4 experts) and at
  data 2 (each rank holds half the rows): the same tokens in the same
  slots as JAX's dispatch, the output and the aux term within 1e-5, the
  gradients within 1e-4;
- three learn steps of `xformer` with 4 experts at expert 2 and at data
  2, and of `ximpala` with 4 experts at data 2 (its losses are sums, so
  each data rank adds half the routers' term), within ROADMAP F14's bar.
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
B, T, D, E, TOP_K, CF = 4, 8, 16, 4, 2, 1.0
AUX_W = 0.01
OPS = {"expert2": dict(expert_parallel=2), "data2": {}}
# One MoE block each: the learn steps' compile time is most of this file's.
XF = dict(obs_shape=(2,), num_actions=3, seq_len=8, burn_in=2, d_model=32, num_heads=2,
          num_layers=1, num_experts=4, moe_capacity_factor=1.0)
XI = dict(obs_shape=(4,), num_actions=3, trajectory=8, d_model=32, num_heads=2, num_layers=1,
          num_experts=4, moe_capacity_factor=1.0)
# (tag, family, config, port mesh kwargs, JAX reference)
LEARN = [("xformer_expert2", "xformer", XF, dict(expert_parallel=2), "xformer"),
         ("xformer_data2", "xformer", XF, {}, "xformer"),
         ("ximpala_data2", "ximpala", XI, {}, "ximpala")]
# JAX's ShardedLearners: (family, config, mesh kwargs, agent built over the
# mesh, devices). The xformer's, over data 2 x expert 2, is the reference
# of both xformer cases (its numbers are the union batch's on any mesh);
# the ximpala's is the MoE transformer over a plain data split.
JAX_LEARN = {"xformer": ("xformer", XF, dict(expert_parallel=2), True, 4),
             "ximpala": ("ximpala", XI, {}, False, 2)}
LEARN_B = 8


def _moe_inputs():
    rng = np.random.default_rng(3)
    params = {"moe_gate": rng.standard_normal((D, E)).astype(np.float32),
              "moe_w1": 0.3 * rng.standard_normal((E, D, 2 * D)).astype(np.float32),
              "moe_b1": 0.1 * rng.standard_normal((E, 2 * D)).astype(np.float32),
              "moe_w2": 0.3 * rng.standard_normal((E, 2 * D, D)).astype(np.float32),
              "moe_b2": 0.1 * rng.standard_normal((E, D)).astype(np.float32)}
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    cot = rng.standard_normal((B, T, D)).astype(np.float32)
    return params, x, cot


# -- one rank (this file's __main__ block) ---------------------------------
def _port_moe(mesh_kw: dict) -> dict:
    """moe_mlp on this rank's rows and experts: the output, the aux term,
    this rank's rows of the union dispatch, the gradients of
    sum(y * cot) + AUX_W * aux (aux / data on each data rank, whose
    gradients sum to the union's)."""
    import torch

    from distributed_reinforcement_learning_tpu_torch.ops import moe
    from distributed_reinforcement_learning_tpu_torch.parallel import make_mesh
    from distributed_reinforcement_learning_tpu_torch.parallel.mesh import DATA_AXIS, EXPERT_AXIS

    mesh = make_mesh(**mesh_kw)
    d, i = mesh.size(DATA_AXIS), mesh.coords[DATA_AXIS]
    n_ep, j = mesh.size(EXPERT_AXIS), mesh.coords[EXPERT_AXIS]
    rows = slice(i * B // d, (i + 1) * B // d)
    experts = slice(j * E // n_ep, (j + 1) * E // n_ep)
    whole, x, cot = _moe_inputs()
    params = {k: torch.from_numpy(v if k == "moe_gate" else v[experts]).requires_grad_(True)
              for k, v in whole.items()}
    x = torch.from_numpy(x[rows]).requires_grad_(True)
    y, aux = moe.moe_mlp(x, params, top_k=TOP_K, capacity_factor=CF, mesh=mesh)
    grads = torch.autograd.grad((y * torch.from_numpy(cot[rows])).sum() + AUX_W * aux / d,
                                [*params.values(), x])
    with torch.no_grad():
        probs = torch.softmax(x.reshape(-1, D) @ params["moe_gate"], -1)
        probs, own = moe._global_probs(probs, x.shape[:-1], mesh, False)
        dispatch = moe._dispatch_combine(probs, TOP_K, moe.expert_capacity(
            probs.shape[0], E, TOP_K, CF))[0]
        dispatch = dispatch if own is None else dispatch[own]
    return {"y": y.detach().numpy(), "aux": float(aux), "rows": (rows.start, rows.stop),
            "experts": (experts.start, experts.stop), "dispatch": dispatch.numpy(),
            "grads": {k: g.numpy() for k, g in zip([*params, "x"], grads)}}


def _run(name: str, payload: dict) -> dict:
    out = {tag: _port_moe(kw) for tag, kw in OPS.items()}
    for tag, algo, kw, mesh_kw, ref in LEARN:
        out[tag] = worlds_lib.port_learn(algo, kw, mesh_kw, payload[ref], LEARN_B, seed0=90)
    return out


# -- the JAX side ------------------------------------------------------------
def _jax_moe() -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from distributed_reinforcement_learning_tpu import parallel as jpar
    from distributed_reinforcement_learning_tpu.ops import moe as jmoe

    mesh = jpar.make_mesh(4, expert_parallel=2)  # data 2 x expert 2
    whole, x, cot = _moe_inputs()
    params = {k: jax.device_put(jnp.asarray(v), NamedSharding(
        mesh, P() if k == "moe_gate" else P("expert"))) for k, v in whole.items()}
    x = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))

    def loss(p, x):
        y, aux = jmoe.moe_mlp(x, p, top_k=TOP_K, capacity_factor=CF, mesh=mesh)
        return jnp.sum(y * cot) + AUX_W * aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, x)
    probs = jax.nn.softmax(jnp.asarray(_moe_inputs()[1]).reshape(-1, D)
                           @ jnp.asarray(whole["moe_gate"]), -1)
    dispatch = jmoe._dispatch_combine(probs, TOP_K, jmoe.expert_capacity(B * T, E, TOP_K, CF))[0]
    return {"y": np.asarray(y), "aux": float(aux), "dispatch": np.asarray(dispatch),
            "grads": {**{k: np.asarray(v) for k, v in gp.items()}, "x": np.asarray(gx)}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("expert_world")
    setups = {ref: worlds_lib.jax_setup(algo, kw, mesh_kw, agent_mesh, n_devices=n)
              for ref, (algo, kw, mesh_kw, agent_mesh, n) in JAX_LEARN.items()}
    procs = worlds_lib.start_world(__file__, "w2", 2, tmp,
                                   {ref: init for ref, (_, init) in setups.items()})
    *learned, moe = worlds_lib.on_threads(
        [lambda h=h: worlds_lib.jax_learn(h, LEARN_B, seed0=90) for h, _ in setups.values()]
        + [_jax_moe])
    learned = dict(zip(setups, learned))
    ranks = worlds_lib.join_world(procs)
    return types.SimpleNamespace(ranks=ranks, moe=moe, learn=learned)


@pytest.mark.parametrize("tag", sorted(OPS))
def test_moe_routes_the_union_batch_as_jax(world, tag):
    want = world.moe
    n = len(world.ranks)
    grads: dict[str, np.ndarray] = {}
    for rank in world.ranks:
        got = rank[tag]
        lo, hi = got["rows"]
        tokens = slice(lo * T, hi * T)
        assert np.array_equal(got["dispatch"], want["dispatch"][tokens]), tag
        np.testing.assert_allclose(got["y"], want["y"][lo:hi], atol=VAL_TOL, rtol=0)
        np.testing.assert_allclose(got["aux"], want["aux"], atol=VAL_TOL, rtol=0)
        np.testing.assert_allclose(got["grads"]["x"], want["grads"]["x"][lo:hi],
                                   atol=GRAD_TOL, rtol=0)
        e0, e1 = got["experts"]
        for k, g in got["grads"].items():
            if k == "x":
                continue
            if tag == "expert2":  # each rank's experts' whole gradient, the gate's too
                w = want["grads"][k] if k == "moe_gate" else want["grads"][k][e0:e1]
                np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=0, err_msg=f"{tag} d{k}")
            else:  # each data rank's part; the parts sum to the union's
                grads[k] = grads.get(k, 0) + g
    for k, g in grads.items():
        np.testing.assert_allclose(g, want["grads"][k], atol=GRAD_TOL, rtol=0,
                                   err_msg=f"{tag} d{k} summed over {n} ranks")
    # The capacity factor drops tokens: the test would see a rank's own routing.
    assert want["dispatch"].sum() < TOP_K * B * T


@pytest.mark.parametrize("tag", [case[0] for case in LEARN])
def test_learn_steps_match_jax(world, tag):
    ref = {case[0]: case[4] for case in LEARN}[tag]
    ranks = [r[tag] for r in world.ranks]
    worlds_lib.assert_ranks_equal(ranks, tag)
    worlds_lib.assert_learn_close(ranks[0], world.learn[ref], ranks[0]["plain"], RTOL, ATOL,
                                  tag)
    moved = ranks[0]["bytes_by"]
    if tag.endswith("expert2"):
        # Each rank holds half the experts; their partial combines summed.
        assert ranks[0]["bytes_local"] < ranks[0]["bytes_whole"]
        assert moved.get("all_reduce/expert", 0) > 0
    else:
        # The routers' probabilities gathered over the data split.
        assert moved.get("all_gather/data", 0) > 0


if __name__ == "__main__":
    worlds_lib.rank_main(sys.argv[1:], _run)
