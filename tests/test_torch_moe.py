"""The mixture-of-experts MLP of the PyTorch port against the JAX package's
`ops/moe.py`, on the CPU.

The same numpy tokens and the same router and expert weights go through
`moe_mlp` of both packages, at top_k 1 and 2, with a capacity factor
that drops tokens and with one that drops none: the dispatch and combine
tensors (`_dispatch_combine`) equal, the outputs at atol 1e-5, the aux
loss at 1e-6, and the gradients of a loss of both outputs with respect
to the tokens and every MoE parameter at 1e-4. Exact ties between router
probabilities go to the lower expert index in both packages (constant
tokens make every probability equal). `init_moe_params` draws the JAX
shapes within the Glorot bounds of the fans (d, h), the expert dim being
a batch axis; a mesh raises.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.ops import moe as jmoe
from distributed_reinforcement_learning_tpu_torch.ops import moe

D, H, E = 16, 64, 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # One thread for torch and for numpy's BLAS pool: OpenBLAS spreads the
    # Atari resize's small matmuls over every core, which costs far more
    # than the matmuls once several test workers share the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _inputs(seed: int, shape=(4, 10)):
    params = jax.tree.map(np.asarray, jmoe.init_moe_params(jax.random.PRNGKey(seed), D, H, E))
    # Non-zero biases, so that their gradients and the dropped tokens' zero
    # outputs are both tested.
    rng = np.random.RandomState(seed)
    params = {k: (v + (0.1 * rng.randn(*v.shape) if k.startswith("moe_b") else 0)
                  ).astype(np.float32) for k, v in params.items()}
    x = rng.randn(*shape, D).astype(np.float32)
    return params, x


def _jax_loss(params, x, top_k, cf):
    y, aux = jmoe.moe_mlp(x, params, top_k=top_k, capacity_factor=cf)
    return jnp.sum(y * jnp.cos(y)) + 3.0 * aux, (y, aux)


@pytest.mark.parametrize("cf", [0.5, 4.0], ids=["drops", "ample"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_mlp_matches_jax(top_k, cf):
    params, x = _inputs(seed=top_k)
    (_, (want_y, want_aux)), (want_gp, want_gx) = jax.value_and_grad(
        _jax_loss, argnums=(0, 1), has_aux=True)(params, x, top_k, cf)

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = moe.moe_mlp(tx, tp, top_k=top_k, capacity_factor=cf)
    loss = torch.sum(y * torch.cos(y)) + 3.0 * aux
    grads = torch.autograd.grad(loss, [tx, *tp.values()])

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(want_aux), atol=1e-6)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_gx), atol=1e-4)
    for (k, _), g in zip(tp.items(), grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_gp[k]), atol=1e-4, err_msg=k)

    # The routing itself: the same tokens in the same slots, the same drops.
    xf = x.reshape(-1, D)
    probs = np.array(jax.nn.softmax(xf @ params["moe_gate"], axis=-1))
    cap = moe.expert_capacity(len(xf), E, top_k, cf)
    assert cap == jmoe.expert_capacity(len(xf), E, top_k, cf)
    want = jmoe._dispatch_combine(jnp.asarray(probs), top_k, cap)
    got = moe._dispatch_combine(torch.from_numpy(probs), top_k, cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-7)
    routed = got[0].sum().item()
    if cf < 1.0:
        assert routed == E * cap < top_k * len(xf)  # full experts dropped tokens
    else:
        assert routed == top_k * len(xf)


def test_ties_go_to_the_lower_expert_as_in_jax():
    """Constant tokens give every token the same probabilities; a zero
    router makes them all equal, so top-k is all ties."""
    params, _ = _inputs(seed=3)
    params["moe_gate"] = np.zeros_like(params["moe_gate"])
    x = np.ones((12, D), np.float32)
    probs = np.full((12, E), 1.0 / E, np.float32)
    vals, idx = moe.top_k_lower_index(torch.from_numpy(probs), 2)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(probs), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))
    for top_k in (1, 2):
        cap = moe.expert_capacity(12, E, top_k, 1.0)
        want = jmoe._dispatch_combine(jnp.asarray(probs), top_k, cap)
        got = moe._dispatch_combine(torch.from_numpy(probs), top_k, cap)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        y, aux = moe.moe_mlp(torch.from_numpy(x), {k: torch.from_numpy(v)
                                                    for k, v in params.items()}, top_k=top_k,
                             capacity_factor=1.0)
        want_y, want_aux = jmoe.moe_mlp(x, params, top_k=top_k, capacity_factor=1.0)
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5)
        np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6)


def test_init_draws_the_jax_shapes_within_the_glorot_bounds():
    got = moe.init_moe_params(D, H, E, torch.Generator().manual_seed(0))
    want = jmoe.init_moe_params(jax.random.PRNGKey(0), D, H, E)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    for k, (fan_in, fan_out) in {"moe_gate": (D, E), "moe_w1": (D, H),
                                 "moe_w2": (H, D)}.items():
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        assert float(got[k].abs().max()) <= bound
        # A uniform draw over [-bound, bound] reaches most of its range.
        assert float(got[k].abs().max()) > 0.8 * bound
        assert float(np.abs(np.asarray(want[k])).max()) <= bound * (1 + 1e-6)
    for k in ("moe_b1", "moe_b2"):
        assert not got[k].any()


def test_a_mesh_raises_naming_item_13():
    # Item 13c is ported: over a mesh of one (this process alone) the
    # union batch is the rank's own, and moe_mlp is the plain one bit for
    # bit (test_torch_expert.py holds the expert and data axes to JAX).
    from distributed_reinforcement_learning_tpu_torch.parallel import make_mesh

    params, x = _inputs(seed=0)
    args = (torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in params.items()})
    y, aux = moe.moe_mlp(*args)
    y1, aux1 = moe.moe_mlp(*args, mesh=make_mesh(device="cpu"))
    assert torch.equal(y, y1) and torch.equal(aux, aux1)
