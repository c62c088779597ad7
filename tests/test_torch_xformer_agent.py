"""The Transformer-R2D2 agent of the PyTorch port against the JAX
package's `XformerAgent`, on the CPU.

`act`, `_td_error` and `_learn` from the same converted parameters (a
target network that differs from the main one) on the same numpy batch
and IS weights, for the dense body (the `xformer` section's), MoE (the
`xformer_moe` section's) and the stacked layout with remat and the eta
priority: act Q-values at atol 1e-5; td_error, loss, grad norm and
priorities at rtol 1e-4; the parameters after the step at rtol 1e-4
(atol 1% of lr), except where the gradient sits at float32's noise
floor, which Adam normalises to up to lr either way: there the lr-sized
bound of chip_smoke's device parity (`adam_step_close`). The flash calls
are those the card counts at T = 16. A K=2 `learn_many` against the JAX
scan. The MoE aux term is in the loss, from the online forward only.
"""

from functools import lru_cache

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.agents import common as jax_common
from distributed_reinforcement_learning_tpu.agents.xformer import XformerAgent as JaxAgent
from distributed_reinforcement_learning_tpu.agents.xformer import XformerBatch as JaxBatch
from distributed_reinforcement_learning_tpu.agents.xformer import XformerConfig as JaxConfig
from distributed_reinforcement_learning_tpu_torch.agents.xformer import (
    XformerAgent, XformerBatch, XformerConfig)
from distributed_reinforcement_learning_tpu_torch.envs.cartpole import pomdp_project
from distributed_reinforcement_learning_tpu_torch.models.convert import (
    transformer_params_from_jax)
from test_torch_xformer import _FlashCalls, _np, _seq


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


LR = 1e-3
AGENTS = {
    "dense": dict(),
    "moe": dict(num_experts=4, moe_aux_weight=0.05),
    # td_error ignores priority_eta in both packages; learn takes it.
    "stacked_remat_eta": dict(stacked=True, remat=True, priority_eta=0.9),
}


def _kw(body: str) -> dict:
    return dict(obs_shape=(2,), num_actions=2, seq_len=16, burn_in=4, d_model=64, num_heads=2,
                num_layers=2, learning_rate=LR, **AGENTS[body])


@lru_cache(maxsize=None)
def _jax(body: str):
    """The JAX agent of a body and its jitted functions, compiled once for
    every test of this file."""
    jagent = JaxAgent(JaxConfig(**_kw(body)))
    return jagent, jax.jit(jagent.init_state), jax.jit(jagent._learn)


def _agents(body: str):
    jagent, init, _ = _jax(body)
    jstate = init(jax.random.PRNGKey(0))
    other = init(jax.random.PRNGKey(1)).params
    jstate = jstate.replace(target_params=other)
    agent = XformerAgent(XformerConfig(**_kw(body)), device="cpu")
    state = agent.state_from_params(transformer_params_from_jax(_np(jstate.params)))
    for k, v in transformer_params_from_jax(_np(other)).items():
        state.target_params[k].copy_(v)
    return jagent, jstate, agent, state


def _batch(B, T, seed, K=None):
    rng = np.random.RandomState(seed)
    lead = (B, T) if K is None else (K, B, T)
    return dict(state=pomdp_project(rng.randn(*lead, 4) * 0.2),
                previous_action=rng.randint(0, 2, lead).astype(np.int32),
                action=rng.randint(0, 2, lead).astype(np.int32),
                reward=rng.choice([0.0, 1.0], lead).astype(np.float32),
                done=rng.rand(*lead) < 0.15)


def _adam_mu(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")).mu


def _assert_adam_steps(params, want_params, mus, want_mus) -> None:
    """Parameters after len(mus) Adam steps, held as chip_smoke's
    `adam_step_close` holds them, with each step's gradient read off
    Adam's first moments (g_t = (mu_t - 0.9 mu_{t-1}) / 0.1): the gradients
    agree to float32 accuracy; where they agree to 0.1% at every step the
    steps are settled and the parameters agree to rtol 1e-4 (atol 1% of lr
    a step); elsewhere a gradient sat at float32's noise floor, Adam
    normalised it to up to lr either way, and the parameters may differ by
    no more than the 2 lr a step that bounds it."""
    steps = len(mus)
    want_p = transformer_params_from_jax(_np(want_params))
    assert set(want_p) == set(params)
    for k, w in want_p.items():
        got = params[k].detach()
        settled = torch.ones_like(got, dtype=torch.bool)
        prev, w_prev = torch.zeros_like(got), torch.zeros_like(got)
        for mu, w_mu in zip(mus, want_mus):
            g, w_g = (mu[k] - 0.9 * prev) / 0.1, (w_mu[k] - 0.9 * w_prev) / 0.1
            prev, w_prev = mu[k], w_mu[k]
            torch.testing.assert_close(g, w_g, rtol=1e-4, atol=1e-5 * float(w_g.abs().max()))
            settled &= (g - w_g).abs() <= 1e-3 * w_g.abs()
        torch.testing.assert_close(got[settled], w[settled], rtol=1e-4, atol=steps * 1e-2 * LR)
        assert float((got - w).abs().max()) <= 2 * steps * LR * (1 + 1e-5), k


def _jax_mu(jstate):
    return transformer_params_from_jax(_np(_adam_mu(jstate.opt_state)))


@pytest.mark.parametrize("body", sorted(AGENTS))
def test_agent_act_td_error_and_learn_match_jax(body, monkeypatch):
    jagent, jstate, agent, state = _agents(body)
    calls = _FlashCalls(monkeypatch)

    obs, pa, done = _seq(5, 16, seed=2)
    done[:, :3] = True  # leading pad slots, as in the actor's first windows
    _, want_q = jagent._act(jstate.params, obs, pa, done, 0.0, jax.random.PRNGKey(0))
    action, q = agent.act(state.params, *map(torch.from_numpy, (obs, pa, done)), 0.0,
                          torch.Generator().manual_seed(0))
    np.testing.assert_allclose(q.numpy(), np.asarray(want_q), atol=1e-5)
    torch.testing.assert_close(action, torch.argmax(q, -1))  # epsilon 0: greedy
    assert calls.take() == (2, 0)

    batch = _batch(4, 16, seed=3)
    is_weight = np.array([1.0, 0.5, 0.25, 0.8], np.float32)
    want_td = jax.jit(jagent._td_error)(jstate, JaxBatch(**batch))
    got_td = agent.td_error(state, XformerBatch(**batch))
    np.testing.assert_allclose(got_td.numpy(), np.asarray(want_td), rtol=1e-4, atol=1e-7)
    assert calls.take() == (4, 0)  # online and target forwards

    jstate, want_prio, want_m = _jax(body)[2](jstate, JaxBatch(**batch), is_weight)
    state, prio, metrics = agent.learn(state, XformerBatch(**batch), is_weight)
    assert calls.take() == (4 + 2 * agent.cfg.remat, 2)
    assert set(metrics) == set(want_m) == {"loss", "grad_norm"}
    for k in want_m:
        np.testing.assert_allclose(float(metrics[k]), float(want_m[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(prio.numpy(), np.asarray(want_prio), rtol=1e-4, atol=1e-7)
    _assert_adam_steps(state.params, jstate.params, [state.mu], [_jax_mu(jstate)])
    assert state.step == 1


def test_moe_aux_is_in_the_loss_from_the_online_forward():
    agent = XformerAgent(XformerConfig(**_kw("moe")), device="cpu")
    state = agent.init_state(seed=0)
    for k, v in agent.init_state(seed=1).params.items():
        state.target_params[k].copy_(v)
    batch = XformerBatch(*(torch.as_tensor(x) for x in XformerBatch(**_batch(4, 16, seed=4))))
    tv, sav, aux = agent._sequence_td(state.params, state.target_params, batch)
    with torch.no_grad():
        _, layers = agent._forward(state.params, batch.state, batch.previous_action,
                                   batch.done, return_aux=True)
    assert len(layers) == 2 and all(float(a) >= 1.0 - 1e-5 for a in layers)
    torch.testing.assert_close(aux.detach(), 0.05 * (layers[0] + layers[1]))
    is_weight = torch.ones(4)
    loss, _ = agent._loss(state.params, state.target_params, batch, is_weight)
    td_loss = torch.mean(torch.mean(torch.square(tv - sav), dim=1) * is_weight)
    torch.testing.assert_close(loss.detach(), (td_loss + aux).detach())
    # Only the online parameters get the router's gradient.
    grads = torch.autograd.grad(aux, [state.params["blocks.0.moe.moe_gate"]])
    assert float(grads[0].abs().max()) > 0


def test_learn_many_matches_the_jax_scan():
    """K = 2 steps in one call against the JAX scan; the K steps one by one
    in both packages give each step's moments (the port's `learn_many` is
    bit for bit its K `learn` steps)."""
    K = 2
    jagent, jstate0, agent, state = _agents("moe")
    _, _, _, one_by_one = _agents("moe")
    fields = _batch(4, 16, seed=5, K=K)
    is_weights = np.random.RandomState(6).uniform(0.2, 1.0, (K, 4)).astype(np.float32)
    many = jax.jit(jax_common.scan_learn_weighted(jagent._learn))
    jstate, want_prio, want_m = many(jstate0, JaxBatch(**fields), is_weights)
    state, prio, metrics = agent.learn_many(state, XformerBatch(**fields), is_weights)
    assert prio.shape == (K, 4) and state.step == K
    np.testing.assert_allclose(prio.numpy(), np.asarray(want_prio), rtol=1e-4, atol=1e-6)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(want_m[k]), rtol=1e-4)

    learn, js, mus, want_mus = _jax("moe")[2], jstate0, [], []
    for i in range(K):
        batch = {k: v[i] for k, v in fields.items()}
        js, _, _ = learn(js, JaxBatch(**batch), is_weights[i])
        agent.learn(one_by_one, XformerBatch(**batch), is_weights[i])
        mus.append({k: v.clone() for k, v in one_by_one.mu.items()})
        want_mus.append(_jax_mu(js))
    for k, v in state.params.items():
        torch.testing.assert_close(one_by_one.params[k], v, rtol=0, atol=0)
    _assert_adam_steps(state.params, jstate.params, mus, want_mus)
