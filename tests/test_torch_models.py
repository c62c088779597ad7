"""IMPALA network of the PyTorch port against the JAX package, on weights
converted from flax.

The same numpy inputs go through the flax model and through the port's
`ImpalaActorCritic` loaded with `impala_params_from_jax`. Tolerance: atol
1e-5 on policy, value, h and c (float32 throughout; convolutions and
matrix products sum in another order).
"""

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.agents.impala import ImpalaAgent as JaxAgent
from distributed_reinforcement_learning_tpu.agents.impala import ImpalaConfig as JaxConfig
from distributed_reinforcement_learning_tpu.models.impala_net import (
    apply_stored_state as jax_apply_stored_state)
from distributed_reinforcement_learning_tpu_torch.models.convert import impala_params_from_jax
from distributed_reinforcement_learning_tpu_torch.models.impala_net import (
    ImpalaActorCritic, apply_stored_state)
from distributed_reinforcement_learning_tpu_torch.models.torso import NatureConv
from distributed_reinforcement_learning_tpu_torch.ops.lstm import lstm_step
from distributed_reinforcement_learning_tpu.ops.lstm import lstm_step as jax_lstm_step


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


CONFIGS = {
    "cartpole": dict(obs_shape=(4,), num_actions=2, lstm_size=64),
    "nature_uint8": dict(obs_shape=(84, 84, 4), num_actions=18, lstm_size=32),
    "resnet_folded": dict(obs_shape=(84, 84, 4), num_actions=4, lstm_size=32,
                          torso="resnet", torso_width=1, fold_normalize=True),
}


def _port_model(cfg, jax_params):
    model = ImpalaActorCritic(cfg.num_actions, cfg.obs_shape, cfg.lstm_size,
                              cfg.fold_normalize, cfg.torso, cfg.torso_width)
    model.load_state_dict(impala_params_from_jax(jax.tree.map(np.asarray, jax_params)),
                          strict=True)
    return model


def _obs(cfg, n, rng):
    if len(cfg.obs_shape) == 1:
        return rng.randn(n, *cfg.obs_shape).astype(np.float32)
    return rng.randint(0, 256, (n, *cfg.obs_shape)).astype(np.uint8)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax_on_converted_weights(name):
    cfg = JaxConfig(**CONFIGS[name])
    jagent = JaxAgent(cfg)
    params = jax.jit(jagent.init_state)(jax.random.PRNGKey(1)).params
    model = _port_model(cfg, params)
    assert sum(p.numel() for p in model.parameters()) == sum(
        x.size for x in jax.tree.leaves(params))

    rng = np.random.RandomState(2)
    n = 3
    obs = _obs(cfg, n, rng)
    pa = rng.randint(0, cfg.num_actions, n).astype(np.int32)
    h = rng.randn(n, cfg.lstm_size).astype(np.float32)
    c = rng.randn(n, cfg.lstm_size).astype(np.float32)

    want = jax.jit(jagent.model.apply)(params, jagent._prep_obs(obs), pa, h, c)
    port_obs = torch.from_numpy(obs)
    if obs.dtype == np.uint8 and not cfg.fold_normalize:
        port_obs = port_obs.float() * (1.0 / 255.0)
    with torch.no_grad():
        got = model(port_obs, torch.from_numpy(pa), torch.from_numpy(h), torch.from_numpy(c))
    for field in ("policy", "value", "h", "c"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)), atol=1e-5, err_msg=field)


def test_stored_state_forward_matches_jax():
    cfg = JaxConfig(**CONFIGS["cartpole"])
    jagent = JaxAgent(cfg)
    params = jax.jit(jagent.init_state)(jax.random.PRNGKey(3)).params
    model = _port_model(cfg, params)
    rng = np.random.RandomState(4)
    B, T = 2, 5
    obs = rng.randn(B, T, 4).astype(np.float32)
    pa = rng.randint(0, 2, (B, T)).astype(np.int32)
    h = rng.randn(B, T, cfg.lstm_size).astype(np.float32)
    c = rng.randn(B, T, cfg.lstm_size).astype(np.float32)
    want_p, want_v = jax_apply_stored_state(jagent.model, params, obs, pa, h, c)
    with torch.no_grad():
        got_p, got_v = apply_stored_state(model, dict(model.named_parameters()),
                                          *map(torch.from_numpy, (obs, pa, h, c)))
    assert tuple(got_p.shape) == (B, T, 2) and tuple(got_v.shape) == (B, T)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-5)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-5)


def test_lstm_step_matches_jax():
    rng = np.random.RandomState(5)
    gates = rng.randn(3, 4 * 8).astype(np.float32)
    c = rng.randn(3, 8).astype(np.float32)
    got = lstm_step(torch.from_numpy(gates), torch.from_numpy(c))
    want = jax_lstm_step(gates, c)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_nature_conv_feature_size():
    assert NatureConv.output_size(84, 84) == 3136
    full = ImpalaActorCritic(18, (84, 84, 4), 256)
    assert sum(p.numel() for p in full.parameters()) == 4153267  # the impala section
    assert tuple(full.lstm.gates_kernel.shape) == (3136 + 256 + 256, 1024)


def test_init_is_seeded_glorot_with_zero_bias():
    a = ImpalaActorCritic(2, (4,), 16, generator=torch.Generator().manual_seed(7))
    b = ImpalaActorCritic(2, (4,), 16, generator=torch.Generator().manual_seed(7))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert torch.count_nonzero(a.lstm.gates_bias) == 0
    bound = (6.0 / (a.lstm.gates_kernel.shape[0] + a.lstm.gates_kernel.shape[1])) ** 0.5
    assert a.lstm.gates_kernel.abs().max() <= bound


def _family_models():
    """(name, structure-only module, params, args) of each family's network."""
    from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexAgent, ApexConfig
    from distributed_reinforcement_learning_tpu_torch.agents.impala import (
        ImpalaAgent, ImpalaConfig)
    from distributed_reinforcement_learning_tpu_torch.agents.xformer import (
        XformerAgent, XformerConfig)

    g = torch.Generator().manual_seed(0)
    out = []
    impala = ImpalaAgent(ImpalaConfig(obs_shape=(4,), num_actions=3, lstm_size=16), device="cpu")
    out.append(("impala", impala.model, impala.init_state(seed=0).params,
                (torch.randn(5, 4, generator=g), torch.tensor([0, 1, 2, 0, 1]),
                 torch.randn(5, 16, generator=g), torch.randn(5, 16, generator=g))))
    apex = ApexAgent(ApexConfig(obs_shape=(4,), num_actions=3), device="cpu")
    out.append(("apex", apex.model, apex.init_state(seed=0).params,
                (torch.randn(5, 4, generator=g), torch.tensor([0, 1, 2, 0, 1]))))
    for stacked in (False, True):
        xf = XformerAgent(XformerConfig(obs_shape=(2,), num_actions=2, seq_len=6, burn_in=2,
                                        d_model=16, num_heads=2, num_layers=2, stacked=stacked),
                          device="cpu")
        done = torch.zeros(3, 6, dtype=torch.bool)
        done[1, 3] = True
        out.append((f"xformer_stacked={stacked}", xf.model, xf.init_state(0).params,
                    (torch.randn(3, 6, 2, generator=g),
                     torch.randint(0, 2, (3, 6), generator=g), done)))
    return out


@pytest.mark.parametrize("case", range(4))
def test_functional_call_is_torch_funcs_bit_for_bit(case):
    """The port's `functional_call` gives `torch.func.functional_call`'s
    outputs and gradients bit for bit, and puts the module's own tensors
    back, also when the call raises; a module with a tied parameter is
    refused by name."""
    from torch.func import functional_call as torch_call

    from distributed_reinforcement_learning_tpu_torch.models.functional import functional_call

    name, model, params, args = _family_models()[case]
    own = {k: v for k, v in model.named_parameters()}
    outs, grads = [], []
    for call in (functional_call, torch_call):
        p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        out = call(model, p, args)
        leaves = [t for t in (out if isinstance(out, tuple) else (out,))
                  if isinstance(t, torch.Tensor) and t.is_floating_point()]
        loss = sum(t.square().sum() for t in leaves)
        grads.append(torch.autograd.grad(loss, list(p.values())))
        outs.append([t.detach() for t in leaves])
    for a, b in zip(*outs):
        assert torch.equal(a, b), name
    for a, b in zip(*grads):
        assert torch.equal(a, b), name
    assert all(v is own[k] for k, v in model.named_parameters())
    with pytest.raises(Exception):
        functional_call(model, params, ())  # the forward raises on missing inputs
    assert all(v is own[k] for k, v in model.named_parameters())
    tied = torch.nn.Sequential(torch.nn.Linear(3, 3, bias=False), torch.nn.Linear(3, 3, bias=False))
    tied[1].weight = tied[0].weight
    with pytest.raises(ValueError, match="'1.weight' is tied to '0.weight'"):
        functional_call(tied, {"0.weight": torch.eye(3)}, (torch.zeros(2, 3),))
