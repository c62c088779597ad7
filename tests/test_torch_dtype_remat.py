"""Model options of the IMPALA and R2D2 agents against the JAX package,
on the CPU: bfloat16 compute (`dtype`), IMPALA's `remat`, the K1 and K2
wrappers fed bfloat16, and the NatureConv layout upgrade of old
checkpoints.

- `dtype=bfloat16` (float32 parameters, bfloat16 torso, embedding and
  heads, float32 LSTM, policy, values and losses) from the same converted
  parameters on the same batch as the JAX agent's `dtype=jnp.bfloat16`:
  the policy, both V-trace passes and the loss (IMPALA), the Q-values,
  the loss and the priorities (R2D2), the JAX side jitted as its agent
  runs it. XLA fuses and rounds bfloat16 products at other places than
  PyTorch, so the bar is measured, not float32's. Measured on these
  inputs (CPU): policy within 3.3e-5; values, vs and rhos within 1.2e-7;
  IMPALA losses within 1.2e-6 relative; R2D2 Q-values within 4.9e-4
  (3.3e-3 of the largest |Q|, about two bfloat16 roundings), losses
  within 7.3e-5 relative, priorities within 3.1e-4 of the largest. Bars,
  3-5x those: atol 1e-4 on probabilities, values and V-trace outputs;
  rtol 3e-4 on losses; atol 1.5e-2 of the largest |Q| on Q-values and
  1.5e-3 of the largest on priorities. The float32 path's own parity
  tests keep rtol 1e-4.
- `remat` on and off give the same gradients at rtol 1e-4 (measured: bit
  for bit).
- A bfloat16 `xg` or V-trace input is cast to float32 by the wrapper: the
  result equals the float32 call on the cast inputs bit for bit.
- `upgrade_nature_conv_params` maps an old-layout tree as the JAX
  function does; a checkpoint saved with the old names restores through
  it, and a corrupt one raises with the first error chained.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.agents.impala import ImpalaAgent as JaxImpala
from distributed_reinforcement_learning_tpu.agents.impala import ImpalaBatch as JaxImpalaBatch
from distributed_reinforcement_learning_tpu.agents.impala import ImpalaConfig as JaxImpalaConfig
from distributed_reinforcement_learning_tpu.agents.r2d2 import R2D2Agent as JaxR2D2
from distributed_reinforcement_learning_tpu.agents.r2d2 import R2D2Batch as JaxR2D2Batch
from distributed_reinforcement_learning_tpu.agents.r2d2 import R2D2Config as JaxR2D2Config
from distributed_reinforcement_learning_tpu.models import torso as jax_torso
from distributed_reinforcement_learning_tpu.models.impala_net import (
    apply_stored_state as jax_apply_stored_state)
from distributed_reinforcement_learning_tpu.ops import vtrace as jax_vtrace
from distributed_reinforcement_learning_tpu_torch.agents import common
from distributed_reinforcement_learning_tpu_torch.agents.impala import (
    ImpalaAgent, ImpalaBatch, ImpalaConfig)
from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import (
    R2D2Agent, R2D2Batch, R2D2Config)
from distributed_reinforcement_learning_tpu_torch.models.convert import (
    impala_params_from_jax, r2d2_params_from_jax, upgrade_nature_conv_params)
from distributed_reinforcement_learning_tpu_torch.models.impala_net import apply_stored_state
from distributed_reinforcement_learning_tpu_torch.ops import vtrace
from distributed_reinforcement_learning_tpu_torch.ops.kernels import lstm as klstm
from distributed_reinforcement_learning_tpu_torch.ops.kernels import vtrace as kvt
from distributed_reinforcement_learning_tpu_torch.utils.checkpoint import Checkpointer
from test_torch_impala import LEARN_CASES, _batch as impala_batch

BF16_ATOL = 1e-4  # probabilities, values, V-trace outputs
BF16_LOSS_RTOL = 3e-4
BF16_Q_ATOL = 1.5e-2  # of the largest |Q|
BF16_PRIORITY_ATOL = 1.5e-3  # of the largest priority


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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(batch_cls, batch: dict):
    return common.batch_to_device(batch_cls(**batch), torch.device("cpu"))


@pytest.mark.parametrize("case", sorted(LEARN_CASES))
def test_impala_bf16_matches_jax_bf16(case):
    kw = LEARN_CASES[case]
    jagent = JaxImpala(JaxImpalaConfig(**kw, dtype=jnp.bfloat16))
    jparams = jax.jit(jagent.init_state)(jax.random.PRNGKey(0)).params
    agent = ImpalaAgent(ImpalaConfig(**kw, dtype=torch.bfloat16), device="cpu")
    params = agent.state_from_params(impala_params_from_jax(_np(jparams))).params
    batch = impala_batch(kw, B=4, seed=3)
    tb = _t(ImpalaBatch, batch)

    jpolicy, jvalue = jax.jit(lambda p, b: jax_apply_stored_state(
        jagent.model, p, jagent._prep_obs(b["state"]), b["previous_action"], b["initial_h"],
        b["initial_c"]))(jparams, batch)
    with torch.no_grad():
        policy, value = apply_stored_state(
            agent.model, params, agent._prep_obs(tb.state), tb.previous_action, tb.initial_h,
            tb.initial_c)
    assert policy.dtype == value.dtype == torch.float32
    np.testing.assert_allclose(policy.numpy(), np.asarray(jpolicy), rtol=0, atol=BF16_ATOL,
                               err_msg="policy")
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), rtol=0, atol=BF16_ATOL,
                               err_msg="value")

    # Both V-trace passes of the loss, each package on its own outputs.
    discounts = (~batch["done"]).astype(np.float32) * 0.99
    for lo, hi in ((0, -2), (1, -1)):
        sl = slice(lo, hi)
        nxt = slice(lo + 1, hi + 1 if hi + 1 < 0 else None)
        want = jax_vtrace.from_softmax(
            behavior_policy=batch["behavior_policy"][:, sl], target_policy=jpolicy[:, sl],
            actions=batch["action"][:, sl], discounts=discounts[:, sl],
            rewards=np.clip(batch["reward"][:, sl], -1, 1), values=jvalue[:, sl],
            next_values=jvalue[:, nxt])
        got = vtrace.from_softmax(
            behavior_policy=tb.behavior_policy[:, sl], target_policy=policy[:, sl],
            actions=tb.action[:, sl], discounts=torch.from_numpy(discounts[:, sl]),
            rewards=torch.clamp(tb.reward[:, sl], -1, 1), values=value[:, sl],
            next_values=value[:, nxt])
        for name, a, b in (("vs", got.vs, want.vs), ("rhos", got.clipped_rhos,
                                                    want.clipped_rhos)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=BF16_ATOL,
                                       err_msg=name)

    jloss, _ = jax.jit(jagent._loss)(jparams, JaxImpalaBatch(**batch))
    with torch.no_grad():
        loss, _ = agent.loss(params, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=BF16_LOSS_RTOL)


R2D2_CASES = {
    "mlp": dict(obs_shape=(2,), num_actions=2, seq_len=8, burn_in=3, lstm_size=32),
    "nature": dict(obs_shape=(84, 84, 4), num_actions=4, seq_len=6, burn_in=2, lstm_size=32,
                   torso="nature", fold_normalize=True, priority_eta=0.9),
}


def _r2d2_batch(kw, B, seed):
    rng = np.random.RandomState(seed)
    T, H, A = kw["seq_len"], kw["lstm_size"], kw["num_actions"]
    if len(kw["obs_shape"]) == 1:
        state = (rng.randn(B, T, *kw["obs_shape"]) * 50).astype(np.int32)
    else:
        state = rng.randint(0, 256, (B, T, *kw["obs_shape"])).astype(np.uint8)
    return dict(state=state, previous_action=rng.randint(0, A, (B, T)).astype(np.int32),
                action=rng.randint(0, A, (B, T)).astype(np.int32),
                reward=rng.randn(B, T).astype(np.float32), done=rng.rand(B, T) < 0.15,
                initial_h=(rng.randn(B, H) * 0.3).astype(np.float32),
                initial_c=(rng.randn(B, H) * 0.3).astype(np.float32))


@pytest.mark.parametrize("case", sorted(R2D2_CASES))
def test_r2d2_bf16_matches_jax_bf16(case):
    kw = R2D2_CASES[case]
    jagent = JaxR2D2(JaxR2D2Config(**kw, dtype=jnp.bfloat16))
    jstate = jax.jit(jagent.init_state)(jax.random.PRNGKey(0))
    jtarget = jax.jit(jagent.init_state)(jax.random.PRNGKey(1)).params
    agent = R2D2Agent(R2D2Config(**kw, dtype=torch.bfloat16), device="cpu")
    state = agent.state_from_params(r2d2_params_from_jax(_np(jstate.params)))
    for k, v in r2d2_params_from_jax(_np(jtarget)).items():
        state.target_params[k].copy_(v)
    batch = _r2d2_batch(kw, B=4, seed=2)
    is_weight = np.linspace(0.5, 1.0, 4).astype(np.float32)
    jb = JaxR2D2Batch(**batch)
    tb = _t(R2D2Batch, batch)

    jq = jax.jit(lambda p, b: jagent.model.apply(
        p, jagent._prep_obs(b.state), b.previous_action, b.done, b.initial_h, b.initial_c,
        method=jagent.model.unroll))(jstate.params, jb)
    from torch.func import functional_call

    with torch.no_grad():
        q = functional_call(agent.model, state.params, (agent._prep_obs(tb.state),
                                                         tb.previous_action, tb.initial_h,
                                                         tb.initial_c, tb.done))
    assert q.dtype == torch.float32
    scale = float(np.abs(np.asarray(jq)).max())
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=0, atol=BF16_Q_ATOL * scale,
                               err_msg="q")
    jloss, jprio = jax.jit(jagent._loss)(jstate.params, jtarget, jb, is_weight)
    with torch.no_grad():
        loss, prio = agent._loss(state.params, state.target_params, tb,
                                 torch.from_numpy(is_weight))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=BF16_LOSS_RTOL)
    np.testing.assert_allclose(prio.numpy(), np.asarray(jprio), rtol=0,
                               atol=BF16_PRIORITY_ATOL * float(np.abs(np.asarray(jprio)).max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(LEARN_CASES))
def test_impala_remat_gives_the_same_gradients(case, dtype):
    kw = LEARN_CASES[case]
    batch = _t(ImpalaBatch, impala_batch(kw, B=3, seed=8))
    grads = []
    for remat in (False, True):
        agent = ImpalaAgent(ImpalaConfig(**kw, dtype=dtype, remat=remat), device="cpu")
        params = agent.init_state(4).params
        loss, _ = agent.loss(params, batch)
        grads.append(torch.autograd.grad(loss, list(params.values())))
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-7)


def test_wrappers_cast_bf16_inputs_to_float32():
    rng = np.random.RandomState(0)
    T, B, H = 6, 3, 8
    args = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(torch.bfloat16)
            for s in ((T, B), (T, B), (T, B), (T, B), (B,))]
    got = kvt.vtrace(*args)
    want = kvt.vtrace(*(a.float() for a in args))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=0, atol=0)

    xg = torch.from_numpy(rng.randn(T, B, 4 * H).astype(np.float32)).to(torch.bfloat16)
    keep = torch.from_numpy((rng.rand(T, B) > 0.2).astype(np.float32)).to(torch.bfloat16)
    wh, h0, c0 = (torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.3)
                  for s in ((H, 4 * H), (B, H), (B, H)))
    got = klstm.lstm_fwd(xg, wh, keep, h0, c0)
    want = klstm.lstm_fwd(xg.float(), wh, keep.float(), h0, c0)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # Through autograd: the gradient of the bfloat16 xg comes back in its type.
    leaf = xg.clone().requires_grad_(True)
    h_all, hT, cT = klstm.LSTMFunction.apply(leaf, wh, keep, h0, c0)
    (h_all.sum() + hT.sum() + cT.sum()).backward()
    assert leaf.grad.dtype == torch.bfloat16 and torch.isfinite(leaf.grad.float()).all()
    with pytest.raises(TypeError, match="float32"):
        klstm.lstm_fwd(xg.float(), wh.half(), keep.float(), h0, c0)


OLD_TREE = {"params": {
    "torso": {"Conv_0": {"kernel": np.ones((8, 8, 4, 32), np.float32), "bias": np.zeros(32)},
              "Conv_1": {"kernel": np.ones((4, 4, 32, 64), np.float32)},
              "Conv_2": {"kernel": np.ones((3, 3, 64, 64), np.float32), "bias": np.zeros(64),
                         "extra": np.zeros(1)}},
    "action_embed": {"Dense_0": {"kernel": np.ones((4, 256)), "bias": np.zeros(256)}},
    "lstm": {"gates_kernel": np.ones((3, 8))}}}


def _keys(tree, prefix=()):
    if not isinstance(tree, dict):
        return {prefix}
    return set().union(*(_keys(v, prefix + (k,)) for k, v in tree.items()))


def test_upgrade_nature_conv_params_matches_jax():
    got = upgrade_nature_conv_params(OLD_TREE)
    want = jax_torso.upgrade_nature_conv_params(OLD_TREE)
    assert _keys(got) == _keys(want)
    assert ("params", "torso", "conv0_kernel") in _keys(got)
    assert ("params", "torso", "Conv_2", "extra") in _keys(got)  # not a conv nest: kept
    assert upgrade_nature_conv_params(np.ones(2)).shape == (2,)


def test_converter_takes_an_old_layout_jax_tree():
    """A JAX tree with the old conv nesting converts to the same
    state_dict as its upgraded form (the converters apply the upgrade)."""
    params = _np(jax.jit(JaxImpala(JaxImpalaConfig(**LEARN_CASES["pixels"])).init_state)(
        jax.random.PRNGKey(0)).params)
    old = {**params, "params": {**params["params"], "torso": {
        f"Conv_{i}": {"kernel": params["params"]["torso"][f"conv{i}_kernel"],
                      "bias": params["params"]["torso"][f"conv{i}_bias"]} for i in range(3)}}}
    got, want = impala_params_from_jax(old), impala_params_from_jax(params)
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_checkpoint_restores_old_conv_names_and_chains_errors(tmp_path):
    kw = LEARN_CASES["pixels"]
    agent = ImpalaAgent(ImpalaConfig(**kw), device="cpu")
    state = agent.init_state(1)
    ckpt = Checkpointer(tmp_path)
    ckpt.save(3, state, {"train_steps": 3})
    path = tmp_path / "ckpt_0000000003.pt"
    saved = torch.load(path, weights_only=True)

    def old(names: dict) -> dict:
        return {k.replace("torso.conv", "torso.Conv_"): v for k, v in names.items()}

    torch.save({k: old(v) if isinstance(v, dict) else v for k, v in saved.items()}, path)
    fresh = agent.init_state(2)
    restored, extra, step = ckpt.restore(fresh)
    assert step == 3 and extra == {"train_steps": 3}
    for k, v in state.params.items():
        torch.testing.assert_close(restored.params[k], v, rtol=0, atol=0)

    saved["params"] = {("bogus." + k): v for k, v in saved["params"].items()}
    torch.save(saved, path)
    with pytest.raises(ValueError) as err:
        ckpt.restore(agent.init_state(2))
    assert isinstance(err.value.__cause__, ValueError)
