"""Ape-X of the PyTorch port against the JAX package, on the CPU.

- `DuelingQNetwork` (84x84x4 frames, raw uint8 with `fold_normalize`,
  normalised floats without) and `SimpleQNetwork` forward on weights
  converted from flax: atol 1e-5.
- `double_q_target` and `td_error` against JAX `ops/dqn.py`, exact ties
  of the argmax included.
- `td_error` and one `learn` step against the JAX `_td_error` / `_learn`
  from the same converted parameters (a target network that differs from
  the main one), non-uniform IS weights, mixed dones and `abs_one`
  clipping: rtol 1e-4 on the loss, TD, grad norm, learning rate, the
  parameters and Adam moments after the step. `grads` + `apply_grads`
  equal `learn`.
- `act` at epsilon 0 against JAX's argmax, epsilon-greedy by
  distribution, `sync_target` in place, the `apex` section, the CUDA
  default of the entry points.
- The learner's ingest: K unrolls in one TD forward equal K per-unroll
  forwards (the JAX package's rtol 1e-5), and the pipelined ingest, forced
  on the CPU, equals the plain one, a train step between a dispatch and
  its flush included.
- One full-width run of the `apex` section through the launcher.
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.agents.apex import ApexAgent as JaxAgent
from distributed_reinforcement_learning_tpu.agents.apex import ApexBatch as JaxBatch
from distributed_reinforcement_learning_tpu.agents.apex import ApexConfig as JaxConfig
from distributed_reinforcement_learning_tpu.ops import dqn as jax_dqn
from distributed_reinforcement_learning_tpu.utils.config import load_config as jax_load_config
from distributed_reinforcement_learning_tpu_torch import train_apex
from distributed_reinforcement_learning_tpu_torch.agents.apex import (
    ApexAgent, ApexBatch, ApexConfig)
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
from distributed_reinforcement_learning_tpu_torch.models.apex_net import (
    DuelingQNetwork, SimpleQNetwork)
from distributed_reinforcement_learning_tpu_torch.models.convert import apex_params_from_jax
from distributed_reinforcement_learning_tpu_torch.ops import dqn
from distributed_reinforcement_learning_tpu_torch.ops.kernels import attention as kattn
from distributed_reinforcement_learning_tpu_torch.ops.kernels import lstm as klstm
from distributed_reinforcement_learning_tpu_torch.ops.kernels import vtrace as kvt
from distributed_reinforcement_learning_tpu_torch.runtime import apex_runner
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore
from distributed_reinforcement_learning_tpu_torch.utils.config import load_config

CONFIG = Path(__file__).resolve().parents[1] / "config.json"
# The JAX package's batched-ingest tolerance (tests/test_e2e.py): the [K*32]
# forward and K [32] forwards sum their products in other orders.
_APEX_INGEST_RTOL = 1e-5


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


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


NETS = {
    "dueling_uint8_folded": dict(obs_shape=(84, 84, 4), num_actions=4, fold_normalize=True),
    "dueling_float": dict(obs_shape=(84, 84, 4), num_actions=4),
    "simple": dict(obs_shape=(4,), num_actions=2),
}


def _obs(kw, n, rng):
    """Raw uint8 frames for a folded conv torso, frames in [0, 1] for one
    that does not fold, vector observations for the MLP."""
    if len(kw["obs_shape"]) == 1:
        return (rng.randn(n, *kw["obs_shape"]) * 0.5).astype(np.float32)
    frames = rng.randint(0, 256, (n, *kw["obs_shape"])).astype(np.uint8)
    return frames if kw.get("fold_normalize") else frames.astype(np.float32) / 255.0


def _nets(kw, seed=0):
    jagent = JaxAgent(JaxConfig(**kw))
    params = jagent.model.init(jax.random.PRNGKey(seed),
                               np.zeros((1, *kw["obs_shape"]), np.float32),
                               np.zeros((1,), np.int32))
    if len(kw["obs_shape"]) == 1:
        net = SimpleQNetwork(kw["num_actions"], kw["obs_shape"][0])
    else:
        net = DuelingQNetwork(kw["num_actions"], kw["obs_shape"],
                              fold_normalize=kw.get("fold_normalize", False))
    net.load_state_dict(apex_params_from_jax(_np(params)), strict=True)
    return jagent, params, net


@pytest.mark.parametrize("name", sorted(NETS))
def test_networks_match_jax(name):
    kw = NETS[name]
    rng = np.random.RandomState(1)
    B = 3
    obs = _obs(kw, B, rng)
    pa = rng.randint(0, kw["num_actions"], B).astype(np.int32)
    jagent, params, net = _nets(kw)
    want = jagent.model.apply(params, obs, pa)
    got = net(_t(obs), _t(pa))
    assert got.shape == (B, kw["num_actions"]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


def test_dueling_parameter_count_matches_jax_at_full_width():
    kw = NETS["dueling_uint8_folded"]
    _, params, net = _nets(kw)
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in net.parameters()) == n_jax == 2_015_141


def test_double_q_target_and_td_error_match_jax_with_exact_ties():
    rng = np.random.RandomState(2)
    B, A = 64, 4
    # Coarse values: many rows tie for the max, and the tied actions
    # evaluate differently on the target net, so the tie-break shows.
    next_main = rng.randint(0, 3, (B, A)).astype(np.float32)
    next_main[0] = [2.0, 2.0, 2.0, 2.0]
    next_main[1] = [0.0, 1.0, 1.0, 0.0]
    next_target = rng.randn(B, A).astype(np.float32)
    rewards = rng.randn(B).astype(np.float32)
    discounts = (rng.rand(B) < 0.8).astype(np.float32) * 0.99
    want = np.asarray(jax_dqn.double_q_target(next_main, next_target, rewards, discounts))
    got = dqn.double_q_target(_t(next_main), _t(next_target), _t(rewards), _t(discounts))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == rewards[0] + discounts[0] * next_target[0, 0]  # first maximal index
    assert got[1] == rewards[1] + discounts[1] * next_target[1, 1]
    sav = rng.randn(B).astype(np.float32)
    np.testing.assert_array_equal(dqn.td_error(got, _t(sav)).numpy(),
                                  np.asarray(jax_dqn.td_error(want, sav)))
    # No gradient flows through the target.
    q = _t(next_main).requires_grad_(True)
    assert not dqn.double_q_target(q, _t(next_target), _t(rewards), _t(discounts)).requires_grad


def _batch(kw, B, seed):
    rng = np.random.RandomState(seed)
    A = kw["num_actions"]
    if len(kw["obs_shape"]) == 1:
        state = _obs(kw, B, rng)
        next_state = _obs(kw, B, rng)
    else:  # what the replay holds: raw frames
        state = rng.randint(0, 256, (B, *kw["obs_shape"])).astype(np.uint8)
        next_state = rng.randint(0, 256, (B, *kw["obs_shape"])).astype(np.uint8)
    return dict(
        state=state, next_state=next_state,
        previous_action=rng.randint(0, A, B).astype(np.int32),
        action=rng.randint(0, A, B).astype(np.int32),
        reward=rng.choice([0.0, 1.0, -1.0, 3.0, -2.5], B).astype(np.float32),
        done=np.arange(B) % 3 == 1,
    )


def _adam_state(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))


LEARN_NETS = {
    "dueling_folded": dict(obs_shape=(36, 36, 4), num_actions=4, fold_normalize=True),
    "dueling": dict(obs_shape=(36, 36, 4), num_actions=4),
    "simple": dict(obs_shape=(4,), num_actions=2),
}


# The `apex` section's learning rate. Adam's first step moves each
# parameter by ~lr * sign(g), except where |g| sits near float32's noise
# floor (a sum that cancels), where the step's size follows that noise:
# there the packages' parameters differ by up to ~0.5% of lr, which the
# parameters' atol of 1% of lr admits (rtol stays 1e-4).
_LR = 1e-4


def _agents(kw):
    """The JAX and port agents on the same converted parameters, with a
    target network that differs from the main one."""
    cfg = dict(kw, start_learning_rate=_LR, end_learning_rate=1e-5, learning_frame=1000,
               gradient_clip_norm=40.0, reward_clipping="abs_one")
    jagent = JaxAgent(JaxConfig(**cfg))
    jstate = jax.jit(jagent.init_state)(jax.random.PRNGKey(0))
    other = jax.jit(jagent.init_state)(jax.random.PRNGKey(1)).params
    jstate = jstate.replace(target_params=other)
    agent = ApexAgent(ApexConfig(**cfg), device="cpu")
    state = agent.state_from_params(apex_params_from_jax(_np(jstate.params)))
    for k, v in apex_params_from_jax(_np(other)).items():
        state.target_params[k].copy_(v)
    return jagent, jstate, agent, state


@pytest.mark.parametrize("name", sorted(LEARN_NETS))
def test_td_error_and_learn_step_match_jax(name):
    kw = LEARN_NETS[name]
    jagent, jstate, agent, state = _agents(kw)
    B = 8
    batch = _batch(kw, B, seed=3)
    assert batch["done"].any() and not batch["done"].all()
    assert np.abs(batch["reward"]).max() > 1.0  # abs_one clipping matters
    is_weight = np.linspace(0.2, 1.0, B).astype(np.float32)

    want_td = jax.jit(jagent._td_error)(jstate, JaxBatch(**batch))
    got_td = agent.td_error(state, ApexBatch(**batch))
    np.testing.assert_allclose(got_td.numpy(), np.asarray(want_td), rtol=1e-4, atol=1e-6)

    jstate, want_td, want_m = jax.jit(jagent._learn)(jstate, JaxBatch(**batch), is_weight)
    state, td, metrics = agent.learn(state, ApexBatch(**batch), is_weight)
    assert set(metrics) == set(want_m) == {"loss", "grad_norm", "learning_rate"}
    for k in want_m:
        np.testing.assert_allclose(float(metrics[k]), float(want_m[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(td.numpy(), np.asarray(want_td), rtol=1e-4, atol=1e-6)
    assert state.step == 1 and int(jstate.step) == 1

    adam = _adam_state(jstate.opt_state)
    for what, got, want_tree in (("params", state.params, jstate.params),
                                 ("mu", state.mu, adam.mu), ("nu", state.nu, adam.nu)):
        want = apex_params_from_jax(_np(want_tree))
        assert set(want) == set(got)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-2 * _LR if what == "params" else 1e-9,
                                       err_msg=f"{what} {k}")


def test_stacked_main_pass_equals_two_passes():
    kw = LEARN_NETS["dueling_folded"]
    _, _, agent, state = _agents(kw)
    b = ApexBatch(**{k: _t(v) for k, v in _batch(kw, 6, seed=4).items()})
    tv, sav = agent._targets(state.params, state.target_params, b)
    from torch.func import functional_call

    main_q = functional_call(agent.model, state.params, (b.state, b.previous_action.long()))
    next_q = functional_call(agent.model, state.params, (b.next_state, b.action.long()))
    target_q = functional_call(agent.model, state.target_params, (b.next_state, b.action.long()))
    want_tv = dqn.double_q_target(next_q, target_q, torch.clamp(b.reward, -1, 1),
                                  (~b.done).float() * 0.99)
    torch.testing.assert_close(sav, dqn.take_state_action_value(main_q, b.action),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(tv, want_tv, rtol=1e-5, atol=1e-6)


def test_grads_then_apply_grads_equals_learn():
    kw = LEARN_NETS["simple"]
    _, _, agent, state = _agents(kw)
    _, _, _, twin = _agents(kw)
    batch = ApexBatch(**_batch(kw, 8, seed=5))
    is_weight = np.linspace(0.3, 1.0, 8).astype(np.float32)
    state, td, metrics = agent.learn(state, batch, is_weight)
    grads, td2, loss = agent.grads(twin, batch, is_weight)
    assert all(not p.requires_grad for p in grads.values())
    twin, metrics2 = agent.apply_grads(twin, grads, loss)
    assert torch.equal(td, td2) and twin.step == state.step == 1
    assert {k: float(v) for k, v in metrics.items()} == {k: float(v) for k, v in metrics2.items()}
    for k, p in state.params.items():
        assert torch.equal(p, twin.params[k])


def test_relu_tape_pins_the_recorded_pattern():
    """chip_smoke's `relu_tape`, which its K-call replay runs under: a taped
    `grads` equals a plain one, a replay pinned to its own tape equals it
    too, and one pinned unit moved across 0 moves the gradients as that
    unit's own derivative would. Other threads go untaped and relu is
    restored after the block."""
    import threading

    from chip_smoke import relu_tape

    kw = LEARN_NETS["dueling_folded"]
    _, _, agent, state = _agents(kw)
    b = ApexBatch(**{k: _t(v) for k, v in _batch(kw, 6, seed=4).items()})
    w = np.linspace(0.3, 1.0, 6).astype(np.float32)
    relu = torch.nn.functional.relu
    plain, _, _ = agent.grads(state, b, w)
    tape, other = [], []
    with relu_tape(tape):
        taped, _, _ = agent.grads(state, b, w)
        worker = threading.Thread(target=lambda: other.append(agent.grads(state, b, w)))
        worker.start()
        worker.join()
    assert torch.nn.functional.relu is relu
    assert other and len(tape) == 18  # 9 ReLUs a pass: the stacked main pass, the target's
    again = []
    with relu_tape(again, pin=tape):
        pinned, _, _ = agent.grads(state, b, w)
    assert len(again) == len(tape)
    for k in plain:
        assert torch.equal(taped[k], plain[k]) and torch.equal(pinned[k], plain[k]), k
    # The conv1 input of the main pass nearest 0, pinned to the other side:
    # the forward barely moves, conv0's gradient takes that unit's term.
    moved = [t.clone() for t in tape]
    conv1 = moved[1].contiguous()
    unit = int(torch.argmin(conv1.abs().flatten()))
    x = float(conv1.view(-1)[unit])
    conv1.view(-1)[unit] = 1.0 if x <= 0 else -1.0
    moved[1] = conv1
    with relu_tape([], pin=moved):
        flipped, _, _ = agent.grads(state, b, w)
    assert abs(x) < 1e-3
    assert not torch.equal(flipped["torso.conv0.weight"], plain["torso.conv0.weight"])
    for k in ("value.layers.1.weight", "mean.layers.1.weight"):
        torch.testing.assert_close(flipped[k], plain[k], rtol=1e-4, atol=1e-6)


def test_act_at_epsilon_zero_is_jax_argmax():
    kw = NETS["dueling_uint8_folded"]
    _, jstate, agent, state = _agents(kw)
    jagent = JaxAgent(JaxConfig(**kw))
    rng = np.random.RandomState(6)
    obs = rng.randint(0, 256, (5, *kw["obs_shape"])).astype(np.uint8)
    pa = rng.randint(0, 4, 5).astype(np.int32)
    want_a, want_q = jagent.act(jstate.params, obs, pa, np.zeros(5, np.float32),
                                jax.random.PRNGKey(3))
    action, q = agent.act(state.params, _t(obs), _t(pa), torch.zeros(5),
                          torch.Generator().manual_seed(0))
    np.testing.assert_allclose(q.numpy(), np.asarray(want_q), atol=1e-5)
    np.testing.assert_array_equal(action.numpy(), np.asarray(want_a))


def test_act_is_epsilon_greedy_by_distribution():
    kw = LEARN_NETS["simple"]
    _, _, agent, state = _agents(kw)
    n = 30000
    obs = torch.from_numpy(np.tile(np.array([[0.1, -0.2, 0.05, 0.3]], np.float32), (n, 1)))
    pa = torch.zeros(n, dtype=torch.int32)
    greedy, _ = agent.act(state.params, obs[:1], pa[:1], 0.0, torch.Generator().manual_seed(0))
    for eps in (0.0, 0.3, 1.0):
        action, _ = agent.act(state.params, obs, pa, torch.full((n,), eps),
                              torch.Generator().manual_seed(1))
        freq = float((action == greedy[0]).float().mean())
        want = 1.0 - eps + eps / kw["num_actions"]
        assert abs(freq - want) <= 5 * np.sqrt(want * (1 - want) / n) + 1e-9, (eps, freq)


def test_sync_target_copies_in_place():
    agent = ApexAgent(ApexConfig(obs_shape=(4,), num_actions=2), device="cpu")
    state = agent.init_state(seed=0)
    target_ids = {k: v.data_ptr() for k, v in state.target_params.items()}
    with torch.no_grad():
        for p in state.params.values():
            p.add_(1.0)
    agent.sync_target(state)
    for k, p in state.params.items():
        assert torch.equal(state.target_params[k], p.detach())
        assert state.target_params[k].data_ptr() == target_ids[k]
        assert not state.target_params[k].requires_grad


def test_load_config_matches_jax():
    cfg, rt = load_config(CONFIG, "apex")
    jcfg, jrt = jax_load_config(CONFIG, "apex")
    assert isinstance(cfg, ApexConfig)
    assert dataclasses.asdict(cfg) == {k: v for k, v in dataclasses.asdict(jcfg).items()
                                       if k != "dtype"}
    for field in dataclasses.fields(rt):
        assert getattr(rt, field.name) == getattr(jrt, field.name), field.name
    assert (cfg.obs_shape, cfg.num_actions, rt.batch_size, rt.queue_size) == (
        (84, 84, 4), 4, 32, 32)
    assert (rt.num_actors, rt.envs_per_actor, rt.replay_capacity) == (4, 5, 100_000)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ApexAgent(ApexConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_apex.main(["--config", str(CONFIG), "--updates", "1"])


@pytest.mark.parametrize("argv, item", [
    (["--mode", "anakin"], "item 13"),
    (["--mode", "inference"], "item 13"),
    (["--mode", "learner", "--serve_inference"], "item 13"),
    (["--mode", "actor", "--task", "0", "--remote_act"], "item 13"),
])
def test_unported_modes_raise(argv, item, tmp_path, monkeypatch):
    # Serving acts, the on-device loop, the learner tier and the
    # multi-process learner are ported, and so is item 13c: a sequence
    # axis on a non-transformer section is ignored, as the JAX package
    # ignores it. Each mode takes the section (its run is stubbed at its
    # entry), and the learner it would build is the plain agent, with no
    # mesh.
    from distributed_reinforcement_learning_tpu_torch.runtime import launch, transport

    cfg = json.loads(CONFIG.read_text())
    cfg["apex"]["seq_parallel"] = 2
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    calls = []
    stub = lambda *a, **kw: calls.append(a) or {}
    monkeypatch.setattr(transport, "run_role", stub)
    monkeypatch.setattr(launch, "train_anakin_apex", stub)
    train_apex.main(["--config", str(path), "--device", "cpu", *argv])
    assert len(calls) == 1
    agent_cfg, rt = load_config(path, "apex")
    assert rt.seq_parallel == 2 and not launch.needs_sharded_learner("apex", agent_cfg, rt)
    assert transport._multihost_mesh("apex", agent_cfg, rt, 1, False)[1] is None
    assert type(launch.make_agent("apex", agent_cfg, device="cpu", rt=rt)) is ApexAgent


def _unrolls(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return [ApexBatch(
        state=rng.rand(32, 4).astype(np.float32),
        next_state=rng.rand(32, 4).astype(np.float32),
        previous_action=rng.randint(0, 2, 32).astype(np.int32),
        action=rng.randint(0, 2, 32).astype(np.int32),
        reward=rng.randn(32).astype(np.float32),
        done=rng.rand(32) < 0.1,
    ) for _ in range(n)]


def _learner(unrolls, **kw):
    agent = ApexAgent(ApexConfig(obs_shape=(4,), num_actions=2), device="cpu")
    queue = TrajectoryQueue(capacity=16)
    learner = apex_runner.ApexLearner(agent, queue, WeightStore(), batch_size=8,
                                      replay_capacity=1_000, seed=0, **kw)
    for u in unrolls:
        queue.put(u)
    return learner


def _assert_same_replay(a, b):
    snap_a, snap_b = a.replay.snapshot(), b.replay.snapshot()
    np.testing.assert_allclose(snap_a["priorities"], snap_b["priorities"],
                               rtol=_APEX_INGEST_RTOL)
    for field in ApexBatch._fields:
        np.testing.assert_array_equal(getattr(snap_a["stacked"], field),
                                      getattr(snap_b["stacked"], field))


def test_ingest_many_matches_per_unroll():
    """The batched [K*32] TD forward ingests exactly what K per-unroll
    passes ingest: the same count, stored transitions and priorities."""
    unrolls = _unrolls()
    a = _learner(unrolls)
    assert a.ingest_pipeline is None  # auto: off on the CPU
    while a.ingest_many(max_unrolls=1, timeout=0.0):
        pass
    b = _learner(unrolls)
    assert b.ingest_many(max_unrolls=4, timeout=0.0) == 4
    assert a.ingested_unrolls == b.ingested_unrolls == 4
    assert len(a.replay) == len(b.replay) == 128
    assert type(a.replay).__name__ == "ArrayPrioritizedReplay"
    _assert_same_replay(a, b)


def test_pipelined_ingest_matches_the_plain_one():
    """Forced on the CPU: the drain loop ingests everything, in order; a
    zero return means nothing is in flight."""
    unrolls = _unrolls()
    a = _learner(unrolls)
    while a.ingest_many(max_unrolls=1, timeout=0.0):
        pass
    c = _learner(unrolls)
    c.ingest_pipeline = True
    total = 0
    while True:
        got = c.ingest_many(max_unrolls=2, timeout=0.0)
        if not got:
            break
        total += got
    assert total == 4 and c.ingested_unrolls == 4 and c._pending_ingest is None
    _assert_same_replay(a, c)


def test_a_train_step_between_dispatch_and_flush_keeps_the_dispatch_state():
    """Unroll k's TD is computed against the state when it was
    dispatched: a train step before its flush neither changes its
    priorities nor reorders what enters the replay."""
    first, second = _unrolls(2, seed=1), _unrolls(1, seed=2)
    plain = _learner(first + second, train_start_unrolls=1)
    c = _learner(first, train_start_unrolls=1)
    c.ingest_pipeline = True
    assert c.ingest_many(max_unrolls=1, timeout=0.0) == 1  # first[1] in flight
    assert c._pending_ingest is not None
    want_td = plain.agent.td_error(plain.state, first[1]).numpy()
    before = {k: v.detach().clone() for k, v in c.state.params.items()}
    assert c.train() is not None  # trains on first[0]; first[1] is still in flight
    assert any(not torch.equal(before[k], v) for k, v in c.state.params.items())
    assert c.ingest_many(max_unrolls=1, timeout=0.0) == 1  # the flush
    snap = c.replay.snapshot()
    np.testing.assert_allclose(snap["priorities"][32:64] ** (1 / 0.6) - 0.001, want_td,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(snap["stacked"].state[32:64], first[1].state)
    np.testing.assert_array_equal(snap["stacked"].state[:32], first[0].state)


def test_full_width_apex_run_on_cpu(tmp_path):
    """Two train steps of the `apex` section (Breakout-sim frames
    84x84x4, NatureConv, 4 actors x 5 envs, batch 32) through the
    launcher: 4 rounds of 8 steps, the warm-up gate of 10 unrolls passed
    in round 3. No kernel launches on the Ape-X path."""
    launches = (kvt.vtrace_cuda.launches, klstm.lstm_fwd_cuda.launches,
                klstm.lstm_bwd_cuda.launches, kattn.flash_fwd_cuda.launches)
    result = train_apex.main(["--config", str(CONFIG), "--section", "apex", "--updates", "2",
                              "--device", "cpu", "--run_dir", str(tmp_path)])
    assert (kvt.vtrace_cuda.launches, klstm.lstm_fwd_cuda.launches,
            klstm.lstm_bwd_cuda.launches, kattn.flash_fwd_cuda.launches) == launches
    assert result["frames"] == 4 * 4 * 8 * 5
    m = result["last_metrics"]
    assert set(m) == {"loss", "grad_norm", "learning_rate"}
    assert all(np.isfinite(v) for v in m.values()) and m["grad_norm"] > 0
