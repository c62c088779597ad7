"""Transformer-IMPALA in the PyTorch port against the JAX package, on the CPU.

- `episode_segments`, `rope` and `TransformerQNet` (both heads, weights
  converted by `transformer_params_from_jax`) against the flax module:
  atol 1e-5, the JAX package's attention tolerance.
- The window-final act policy against JAX `_act`, and sampling by that
  policy (the RNG streams of the two packages differ, so the test
  compares frequencies with probabilities).
- One learn step against JAX `XImpalaAgent._learn` from the same
  converted parameters on the same numpy batch, whose `env_done` (the
  attention segments) differs from `done` (the discounts): each loss
  term, `grad_norm` and every parameter after the step at rtol 1e-4
  (float32 sums in another order), parameters also atol 1e-8.
- The actor's window: reset at each unroll start, pad slots marked
  done, the true done written into the window's last slot.
- The `ximpala` section loads as in the JAX package; the body knobs that
  need a mesh raise and name ROADMAP item 13, mixture of experts, remat
  and the stacked layout load and learn (the MoE aux term in the total
  loss); one full-width update runs through the launcher.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.agents.ximpala import XImpalaAgent as JaxAgent
from distributed_reinforcement_learning_tpu.agents.ximpala import XImpalaBatch as JaxBatch
from distributed_reinforcement_learning_tpu.agents.ximpala import XImpalaConfig as JaxConfig
from distributed_reinforcement_learning_tpu.models import transformer_net as jnet
from distributed_reinforcement_learning_tpu.utils.config import load_config as jax_load_config
from distributed_reinforcement_learning_tpu_torch import train_ximpala
from distributed_reinforcement_learning_tpu_torch.agents import common
from distributed_reinforcement_learning_tpu_torch.agents.ximpala import (
    XImpalaActOutput, XImpalaAgent, XImpalaBatch, XImpalaConfig)
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
from distributed_reinforcement_learning_tpu_torch.envs.cartpole import VectorCartPole
from distributed_reinforcement_learning_tpu_torch.models import transformer_net as net
from distributed_reinforcement_learning_tpu_torch.models.convert import (
    transformer_params_from_jax)
from distributed_reinforcement_learning_tpu_torch.ops.kernels import attention as kattn
from distributed_reinforcement_learning_tpu_torch.ops.kernels import vtrace as kvt
from distributed_reinforcement_learning_tpu_torch.runtime.ximpala_runner import XImpalaActor
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore
from distributed_reinforcement_learning_tpu_torch.utils.config import load_config

CONFIG = Path(__file__).resolve().parents[1] / "config.json"
# Head dim 32, one the flash kernels take, so that T = 16 takes the flash
# route in the port.
SMALL = dict(obs_shape=(4,), num_actions=3, trajectory=16, d_model=64, num_heads=2,
             num_layers=2)


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


def _launches():
    return (kattn.flash_fwd_cuda.launches, kattn.flash_dq_cuda.launches,
            kattn.flash_dkv_cuda.launches, kvt.vtrace_cuda.launches)


def _dones(B, T, rng, p=0.15):
    return rng.rand(B, T) < p


def test_episode_segments_and_rope_match_jax():
    rng = np.random.RandomState(0)
    done = _dones(4, 16, rng, p=0.3)
    np.testing.assert_array_equal(net.episode_segments(torch.from_numpy(done)).numpy(),
                                  np.asarray(jnet.episode_segments(jnp.asarray(done))))
    x = rng.randn(2, 16, 3, 8).astype(np.float32)
    np.testing.assert_allclose(net.rope(torch.from_numpy(x)).numpy(),
                               np.asarray(jnet.rope(jnp.asarray(x))), atol=1e-6)


def _jax_model(head, **kw):
    return jnet.TransformerQNet(num_actions=kw["num_actions"], d_model=kw["d_model"],
                                num_heads=kw["num_heads"], num_layers=kw["num_layers"],
                                max_len=16, head=head)


@pytest.mark.parametrize("T", [16, 12])
@pytest.mark.parametrize("head", ["actor_critic", "dueling_q"])
def test_transformer_net_matches_jax(head, T):
    """T = 16 takes the flash route in the port (the plain K3a), T = 12
    the dense one; the JAX model runs its CPU route (dense) for both."""
    kw = SMALL
    rng = np.random.RandomState(1)
    obs = rng.randn(3, T, 4).astype(np.float32)
    pa = rng.randint(0, 3, (3, T)).astype(np.int32)
    done = _dones(3, T, rng)
    jmodel = _jax_model(head, **kw)
    variables = jmodel.init(jax.random.PRNGKey(0), obs, pa, done)
    want = jmodel.apply(variables, obs, pa, done)

    model = net.TransformerQNet(num_actions=3, obs_shape=(4,), d_model=kw["d_model"],
                                num_heads=kw["num_heads"],
                                num_layers=2, max_len=16, head=head)
    model.load_state_dict(transformer_params_from_jax(
        jax.tree.map(np.asarray, variables), head=head), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(obs), torch.from_numpy(pa), torch.from_numpy(done))
    if head == "actor_critic":
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="max_len"):
        model(torch.zeros(1, 17, 4), torch.zeros(1, 17, dtype=torch.long),
              torch.zeros(1, 17, dtype=torch.bool))


def _agents(**overrides):
    kw = {**SMALL, **overrides}
    jagent = JaxAgent(JaxConfig(**kw))
    jstate = jax.jit(jagent.init_state)(jax.random.PRNGKey(0))
    agent = XImpalaAgent(XImpalaConfig(**kw), device="cpu")
    state = agent.state_from_params(transformer_params_from_jax(
        jax.tree.map(np.asarray, jstate.params), head="actor_critic"))
    return jagent, jstate, agent, state


def _windows(N, W, rng):
    """Act windows with a few leading pad slots (done) and dones inside."""
    obs = rng.randn(N, W, 4).astype(np.float32)
    pa = rng.randint(0, 3, (N, W)).astype(np.int32)
    done = _dones(N, W, rng)
    done[:, :3] = True
    obs[:, :3] = 0.0
    pa[:, :3] = 0
    return obs, pa, done


def test_act_policy_matches_jax_window_final():
    jagent, jstate, agent, state = _agents()
    obs, pa, done = _windows(5, 16, np.random.RandomState(2))
    want = jagent._act(jstate.params, obs, pa, done, jax.random.PRNGKey(0))
    before = _launches()
    out = agent.act(state.params, *map(torch.from_numpy, (obs, pa, done)),
                    torch.Generator().manual_seed(0))
    assert _launches() == before
    assert isinstance(out, XImpalaActOutput)
    assert out.action.shape == (5,) and out.policy.shape == (5, 3)
    np.testing.assert_allclose(out.policy.numpy(), np.asarray(want.policy), atol=1e-5)


def test_act_samples_by_the_window_final_policy():
    agent = XImpalaAgent(XImpalaConfig(**SMALL), device="cpu")
    params = agent.init_state(seed=3).params
    obs, pa, done = _windows(2, 16, np.random.RandomState(4))
    n = 20000
    win = [torch.from_numpy(np.repeat(a, n // 2, axis=0)) for a in (obs * 3, pa, done)]
    out = agent.act(params, *win, torch.Generator().manual_seed(1))
    for row in (0, 1):
        sl = slice(row * n // 2, (row + 1) * n // 2)
        p = out.policy[sl][0].numpy()
        freq = np.bincount(out.action[sl].numpy(), minlength=3) / (n // 2)
        sigma = np.sqrt(p * (1 - p) / (n // 2))
        assert np.all(np.abs(freq - p) < 5 * sigma + 1e-9), (freq, p)
    again = agent.act(params, *win, torch.Generator().manual_seed(1))
    assert torch.equal(again.action, out.action)  # the generator is the only randomness


def _batch(B, T, A, seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, A)
    behavior = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    env_done = _dones(B, T, rng, p=0.1)
    # Life-loss shaping marks extra recorded dones where the episode goes on.
    done = env_done | _dones(B, T, rng, p=0.1)
    assert (done != env_done).any()
    return dict(
        state=rng.randn(B, T, 4).astype(np.float32),
        reward=(rng.randn(B, T) * 2).astype(np.float32),
        action=rng.randint(0, A, (B, T)).astype(np.int32),
        done=done,
        env_done=env_done,
        behavior_policy=behavior.astype(np.float32),
        previous_action=rng.randint(0, A, (B, T)).astype(np.int32),
    )


def test_learn_step_matches_jax():
    jagent, jstate, agent, state = _agents(entropy_coef=0.01, baseline_loss_coef=0.5,
                                           start_learning_rate=2e-3)
    batch = _batch(4, 16, 3, seed=5)
    jstate, jmetrics = jax.jit(jagent._learn)(jstate, JaxBatch(**batch))
    before = _launches()
    state, metrics = agent.learn(state, XImpalaBatch(**batch))
    assert _launches() == before  # CPU tensors take the plain versions

    assert set(metrics) == set(jmetrics)
    for k, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(want), rtol=1e-4, err_msg=k)
    want_params = transformer_params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                              head="actor_critic")
    assert set(want_params) == set(state.params)
    for k, want in want_params.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-8, err_msg=k)
    assert state.step == 1


class _RecordingAgent:
    """Stands in for XImpalaAgent in the actor: records the windows it is
    handed and always picks action 1 with a uniform policy."""

    def __init__(self, trajectory):
        self.cfg = XImpalaConfig(obs_shape=(4,), num_actions=2, trajectory=trajectory)
        self.device = torch.device("cpu")
        self.windows = []

    def act(self, params, obs, pa, done, generator):
        self.windows.append((obs.numpy().copy(), pa.numpy().copy(), done.numpy().copy()))
        n = obs.shape[0]
        return XImpalaActOutput(torch.ones(n, dtype=torch.long), torch.full((n, 2), 0.5))


def test_actor_window_resets_each_unroll_with_done_pads():
    W, N = 16, 3
    agent = _RecordingAgent(W)
    weights = WeightStore()
    weights.publish({"w": torch.zeros(1)}, 0)
    queue = TrajectoryQueue(capacity=64)
    actor = XImpalaActor(agent, VectorCartPole(num_envs=N, seed=0), queue, weights, seed=1)
    for unroll in range(2):
        assert actor.run_unroll() == N * W
        rec = queue.get_batch(N, timeout=1.0)
        assert set(rec._fields) == set(XImpalaBatch._fields)
        assert rec.env_done.any()  # an always-right policy ends CartPole episodes
        np.testing.assert_array_equal(rec.done, rec.env_done)  # no shaping on CartPole
        for t in range(W):
            obs, pa, done = agent.windows[unroll * W + t]
            pad = W - 1 - t
            assert done[:, :pad].all() and (obs[:, :pad] == 0).all() and (pa[:, :pad] == 0).all()
            np.testing.assert_array_equal(obs[:, pad:], rec.state[:, :t + 1])
            np.testing.assert_array_equal(pa[:, pad:], rec.previous_action[:, :t + 1])
            # The current step's done is unknown (False); earlier slots
            # hold the true env dones.
            assert not done[:, -1].any()
            np.testing.assert_array_equal(done[:, pad:-1], rec.env_done[:, :t])
        np.testing.assert_array_equal(rec.previous_action[:, 1:],
                                      np.where(rec.env_done[:, :-1], 0, rec.action[:, :-1]))


def test_learner_forward_reproduces_behavior_policy():
    """With the actor's parameters, the learner's `[B, T]` forward over a
    recorded unroll gives back the window-final policies the actor
    recorded (rho = 1 on policy): the pad slots and the true dones in the
    window give each step exactly the context the learner sees."""
    agent = XImpalaAgent(XImpalaConfig(**{**SMALL, "num_actions": 2}), device="cpu")
    state = agent.init_state(seed=4)
    weights = WeightStore()
    weights.publish(state.params, 0)
    queue = TrajectoryQueue(capacity=16)
    actor = XImpalaActor(agent, VectorCartPole(num_envs=4, seed=2), queue, weights, seed=3)
    actor.run_unroll()
    batch = queue.get_batch(4, timeout=1.0)
    assert batch.env_done.any()
    with torch.no_grad():
        policy, _ = agent._forward(state.params,
                                   common.batch_to_device(batch, torch.device("cpu")))
    np.testing.assert_allclose(policy.numpy(), batch.behavior_policy, atol=1e-6)


def test_load_config_matches_jax():
    cfg, rt = load_config(CONFIG, "ximpala")
    jcfg, jrt = jax_load_config(CONFIG, "ximpala")
    assert isinstance(cfg, XImpalaConfig)
    assert dataclasses.asdict(cfg) == {k: v for k, v in dataclasses.asdict(jcfg).items()
                                       if k != "dtype"}
    for field in dataclasses.fields(rt):
        assert getattr(rt, field.name) == getattr(jrt, field.name), field.name
    assert (cfg.trajectory, cfg.d_model, cfg.num_heads, cfg.num_layers) == (16, 64, 2, 2)
    assert (rt.batch_size, rt.num_actors, rt.envs_per_actor) == (16, 1, 16)


@pytest.mark.parametrize("knob", [{"attention": "ring"}, {"pipeline": True},
                                  {"seq_parallel": 2}, {"expert_parallel": 2}])
def test_unported_body_knobs_raise(tmp_path, knob):
    """Item 13c is ported: every knob loads as the JAX package loads it,
    and an agent knob that needs a mesh is refused without one, for JAX's
    own reason and in its words (`test_torch_sequence.py`,
    `test_torch_pipeline.py` and `test_torch_expert.py` run them over
    meshes)."""
    from distributed_reinforcement_learning_tpu.agents.ximpala import (
        XImpalaAgent as JaxAgent, XImpalaConfig as JaxConfig)
    from distributed_reinforcement_learning_tpu.utils.config import load_config as jax_load

    section = {**json.loads(CONFIG.read_text())["ximpala"], **knob}
    path = tmp_path / "config.json"
    path.write_text(json.dumps({"ximpala": section}))
    agent_cfg, rt = load_config(path, "ximpala")
    jax_cfg, jax_rt = jax_load(path, "ximpala")
    assert (rt.seq_parallel, rt.expert_parallel) == (jax_rt.seq_parallel, jax_rt.expert_parallel)
    assert (agent_cfg.attention, agent_cfg.pipeline) == (jax_cfg.attention, jax_cfg.pipeline)
    if set(knob) <= {f.name for f in dataclasses.fields(XImpalaConfig)}:
        with pytest.raises(ValueError, match="needs a mesh") as got:
            XImpalaAgent(XImpalaConfig(**{**SMALL, **knob}), device="cpu")
        with pytest.raises(ValueError, match="needs a mesh") as want:
            JaxAgent(JaxConfig(**{**SMALL, **knob}))
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("knob", [{"num_experts": 4}, {"remat": True}, {"stacked": True}])
def test_moe_remat_and_stacked_knobs_run(tmp_path, knob):
    """Mixture of experts, remat and the stacked layout load and train
    (one learn step at the SMALL width); with experts the routers'
    load-balancing term is in the total loss."""
    section = {**json.loads(CONFIG.read_text())["ximpala"], **knob}
    path = tmp_path / "config.json"
    path.write_text(json.dumps({"ximpala": section}))
    cfg, _ = load_config(path, "ximpala")
    jcfg, _ = jax_load_config(path, "ximpala")
    # The JAX loader reads no `stacked` key (its XImpalaConfig has the field).
    assert {k: v for k, v in dataclasses.asdict(cfg).items() if k != "stacked"} == {
        k: v for k, v in dataclasses.asdict(jcfg).items() if k not in ("dtype", "stacked")}
    agent = XImpalaAgent(XImpalaConfig(**{**SMALL, **knob}), device="cpu")
    state = agent.init_state(seed=0)
    batch = common.batch_to_device(XImpalaBatch(**_batch(4, 16, 3, seed=6)),
                                   torch.device("cpu"))
    out = agent._forward(state.params, batch)
    assert len(out) == (3 if "num_experts" in knob else 2)
    state, metrics = agent.learn(state, batch)
    assert all(np.isfinite(float(v)) for v in metrics.values()) and state.step == 1
    if "num_experts" in knob:
        c = agent.cfg
        parts = (metrics["pi_loss"] + c.baseline_loss_coef * metrics["baseline_loss"]
                 + c.entropy_coef * metrics["entropy"])
        assert float(metrics["total_loss"] - parts) == pytest.approx(float(out[2].detach()),
                                                                    rel=1e-4)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        XImpalaAgent(XImpalaConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_ximpala.main(["--config", str(CONFIG), "--updates", "1"])


def test_full_width_ximpala_update_on_cpu(tmp_path):
    """One update of the `ximpala` section (d_model 64, 2 heads, 2 layers,
    batch 16 x 16, 1 actor x 16 envs) through the launcher."""
    before = _launches()
    result = train_ximpala.main(["--config", str(CONFIG), "--section", "ximpala",
                                 "--updates", "1", "--device", "cpu",
                                 "--run_dir", str(tmp_path)])
    assert _launches() == before
    assert result["frames"] == 16 * 16  # one actor round fills a batch of 16
    m = result["last_metrics"]
    assert set(m) == {"pi_loss", "baseline_loss", "entropy", "total_loss", "grad_norm",
                      "learning_rate"}
    assert all(np.isfinite(v) for v in m.values()) and m["grad_norm"] > 0
