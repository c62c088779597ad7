"""Transformer-R2D2 in the PyTorch port against the JAX package, on the CPU.

- `TransformerQNet` (dueling head) with the dense body, MoE and the
  stacked layout, on weights converted by `transformer_params_from_jax`:
  Q at atol 1e-5 and each layer's router aux at 1e-6, at T = 16 (the
  flash route's plain version in the port) and T = 12 (dense).
- Remat: the gradients of a loss of Q equal the run without remat (rtol
  1e-6), for the module body, MoE and the stacked layout, and the flash
  calls on the CPU are those the card counts (2 K3a a forward, 2 more
  with remat: the recompute; 2 K3b + K3c). The plain model's gradients
  are held to JAX through the learn steps of
  tests/test_torch_xformer_agent.py.
- Causality and episode isolation (the JAX `tests/test_xformer.py`
  cases).
- The `xformer` and `xformer_moe` sections load as in the JAX package,
  mesh knobs included; an agent knob that needs a mesh is refused
  without one in JAX's words.
- The actor against the JAX actor, both driven by stand-in agents that
  play one fixed action sequence: the windows each act is handed, the
  epsilons, and the queued sequences, whose codec blobs are byte for byte
  the JAX ones through both codecs.
- A learner over the sharded service checkpoints and resumes; the
  pipelined actor un-pushes a discarded act; full-width runs of both
  sections through `train_xformer`.
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

from distributed_reinforcement_learning_tpu.agents.xformer import XformerConfig as JaxConfig
from distributed_reinforcement_learning_tpu.data import codec as jax_codec
from distributed_reinforcement_learning_tpu.data.fifo import TrajectoryQueue as JaxQueue
from distributed_reinforcement_learning_tpu.envs.cartpole import VectorCartPole as JaxCartPole
from distributed_reinforcement_learning_tpu.envs.cartpole import pomdp_project as jax_pomdp
from distributed_reinforcement_learning_tpu.models import transformer_net as jnet
from distributed_reinforcement_learning_tpu.runtime import xformer_runner as jax_runner
from distributed_reinforcement_learning_tpu.runtime.weights import WeightStore as JaxWeights
from distributed_reinforcement_learning_tpu.utils.config import load_config as jax_load_config
from distributed_reinforcement_learning_tpu_torch import train_xformer
from distributed_reinforcement_learning_tpu_torch.agents.xformer import (
    XformerAgent, XformerBatch, XformerConfig, build_transformer_models)
from distributed_reinforcement_learning_tpu_torch.data import codec, replay_service
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
from distributed_reinforcement_learning_tpu_torch.envs.batched import BatchedEnv
from distributed_reinforcement_learning_tpu_torch.envs.cartpole import (
    VectorCartPole, pomdp_project)
from distributed_reinforcement_learning_tpu_torch.envs.registry import make_env
from distributed_reinforcement_learning_tpu_torch.models import transformer_net as net
from distributed_reinforcement_learning_tpu_torch.models.convert import (
    transformer_params_from_jax)
from distributed_reinforcement_learning_tpu_torch.ops.kernels import attention as kattn
from distributed_reinforcement_learning_tpu_torch.runtime import replay_shard, xformer_runner
from distributed_reinforcement_learning_tpu_torch.runtime.actor_pipeline import ActorPipeline
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore
from distributed_reinforcement_learning_tpu_torch.utils import checkpoint
from distributed_reinforcement_learning_tpu_torch.utils.config import load_config

CONFIG = Path(__file__).resolve().parents[1] / "config.json"
# Head dim 32, one the flash kernels take, so that T = 16 takes the flash
# route in the port.
NET = dict(num_actions=2, d_model=64, num_heads=2, num_layers=2)
BODIES = {"dense": {}, "moe": {"num_experts": 4}, "stacked": {"stack_layers": True}}


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


def _seq(B, T, seed, p_done=0.15):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, 2).astype(np.float32), rng.randint(0, 2, (B, T)).astype(np.int32),
            rng.rand(B, T) < p_done)


def _jax_sown_aux(sown) -> list[float]:
    losses = sown.get("losses", {})
    return [float(losses[f"SelfAttentionBlock_{i}"]["moe_aux"][0]) for i in range(len(losses))]


@pytest.mark.parametrize("T", [16, 12])
@pytest.mark.parametrize("body", sorted(BODIES))
def test_transformer_qnet_matches_jax(body, T):
    kw = BODIES[body]
    obs, pa, done = _seq(3, T, seed=1)
    jmodel = jnet.TransformerQNet(**NET, max_len=16, **kw)
    params = {"params": jmodel.init(jax.random.PRNGKey(0), obs, pa, done)["params"]}
    want_q, sown = jmodel.apply(params, obs, pa, done, mutable=["losses"])
    model = net.TransformerQNet(obs_shape=(2,), max_len=16, **NET, **kw)
    model.load_state_dict(transformer_params_from_jax(_np(params)), strict=True)
    with torch.no_grad():
        q, aux = model(*map(torch.from_numpy, (obs, pa, done)), return_aux=True)
    np.testing.assert_allclose(q.numpy(), np.asarray(want_q), atol=1e-5)
    want_aux = _jax_sown_aux(sown)
    assert len(aux) == len(want_aux) == (2 if body == "moe" else 0)
    np.testing.assert_allclose([float(a) for a in aux], want_aux, atol=1e-6)


class _FlashCalls:
    """Counts the flash forward and backward calls (the CUDA launches' CPU
    twins: `flash_fwd` is K3a, `flash_bwd` K3b + K3c)."""

    def __init__(self, monkeypatch):
        self.fwd = self.bwd = 0
        fwd, bwd = kattn.flash_fwd, kattn.flash_bwd

        def count_fwd(*a):
            self.fwd += 1
            return fwd(*a)

        def count_bwd(*a):
            self.bwd += 1
            return bwd(*a)

        monkeypatch.setattr(kattn, "flash_fwd", count_fwd)
        monkeypatch.setattr(kattn, "flash_bwd", count_bwd)

    def take(self) -> tuple[int, int]:
        got, self.fwd, self.bwd = (self.fwd, self.bwd), 0, 0
        return got


@pytest.mark.parametrize("body", sorted(BODIES))
def test_remat_gradients_equal_the_plain_ones(body, monkeypatch):
    kw = BODIES[body]
    obs, pa, _ = _seq(4, 16, seed=17)
    done = np.zeros((4, 16), bool)
    done[:, 3] = True
    params = net.TransformerQNet(obs_shape=(2,), max_len=16, **NET, **kw,
                                 generator=torch.Generator().manual_seed(3)).state_dict()
    calls = _FlashCalls(monkeypatch)
    grads = {}
    for remat in (False, True):
        model = net.TransformerQNet(obs_shape=(2,), max_len=16, remat=remat, **NET, **kw)
        model.load_state_dict(params, strict=True)
        loss = torch.sum(model(*map(torch.from_numpy, (obs, pa, done))) ** 2)
        names = [k for k, _ in model.named_parameters()]
        grads[remat] = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
        # One forward per layer, and with remat one more in the backward.
        assert calls.take() == (2 * (1 + remat), 2)
    assert set(grads[True]) == set(params)
    for k, g in grads[False].items():
        torch.testing.assert_close(grads[True][k], g, rtol=1e-6, atol=1e-7)
        assert float(g.abs().max()) > 0, k


@pytest.mark.parametrize("T, d_model", [(8, 32), (16, 64)], ids=["dense", "flash"])
def test_causality_and_episode_isolation(T, d_model):
    model = net.TransformerQNet(num_actions=3, obs_shape=(2,), d_model=d_model, num_heads=2,
                                num_layers=2, max_len=16,
                                generator=torch.Generator().manual_seed(0))
    obs, pa, _ = _seq(2, T, seed=0)
    obs, pa = torch.from_numpy(obs), torch.from_numpy(pa)
    done = torch.zeros(2, T, dtype=torch.bool)
    with torch.no_grad():
        # Perturbing future observations leaves past Q-values alone.
        q1 = model(obs, pa, done)
        q2 = model(obs.clone().index_fill_(1, torch.arange(5, T), 0.0), pa, done)
        torch.testing.assert_close(q1[:, :5], q2[:, :5], rtol=0, atol=1e-6)
        assert float((q1[:, 5:] - q2[:, 5:]).abs().max()) > 1e-4
        # Q after a reset does not depend on the earlier episode.
        done[:, 3] = True
        q1 = model(obs, pa, done)
        q2 = model(obs.clone().index_fill_(1, torch.arange(4), 0.0), pa, done)
        torch.testing.assert_close(q1[:, 4:], q2[:, 4:], rtol=0, atol=1e-6)
        assert float((q1[:, :4] - q2[:, :4]).abs().max()) > 1e-4


# -- config ------------------------------------------------------------------

@pytest.mark.parametrize("section", ["xformer", "xformer_moe"])
def test_load_config_matches_jax(section):
    cfg, rt = load_config(CONFIG, section)
    jcfg, jrt = jax_load_config(CONFIG, section)
    assert isinstance(cfg, XformerConfig)
    assert dataclasses.asdict(cfg) == {k: v for k, v in dataclasses.asdict(jcfg).items()
                                       if k != "dtype"}
    for field in dataclasses.fields(rt):
        assert getattr(rt, field.name) == getattr(jrt, field.name), field.name
    assert (cfg.d_model, cfg.num_heads, cfg.num_layers, cfg.seq_len, cfg.burn_in) == (
        64, 2, 2, 10, 5)
    assert (rt.batch_size, rt.num_actors, rt.envs_per_actor, rt.target_sync_interval) == (
        32, 3, 4, 20)
    assert cfg.num_experts == (4 if section == "xformer_moe" else 0)


@pytest.mark.parametrize("knob, agent_raises", [
    ({"attention": "ring"}, True), ({"attention": "ulysses"}, True),
    ({"pipeline": True}, True), ({"seq_parallel": 2}, False),
    ({"expert_parallel": 2}, False)])
def test_mesh_features_raise_naming_item_13(tmp_path, knob, agent_raises):
    # Item 13c is ported: every knob loads as the JAX package loads it. An
    # agent knob that needs a mesh is refused without one, for JAX's own
    # reason and in its words; a runtime knob sizes the learner's mesh,
    # and a mesh of one carries it (the MoE routes over it).
    from distributed_reinforcement_learning_tpu.agents.xformer import XformerAgent as JaxAgent
    from distributed_reinforcement_learning_tpu_torch.parallel import make_mesh

    section = {**json.loads(CONFIG.read_text())["xformer_moe"], **knob}
    path = tmp_path / "config.json"
    path.write_text(json.dumps({"xformer": section}))
    agent_cfg, rt = load_config(path, "xformer")
    jax_cfg, jax_rt = jax_load_config(path, "xformer")
    assert (rt.seq_parallel, rt.expert_parallel) == (jax_rt.seq_parallel, jax_rt.expert_parallel)
    assert (agent_cfg.attention, agent_cfg.pipeline) == (jax_cfg.attention, jax_cfg.pipeline)
    if agent_raises:
        with pytest.raises(ValueError, match="needs a mesh") as got:
            XformerAgent(XformerConfig(**knob), device="cpu")
        with pytest.raises(ValueError, match="needs a mesh") as want:
            JaxAgent(JaxConfig(**knob))
        assert str(got.value) == str(want.value)
    else:
        model, twin = build_transformer_models(agent_cfg, mesh=make_mesh(device="cpu"),
                                               seq_len=10)
        assert twin is not model and model.blocks[0].moe_mesh.shape["expert"] == 1


def test_stacked_layout_refuses_experts():
    with pytest.raises(ValueError, match="mixture-of-experts"):
        XformerAgent(XformerConfig(stacked=True, num_experts=4), device="cpu")


# -- the actor ---------------------------------------------------------------

class _FixedPolicy:
    """Plays `actions[i]` at the i-th act and records what it was handed."""

    def __init__(self, cfg, actions):
        self.cfg, self.actions, self.calls = cfg, actions, []
        self.device = torch.device("cpu")

    def _record(self, obs, pa, done, epsilon):
        self.calls.append(tuple(np.array(x) for x in (obs, pa, done, epsilon)))
        return self.actions[len(self.calls) - 1]


class _JaxFixed(_FixedPolicy):
    def act(self, params, obs, pa, done, epsilon, rng):
        return jnp.asarray(self._record(obs, pa, done, epsilon)), None


class _PortFixed(_FixedPolicy):
    def act(self, params, obs, pa, done, epsilon, generator):
        return torch.from_numpy(self._record(obs, pa, done, epsilon)), None


def test_actor_matches_the_jax_actor_and_its_blobs():
    N, W, unrolls = 3, 10, 3
    actions = np.random.RandomState(0).randint(0, 2, (W * unrolls, N)).astype(np.int32)
    cfg = dict(obs_shape=(2,), num_actions=2, seq_len=W)
    jax_agent, port_agent = _JaxFixed(JaxConfig(**cfg), actions), _PortFixed(
        XformerConfig(**cfg), actions)
    jweights, weights = JaxWeights(), WeightStore()
    jweights.publish({"w": np.zeros(1)}, 0)
    weights.publish({"w": torch.zeros(1)}, 0)
    jqueue, queue = JaxQueue(64), TrajectoryQueue(64)
    jactor = jax_runner.XformerActor(jax_agent, JaxCartPole(N, seed=0), jqueue, jweights, seed=1,
                                     obs_transform=jax_pomdp)
    actor = xformer_runner.XformerActor(port_agent, VectorCartPole(N, seed=0), queue, weights,
                                        seed=1, obs_transform=pomdp_project)
    for _ in range(unrolls):
        assert actor.run_unroll() == jactor.run_unroll() == N * W
        for _ in range(N):
            mine, ref = queue.get(timeout=1.0), jqueue.get(timeout=1.0)
            assert type(mine) is XformerBatch and type(ref).__name__ == "XformerBatch"
            blob = codec.encode(mine)
            assert bytes(blob) == bytes(jax_codec.encode(ref))
            back = jax_codec.decode(blob, copy=True)
            assert all(a.tobytes() == b.tobytes() for a, b in zip(back, ref))
    assert len(port_agent.calls) == len(jax_agent.calls) == W * unrolls
    for got, want in zip(port_agent.calls, jax_agent.calls):
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(got[3], want[3].astype(np.float32), rtol=1e-7)
    # The window is never cleared: the first act sees W - 1 pad slots
    # (done) and the live step; later windows carry the true dones.
    obs, pa, done, eps = port_agent.calls[0]
    assert done[:, :-1].all() and not done[:, -1].any() and (obs[:, :-1] == 0).all()
    assert (eps >= 0.15).all()
    assert actor.episode_returns == jactor.episode_returns and actor.episode_returns


def test_pipelined_actor_unpushes_a_discarded_act(monkeypatch):
    monkeypatch.setenv("DRL_NO_GYMNASIUM", "1")  # the in-tree CartPole stream
    agent = XformerAgent(XformerConfig(obs_shape=(2,), num_actions=2, seq_len=8, d_model=32,
                                       num_heads=2), device="cpu")
    weights = WeightStore()
    weights.publish(agent.init_state(seed=0).params, 0)
    env = BatchedEnv([lambda s=s: make_env("CartPole-v0", seed=s) for s in range(4)])
    actor = xformer_runner.XformerActor(agent, env, TrajectoryQueue(64), weights, seed=1,
                                        obs_transform=pomdp_project)
    (sl,) = actor.pipeline_make_slices(1)
    actor.pipeline_sync_weights([sl])
    actor.slice_begin_round(sl, 8)
    actor.slice_step(sl, actor.slice_act(sl))
    before = [x.copy() for x in (sl.win_obs, sl.win_pa, sl.win_done)]
    out = actor.slice_act(sl)
    actor.slice_discard_act(sl, out)
    for x, b in zip((sl.win_obs, sl.win_pa, sl.win_done), before):
        np.testing.assert_array_equal(x, b)
    pipe = ActorPipeline(actor, num_slices=2)
    try:
        assert pipe.run_unroll() == 4 * 8
    finally:
        pipe.close()
    assert len(actor.queue) == 4


# -- learner, launcher -------------------------------------------------------

def _xformer_blobs(n_rounds: int, seed: int) -> list[bytes]:
    from distributed_reinforcement_learning_tpu_torch.data.structures import (
        XformerSequenceAccumulator)

    rng = np.random.RandomState(seed)
    blobs = []
    for _ in range(n_rounds):
        acc = XformerSequenceAccumulator()
        for _ in range(10):
            acc.append(state=pomdp_project(rng.randn(4, 4) * 0.2),
                       previous_action=rng.randint(0, 2, 4).astype(np.int32),
                       action=rng.randint(0, 2, 4).astype(np.int32),
                       reward=np.ones(4, np.float32), done=rng.rand(4) < 0.1)
        blobs += [bytes(codec.encode(seq)) for seq in acc.extract()]
    return blobs


def test_learner_over_the_service_checkpoints_and_resumes(tmp_path):
    cfg = XformerConfig(obs_shape=(2,), num_actions=2, seq_len=10, burn_in=5, d_model=32,
                        num_heads=2, num_experts=4)

    def learner():
        svc = replay_service.ShardedReplayService(2, 256, mode="sequence", seed=0)
        return xformer_runner.XformerLearner(XformerAgent(cfg, device="cpu"),
                                             TrajectoryQueue(8), WeightStore(), batch_size=8,
                                             replay_capacity=256, seed=0, replay_service=svc)

    a, b = learner(), learner()
    try:
        facade = replay_shard.ReplayIngestFifo(a.replay_service, a.queue)
        for blob in _xformer_blobs(6, seed=7):
            assert facade.ingest_blob(blob)
        assert a.train() is not None and a.train() is not None
        ckpt = checkpoint.Checkpointer(tmp_path)
        a.save_checkpoint(ckpt)
        assert b.restore_checkpoint(ckpt)
        assert b.train_steps == 2 and len(b.replay_service) == len(a.replay_service) == 24
        for k, v in a.state.params.items():
            torch.testing.assert_close(b.state.params[k], v, rtol=0, atol=0)
            torch.testing.assert_close(b.state.mu[k], a.state.mu[k], rtol=0, atol=0)
        items = b.replay_service.snapshot()["items"]
        assert {type(x).__name__ for x in items} == {"XformerBatch"}
        assert b.train() is not None and b.train_steps == 3
    finally:
        for x in (a, b):
            x.close()
            x.replay_service.close()


@pytest.mark.parametrize("section", ["xformer", "xformer_moe"])
def test_full_width_sections_train_through_the_launcher(section, tmp_path, monkeypatch):
    calls = _FlashCalls(monkeypatch)
    result = train_xformer.main(["--config", str(CONFIG), "--section", section,
                                 "--updates", "2", "--device", "cpu",
                                 "--run_dir", str(tmp_path)])
    assert calls.take() == (0, 0)  # seq_len 10: the dense route
    # 12 envs x 10 steps a round; warm at 64 sequences, after 6 rounds.
    assert result["frames"] == 7 * 12 * 10
    m = result["last_metrics"]
    assert set(m) == {"loss", "grad_norm"} and all(np.isfinite(v) for v in m.values())
    assert m["grad_norm"] > 0


@pytest.mark.parametrize("mode, item", [("inference", "item 13"), ("anakin", "item 14")])
def test_unported_modes_raise_by_name(mode, item, tmp_path, monkeypatch):
    # Serving acts and item 13c are ported: an act-serving replica takes a
    # sequence axis (ignored under dense attention, as in JAX) and builds
    # the plain agent (its run is stubbed at its entry); this family has
    # no on-device loop (item 14), which is still refused by name.
    from distributed_reinforcement_learning_tpu_torch.runtime import launch, transport

    cfg = json.loads(CONFIG.read_text())
    cfg["xformer"]["seq_parallel"] = 2
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    if mode == "anakin":
        with pytest.raises(ValueError, match=item):
            train_xformer.main(["--config", str(path), "--mode", mode, "--device", "cpu"])
        return
    calls = []
    monkeypatch.setattr(transport, "run_role", lambda *a, **kw: calls.append(a) or {})
    train_xformer.main(["--config", str(path), "--mode", mode, "--device", "cpu"])
    assert [c[3] for c in calls] == ["inference"]
    agent_cfg, rt = load_config(path, "xformer")
    agent = launch.make_agent("xformer", agent_cfg, device="cpu", rt=rt, actor=True)
    assert rt.seq_parallel == 2 and agent.mesh is None and agent.twin is agent.model


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        XformerAgent(XformerConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_xformer.main(["--config", str(CONFIG), "--updates", "1"])
