"""R2D2 of the PyTorch port against the JAX package, on the CPU.

- `R2D2Net.step` and `unroll` on weights converted from flax: atol 1e-5
  (float32; products sum in another order).
- `value_rescale` and its inverse against JAX.
- `td_error` and one learn step against the JAX `_td_error` / `_learn`
  from the same converted parameters (with a target network that differs
  from the main one) on the same numpy batch and IS weights, in both
  priority modes and with the optional clip: loss, grad norm,
  priorities, updated parameters and Adam moments at rtol 1e-4.
- `PrioritizedReplay` against the JAX python backend under one seed: the
  same tree indices and totals, bit-equal IS weights. The learner's own
  replay is `make_replay("auto")`'s array backend in both packages, and
  from the same seed and inserts it samples the JAX learner's indices.
- The sequence accumulator, the `r2d2` config sections, epsilon-greedy
  by distribution, the CUDA default of the entry points, and one
  full-width run of the `r2d2` section through the launcher.
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.agents.r2d2 import R2D2Agent as JaxAgent
from distributed_reinforcement_learning_tpu.agents.r2d2 import R2D2Batch as JaxBatch
from distributed_reinforcement_learning_tpu.agents.r2d2 import R2D2Config as JaxConfig
from distributed_reinforcement_learning_tpu.data.replay import PrioritizedReplay as JaxReplay
from distributed_reinforcement_learning_tpu.data.replay import (
    priority_transform as jax_priority_transform)
from distributed_reinforcement_learning_tpu.data.structures import (
    R2D2SequenceAccumulator as JaxAccumulator)
from distributed_reinforcement_learning_tpu.envs.cartpole import pomdp_project as jax_pomdp
from distributed_reinforcement_learning_tpu.models.r2d2_net import R2D2Net as JaxNet
from distributed_reinforcement_learning_tpu.ops import value_rescale as jax_vr
from distributed_reinforcement_learning_tpu.utils.config import load_config as jax_load_config
from distributed_reinforcement_learning_tpu_torch import train_r2d2
from distributed_reinforcement_learning_tpu_torch.agents import common
from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import (
    R2D2Agent, R2D2Batch, R2D2Config)
from distributed_reinforcement_learning_tpu_torch.data.replay import (
    PrioritizedReplay, priority_transform)
from distributed_reinforcement_learning_tpu_torch.data.structures import R2D2SequenceAccumulator
from distributed_reinforcement_learning_tpu_torch.envs.cartpole import pomdp_project
from distributed_reinforcement_learning_tpu_torch.models.convert import r2d2_params_from_jax
from distributed_reinforcement_learning_tpu_torch.models.r2d2_net import R2D2Net
from distributed_reinforcement_learning_tpu_torch.ops import value_rescale
from distributed_reinforcement_learning_tpu_torch.ops.kernels import lstm as klstm
from distributed_reinforcement_learning_tpu_torch.utils.config import load_config

CONFIG = Path(__file__).resolve().parents[1] / "config.json"


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


NETS = {
    "mlp": dict(obs_shape=(2,), num_actions=2, lstm_size=64),
    "nature_folded": dict(obs_shape=(36, 36, 4), num_actions=4, lstm_size=32,
                          torso="nature", fold_normalize=True),
    "resnet": dict(obs_shape=(16, 16, 3), num_actions=3, lstm_size=16, torso="resnet"),
}


def _obs(kw, shape, rng):
    """Vector observations; raw uint8 frames for a folded conv torso; frames
    already in [0, 1] for one that does not fold."""
    if len(kw["obs_shape"]) == 1:
        return (rng.randn(*shape, *kw["obs_shape"]) * 0.3).astype(np.float32)
    if kw.get("fold_normalize"):
        return rng.randint(0, 256, (*shape, *kw["obs_shape"])).astype(np.uint8)
    return rng.rand(*shape, *kw["obs_shape"]).astype(np.float32)


def _jax_net(kw):
    return JaxNet(num_actions=kw["num_actions"], lstm_size=kw["lstm_size"],
                  torso=kw.get("torso", "mlp"), fold_normalize=kw.get("fold_normalize", False))


def _port_net(kw, jax_params):
    net = R2D2Net(kw["num_actions"], kw["obs_shape"], lstm_size=kw["lstm_size"],
                  torso=kw.get("torso", "mlp"), fold_normalize=kw.get("fold_normalize", False))
    net.load_state_dict(r2d2_params_from_jax(jax.tree.map(np.asarray, jax_params)), strict=True)
    return net


@pytest.mark.parametrize("name", sorted(NETS))
def test_net_step_and_unroll_match_jax(name):
    kw = NETS[name]
    B, T, A, H = 3, 6, kw["num_actions"], kw["lstm_size"]
    rng = np.random.RandomState(2)
    obs = _obs(kw, (B, T), rng)
    pa = rng.randint(0, A, (B, T)).astype(np.int32)
    done = rng.rand(B, T) < 0.2
    h0 = (rng.randn(B, H) * 0.3).astype(np.float32)
    c0 = (rng.randn(B, H) * 0.3).astype(np.float32)
    jnet = _jax_net(kw)
    params = jnet.init(jax.random.PRNGKey(0), obs[:, 0], pa[:, 0], h0, c0)
    net = _port_net(kw, params)

    want_q, want_h, want_c = jnet.apply(params, obs[:, 0], pa[:, 0], h0, c0)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    q, h, c = net.step(t(obs[:, 0]), t(pa[:, 0]), t(h0), t(c0))
    for got, want in ((q, want_q), (h, want_h), (c, want_c)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)

    want_seq = jnet.apply(params, obs, pa, done, h0, c0, method=jnet.unroll)
    got_seq = net(t(obs), t(pa), t(h0), t(c0), done=t(done))
    assert got_seq.shape == (B, T, A)
    np.testing.assert_allclose(got_seq.detach().numpy(), np.asarray(want_seq), atol=1e-5)


def test_value_rescale_matches_jax_and_round_trips():
    """h matches JAX to float32 rounding. Its inverse subtracts 1 from
    sqrt(1 + 4 eps (|x| + 1 + eps)), which cancels digits, and XLA may
    reassociate the constant factors: rtol 1e-5 there."""
    x = np.concatenate([np.linspace(-500, 500, 101), [0.0, 1e-6, -3.5]]).astype(np.float32)
    got = value_rescale.value_rescale(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_vr.value_rescale(x)), rtol=1e-6,
                               atol=1e-7)
    back = value_rescale.inverse_value_rescale(got)
    np.testing.assert_allclose(back.numpy(), np.asarray(jax_vr.inverse_value_rescale(
        jax_vr.value_rescale(x))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-4, atol=1e-3)


def _seq_batch(B, T, H, seed):
    rng = np.random.RandomState(seed)
    return dict(
        state=pomdp_project(rng.randn(B, T, 4) * 0.2),
        previous_action=rng.randint(0, 2, (B, T)).astype(np.int32),
        action=rng.randint(0, 2, (B, T)).astype(np.int32),
        reward=rng.choice([0.0, 1.0], (B, T)).astype(np.float32),
        done=rng.rand(B, T) < 0.15,
        initial_h=(rng.randn(B, H) * 0.2).astype(np.float32),
        initial_c=(rng.randn(B, H) * 0.2).astype(np.float32),
    )


LEARN_MODES = {
    "reference": dict(),
    "eta": dict(priority_eta=0.9),
    "clipped": dict(gradient_clip_norm=0.05),
}


def _adam_state(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))


@pytest.mark.parametrize("mode", sorted(LEARN_MODES))
def test_td_error_and_learn_step_match_jax(mode):
    kw = dict(obs_shape=(2,), num_actions=2, seq_len=10, burn_in=5, lstm_size=32,
              learning_rate=1e-3, **LEARN_MODES[mode])
    jagent = JaxAgent(JaxConfig(**kw))
    jstate = jax.jit(jagent.init_state)(jax.random.PRNGKey(0))
    other = jax.jit(jagent.init_state)(jax.random.PRNGKey(1)).params
    jstate = jstate.replace(target_params=other)
    agent = R2D2Agent(R2D2Config(**kw), device="cpu")
    state = agent.state_from_params(r2d2_params_from_jax(jax.tree.map(np.asarray, jstate.params)))
    for k, v in r2d2_params_from_jax(jax.tree.map(np.asarray, other)).items():
        state.target_params[k].copy_(v)

    batch = _seq_batch(B=4, T=10, H=32, seed=3)
    is_weight = np.array([1.0, 0.5, 0.25, 0.8], np.float32)
    want_td = jax.jit(jagent._td_error)(jstate, JaxBatch(**batch))
    fwd, bwd = klstm.lstm_fwd_cuda.launches, klstm.lstm_bwd_cuda.launches
    got_td = agent.td_error(state, R2D2Batch(**batch))
    np.testing.assert_allclose(got_td.numpy(), np.asarray(want_td), rtol=1e-4, atol=1e-7)

    jstate, want_prio, want_m = jax.jit(jagent._learn)(jstate, JaxBatch(**batch), is_weight)
    state, prio, metrics = agent.learn(state, R2D2Batch(**batch), is_weight)
    assert (klstm.lstm_fwd_cuda.launches, klstm.lstm_bwd_cuda.launches) == (fwd, bwd)
    assert set(metrics) == set(want_m) == {"loss", "grad_norm"}
    for k in want_m:
        np.testing.assert_allclose(float(metrics[k]), float(want_m[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(prio.numpy(), np.asarray(want_prio), rtol=1e-4, atol=1e-7)
    assert state.step == 1

    adam = _adam_state(jstate.opt_state)
    for name, got, want_tree in (("params", state.params, jstate.params),
                                 ("mu", state.mu, adam.mu), ("nu", state.nu, adam.nu)):
        want = r2d2_params_from_jax(jax.tree.map(np.asarray, want_tree))
        assert set(want) == set(got)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-9 if name != "params" else 1e-7,
                                       err_msg=f"{name} {k}")


def test_sync_target_copies_in_place():
    agent = R2D2Agent(R2D2Config(lstm_size=8), device="cpu")
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


@pytest.mark.parametrize("capacity,n_add", [(64, 40), (16, 50)])
def test_replay_matches_jax_python_backend(capacity, n_add):
    rng = np.random.RandomState(7)
    errors = (rng.rand(n_add) * 3.0).astype(np.float32)
    items = list(range(n_add))
    mine, ref = PrioritizedReplay(capacity, seed=0), JaxReplay(capacity, seed=0)
    assert mine.add_batch(errors, items) == ref.add_batch(errors, items)
    np.testing.assert_array_equal(priority_transform(errors), jax_priority_transform(errors))
    r_mine, r_ref = np.random.RandomState(11), np.random.RandomState(11)
    for _ in range(3):
        got_items, got_idx, got_w = mine.sample(8, r_mine)
        want_items, want_idx, want_w = ref.sample(8, r_ref)
        assert got_items == want_items
        np.testing.assert_array_equal(got_idx, want_idx)
        np.testing.assert_array_equal(got_w, want_w)
        assert got_w.dtype == np.float32 and mine.beta == ref.beta
        new_err = r_mine.rand(8) * 2.0
        r_ref.rand(8)
        mine.update_batch(got_idx, new_err)
        ref.update_batch(want_idx, new_err)
        assert mine.tree.total == ref.tree.total
        np.testing.assert_array_equal(mine.tree._tree, ref.tree._tree)
    assert len(mine) == len(ref) == min(capacity, n_add)


def test_learner_replay_is_the_jax_learners_backend():
    """The learner builds `make_replay(backend="auto")`, as the JAX
    learner does: the array backend over the native sum tree here. From
    the same seed and inserts it samples the JAX learner's indices and
    IS weights, through each learner's own sampling stream."""
    from distributed_reinforcement_learning_tpu.data.fifo import TrajectoryQueue as JaxQueue
    from distributed_reinforcement_learning_tpu.runtime.r2d2_runner import (
        R2D2Learner as JaxLearner)
    from distributed_reinforcement_learning_tpu.runtime.weights import WeightStore as JaxStore
    from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
    from distributed_reinforcement_learning_tpu_torch.runtime.r2d2_runner import R2D2Learner
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

    kw = dict(obs_shape=(2,), num_actions=2, seq_len=10, burn_in=5, lstm_size=16)
    mine = R2D2Learner(R2D2Agent(R2D2Config(**kw), device="cpu"), TrajectoryQueue(8),
                       WeightStore(), batch_size=8, replay_capacity=100, seed=3)
    ref = JaxLearner(JaxAgent(JaxConfig(**kw)), JaxQueue(8), JaxStore(), batch_size=8,
                     replay_capacity=100, seed=3)
    assert type(mine.replay).__name__ == type(ref.replay).__name__ == "ArrayPrioritizedReplay"
    rng = np.random.RandomState(8)
    for _ in range(3):
        batch = _seq_batch(B=40, T=10, H=16, seed=int(rng.randint(1 << 30)))
        errors = rng.rand(40) * 2.0
        mine.replay.add_batch_stacked(errors, R2D2Batch(**batch))
        ref.replay.add_batch_stacked(errors, JaxBatch(**batch))
    for _ in range(3):
        got, idx, w = mine.replay.sample(8, mine._np_rng)
        want, want_idx, want_w = ref.replay.sample(8, ref._np_rng)
        np.testing.assert_array_equal(idx, want_idx)
        np.testing.assert_array_equal(w, want_w)
        assert isinstance(got, R2D2Batch)
        for field in R2D2Batch._fields:
            np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(want, field)))
        new = rng.rand(8)
        mine.replay.update_batch(idx, new)
        ref.replay.update_batch(want_idx, new)
    assert len(mine.replay) == len(ref.replay) == 100


def test_sequence_accumulator_matches_jax():
    rng = np.random.RandomState(5)
    N, T, H = 3, 4, 6
    h0, c0 = rng.randn(N, H).astype(np.float32), rng.randn(N, H).astype(np.float32)
    mine, ref = R2D2SequenceAccumulator(), JaxAccumulator()
    mine.reset(h0, c0)
    ref.reset(h0, c0)
    h0 += 1.0  # the accumulators keep their own copy of the start state
    for _ in range(T):
        step = dict(state=pomdp_project(rng.randn(N, 4)),
                    previous_action=rng.randint(0, 2, N).astype(np.int32),
                    action=rng.randint(0, 2, N).astype(np.int32),
                    reward=rng.rand(N).astype(np.float32), done=rng.rand(N) < 0.3)
        mine.append(**step)
        ref.append(**step)
    assert len(mine) == T
    got, want = mine.extract(), ref.extract()
    assert len(got) == len(want) == N
    for g, w in zip(got, want):
        assert isinstance(g, R2D2Batch) and g._fields == w._fields
        for field in g._fields:
            np.testing.assert_array_equal(getattr(g, field), np.asarray(getattr(w, field)))
    assert got[0].state.shape == (T, 2) and got[0].initial_h.shape == (H,)
    np.testing.assert_array_equal(pomdp_project(np.ones((2, 4)) * 0.5),
                                  jax_pomdp(np.ones((2, 4)) * 0.5))


@pytest.mark.parametrize("section", ["r2d2", "r2d2_pixel"])
def test_load_config_matches_jax(section):
    cfg, rt = load_config(CONFIG, section)
    jcfg, jrt = jax_load_config(CONFIG, section)
    assert isinstance(cfg, R2D2Config)
    mine = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}
    theirs = {k: v for k, v in dataclasses.asdict(jcfg).items() if k != "dtype"}
    assert mine == theirs
    assert str(cfg.dtype) == f"torch.{np.dtype(jcfg.dtype).name}"  # float32 in both
    for field in dataclasses.fields(rt):
        assert getattr(rt, field.name) == getattr(jrt, field.name), field.name
    if section == "r2d2":
        raw = json.loads(CONFIG.read_text())["r2d2"]
        assert raw["gradient_clip_norm"] == 40.0 and cfg.gradient_clip_norm is None
        assert (cfg.lstm_size, rt.batch_size, cfg.seq_len, cfg.burn_in) == (512, 32, 10, 5)
        assert (rt.num_actors, rt.envs_per_actor) == (3, 4)


def test_epsilon_greedy_by_distribution():
    n, A = 30000, 4
    q = torch.zeros(n, A)
    q[:, 2] = 1.0
    eps = torch.tensor([0.0, 0.3, 1.0]).repeat_interleave(n // 3)
    action = common.epsilon_greedy(q, eps, A, torch.Generator().manual_seed(0))
    for i, e in enumerate((0.0, 0.3, 1.0)):
        sl = action[i * n // 3:(i + 1) * n // 3].numpy()
        freq = np.bincount(sl, minlength=A) / len(sl)
        want = np.full(A, e / A)
        want[2] += 1.0 - e
        sigma = np.sqrt(want * (1 - want) / len(sl))
        assert np.all(np.abs(freq - want) <= 5 * sigma + 1e-9), (e, freq, want)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        R2D2Agent(R2D2Config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_r2d2.main(["--config", str(CONFIG), "--updates", "1"])


def test_full_width_r2d2_run_on_cpu(tmp_path):
    """Three train steps of the `r2d2` section (LSTM 512, batch 32 x 10,
    3 actors x 4 envs) through the launcher: 8 rounds of 12 sequences,
    the first train step once 64 sequences have arrived."""
    launches = (klstm.lstm_fwd_cuda.launches, klstm.lstm_bwd_cuda.launches)
    result = train_r2d2.main(["--config", str(CONFIG), "--section", "r2d2", "--updates", "3",
                              "--device", "cpu", "--run_dir", str(tmp_path)])
    assert (klstm.lstm_fwd_cuda.launches, klstm.lstm_bwd_cuda.launches) == launches
    assert result["frames"] == 8 * 12 * 10
    m = result["last_metrics"]
    assert set(m) == {"loss", "grad_norm"} and all(np.isfinite(v) for v in m.values())
    assert m["grad_norm"] > 0
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines if x["tag"] == "learner/loss"] == [1, 2, 3]
