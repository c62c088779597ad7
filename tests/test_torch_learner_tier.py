"""The port's learner tier (`runtime/learner_tier.py`) on the CPU.

Twin of `tests/test_learner_tier.py` (its `TestMembership` and
`TestCollective` are in `tests/test_torch_collective.py`; its mesh-seat
pin waits for ROADMAP item 13b), at the reference's tolerances:

- the flat vector: a dict of tensors round-trips with its shapes,
  dtypes and device;
- union-batch equivalence: two `allreduce` seats' merged gradients equal
  the union batch's (rtol 1e-4, atol 1e-6); after 3 tier-wrapped steps
  the seats' parameters are bit for bit equal and within rtol 1e-3 /
  atol 1e-6 of the union learner's;
- against JAX: from converted weights the port's two-seat merged
  gradient, by name, is JAX's (rtol 1e-4); the port's exchange plan
  equals JAX's by leaf name, class and size for the `apex`, `r2d2` and
  `xformer_moe` parameters;
- the tier: publisher re-election and demotion to solo, the async
  bounded-staleness pin (the merge lands in the live tensors), priority
  write-back to each seat's own replay;
- `attach`: allreduce refused for every family without the split learn
  step, K forced to 1, and every learner's `_learn` seam is the path its
  learn step takes (host and device sample paths, `_learn_many` for
  IMPALA K > 1);
- the gates and `build_tier`;
- two seat processes (this file's `__main__` block): bit identity, and a
  hard death mid-run that the survivor rides out solo as publisher;
- the launcher: two `apex` seats under allreduce on the CPU, and its
  refusals.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_reinforcement_learning_tpu_torch.runtime import learner_tier
from distributed_reinforcement_learning_tpu_torch.runtime.learner_tier import (
    LearnerTier,
    flatten_tree,
    unflatten_tree,
)

REPO = Path(__file__).resolve().parent.parent
CONFIG = REPO / "config.json"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _addrs(n: int) -> list[str]:
    return [f"127.0.0.1:{_free_port()}" for _ in range(n)]


def _run_threads(fns, timeout: float = 30.0):
    out = [None] * len(fns)
    errs = [None] * len(fns)

    def wrap(i):
        try:
            out[i] = fns[i]()
        except Exception as e:  # noqa: BLE001 — surfaced by the assert
            errs[i] = e

    threads = [threading.Thread(target=wrap, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a seat thread wedged"
    assert all(e is None for e in errs), errs
    return out


def _tiers(n: int, sync: str = "allreduce", wait_s: float = 20.0, **kw) -> list[LearnerTier]:
    addrs = _addrs(n)
    tiers = [LearnerTier(r, addrs, sync=sync, probe_interval_s=kw.pop("probe_interval_s", 60.0),
                         **kw) for r in range(n)]
    for t in tiers:
        t.collective.wait_s = wait_s
        t.start()
    return tiers


def _close(tiers) -> None:
    threads = [threading.Thread(target=t.close) for t in tiers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the flat vector -------------------------------------------------------------


class TestFlattenTree:
    def test_round_trip_shapes_dtypes_and_device(self):
        tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "b": {"c": torch.tensor([1.5, 2.5], dtype=torch.float64),
                      "d": torch.tensor([[7]], dtype=torch.int32)}}
        vec, meta = flatten_tree(tree)
        assert vec.dtype == np.float32 and vec.shape == (9,)
        np.testing.assert_array_equal(vec, [0, 1, 2, 3, 4, 5, 1.5, 2.5, 7])  # dict order
        back = unflatten_tree(vec, meta)
        assert back["b"]["c"].dtype == torch.float64 and back["b"]["d"].dtype == torch.int32
        assert back["a"].device == tree["a"].device and back["a"].shape == (2, 3)
        torch.testing.assert_close(back["a"], tree["a"])
        torch.testing.assert_close(back["b"]["c"], tree["b"]["c"])

    def test_length_mismatch_raises(self):
        _, meta = flatten_tree({"a": torch.zeros(4)})
        with pytest.raises(ValueError):
            unflatten_tree(np.zeros(5, np.float32), meta)

    def test_read_only_vectors_unflatten(self):
        vec, meta = flatten_tree({"a": torch.ones(3)})
        ro = np.frombuffer(vec.tobytes(), np.float32)  # as a peer's merge arrives
        torch.testing.assert_close(unflatten_tree(ro, meta)["a"], torch.ones(3))


# -- union-batch equivalence -----------------------------------------------------


def _apex_fixture(obs_dim: int = 12, b: int = 16):
    from distributed_reinforcement_learning_tpu_torch.agents.apex import (
        ApexAgent, ApexBatch, ApexConfig)

    agent = ApexAgent(ApexConfig(obs_shape=(obs_dim,), num_actions=3), device="cpu")
    rng = np.random.RandomState(0)
    union = ApexBatch(
        state=rng.rand(2 * b, obs_dim).astype(np.float32),
        next_state=rng.rand(2 * b, obs_dim).astype(np.float32),
        previous_action=rng.randint(0, 3, 2 * b).astype(np.int32),
        action=rng.randint(0, 3, 2 * b).astype(np.int32),
        reward=rng.randn(2 * b).astype(np.float32),
        done=(rng.rand(2 * b) < 0.1))
    halves = [ApexBatch(*(x[:b] for x in union)), ApexBatch(*(x[b:] for x in union))]
    isw = np.ones(2 * b, np.float32)
    return agent, union, halves, isw


def _fresh_state(agent):
    return agent.sync_target(agent.init_state(0))


class TestAllreduceEquivalence:
    def test_merged_gradients_equal_union_batch(self):
        agent, union, halves, isw = _apex_fixture()
        b = len(isw) // 2
        state = _fresh_state(agent)
        gu, _, lu = agent.grads(state, union, isw)
        vu, _ = flatten_tree(gu)
        tiers = _tiers(2)
        try:
            parts = []
            for r in range(2):
                g, _, loss = agent.grads(state, halves[r], isw[:b])
                parts.append(np.concatenate([flatten_tree(g)[0], np.float32([float(loss)])]))
            out = _run_threads([lambda r=r: tiers[r].collective.allreduce_mean(parts[r])
                                for r in range(2)])
            np.testing.assert_array_equal(out[0], out[1])  # bit-identical
            np.testing.assert_allclose(out[0][:-1], vu, rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(out[0][-1], float(lu), rtol=1e-5)
        finally:
            _close(tiers)

    def test_tiered_seats_track_union_learner(self):
        agent, union, halves, isw = _apex_fixture()
        b = len(isw) // 2
        s = _fresh_state(agent)
        for _ in range(3):
            s, _, _ = agent.learn(s, union, isw)
        union_params = {k: v.detach().clone() for k, v in s.params.items()}
        tiers = _tiers(2)
        try:
            fns = [t._make_allreduce_learn(agent.grads, agent.apply_grads) for t in tiers]
            states = [_fresh_state(agent) for _ in range(2)]

            def seat(r):
                st = states[r]
                for _ in range(3):
                    st, _, metrics = fns[r](st, halves[r], isw[:b])
                assert metrics["loss"].dtype == torch.float32
                return st

            res = _run_threads([lambda r=r: seat(r) for r in range(2)], timeout=120.0)
            for k in union_params:
                torch.testing.assert_close(res[0].params[k], res[1].params[k], rtol=0, atol=0)
                np.testing.assert_allclose(res[0].params[k].detach().numpy(),
                                           union_params[k].numpy(), rtol=1e-3, atol=1e-6)
            assert res[0].step == 3 and tiers[0].stat("rounds") == 3
        finally:
            _close(tiers)


# -- against the JAX package -----------------------------------------------------


def test_two_seat_merged_gradient_matches_jax_by_name():
    """Both packages' two-seat allreduce over the same halves of one
    batch, from converted parameters: the merged gradients agree by
    parameter name at the learn step's rtol 1e-4 (conv kernels and Dense
    weights through the converter's transposes), the merged loss too."""
    import jax

    from distributed_reinforcement_learning_tpu.agents.apex import ApexAgent as JaxAgent
    from distributed_reinforcement_learning_tpu.agents.apex import ApexBatch as JaxBatch
    from distributed_reinforcement_learning_tpu.agents.apex import ApexConfig as JaxConfig
    from distributed_reinforcement_learning_tpu.parallel import collective as jax_coll
    from distributed_reinforcement_learning_tpu.runtime import learner_tier as jax_tier
    from distributed_reinforcement_learning_tpu_torch.agents.apex import (
        ApexAgent, ApexBatch, ApexConfig)
    from distributed_reinforcement_learning_tpu_torch.models.convert import apex_params_from_jax

    kw = dict(obs_shape=(36, 36, 4), num_actions=4)
    jagent = JaxAgent(JaxConfig(**kw))
    jstate = jax.jit(jagent.init_state)(jax.random.PRNGKey(0))
    jparams = jax.tree.map(np.asarray, jstate.params)
    agent = ApexAgent(ApexConfig(**kw), device="cpu")
    state = agent.sync_target(agent.state_from_params(apex_params_from_jax(jparams)))
    rng = np.random.RandomState(5)
    b = 4
    halves = [dict(state=rng.randint(0, 256, (b, 36, 36, 4)).astype(np.uint8),
                   next_state=rng.randint(0, 256, (b, 36, 36, 4)).astype(np.uint8),
                   previous_action=rng.randint(0, 4, b).astype(np.int32),
                   action=rng.randint(0, 4, b).astype(np.int32),
                   reward=rng.choice([0.0, 1.0, -1.0, 3.0], b).astype(np.float32),
                   done=np.arange(b) % 3 == 1) for _ in range(2)]
    isw = [np.linspace(0.3, 1.0, b).astype(np.float32), np.full(b, 0.7, np.float32)]

    jgrads = jax.jit(jagent.grads)
    jvecs, jmeta = [], None
    pvecs, pmeta = [], None
    for r in range(2):
        g, _, loss = jgrads(jstate, JaxBatch(**halves[r]), isw[r])
        v, jmeta = jax_tier.flatten_tree(g)
        jvecs.append(np.concatenate([v, np.float32([loss]).ravel()]))
        g, _, loss = agent.grads(state, ApexBatch(**halves[r]), isw[r])
        v, pmeta = flatten_tree(g)
        pvecs.append(np.concatenate([v, np.float32([float(loss)])]))
    merged = {}
    for name, module, vecs in (("jax", jax_coll, jvecs), ("port", learner_tier, pvecs)):
        addrs = _addrs(2)
        colls = [module.HostCollective(r, addrs, wait_s=20.0).start() for r in range(2)]
        try:
            out = _run_threads([lambda r=r: colls[r].allreduce_mean(vecs[r]) for r in range(2)])
        finally:
            threads = [threading.Thread(target=c.close) for c in colls]
            for t in threads:
                t.start()
            for t in threads:
                t.join(10.0)
        assert out[0].tobytes() == out[1].tobytes()
        merged[name] = out[0]
    want = apex_params_from_jax(jax.tree.map(np.asarray,
                                             jax_tier.unflatten_tree(merged["jax"][:-1], jmeta)))
    got = unflatten_tree(merged["port"][:-1], pmeta)
    assert set(got) == set(want) == set(state.params)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(merged["port"][-1], merged["jax"][-1], rtol=1e-4)


@pytest.mark.parametrize("section", ["apex", "r2d2", "xformer_moe"])
def test_exchange_plan_matches_jax_by_leaf_name(section):
    """The port's plan and JAX's over the section's parameters (shapes
    only, each leaf filled with its own index so that a converted name
    tells its source): leaf by leaf, the same class and size; the loss
    tail last in both. The orders differ (flax sorts its keys)."""
    import jax

    from distributed_reinforcement_learning_tpu.parallel import partition as jax_partition
    from distributed_reinforcement_learning_tpu.runtime import launch as jax_launch
    from distributed_reinforcement_learning_tpu.utils.config import load_config as jax_load
    from distributed_reinforcement_learning_tpu_torch.models import convert
    from distributed_reinforcement_learning_tpu_torch.parallel.partition import (
        build_exchange_plan)

    to_port = {"apex": convert.apex_params_from_jax, "r2d2": convert.r2d2_params_from_jax,
               "xformer": lambda t: convert.transformer_params_from_jax(t, head="dueling_q")}
    cfg, rt = jax_load(str(CONFIG), section)
    algo = jax_launch._algo_of(cfg)
    agent = jax_launch.make_agent(algo, cfg, rt)
    shapes = jax.eval_shape(lambda: agent.init_state(jax.random.PRNGKey(0)).params)
    flat = jax.tree.leaves(shapes)
    filled = jax.tree.unflatten(jax.tree.structure(shapes),
                                [np.full(s.shape, i, np.float32) for i, s in enumerate(flat)])
    jax_plan = jax_partition.build_exchange_plan(filled, tail=1)
    ported = {k: v.numpy() for k, v in to_port[algo](filled).items()}
    plan = build_exchange_plan(ported, tail=1)
    assert len(plan.entries) == len(jax_plan.entries) == len(flat) + 1
    for (key, size), arr in zip(plan.entries, ported.values()):
        source = int(arr.flat[0])
        assert (key, size) == tuple(jax_plan.entries[source]), (key, size, source)
    assert plan.entries[-1] == tuple(jax_plan.entries[-1]) == ("rep", 1)
    assert plan.length == jax_plan.length and set(plan.classes) == set(jax_plan.classes)
    if section == "xformer_moe":
        assert {"expert", "-,model", "rep"} <= set(plan.classes)


# -- the tier's behaviour --------------------------------------------------------


class TestLearnerTier:
    def test_publisher_reelection_and_demote_to_solo(self):
        tiers = _tiers(2, wait_s=2.0, probe_interval_s=0.25, dead_after_s=0.5)
        try:
            assert tiers[0].is_publisher() and not tiers[1].is_publisher()
            assert tiers[1].publisher_pid() in (None, os.getpid())
            fired = []
            tiers[1].set_promote_cb(lambda: fired.append(True))
            tiers[0].close()
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline and not fired:
                tiers[1].sweep()
                time.sleep(0.1)
            assert fired, "promote callback never fired"
            assert tiers[1].is_publisher() and tiers[1].publisher_pid() == os.getpid()
            assert tiers[1].collective.membership.solo
            assert tiers[1].stat("promotions") == 1
            out = tiers[1]._merged_rounds(np.arange(4, dtype=np.float32))
            np.testing.assert_array_equal(out, np.arange(4, dtype=np.float32))
        finally:
            tiers[1].close()

    def test_promote_cb_fires_on_arrival_after_promotion(self):
        tier = LearnerTier(1, _addrs(2), sync="allreduce", probe_interval_s=60.0)
        tier.start()
        try:
            tier.collective._note_dead(0)
            tier._check_membership()
            assert tier.is_publisher()
            fired = []
            tier.set_promote_cb(lambda: fired.append(True))
            assert fired, "fire-on-arrival missed the earlier promotion"
        finally:
            tier.close()

    def test_async_merge_bounded_staleness_pin(self):
        @dataclasses.dataclass
        class S:
            params: dict

        tiers = _tiers(2, sync="async")
        for t in tiers:
            t.merge_steps = 1
            t.stale_max = 2
        try:
            w = torch.ones(4, requires_grad=True)
            state = S(params={"w": w})
            assert tiers[1].collective.push_merge(np.full(4, 3.0, np.float32), step=1) == 1
            merged = tiers[0]._maybe_async_merge(state)
            assert merged.params["w"] is w  # averaged into the live tensor
            np.testing.assert_allclose(w.detach().numpy(), np.full(4, 2.0, np.float32))
            assert tiers[0].stat("merges_applied") == 1
            # A sender silent past stale_max of our merge rounds: dropped.
            tiers[0]._merge_step = 10
            merged2 = tiers[0]._maybe_async_merge(merged)
            np.testing.assert_allclose(merged2.params["w"].detach().numpy(), 2.0)
            assert tiers[0].stat("merges_skipped_stale") >= 1
            # A NEW push re-includes it, its own stamp far behind ours.
            assert tiers[1].collective.push_merge(np.full(4, 5.0, np.float32), step=2) == 1
            before = tiers[0].stat("merges_applied")
            tiers[0]._maybe_async_merge(merged2)
            assert tiers[0].stat("merges_applied") == before + 1
            np.testing.assert_allclose(w.detach().numpy(), (2.0 + 5.0) / 2.0)
        finally:
            _close(tiers)

    def test_priority_writeback_routes_to_own_seat_loss_free(self):
        from distributed_reinforcement_learning_tpu_torch.agents.apex import (
            ApexAgent, ApexBatch, ApexConfig)
        from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
        from distributed_reinforcement_learning_tpu_torch.data.replay_service import (
            ShardedReplayService)
        from distributed_reinforcement_learning_tpu_torch.runtime import apex_runner
        from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

        tiers = _tiers(2)
        learners, services = [], []
        rng = np.random.RandomState(3)
        try:
            for r in range(2):
                svc = ShardedReplayService(2, 2048, mode="transition", scorer="max", seed=r)
                agent = ApexAgent(ApexConfig(obs_shape=(8,), num_actions=2), device="cpu")
                learner = apex_runner.ApexLearner(
                    agent, TrajectoryQueue(8), WeightStore(), batch_size=16,
                    replay_capacity=2048, train_start_unrolls=1, seed=r, replay_service=svc)
                tiers[r].attach(learner)
                for shard in svc.shards:
                    shard.ingest(ApexBatch(
                        state=rng.rand(32, 8).astype(np.float32),
                        next_state=rng.rand(32, 8).astype(np.float32),
                        previous_action=rng.randint(0, 2, 32).astype(np.int32),
                        action=rng.randint(0, 2, 32).astype(np.int32),
                        reward=rng.randn(32).astype(np.float32),
                        done=(rng.rand(32) < 0.1)))
                learner.ingested_unrolls = 4  # past the warm gate
                learners.append(learner)
                services.append(svc)

            def train(r):
                for _ in range(2):
                    assert learners[r].train() is not None
                assert services[r].flush_updates(timeout=10.0)
                return sum(s.stats()["updates_applied"] for s in services[r].shards)

            applied = _run_threads([lambda r=r: train(r) for r in range(2)], timeout=120.0)
            assert applied == [32, 32]  # 2 calls x batch 16, each on the seat that sampled
            assert [t.stat("rounds") for t in tiers] == [2, 2]
            # attach built the plan: the Linear weights went owner-scoped.
            assert [t.collective.stat("coll_rounds_part") for t in tiers] == [2, 2]
            assert tiers[1].collective.stat("coll_bytes_model") > 0
            for k, v in learners[0].state.params.items():
                torch.testing.assert_close(v, learners[1].state.params[k], rtol=0, atol=0)
        finally:
            _close(tiers)
            for lrn in learners:
                lrn.close()
            for svc in services:
                svc.close()


# -- attach and the learners' seams ----------------------------------------------


def _impala_unrolls(kw: dict, n: int, seed: int):
    from distributed_reinforcement_learning_tpu_torch.agents.impala import ImpalaBatch

    rng = np.random.RandomState(seed)
    T, A, H = kw["trajectory"], kw["num_actions"], kw["lstm_size"]
    logits = rng.randn(n, T, A)
    batch = dict(state=rng.randn(n, T, *kw["obs_shape"]).astype(np.float32),
                 reward=rng.randn(n, T).astype(np.float32),
                 action=rng.randint(0, A, (n, T)).astype(np.int32),
                 done=rng.rand(n, T) < 0.2,
                 behavior_policy=(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
                                  ).astype(np.float32),
                 previous_action=rng.randint(0, A, (n, T)).astype(np.int32),
                 initial_h=rng.randn(n, T, H).astype(np.float32),
                 initial_c=rng.randn(n, T, H).astype(np.float32))
    return [ImpalaBatch(**{k: v[i] for k, v in batch.items()}) for i in range(n)]


def _learner(family: str, k: int = 1, svc=None):
    """A small learner of `family` on the CPU."""
    from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

    queue, weights = TrajectoryQueue(64), WeightStore()
    if family in ("impala", "ximpala"):
        from distributed_reinforcement_learning_tpu_torch.runtime import (
            impala_runner, ximpala_runner)

        if family == "impala":
            from distributed_reinforcement_learning_tpu_torch.agents.impala import (
                ImpalaAgent, ImpalaConfig)

            agent = ImpalaAgent(ImpalaConfig(obs_shape=(4,), num_actions=2, lstm_size=16,
                                             trajectory=4), device="cpu")
            return impala_runner.ImpalaLearner(agent, queue, weights, batch_size=2,
                                               updates_per_call=k)
        from distributed_reinforcement_learning_tpu_torch.agents.ximpala import (
            XImpalaAgent, XImpalaConfig)

        agent = XImpalaAgent(XImpalaConfig(obs_shape=(4,), num_actions=2, d_model=16,
                                           num_heads=2, num_layers=1, trajectory=4),
                             device="cpu")
        return ximpala_runner.XImpalaLearner(agent, queue, weights, batch_size=2)
    if family == "apex":
        from distributed_reinforcement_learning_tpu_torch.agents.apex import (
            ApexAgent, ApexConfig)
        from distributed_reinforcement_learning_tpu_torch.runtime import apex_runner

        agent = ApexAgent(ApexConfig(obs_shape=(4,), num_actions=2), device="cpu")
        return apex_runner.ApexLearner(agent, queue, weights, batch_size=8,
                                       replay_capacity=2048, replay_service=svc,
                                       updates_per_call=k, train_start_unrolls=1,
                                       target_sync_interval=10)
    from distributed_reinforcement_learning_tpu_torch.runtime import r2d2_runner, xformer_runner

    if family == "r2d2":
        from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import (
            R2D2Agent, R2D2Config)

        agent = R2D2Agent(R2D2Config(obs_shape=(2,), num_actions=2, seq_len=10, burn_in=5,
                                     lstm_size=32), device="cpu")
        return r2d2_runner.R2D2Learner(agent, queue, weights, batch_size=8,
                                       replay_capacity=2048, replay_service=svc,
                                       updates_per_call=k, target_sync_interval=10)
    from distributed_reinforcement_learning_tpu_torch.agents.xformer import (
        XformerAgent, XformerConfig)

    agent = XformerAgent(XformerConfig(obs_shape=(2,), num_actions=2, seq_len=10, burn_in=5,
                                       d_model=16, num_heads=2, num_layers=1), device="cpu")
    return xformer_runner.XformerLearner(agent, queue, weights, batch_size=8,
                                         replay_capacity=2048, replay_service=svc)


_ALLREDUCE_REFUSED = "DRL_LEARNER_SYNC=allreduce needs the split learn step"


class TestAttach:
    @pytest.mark.parametrize("family", ["impala", "r2d2", "xformer", "ximpala"])
    def test_allreduce_refused_without_the_split_step(self, family):
        tier = LearnerTier(0, _addrs(2), sync="allreduce", probe_interval_s=60.0)
        learner = _learner(family)
        try:
            with pytest.raises(ValueError, match=_ALLREDUCE_REFUSED):
                tier.attach(learner)
        finally:
            learner.close()
            tier.close()

    def test_refusal_is_the_jax_message(self):
        from distributed_reinforcement_learning_tpu.runtime import learner_tier as jax_tier

        class NoSplit:
            _learn = staticmethod(lambda *a: a)

            class agent:  # noqa: N801 — stub
                pass

        msgs = []
        for module in (jax_tier, learner_tier):
            with pytest.raises(ValueError) as e:
                module.LearnerTier(0, _addrs(2), sync="allreduce",
                                   probe_interval_s=60.0).attach(NoSplit())
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] and _ALLREDUCE_REFUSED in msgs[1]

    def test_attach_contract(self):
        tier = LearnerTier(0, _addrs(2), sync="allreduce", probe_interval_s=60.0)

        class NoSeam:
            agent = object()

        with pytest.raises(ValueError, match="_learn"):
            tier.attach(NoSeam())

        class K8:
            class agent:  # noqa: N801 — stub
                grads = apply_grads = staticmethod(lambda *a: a)

            _learn = staticmethod(lambda *a: a)
            updates_per_call = 8

        k8 = K8()
        tier.attach(k8)
        assert k8.updates_per_call == 1 and k8._learn is not K8._learn

        class FakePrefetcher:
            reconfigured_to = None

            def reconfigure(self, stack_calls):
                self.reconfigured_to = stack_calls

        k8p = K8()
        k8p.prefetcher = FakePrefetcher()
        tier.attach(k8p)
        assert k8p.updates_per_call == 1 and k8p.prefetcher.reconfigured_to == 1
        tier.close()

    def test_async_keeps_impala_k_and_forces_replay_k_to_one(self):
        tier = LearnerTier(0, _addrs(2), sync="async", probe_interval_s=60.0)
        impala, apex = _learner("impala", k=4), _learner("apex", k=2)
        try:
            tier.attach(impala)
            assert impala.updates_per_call == 4 and "_learn_many" in vars(impala)
            tier.attach(apex)
            assert apex.updates_per_call == 1 and "_learn" in vars(apex)
        finally:
            impala.close()
            apex.close()
            tier.close()

    @pytest.mark.parametrize("family, device_path", [
        ("apex", False), ("apex", True), ("r2d2", False), ("r2d2", True)])
    def test_replay_learn_steps_go_through_the_seam(self, family, device_path):
        """A wrapped `_learn` sees every K = 1 train() call, on the host
        path and through the device sample path (`device_train_call`)."""
        from distributed_reinforcement_learning_tpu_torch.data import codec
        from distributed_reinforcement_learning_tpu_torch.data.replay_service import (
            ShardedReplayService)
        from test_torch_replay_service import apex_unrolls, r2d2_sequences

        mode = "transition" if family == "apex" else "sequence"
        svc = ShardedReplayService(2, 2048, mode=mode, scorer="max", seed=0)
        if family == "apex":
            from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexBatch

            items = apex_unrolls(ApexBatch, 0, 8)
        else:
            from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Batch

            items = r2d2_sequences(R2D2Batch, 0, 16, t=10, h=32)
        for i, item in enumerate(items):
            svc.shards[i % 2].ingest_blob(bytes(codec.encode(item)))
        learner = _learner(family, svc=svc)
        learner.device_path_force = device_path
        seen = []
        seam = learner._learn

        def counting(*args):
            seen.append(1)
            return seam(*args)

        learner._learn = counting
        try:
            deadline = time.monotonic() + 30.0
            while learner.train_steps < 3:
                learner.train()
                assert time.monotonic() < deadline
            assert len(seen) == learner.train_steps == 3
            assert (learner._device_path is not None) == device_path
        finally:
            learner.close()
            svc.close()

    @pytest.mark.parametrize("k", [1, 3])
    def test_impala_learn_steps_go_through_the_seams(self, k):
        learner = _learner("impala", k=k)
        calls = {"_learn": 0, "_learn_many": 0}
        for name in calls:
            seam = getattr(learner, name)

            def counting(*args, name=name, seam=seam):
                calls[name] += 1
                return seam(*args)

            setattr(learner, name, counting)
        try:
            for u in _impala_unrolls(dict(obs_shape=(4,), num_actions=2, lstm_size=16,
                                          trajectory=4), 2 * k * 2, seed=1):
                learner.queue.put(u)
            for _ in range(2):
                assert learner.step(timeout=1.0) is not None
            assert calls == ({"_learn": 2, "_learn_many": 0} if k == 1
                             else {"_learn": 0, "_learn_many": 2})
        finally:
            learner.close()


# -- the gates -------------------------------------------------------------------


class TestGates:
    def test_build_tier_env_resolution(self, monkeypatch):
        monkeypatch.delenv("DRL_LEARNER_RANK", raising=False)
        monkeypatch.delenv("DRL_LEARNER_PEERS", raising=False)
        assert learner_tier.build_tier() is None
        monkeypatch.setenv("DRL_LEARNER_RANK", "1")
        monkeypatch.setenv("DRL_LEARNER_PEERS", "127.0.0.1:1,127.0.0.1:2,127.0.0.1:3")
        tier = learner_tier.build_tier()
        assert tier is not None and tier.rank == 1 and tier.seats == 3
        monkeypatch.setenv("DRL_LEARNER_PEERS", "127.0.0.1:1")
        assert learner_tier.build_tier() is None  # one seat = no tier

    def test_seat_count_and_sync_gates(self, monkeypatch):
        from distributed_reinforcement_learning_tpu.runtime import learner_tier as jax_tier

        monkeypatch.setenv("DRL_LEARNER_SEATS", "3")
        assert learner_tier.seat_count() == 3
        monkeypatch.setenv("DRL_LEARNER_SEATS", "0")
        assert learner_tier.seat_count() == 0
        monkeypatch.setenv("DRL_LEARNER_SEATS", "two")
        with pytest.raises(ValueError, match="DRL_LEARNER_SEATS"):
            learner_tier.seat_count()
        monkeypatch.delenv("DRL_LEARNER_SEATS")
        # Unset: the constant, which holds the committed verdict.
        assert learner_tier.seat_count() == jax_tier.seat_count() == 0
        assert learner_tier.tier_auto_enabled() is jax_tier.tier_auto_enabled() is False
        monkeypatch.setenv("DRL_LEARNER_SYNC", "async")
        assert learner_tier.sync_mode() == "async"
        monkeypatch.setenv("DRL_LEARNER_SYNC", "bogus")
        with pytest.raises(ValueError):
            learner_tier.sync_mode()
        monkeypatch.setenv("DRL_LEARNER_MERGE_STEPS", "0")
        monkeypatch.setenv("DRL_LEARNER_STALE_MAX", "3")
        assert (learner_tier.merge_steps(), learner_tier.stale_max()) == (1, 3)


# -- two seat processes ----------------------------------------------------------


def _spawn_seat(rank: int, peers: str, rounds: int, mode: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, __file__, str(rank), peers, str(rounds), mode],
                            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)


def _seat_result(proc: subprocess.Popen, timeout: float):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate(timeout=10)
        raise AssertionError(f"seat wedged: {err[-800:]}") from None
    line = next((ln for ln in out.splitlines() if ln.startswith("SEAT_OUT=")), None)
    return (None if line is None else json.loads(line.split("=", 1)[1])), out, err


class TestTwoProcessSeats:
    def test_two_process_allreduce_bit_identity(self):
        peers = ",".join(_addrs(2))
        procs = [_spawn_seat(r, peers, 3, "ok") for r in range(2)]
        results = []
        for proc in procs:
            res, out, err = _seat_result(proc, timeout=60)
            assert proc.returncode == 0 and res is not None, out + err[-800:]
            results.append(res)
        for a, b in zip(results[0]["rounds"], results[1]["rounds"]):
            assert a["crc"] == b["crc"] and a["head"] == b["head"]
        assert results[0]["publisher"] and not results[1]["publisher"]
        assert all(not r["solo"] for r in results[0]["rounds"])
        assert results[0]["stats"]["round_giveups"] == 0

    def test_two_process_mid_round_death_survivor_goes_solo(self):
        peers = ",".join(_addrs(2))
        procs = [_spawn_seat(r, peers, 3, "die") for r in range(2)]
        _seat_result(procs[0], timeout=60)
        assert procs[0].returncode == 17  # the scripted hard death
        res, out, err = _seat_result(procs[1], timeout=60)
        assert procs[1].returncode == 0 and res is not None, out + err[-800:]
        assert res["rounds"][-1]["solo"] is True
        assert res["publisher"] is True and res["stats"]["promotions"] == 1
        assert res["coll"]["peer_deaths"] == 1


# -- the launcher ----------------------------------------------------------------

_APEX_CARTPOLE = {
    "num_actors": 1, "env": ["CartPole-v0"], "available_action": [2], "envs_per_actor": 4,
    "model_input": [4], "model_output": 2, "batch_size": 32, "queue_size": 32,
    "replay_capacity": 2000, "target_sync_interval": 10, "start_learning_rate": 0.001,
}


def test_launcher_runs_two_apex_seats_under_allreduce(tmp_path):
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"apex_cartpole": _APEX_CARTPOLE}))
    env = dict(os.environ, DRL_NO_GYMNASIUM="1", OMP_NUM_THREADS="1", DRL_SHM_WEIGHTS="1")
    env.pop("DRL_LEARNER_ADDR", None)
    updates = 20
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_reinforcement_learning_tpu_torch.launch_local_cluster",
         "--config", str(config), "--section", "apex_cartpole", "--algo", "apex",
         "--actors", "2", "--updates", str(updates), "--device", "cpu", "--actor_grace", "5",
         "--learners", "2", "--learner_sync", "allreduce"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate(timeout=10)
        raise
    assert proc.returncode == 0, out[-4000:]
    assert "[cluster] learner tier: 2 seat(s), sync=allreduce" in out
    seats = []
    for rank in range(2):
        name = f"learner{rank}"
        assert f"[{name}] [learner] tier seat {rank}/2 (sync=allreduce" in out
        (summary,) = [json.loads(line[len(name) + 3:]) for line in out.splitlines()
                      if line.startswith(f"[{name}] {{")]
        seats.append(summary)
    for rank, s in enumerate(seats):
        tier = s["tier"]
        assert s["train_steps"] == updates and tier["rank"] == rank
        assert tier["rounds"] == updates and tier["round_giveups"] == 0
        assert tier["collective"]["rounds_ok"] > 0 and tier["live"] == [0, 1]
    assert seats[0]["tier"]["publisher"] and seats[0]["board"] is not None
    assert seats[1]["board"] is None  # only the publisher writes the shared board
    assert "shm weight board attached: drlwboard-" in out and "-tier" in out


@pytest.mark.parametrize("argv, msg", [
    (["--learners", "2"], "item 13b"),
    (["--learners", "2", "--learner_sync", "allreduce", "--section", "r2d2"],
     "use --learner_sync async for 'r2d2'"),
    (["--learners", "2", "--learner_sync", "async", "--respawn", "on-exit"],
     "--respawn needs --learners 1"),
    (["--learner_sync", "async"], "item 13a"),
])
def test_launcher_tier_refusals(argv, msg, capsys, monkeypatch):
    from distributed_reinforcement_learning_tpu_torch import launch_local_cluster as cluster

    monkeypatch.delenv("DRL_LEARNER_SEATS", raising=False)
    with pytest.raises(SystemExit) as e:
        cluster.parse_args(["--section", "impala_cartpole", *argv])
    assert e.value.code == 2 and msg in capsys.readouterr().err


def test_launcher_tier_resolution(monkeypatch):
    from distributed_reinforcement_learning_tpu_torch import launch_local_cluster as cluster

    monkeypatch.delenv("DRL_LEARNER_SEATS", raising=False)
    args = cluster.parse_args(["--section", "r2d2", "--learners", "2", "--learner_sync",
                               "async"])
    assert args.tier_sync == "async"
    monkeypatch.setenv("DRL_LEARNER_SEATS", "2")
    monkeypatch.setenv("DRL_LEARNER_SYNC", "async")
    assert cluster.parse_args(["--section", "r2d2", "--learners", "2"]).tier_sync == "async"
    assert cluster.parse_args(["--section", "apex"]).tier_sync is None


# -- the seat worker: `python tests/test_torch_learner_tier.py <rank> <peers> <rounds> <mode>`


def _seat_main(argv: list[str]) -> None:
    """One seat of a 2-seat collective: joins the roster, runs `rounds`
    allreduce rounds over a seeded vector and prints the merged results
    (crc and first elements). Mode "die": seat 0 exits hard after the
    first round, and the survivor must finish its rounds solo."""
    rank, peers, rounds, mode = int(argv[0]), argv[1].split(","), int(argv[2]), argv[3]
    tier = LearnerTier(rank, peers, sync="allreduce", probe_interval_s=0.25, dead_after_s=1.0)
    tier.collective.wait_s = 2.0
    tier.start()
    assert tier.await_peers(30.0), "startup barrier failed"
    tier.set_promote_cb(lambda: None)
    rng = np.random.RandomState(100 + rank)
    out = []
    for i in range(rounds):
        merged = tier._merged_rounds(rng.rand(257).astype(np.float32) * (rank + 1))
        out.append({"round": i, "crc": zlib.crc32(merged.tobytes()) & 0xFFFFFFFF,
                    "head": [float(x) for x in merged[:3]],
                    "solo": tier.collective.membership.solo})
        if mode == "die" and rank == 0 and i == 0:
            os._exit(17)  # no close(), no goodbye
    print("SEAT_OUT=" + json.dumps({"rank": rank, "rounds": out,
                                    "publisher": tier.is_publisher(),
                                    "stats": tier.snapshot_stats(),
                                    "coll": tier.collective.snapshot_stats()}), flush=True)
    tier.close()


if __name__ == "__main__":
    _seat_main(sys.argv[1:])
