"""The port's host collective (`parallel/collective.py`) and exchange plans.

Twin of `tests/test_collective_partition.py` (the bf16 codec, plan
hashing and the class walk, plan negotiation and the mismatch refusal,
owner-scoped k = 2/3 rounds, bf16 wire bytes, NaN/Inf, the gates,
overlapped rounds) and of `tests/test_learner_tier.py`'s `TestMembership`
and `TestCollective`, on the port's modules, with the reference's
tolerances. Across the packages: a ring of JAX and port seats (k = 2 and
3, plan-less and partitioned, f32 and bf16) merges bit for bit as an
all-JAX ring does, and both packages hash the same entries alike.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_reinforcement_learning_tpu.data import bf16 as jax_bf16
from distributed_reinforcement_learning_tpu.parallel import collective as jax_coll
from distributed_reinforcement_learning_tpu_torch.data.bf16 import (
    bf16_u16_to_f32,
    f32_to_bf16_u16,
)
from distributed_reinforcement_learning_tpu_torch.parallel import collective as coll
from distributed_reinforcement_learning_tpu_torch.parallel.collective import (
    CollectiveError,
    ExchangePlan,
    Membership,
    PeerLost,
    PlanMismatch,
    RoundAborted,
    class_label,
)
from distributed_reinforcement_learning_tpu_torch.parallel.partition import build_exchange_plan
from distributed_reinforcement_learning_tpu_torch.runtime import learner_tier
from distributed_reinforcement_learning_tpu_torch.runtime.learner_tier import LearnerTier

REPO = Path(__file__).parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _addrs(n: int) -> list[str]:
    return [f"127.0.0.1:{_free_port()}" for _ in range(n)]


def _collectives(n: int, wait_s: float = 5.0, modules=None) -> list:
    """`n` started seats; seat r is `modules[r]`'s HostCollective (the
    port's by default)."""
    addrs = _addrs(n)
    modules = modules or [coll] * n
    return [modules[r].HostCollective(r, addrs, wait_s=wait_s).start() for r in range(n)]


def _close(colls) -> None:
    """Close the seats side by side: a JAX endpoint's stop waits out its
    accept timeout (0.5 s), so closing them in turn adds that up."""
    threads = [threading.Thread(target=c.close) for c in colls]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)


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


def _swallow(fn):
    try:
        return fn()
    except (RoundAborted, PeerLost):
        return None


def _params_tree():
    """A schema of the port's names hitting every default partition
    class: a big Linear weight (model), an expert-stacked MoE tensor
    (expert), a pipe-stacked block, and a small bias (replicated)."""
    return {
        "dense.weight": np.ones((128, 64), np.float32),
        "dense.bias": np.zeros(128, np.float32),
        "moe_w1": np.ones((4, 32, 64), np.float32),
        "blocks_stacked": {"w": np.ones((8, 32, 32), np.float32)},
    }


# The direct-entry plan the exchange tests drive: one segment a class,
# sizes past MIN_PARTITION_SIZE so the classes are honest.
_ENTRIES = [("rep", 5000), ("-,model", 4096), ("expert", 4096), ("pipe", 4096)]
_VEC_LEN = sum(n for _, n in _ENTRIES)


def _seat_vecs(k: int) -> list[np.ndarray]:
    """Seat vectors at magnitudes 1e-3..1e3, so that the bf16 error bound
    is exercised across exponents."""
    rng = np.random.RandomState(7)
    scale = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), _VEC_LEN))
    return [(rng.randn(_VEC_LEN) * scale).astype(np.float32) for _ in range(k)]


# -- membership and the plan-less ring ------------------------------------------


class TestMembership:
    def test_epoch_bumps_only_on_live_removal(self):
        m = Membership(range(3), rank=0)
        assert m.live() == [0, 1, 2] and m.epoch == 0
        assert m.mark_dead(2) is True
        assert m.epoch == 1 and m.live() == [0, 1]
        assert m.mark_dead(2) is False  # already dead: no bump
        assert m.epoch == 1

    def test_own_rank_never_dies(self):
        m = Membership(range(2), rank=0)
        assert m.mark_dead(0) is False
        assert m.live() == [0, 1]

    def test_solo_and_snapshot_coherence(self):
        m = Membership(range(2), rank=1)
        assert not m.solo
        m.mark_dead(0)
        assert m.solo
        live, epoch = m.snapshot()
        assert live == [1] and epoch == 1

    def test_own_rank_must_be_in_roster(self):
        with pytest.raises(ValueError):
            Membership([0, 1], rank=5)


class TestCollective:
    @pytest.mark.parametrize("n", [2, 3])
    def test_allreduce_bit_identity_across_seats(self, n):
        """Every seat ends with the SAME bytes, the mean."""
        colls = _collectives(n)
        try:
            vecs = [np.arange(23, dtype=np.float32) * (r + 1) + 0.25 for r in range(n)]
            out = _run_threads([lambda r=r: colls[r].allreduce_mean(vecs[r]) for r in range(n)])
            want = np.sum(vecs, axis=0, dtype=np.float32) / np.float32(n)
            for r in range(n):
                np.testing.assert_array_equal(out[r], out[0])
            np.testing.assert_allclose(out[0], want, rtol=1e-6)
        finally:
            _close(colls)

    def test_round_seq_advances_across_rounds(self):
        colls = _collectives(2)
        try:
            for _ in range(3):  # three back-to-back rounds must pair up
                vecs = [np.random.RandomState(7).rand(8).astype(np.float32),
                        np.random.RandomState(8).rand(8).astype(np.float32)]
                out = _run_threads([lambda r=r: colls[r].allreduce_mean(vecs[r])
                                    for r in range(2)])
                np.testing.assert_array_equal(out[0], out[1])
            assert colls[0].stat("rounds_ok") == 3
        finally:
            _close(colls)

    def test_nak_from_reformed_peer_aborts_round(self):
        colls = _collectives(2)
        try:
            colls[1].membership.mark_dead(0)  # seat 1 dropped seat 0
            with pytest.raises(RoundAborted):
                colls[0].allreduce_mean(np.ones(8, np.float32))
        finally:
            _close(colls)

    def test_epoch_bump_under_inflight_wait_aborts(self):
        colls = _collectives(3, wait_s=30.0)
        try:
            t = threading.Thread(target=lambda: _swallow(
                lambda: colls[0].allreduce_mean(np.ones(9, np.float32))))
            t0 = time.monotonic()
            t.start()
            time.sleep(0.3)  # seat 0 is now parked waiting on seat 2
            colls[0]._note_dead(2)
            t.join(10.0)
            assert not t.is_alive()
            assert time.monotonic() - t0 < 10.0  # well under wait_s
        finally:
            _close(colls)

    def test_dead_peer_detected_and_membership_reforms(self):
        colls = _collectives(2, wait_s=1.0)
        try:
            colls[1].close()
            with pytest.raises((PeerLost, RoundAborted)):
                colls[0].allreduce_mean(np.ones(8, np.float32))
            assert colls[0].membership.solo
            out = colls[0].allreduce_mean(np.arange(8, dtype=np.float32))
            np.testing.assert_array_equal(out, np.arange(8, dtype=np.float32))
            assert colls[0].stat("solo_rounds") == 1
        finally:
            colls[0].close()

    def test_async_merge_latest_wins_and_staleness_filter(self):
        colls = _collectives(2)
        try:
            v5 = np.full(4, 5.0, np.float32)
            v9 = np.full(4, 9.0, np.float32)
            assert colls[0].push_merge(v5, step=5) == 1
            assert colls[0].push_merge(v9, step=9) == 1  # overwrites
            got = colls[1].take_merges(min_step=9)
            assert list(got) == [0]
            step, arr = got[0]
            assert step == 9
            np.testing.assert_array_equal(arr, v9)
            assert colls[1].take_merges(min_step=10) == {}
        finally:
            _close(colls)

    def test_merge_from_dropped_sender_naks(self):
        colls = _collectives(2)
        try:
            colls[1].membership.mark_dead(0)
            assert colls[0].push_merge(np.ones(4, np.float32), step=1) == 0
            assert colls[1].take_merges(min_step=0) == {}
        finally:
            _close(colls)

    def test_probe_reports_peer_pid_and_membership_view(self):
        colls = _collectives(2)
        try:
            assert colls[0].probe_peer(1) is True
            assert colls[0].peer_pid(1) == colls[1].peer_pid(0)  # same process
            colls[1].membership.mark_dead(0)
            assert colls[0].probe_peer(1) is False  # the peer dropped us
        finally:
            _close(colls)


# -- the bf16 codec ---------------------------------------------------------------


class TestBf16Codec:
    def test_byte_identity_with_weight_shard_aliases_and_jax(self):
        """The weight plane's codec IS data/bf16.py's, and it rounds byte
        for byte as the JAX package's does on an adversarial vector."""
        from distributed_reinforcement_learning_tpu_torch.runtime import weight_shards

        assert weight_shards._f32_to_bf16_u16 is f32_to_bf16_u16
        assert weight_shards._bf16_u16_to_f32 is bf16_u16_to_f32
        x = np.array([0.0, -0.0, 1.0, -1.0, np.pi, 1e-38, 1e38, np.inf, -np.inf, np.nan,
                      -np.nan, 1.0039062, 1.0039063, 65504.0, 3.3895314e38], np.float32)
        a = f32_to_bf16_u16(x)
        assert a.tobytes() == jax_bf16.f32_to_bf16_u16(x).tobytes()
        assert bf16_u16_to_f32(a).tobytes() == jax_bf16.bf16_u16_to_f32(a).tobytes()

    def test_rne_error_bound_and_idempotency(self):
        rng = np.random.RandomState(3)
        x = (rng.randn(4096) * np.exp(rng.uniform(np.log(1e-6), np.log(1e6), 4096))
             ).astype(np.float32)
        rt = bf16_u16_to_f32(f32_to_bf16_u16(x))
        assert np.all(np.abs(rt - x) <= np.float32(2.0 ** -8) * np.abs(x))
        rt2 = bf16_u16_to_f32(f32_to_bf16_u16(rt))
        assert rt2.tobytes() == rt.tobytes()

    def test_nan_inf_safety(self):
        x = np.array([np.nan, -np.nan, np.inf, -np.inf, 3.39e38, -3.39e38], np.float32)
        rt = bf16_u16_to_f32(f32_to_bf16_u16(x))
        assert np.isnan(rt[0]) and np.isnan(rt[1])  # NaN never -> Inf
        assert rt[2] == np.inf and rt[3] == -np.inf
        assert not np.isnan(rt[4]) and not np.isnan(rt[5])


# -- plan building ---------------------------------------------------------------


class TestExchangePlan:
    def test_segments_merge_and_deterministic_class_walk(self):
        plan = ExchangePlan([("rep", 4), ("rep", 4), ("-,model", 8), ("rep", 2)])
        assert plan.length == 18
        assert plan.segments["rep"] == [(0, 8), (16, 18)]
        assert plan.segments["-,model"] == [(8, 16)]
        assert plan.classes == ["rep", "-,model"]  # rep first, then sorted
        vec = np.arange(18, dtype=np.float32)
        rep = plan.gather(vec, "rep")
        assert rep.tolist() == list(range(8)) + [16.0, 17.0]
        out = np.zeros(18, np.float32)
        plan.scatter(out, "rep", rep)
        assert out[:8].tolist() == list(range(8)) and out[16] == 16.0

    def test_plan_hash_agreement_k2_k3(self):
        hashes = [build_exchange_plan(_params_tree(), tail=1).plan_hash for _ in range(3)]
        assert hashes[0] == hashes[1] == hashes[2]
        plan = build_exchange_plan(_params_tree(), tail=1)
        assert {"-,model", "expert", "pipe", "rep"} == set(plan.classes)
        # The dict's own order, the order of the tier's flat vector; the
        # loss tail last.
        assert [n for _, n in plan.entries] == [8192, 128, 8192, 8192, 1]
        assert plan.entries[-1] == ("rep", 1)

    def test_device_tensors_plan_as_arrays_do(self):
        tensors = {k: torch.as_tensor(v) for k, v in _params_tree().items()
                   if not isinstance(v, dict)}
        arrays = {k: v for k, v in _params_tree().items() if not isinstance(v, dict)}
        assert (build_exchange_plan(tensors, tail=1).plan_hash
                == build_exchange_plan(arrays, tail=1).plan_hash)

    def test_quant_and_overlap_fold_into_hash(self):
        base = build_exchange_plan(_params_tree())
        assert build_exchange_plan(_params_tree(), quant="bf16").plan_hash != base.plan_hash
        assert build_exchange_plan(_params_tree(), overlap=1).plan_hash != base.plan_hash

    def test_invalid_quant_refused(self):
        with pytest.raises(ValueError, match="f32|bf16"):
            ExchangePlan([("rep", 4)], quant="fp8")

    def test_class_label_vocabulary(self):
        assert class_label("rep") == "rep"
        assert class_label("-,model") == "model"
        assert class_label("expert") == "expert"
        assert class_label("pipe") == "pipe"
        assert class_label("-,weird_axis") == "other"

    @pytest.mark.parametrize("quant, overlap", [("f32", 0), ("bf16", 0), ("f32", 1)])
    def test_plan_hash_equals_jax_for_the_same_entries(self, quant, overlap):
        entries = _ENTRIES + [("rep", 1)]
        assert (ExchangePlan(entries, quant=quant, overlap=overlap).plan_hash
                == jax_coll.ExchangePlan(entries, quant=quant, overlap=overlap).plan_hash)


# -- plan negotiation ------------------------------------------------------------


class TestPlanNegotiation:
    @pytest.mark.parametrize("k", [2, 3])
    def test_hello_pins_agreement(self, k):
        colls = _collectives(k)
        plan = build_exchange_plan(_params_tree(), tail=1)
        try:
            for c in colls:
                c.set_plan(plan)
            for a in range(k):
                for b in range(k):
                    if a != b:
                        assert colls[a].probe_peer(b) is True
            for c in colls:
                c.check_plan_agreement()
        finally:
            _close(colls)

    def test_rule_mismatch_is_loud_refusal(self):
        colls = _collectives(2)
        good = ExchangePlan(_ENTRIES)
        skewed = ExchangePlan([("rep", 5000 + 4096), ("expert", 4096), ("pipe", 4096)])
        try:
            colls[0].set_plan(good)
            colls[1].set_plan(skewed)
            assert colls[0].probe_peer(1) is False  # hash skew -> NAK
            assert colls[1].probe_peer(0) is False
            with pytest.raises(PlanMismatch):
                colls[0].check_plan_agreement()
            with pytest.raises(PlanMismatch):
                colls[1].check_plan_agreement()
            with pytest.raises(PlanMismatch):
                colls[0].allreduce_mean(np.zeros(_VEC_LEN, np.float32), plan=good)
        finally:
            _close(colls)

    def test_quant_mismatch_refused_too(self):
        colls = _collectives(2)
        try:
            colls[0].set_plan(ExchangePlan(_ENTRIES, quant="f32"))
            colls[1].set_plan(ExchangePlan(_ENTRIES, quant="bf16"))
            assert colls[0].probe_peer(1) is False
            with pytest.raises(PlanMismatch):
                colls[0].check_plan_agreement()
        finally:
            _close(colls)

    def test_unnegotiated_peer_is_not_a_mismatch(self):
        colls = _collectives(2)
        try:
            colls[0].set_plan(ExchangePlan(_ENTRIES))
            assert colls[0].probe_peer(1) is True
            colls[0].check_plan_agreement()  # peer None: no refusal
        finally:
            _close(colls)


# -- partitioned rounds ----------------------------------------------------------


def _round(colls, plan, vecs, plans=None):
    plans = plans or [plan] * len(colls)
    for c, p in zip(colls, plans):
        c.set_plan(p)
    return _run_threads([lambda r=r: colls[r].allreduce_mean(vecs[r], plan=plans[r])
                         for r in range(len(colls))])


class TestPartitionedExchange:
    def test_owner_scoped_k2_exact_mean_per_class(self):
        vecs = _seat_vecs(2)
        colls = _collectives(2)
        plan = ExchangePlan(_ENTRIES)
        try:
            out = _round(colls, plan, vecs)
            expect = (vecs[0] + vecs[1]) / np.float32(2)
            assert out[0].tobytes() == out[1].tobytes()
            for key in plan.classes:
                np.testing.assert_array_equal(plan.gather(out[0], key), plan.gather(expect, key),
                                              err_msg=f"class {key}")
        finally:
            _close(colls)

    def test_owner_scoped_k3_bit_identical_and_close(self):
        vecs = _seat_vecs(3)
        colls = _collectives(3)
        plan = ExchangePlan(_ENTRIES)
        try:
            out = _round(colls, plan, vecs)
            assert out[0].tobytes() == out[1].tobytes() == out[2].tobytes()
            np.testing.assert_allclose(out[0], np.mean(np.stack(vecs), axis=0, dtype=np.float64),
                                       rtol=1e-5, atol=1e-6)
            for c in colls:
                stats = c.snapshot_stats()
                assert stats["coll_rounds_part"] == 1
                for cls in ("model", "expert", "pipe"):
                    assert stats[f"coll_bytes_{cls}"] > 0, (c.rank, stats)
        finally:
            _close(colls)

    def test_all_replicated_plan_matches_plan_less_ring_bitwise(self):
        vecs = _seat_vecs(2)
        legacy = _collectives(2)
        try:
            base = _round(legacy, None, vecs)
        finally:
            _close(legacy)
        part = _collectives(2)
        try:
            out = _round(part, ExchangePlan([("rep", _VEC_LEN)]), vecs)
        finally:
            _close(part)
        assert out[0].tobytes() == base[0].tobytes()
        assert out[1].tobytes() == base[1].tobytes()

    def test_bf16_halves_wire_bytes_and_bounds_error(self):
        vecs = _seat_vecs(2)
        f32_colls = _collectives(2)
        try:
            f32_out = _round(f32_colls, ExchangePlan(_ENTRIES), vecs)
            f32_bytes = sum(c.stat("bytes_sent") for c in f32_colls)
        finally:
            _close(f32_colls)
        bf_colls = _collectives(2)
        try:
            bf_out = _round(bf_colls, ExchangePlan(_ENTRIES, quant="bf16"), vecs)
            bf_bytes = sum(c.stat("bytes_sent") for c in bf_colls)
            for c in bf_colls:
                assert c.stat("coll_quant_rounds") == 1
        finally:
            _close(bf_colls)
        assert bf_bytes * 2 == f32_bytes
        assert bf_out[0].tobytes() == bf_out[1].tobytes()
        bound = np.float32(2.0 ** -7) * (np.abs(vecs[0]) + np.abs(vecs[1])) / 2 + 1e-7
        assert np.all(np.abs(bf_out[0] - f32_out[0]) <= bound)

    def test_bf16_nan_inf_survive_the_round(self):
        vecs = _seat_vecs(2)
        vecs[0][10] = np.nan  # rep segment (ring)
        vecs[1][5000 + 7] = np.inf  # model segment (star)
        colls = _collectives(2)
        try:
            out = _round(colls, ExchangePlan(_ENTRIES, quant="bf16"), vecs)
            assert out[0].tobytes() == out[1].tobytes()
            assert np.isnan(out[0][10])
            assert np.isinf(out[0][5000 + 7])
        finally:
            _close(colls)

    def test_stale_plan_length_refused(self):
        colls = _collectives(1)  # solo: the check is local
        try:
            with pytest.raises(CollectiveError, match="stale plan"):
                colls[0].allreduce_mean(np.zeros(8, np.float32), plan=ExchangePlan([("rep", 9)]))
        finally:
            colls[0].close()


# -- one wire protocol across the packages --------------------------------------


@pytest.mark.parametrize("seats, quant, partitioned", [
    ("jp", "f32", False), ("jp", "f32", True), ("pj", "bf16", True),
    ("jpj", "f32", False), ("pjp", "f32", True), ("jpj", "bf16", True)])
def test_mixed_ring_merges_as_an_all_jax_ring(seats, quant, partitioned):
    """Seats of both packages in one ring (j = JAX, p = port) end with
    the bytes an all-JAX ring of the same vectors ends with, plan-less
    and partitioned, f32 and bf16 hops."""
    k = len(seats)
    vecs = _seat_vecs(k)

    def plan_of(module):
        return module.ExchangePlan(_ENTRIES, quant=quant) if partitioned else None

    ref = _collectives(k, modules=[jax_coll] * k)
    try:
        want = _round(ref, None, vecs, plans=[plan_of(jax_coll)] * k)
    finally:
        _close(ref)
    modules = [jax_coll if s == "j" else coll for s in seats]
    mixed = _collectives(k, modules=modules)
    try:
        got = _round(mixed, None, vecs, plans=[plan_of(m) for m in modules])
        for c in mixed:
            c.check_plan_agreement()
    finally:
        _close(mixed)
    for r in range(k):
        assert got[r].tobytes() == want[r].tobytes(), (seats, r)
    assert want[0].tobytes() == want[-1].tobytes()


def test_mixed_async_merges_cross_the_packages():
    colls = _collectives(2, modules=[jax_coll, coll])
    try:
        v = np.arange(6, dtype=np.float32)
        assert colls[0].push_merge(v, step=3) == 1
        assert colls[1].push_merge(v * 2, step=4) == 1
        assert colls[1].take_merges(0)[0][0] == 3
        np.testing.assert_array_equal(colls[0].take_merges(0)[1][1], v * 2)
    finally:
        _close(colls)


# -- the gates, constants of the committed verdicts ------------------------------


class TestCollGates:
    @pytest.fixture(autouse=True)
    def _fresh_flags(self, monkeypatch):
        for key in ("DRL_COLL_PARTITION", "DRL_COLL_QUANT", "DRL_COLL_OVERLAP"):
            monkeypatch.delenv(key, raising=False)
        learner_tier.refresh_coll_flags()
        yield monkeypatch
        learner_tier.refresh_coll_flags()

    def test_partition_defaults_on_and_env_forces(self, monkeypatch):
        assert learner_tier.coll_partition() is True
        monkeypatch.setenv("DRL_COLL_PARTITION", "0")
        learner_tier.refresh_coll_flags()
        assert learner_tier.coll_partition() is False
        monkeypatch.setenv("DRL_COLL_PARTITION", "1")
        learner_tier.refresh_coll_flags()
        assert learner_tier.coll_partition() is True

    def test_quant_env_forces(self, monkeypatch):
        monkeypatch.setenv("DRL_COLL_QUANT", "bf16")
        learner_tier.refresh_coll_flags()
        assert learner_tier.coll_quant() == "bf16"
        monkeypatch.setenv("DRL_COLL_QUANT", "0")
        learner_tier.refresh_coll_flags()
        assert learner_tier.coll_quant() == "f32"

    def test_overlap_env_caps_depth_at_one(self, monkeypatch):
        monkeypatch.setenv("DRL_COLL_OVERLAP", "3")
        learner_tier.refresh_coll_flags()
        assert learner_tier.coll_overlap() == 1
        monkeypatch.setenv("DRL_COLL_OVERLAP", "0")
        learner_tier.refresh_coll_flags()
        assert learner_tier.coll_overlap() == 0

    def test_overlap_non_integer_is_loud(self, monkeypatch):
        monkeypatch.setenv("DRL_COLL_OVERLAP", "yes")
        learner_tier.refresh_coll_flags()
        with pytest.raises(ValueError, match="DRL_COLL_OVERLAP"):
            learner_tier.coll_overlap()

    def test_unset_follows_the_committed_verdicts(self):
        """The port reads no verdict file: its constants hold the JAX
        package's committed values, and the unset gates follow them."""
        verdict = json.loads((REPO / "benchmarks" / "collective_verdict.json").read_text())
        assert learner_tier.QUANT_AUTO_ENABLE is verdict["quant_auto_enable"]
        assert learner_tier.OVERLAP_AUTO_ENABLE is verdict["overlap_auto_enable"]
        assert (learner_tier.coll_quant() == "bf16") is verdict["quant_auto_enable"]
        assert (learner_tier.coll_overlap() == 1) is verdict["overlap_auto_enable"]
        tier = json.loads((REPO / "benchmarks" / "learner_verdict.json").read_text())
        assert learner_tier.TIER_AUTO_ENABLE is tier["auto_enable"]
        assert learner_tier.VERDICT_SEATS == tier["seats"]
        assert learner_tier.VERDICT_SYNC == tier["sync"]


# -- backward-overlapped rounds --------------------------------------------------


class _OverlapRig:
    """A solo tier with stubbed backward and exchange latencies: grads_fn
    IS the backward (sleep BW), _merged_rounds the exchange (sleep RT)."""

    BW = 0.06
    RT = 0.06

    def __init__(self, overlap: int):
        self.tier = LearnerTier(0, _addrs(1), sync="allreduce", probe_interval_s=60.0)
        self.tier.start()
        self.tier._plan = ExchangePlan([("rep", 5)], overlap=overlap)

        def merged(vec):
            time.sleep(self.RT)
            return vec.astype(np.float32, copy=True)

        self.tier._merged_rounds = merged
        if overlap:
            self.tier._coll_worker = threading.Thread(target=self.tier._coll_loop, daemon=True,
                                                      name="t-coll")
            self.tier._coll_worker.start()

        def grads_fn(state, batch, w):
            time.sleep(self.BW)
            return {"g": torch.full((4,), float(state))}, None, torch.tensor(0.5)

        def apply_fn(state, grads, loss):
            return state + 1, {"loss": loss, "grad_norm": 1.0}

        self.learn = self.tier._make_allreduce_learn(grads_fn, apply_fn)

    def close(self):
        self.tier.close()


class TestOverlappedRounds:
    def test_overlap_actually_overlaps(self):
        steps = 6
        serial = _OverlapRig(overlap=0)
        try:
            state, t0 = 0, time.perf_counter()
            for _ in range(steps):
                state, _, _ = serial.learn(state, None, None)
            serial_s = time.perf_counter() - t0
            assert state == steps
        finally:
            serial.close()
        rig = _OverlapRig(overlap=1)
        try:
            state, t0 = 0, time.perf_counter()
            for _ in range(steps):
                state, _, _ = rig.learn(state, None, None)
            overlap_s = time.perf_counter() - t0
            assert state == steps - 1  # one apply behind
        finally:
            rig.close()
        assert overlap_s < 0.85 * serial_s, (overlap_s, serial_s)

    def test_priming_step_returns_state_unchanged(self):
        rig = _OverlapRig(overlap=1)
        try:
            state, _, metrics = rig.learn(7, None, None)
            assert state == 7
            assert set(metrics) == {"loss"}
            state, _, metrics = rig.learn(state, None, None)
            assert state == 8
            assert "grad_norm" in metrics and float(metrics["loss"]) == 0.5
            assert rig.tier.snapshot_stats()["overlap_rounds"] == 2
        finally:
            rig.close()

    def test_worker_exception_reraises_on_learn_thread(self):
        rig = _OverlapRig(overlap=1)
        try:
            def boom(vec):
                raise PlanMismatch("skewed plans")

            rig.tier._merged_rounds = boom
            rig.learn(0, None, None)  # primes: hands vec to the worker
            with pytest.raises(PlanMismatch, match="skewed"):
                rig.learn(0, None, None)
        finally:
            rig.close()
