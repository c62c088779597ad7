"""The port's sample-at-source admission (`data/admission.py`, the stamp
paths of `runtime/transport.py`) against the JAX package's, on the CPU.

- The gates' unset defaults are the JAX package's committed
  `benchmarks/admission_verdict.json` (both off).
- Stamp frames are byte-identical to the JAX package's for the same
  unroll and scorer, at full admission and under pressure (the same
  seed gives the same coin flips, Horvitz-Thompson corrections and
  thinned trees).
- Keep counts pass the chi-square against their Bernoulli
  probabilities, Horvitz-Thompson corrections preserve the expected
  priority mass, and the ledger loses no mass, as in the JAX tests.
- Across the wire: a JAX client that stamps feeds a port learner's
  ingest facade, and a port client feeds a JAX facade, with the
  ingested priority mass each package's own pair gives.
"""

import json
import socket
import time
from pathlib import Path

import numpy as np
import pytest

from distributed_reinforcement_learning_tpu.data import admission as jax_admission
from distributed_reinforcement_learning_tpu.data import codec as jax_codec
from distributed_reinforcement_learning_tpu.data import replay_service as jax_rs
from distributed_reinforcement_learning_tpu.data.fifo import TrajectoryQueue as JaxQueue
from distributed_reinforcement_learning_tpu.runtime import replay_shard as jax_shard
from distributed_reinforcement_learning_tpu.runtime import transport as jax_transport
from distributed_reinforcement_learning_tpu.runtime.weights import WeightStore as JaxWeights
from distributed_reinforcement_learning_tpu_torch.data import admission, codec, replay_service
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
from distributed_reinforcement_learning_tpu_torch.runtime import replay_shard, transport
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

REPO = Path(__file__).resolve().parents[1]
PKG = {"port": (admission, codec, replay_service, replay_shard, transport, TrajectoryQueue,
                WeightStore),
       "jax": (jax_admission, jax_codec, jax_rs, jax_shard, jax_transport, JaxQueue, JaxWeights)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_unroll(rng, steps=16, obs=6, scale=1.0):
    return {"obs": rng.standard_normal((steps, obs)).astype(np.float32),
            "reward": (scale * rng.standard_normal(steps)).astype(np.float32),
            "done": (rng.random(steps) < 0.1).astype(np.float32)}


@pytest.fixture
def gates(monkeypatch):
    """Set the admission gates for both packages; re-resolve after."""
    def set_env(**env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        admission.refresh_flags()
        jax_admission.refresh_flags()

    for k in ("DRL_ACTOR_PRIORITY", "DRL_ADMISSION", "DRL_ADMISSION_PRESSURE",
              "DRL_REPLAY_SCORER"):
        monkeypatch.delenv(k, raising=False)
    yield set_env
    monkeypatch.undo()
    admission.refresh_flags()
    jax_admission.refresh_flags()


def test_gate_defaults_are_the_committed_verdict(gates):
    gates()
    verdict = json.loads((REPO / "benchmarks" / "admission_verdict.json").read_text())
    for key, value in admission.DEFAULTS.items():
        assert value == bool(verdict.get(key, False))
    assert admission.actor_priority_enabled() is jax_admission.actor_priority_enabled() is False
    assert admission.admission_enabled() is jax_admission.admission_enabled() is False
    assert admission.ALGO_MODES == jax_admission.ALGO_MODES == replay_shard._ALGO_MODE
    assert (admission.EPS, admission.ALPHA) == (jax_admission.EPS, jax_admission.ALPHA)


@pytest.mark.parametrize("env, mine", [
    ({"DRL_ACTOR_PRIORITY": "1"}, False),  # the max scorer cannot stamp
    ({"DRL_ACTOR_PRIORITY": "1", "DRL_REPLAY_SCORER": "td_proxy"}, True),
    ({"DRL_ACTOR_PRIORITY": "0", "DRL_REPLAY_SCORER": "td_proxy"}, False)])
def test_controller_gate_resolves_as_jax(env, mine, gates):
    gates(**env)
    assert (admission.maybe_controller("apex") is not None) == mine
    assert (jax_admission.maybe_controller("apex") is not None) == mine
    assert admission.maybe_controller("impala") is None


@pytest.mark.parametrize("mode", ["transition", "sequence"])
@pytest.mark.parametrize("pressure", [None, "0.8", "1.0"])
def test_stamp_frames_match_jax(mode, pressure, gates):
    """The same unrolls through both controllers from one seed: the same
    decisions, stamps, stamp frames, thinned trees and stamped blobs."""
    env = {"DRL_ACTOR_PRIORITY": "1", "DRL_REPLAY_SCORER": "td_proxy"}
    if pressure is not None:
        env.update(DRL_ADMISSION="1", DRL_ADMISSION_PRESSURE=pressure)
    gates(**env)
    mine = admission.AdmissionController(mode, "td_proxy", seed=5)
    ref = jax_admission.AdmissionController(mode, "td_proxy", seed=5)
    rng = np.random.default_rng(3)
    dropped = thinned = 0
    for i in range(60):
        tree = make_unroll(rng, steps=12, scale=2.0 if i % 5 == 0 else 0.2)
        a, b = mine.admit(tree), ref.admit(tree)
        assert a.send == b.send and a.orig_t == b.orig_t
        if not a.send:
            dropped += 1
            continue
        assert a.stamp == b.stamp
        assert codec.stamp_frame(a.stamp) == jax_codec.stamp_frame(b.stamp)
        assert (a.tree is None) == (b.tree is None)
        sent = tree if a.tree is None else a.tree
        thinned += a.tree is not None
        blob_a = codec.stamp_blob(codec.encode(sent), a.stamp)
        blob_b = jax_codec.stamp_blob(jax_codec.encode(tree if b.tree is None else b.tree),
                                      b.stamp)
        assert bytes(blob_a) == bytes(blob_b)
        mine.note_wire(len(blob_a), a)
        ref.note_wire(len(blob_b), b)
    assert mine.snapshot() == ref.snapshot()
    assert mine.pending_folded_mass() == ref.pending_folded_mass()
    if pressure is not None and mode == "transition":
        assert dropped > 0 and thinned > 0


def _pinned(mu, pressure, gates, seed=0):
    gates(DRL_REPLAY_SCORER="td_proxy", DRL_ACTOR_PRIORITY="1", DRL_ADMISSION="1",
          DRL_ADMISSION_PRESSURE=str(pressure))
    ctrl = admission.AdmissionController("transition", "td_proxy", seed=seed)
    ctrl._mu, ctrl._mu_n = mu, 1  # pin the fleet mean: q_i is then analytic
    return ctrl


def _q(ctrl, pri, mu, pressure):
    mu_eff = ctrl.MU_DECAY * mu + (1 - ctrl.MU_DECAY) * float(pri.mean())
    s = min(1.0, (pressure - ctrl.lo) / (ctrl.hi - ctrl.lo))
    f = 1.0 - s * (1.0 - ctrl.floor)
    return np.minimum(np.maximum(f * pri / mu_eff, ctrl.floor), 1.0)


def test_chi_square_keep_counts_match_bernoulli_probabilities(gates):
    tree = make_unroll(np.random.default_rng(6), steps=12, scale=0.4)
    pri = admission.transform(replay_service.td_proxy_scorer(tree, True))
    mu = float(pri.mean()) * 4.0
    ctrl = _pinned(mu, 0.7, gates)
    q = _q(ctrl, pri, mu, 0.7)
    n_trials = 4000
    keeps = np.zeros(len(q))
    rows = [r.tobytes() for r in tree["obs"]]
    for _ in range(n_trials):
        ctrl._mu = mu  # re-pin: admit() advances the running mean
        d = ctrl.admit(tree)
        if not d.send:
            continue
        sent = {r.tobytes() for r in (tree if d.tree is None else d.tree)["obs"]}
        keeps += [r in sent for r in rows]
    expected = n_trials * q
    chi2 = float(np.sum((keeps - expected) ** 2 / expected
                        + ((n_trials - keeps) - (n_trials - expected)) ** 2
                        / (n_trials - expected)))
    assert chi2 < 32.9, (chi2, keeps / n_trials, q)  # dof 12, P(>32.9) ~ 0.001


def test_horvitz_thompson_corrections_preserve_expected_mass(gates):
    tree = make_unroll(np.random.default_rng(7), steps=10, scale=0.3)
    pri = admission.transform(replay_service.td_proxy_scorer(tree, True))
    mu = float(pri.mean()) * 3.0
    ctrl = _pinned(mu, 0.8, gates)
    total, n_trials = 0.0, 3000
    for _ in range(n_trials):
        ctrl._mu = mu
        d = ctrl.admit(tree)
        if d.send:
            total += float(admission.transform(np.asarray(d.stamp["pri"])).sum())
            total -= float(d.stamp.get("folded", 0.0))
    total += ctrl.snapshot()["dropped_mass"]
    assert abs(total / n_trials - float(pri.sum())) / float(pri.sum()) < 0.02


def test_q_equal_one_transitions_pass_through_bitwise(gates):
    tree = make_unroll(np.random.default_rng(8), steps=8, scale=0.5)
    err = np.asarray(replay_service.td_proxy_scorer(tree, True), np.float64)
    pri = admission.transform(err)
    mu = float(pri.mean()) * 1.3
    ctrl = _pinned(mu, 0.6, gates)
    checked = 0
    for _ in range(300):
        ctrl._mu = mu
        d = ctrl.admit(tree)
        if not d.send or d.tree is None:
            continue
        q = _q(ctrl, pri, mu, 0.6)
        sent = {r.tobytes(): j for j, r in enumerate(d.tree["obs"])}
        for i, row in enumerate(tree["obs"]):
            j = sent.get(row.tobytes())
            if j is None:
                continue
            if q[i] >= 1.0:
                assert np.float64(d.stamp["pri"][j]).tobytes() == err[i].tobytes()
            else:
                np.testing.assert_allclose(admission.transform(np.float64(d.stamp["pri"][j])),
                                           pri[i] / q[i], rtol=1e-12)
            checked += 1
    assert checked > 0


def test_zero_lost_mass_ledger(gates):
    rng = np.random.default_rng(9)
    ctrl = _pinned(10.0, 1.0, gates)
    sent_folded = 0.0
    for _ in range(400):
        ctrl._mu = 10.0  # everything far below the mean: maximal thinning
        d = ctrl.admit(make_unroll(rng, steps=6, scale=0.05))
        if d.send:
            sent_folded += float(d.stamp.get("folded", 0.0))
    snap = ctrl.snapshot()
    assert snap["dropped_unrolls"] > 0
    assert snap["dropped_mass"] == pytest.approx(sent_folded + ctrl.pending_folded_mass(),
                                                 abs=1e-12)
    assert snap["folded_mass_sent"] == pytest.approx(sent_folded, abs=1e-12)


def test_duty_meter_and_ingest_pressure():
    meter = admission.DutyMeter()
    assert meter.value() == 0.0
    meter.note(0.2)
    assert meter.total() == pytest.approx(0.2)
    svc = replay_service.ShardedReplayService(1, 64, mode="transition", seed=0)
    facade = replay_shard.ReplayIngestFifo(svc, TrajectoryQueue(4))
    try:
        assert 0 <= facade.ingest_pressure() <= 1000
    finally:
        facade.close()


def _ingest_over_tcp(client_pkg: str, server_pkg: str, trees, pressure: bool):
    """`trees` from a stamping client of `client_pkg` into a 2-shard
    facade of `server_pkg` -> (ingested priority mass, admission stats,
    the client's admission snapshot)."""
    c_adm, _, _, _, c_transport, _, _ = PKG[client_pkg]
    _, _, s_rs, s_shard, s_transport, s_queue, s_weights = PKG[server_pkg]
    svc = s_rs.ShardedReplayService(2, 4096, mode="transition", scorer="td_proxy", seed=0)
    facade = s_shard.ReplayIngestFifo(svc, s_queue(16))
    server = s_transport.TransportServer(facade, s_weights(), host="127.0.0.1",
                                         port=_free_port()).start()
    try:
        client = c_transport.TransportClient("127.0.0.1", server.port)
        ctrl = c_adm.configure(client, "apex", seed=4)
        assert ctrl is not None
        if pressure:
            ctrl._mu, ctrl._mu_n = 10.0, 1
        for i, tree in enumerate(trees):
            if pressure:
                ctrl._mu = 10.0
            if i % 2:
                assert client.put_trajectories([tree]) == 1
            else:
                assert client.put_trajectory(tree)
        client.close()
        stats = facade.admission_stats()
        mass = sum(s.mass_count()[0] for s in svc.shards)
        return mass, stats, ctrl.snapshot(), ctrl.pending_folded_mass()
    finally:
        server.stop()
        svc.close()


@pytest.mark.parametrize("pressure", [False, True])
def test_stamped_puts_cross_the_wire_both_ways(pressure, gates):
    env = {"DRL_ACTOR_PRIORITY": "1", "DRL_REPLAY_SCORER": "td_proxy"}
    if pressure:
        env.update(DRL_ADMISSION="1", DRL_ADMISSION_PRESSURE="1.0")
    gates(**env)
    rng = np.random.default_rng(12)
    trees = [make_unroll(rng, steps=6, scale=0.05 if pressure else 1.0) for _ in range(30)]
    runs = {pair: _ingest_over_tcp(*pair, trees, pressure)
            for pair in [("jax", "port"), ("port", "jax"), ("port", "port"), ("jax", "jax")]}
    mass, stats, snap, pending = runs[("port", "port")]
    assert stats["scored_blobs"] == 0 and stats["stamped_blobs"] == snap["stamped_puts"] > 0
    for pair, (m, st, sn, pend) in runs.items():
        assert m == mass, pair
        assert st == stats and sn == snap and pend == pending, pair
        # Zero lost mass across the wire: dropped at the actor = folded
        # at the learner + the ledger not yet drained.
        assert sn["dropped_mass"] == pytest.approx(st["folded_mass"] + pend, abs=1e-9)
    if pressure:
        assert snap["dropped_unrolls"] > 0
