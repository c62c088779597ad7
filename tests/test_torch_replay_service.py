"""The port's sharded replay service (`data/replay_service.py`,
`runtime/replay_shard.py`) against the JAX package's, on the CPU.

- Index arithmetic (`pack_index`, `allocate_proportional`, the merged IS
  weights) identical to the JAX functions over random and extreme inputs.
- The same blobs (the port's codec gives the JAX codec's bytes) into the
  same shards in the same order: from one `RandomState` seed both
  services return identical packed indices, stored contents and IS
  weights, in transition and in sequence mode, through routed priority
  updates; after a restart a stale-epoch update is dropped in both.
- A chi-square test of the sharded sample against the monolithic
  sampler, as the JAX package's own test.
- The gate constants are the JAX package's committed verdicts.
- F6: with no `DRL_REPLAY_*` set, the port's `run_role` learner builds
  the service the JAX package's `build_service` builds (2 shards, spill
  tier on), for `apex` and `r2d2`.
- The ingest facade: poison blobs, shard death, demotion to the
  monolithic queue and revival.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from distributed_reinforcement_learning_tpu.agents.apex import ApexBatch as JaxApexBatch
from distributed_reinforcement_learning_tpu.agents.r2d2 import R2D2Batch as JaxR2D2Batch
from distributed_reinforcement_learning_tpu.data import codec as jax_codec
from distributed_reinforcement_learning_tpu.data import replay as jax_replay
from distributed_reinforcement_learning_tpu.data import replay_service as jax_rs
from distributed_reinforcement_learning_tpu.runtime import replay_shard as jax_shard
from distributed_reinforcement_learning_tpu.utils.config import load_config as jax_load_config
from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexBatch
from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Batch
from distributed_reinforcement_learning_tpu_torch.data import codec, replay, replay_service
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
from distributed_reinforcement_learning_tpu_torch.runtime import replay_shard

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "config.json"


def apex_unrolls(cls, seed: int, count: int, steps: int = 8):
    rng = np.random.RandomState(seed)
    return [cls(state=rng.rand(steps, 4).astype(np.float32),
                next_state=rng.rand(steps, 4).astype(np.float32),
                previous_action=rng.randint(0, 2, steps).astype(np.int32),
                action=rng.randint(0, 2, steps).astype(np.int32),
                reward=rng.randn(steps).astype(np.float32),
                done=rng.rand(steps) < 0.1) for _ in range(count)]


def r2d2_sequences(cls, seed: int, count: int, t: int = 6, h: int = 4):
    rng = np.random.RandomState(seed)
    return [cls(state=rng.randint(0, 255, (t, 2)).astype(np.int32),
                previous_action=rng.randint(0, 2, t).astype(np.int32),
                action=rng.randint(0, 2, t).astype(np.int32),
                reward=rng.randn(t).astype(np.float32),
                done=rng.rand(t) < 0.2,
                initial_h=rng.randn(h).astype(np.float32),
                initial_c=rng.randn(h).astype(np.float32)) for _ in range(count)]


def blobs_of(mode: str, seed: int, count: int, **shape) -> list[bytes]:
    """Codec blobs from the port, checked byte-identical to the JAX codec's."""
    if mode == "transition":
        mine = apex_unrolls(ApexBatch, seed, count, **shape)
        ref = apex_unrolls(JaxApexBatch, seed, count, **shape)
    else:
        mine = r2d2_sequences(R2D2Batch, seed, count, **shape)
        ref = r2d2_sequences(JaxR2D2Batch, seed, count, **shape)
    out = [bytes(codec.encode(x)) for x in mine]
    assert out == [bytes(jax_codec.encode(x)) for x in ref]
    return out


def assert_batches_equal(a, b):
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_batches_equal(x, y)
        return
    assert type(a).__name__ == type(b).__name__ and a._fields == b._fields
    for x, y in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, y)


# -- index arithmetic ---------------------------------------------------------

def test_pack_index_matches_jax():
    rng = np.random.RandomState(0)
    shard = rng.randint(0, 256, 500)
    epoch = rng.randint(0, 1 << 10, 500)  # wraps past the 8 epoch bits
    idx = np.concatenate([rng.randint(0, 1 << 46, 497, dtype=np.int64),
                          [0, (1 << 46) - 1, 1 << 46]])
    for s, e in [(shard[0], epoch[0]), (255, 255), (0, 0), (17, 256)]:
        mine = replay_service.pack_index(int(s), int(e), idx)
        np.testing.assert_array_equal(mine, jax_rs.pack_index(int(s), int(e), idx))
        for a, b in zip(replay_service.unpack_index(mine), jax_rs.unpack_index(mine)):
            np.testing.assert_array_equal(a, b)
    mixed = np.concatenate([replay_service.pack_index(3, 1, idx[:5]), idx[:5]])
    np.testing.assert_array_equal(replay_service.is_packed_index(mixed),
                                  jax_rs.is_packed_index(mixed))
    assert replay_service.MAX_SHARDS == jax_rs.MAX_SHARDS


@pytest.mark.parametrize("n, masses", [
    (32, np.random.RandomState(1).rand(7)),
    (1, np.random.RandomState(2).rand(3)),
    (1000, np.array([1e-12, 1.0, 1e12, 0.0])),
    (5, np.zeros(4)),
    (0, np.ones(3)),
    (17, np.array([0.0, 0.0, 3.0])),
    (64, np.array([1.0, 1.0, 1.0])),
])
def test_allocate_proportional_matches_jax(n, masses):
    mine = replay_service.allocate_proportional(n, masses)
    np.testing.assert_array_equal(mine, jax_rs.allocate_proportional(n, masses))
    assert mine.sum() == (n if masses.sum() > 0 and n > 0 else 0)


def test_is_weights_match_jax():
    rng = np.random.RandomState(3)
    for _ in range(20):
        prios = rng.rand(64) * 10 ** rng.uniform(-6, 6) + 1e-9
        total, count, beta = float(prios.sum() * rng.uniform(1, 50)), int(rng.randint(64, 10 ** 6)), rng.rand()
        mine = replay_service.merge_is_weights(prios, total, count, beta)
        np.testing.assert_array_equal(mine, jax_rs.merge_is_weights(prios, total, count, beta))
        np.testing.assert_array_equal(mine, replay._is_weights(prios, total, count, beta))
        np.testing.assert_array_equal(mine, jax_replay._is_weights(prios, total, count, beta))


# -- the service against the JAX package's -----------------------------------

@pytest.mark.parametrize("mode, scorer, shards", [
    ("transition", "max", 2), ("transition", "td_proxy", 3), ("sequence", "max", 2),
    ("sequence", "td_proxy", 2)])
def test_service_matches_jax(mode, scorer, shards):
    """Same blobs into the same shards in the same order, same seed: the
    same packed indices, contents and IS weights, through routed
    priority updates."""
    mine = replay_service.ShardedReplayService(shards, 300, mode=mode, scorer=scorer, seed=0)
    ref = jax_rs.ShardedReplayService(shards, 300, mode=mode, scorer=scorer, seed=0)
    try:
        for i, blob in enumerate(blobs_of(mode, 0, 40)):
            assert (mine.shards[i % shards].ingest_blob(blob)
                    == ref.shards[i % shards].ingest_blob(blob))
        assert len(mine) == len(ref) and mine.ingested_blobs() == ref.ingested_blobs() == 40
        assert mine.stacked_samples == ref.stacked_samples
        rng_m, rng_r, errs = (np.random.RandomState(5), np.random.RandomState(5),
                              np.random.RandomState(6))
        for _ in range(6):
            got, want = mine.sample(16, rng_m), ref.sample(16, rng_r)
            np.testing.assert_array_equal(got[1], want[1])
            assert got[2].dtype == want[2].dtype == np.float32
            np.testing.assert_array_equal(got[2], want[2])
            assert_batches_equal(got[0], want[0])
            e = errs.rand(16) * 4
            mine.update_batch(got[1], e)
            ref.update_batch(want[1], e)
            assert mine.flush_updates() and ref.flush_updates()
        assert mine.beta == ref.beta
        for a, b in zip(mine.shard_stats(), ref.shard_stats()):
            assert a == b
    finally:
        mine.close()
        ref.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_stale_epoch_update_dropped_after_restart(pkg):
    rs = replay_service if pkg == "port" else jax_rs
    shard = rs.ReplayShard(0, 64, mode="sequence", scorer=None, backend="auto")
    shard.ingest_blob(blobs_of("sequence", 1, 1)[0])
    idx = shard.backend.tree.capacity - 1
    assert shard.update(np.array([idx]), np.array([2.0]), epoch=0) == 1
    shard.restart()
    assert shard.update(np.array([idx]), np.array([9.0]), epoch=0) == 0
    assert shard.stats()["epoch"] == 1 and shard.stats()["count"] == 0


def test_chi_square_against_monolithic():
    """Same 32 items, same raw priorities, the monolithic backend and a
    4-shard service: both samplers' item frequencies match the priority
    distribution (chi-square, dof = 31, at the JAX package's pinned bar)."""
    k, draws, batch = 32, 400, 16
    errors = np.linspace(0.05, 2.0, k)
    items = [{"tag": np.int64(i), "reward": np.float32(0.0), "done": np.bool_(False)}
             for i in range(k)]
    mono = replay.make_replay(256, backend="python", seed=0)
    svc = replay_service.ShardedReplayService(4, 256, mode="sequence", scorer="max",
                                              backend="python", seed=0)
    try:
        for i, (e, item) in enumerate(zip(errors, items)):
            mono.add(float(e), item)
            svc.shards[i % 4].backend.add(float(e), item)
        prios = np.array([mono._priority(e) for e in errors])
        probs = prios / prios.sum()

        def chi2(counts):
            exp = probs * counts.sum()
            return float(((counts - exp) ** 2 / exp).sum())

        rng_m, rng_s = np.random.RandomState(7), np.random.RandomState(8)
        counts_m, counts_s = np.zeros(k), np.zeros(k)
        for _ in range(draws):
            for it in mono.sample(batch, rng_m)[0]:
                counts_m[int(it["tag"])] += 1
            for it in svc.sample(batch, rng_s)[0]:
                counts_s[int(it["tag"])] += 1
        assert chi2(counts_m) < 61.1, chi2(counts_m)  # chi2(0.999, dof=31) ~= 61.1
        assert chi2(counts_s) < 61.1, chi2(counts_s)
    finally:
        svc.close()


# -- gates --------------------------------------------------------------------

def test_gate_constants_are_the_committed_verdicts():
    shards = json.loads((REPO / "benchmarks" / "replay_verdict.json").read_text())
    spill = json.loads((REPO / "benchmarks" / "replay_spill_verdict.json").read_text())
    assert replay_shard.DEFAULT_SHARDS == (shards.get("shards", 2) if shards["auto_enable"] else 0)
    assert replay_shard.DEFAULT_SPILL == bool(spill["auto_enable"])
    assert replay_shard._ALGO_MODE == jax_shard._ALGO_MODE


@pytest.mark.parametrize("env, shards, spill", [
    ({}, 2, True), ({"DRL_REPLAY_SHARDS": "0"}, 0, True), ({"DRL_REPLAY_SHARDS": "3"}, 3, True),
    ({"DRL_REPLAY_SPILL": "0"}, 2, False), ({"DRL_REPLAY_SPILL": "1"}, 2, True)])
def test_gates_resolve_as_jax(env, shards, spill, monkeypatch):
    for k in ("DRL_REPLAY_SHARDS", "DRL_REPLAY_SPILL"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert replay_shard.shard_count() == jax_shard.shard_count() == shards
    assert replay_shard.spill_auto_enabled() == jax_shard.spill_auto_enabled() == spill


def test_spill_config_resolves_as_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("DRL_REPLAY_SPILL_DIR", str(tmp_path))
    monkeypatch.setenv("DRL_REPLAY_SPILL_HOT_MB", "1.5")
    monkeypatch.setenv("DRL_REPLAY_SPILL_SEG", "7")
    mine, ref = replay_shard.spill_config(), jax_shard.spill_config()
    assert (mine.directory, mine.hot_bytes, mine.seg_items, mine.wait_s, mine.queue_cap,
            mine.max_inflight, mine.fresh) == (ref.directory, ref.hot_bytes, ref.seg_items,
                                               ref.wait_s, ref.queue_cap, ref.max_inflight,
                                               ref.fresh)


# -- F6: the run_role learner's replay ----------------------------------------

class _Built(Exception):
    pass


@pytest.mark.parametrize("algo, section", [("apex", "apex"), ("r2d2", "r2d2")])
def test_run_role_learner_builds_the_jax_default_service(algo, section, monkeypatch, tmp_path):
    """F6: with no DRL_REPLAY_* set, the port's `run_role` learner hands
    its learner the service the JAX package's `build_service` builds."""
    import tempfile

    from distributed_reinforcement_learning_tpu_torch.runtime import launch
    from distributed_reinforcement_learning_tpu_torch.runtime.transport import run_role

    for k in ("DRL_REPLAY_SHARDS", "DRL_REPLAY_SCORER", "DRL_REPLAY_SPILL",
              "DRL_REPLAY_SPILL_DIR", "DRL_REPLAY_SPILL_HOT_MB", "DRL_REPLAY_SPILL_SEG"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    seen = {}

    def fake_make_learner(*args, **kw):
        seen.update(kw)
        raise _Built

    monkeypatch.setattr(launch, "make_learner", fake_make_learner)
    with pytest.raises(_Built):
        run_role(algo, str(CONFIG), section, "learner", 0, device="cpu")
    mine = seen.get("replay_service")
    ref = jax_shard.build_service(algo, jax_load_config(str(CONFIG), section)[1])
    try:
        assert ref is not None and mine is not None
        assert len(mine.shards) == len(ref.shards) == 2
        assert mine.scorer_name == ref.scorer_name == "max"
        assert mine.mode == ref.mode == {"apex": "transition", "r2d2": "sequence"}[algo]
        assert [s.capacity for s in mine.shards] == [s.capacity for s in ref.shards]
        assert mine.tier_stats() is not None and ref.tier_stats() is not None
        for a, b in zip(mine.shards, ref.shards):
            ca, cb = a._spill, b._spill
            assert (ca.hot_bytes, ca.seg_items, ca.wait_s, ca.queue_cap, ca.max_inflight) == \
                (cb.hot_bytes, cb.seg_items, cb.wait_s, cb.queue_cap, cb.max_inflight)
            assert type(a.backend).__name__ == type(b.backend).__name__ == "TieredStore"
    finally:
        for svc in (mine, ref):
            if svc is not None:
                svc.close()


# -- the ingest facade --------------------------------------------------------

def _facade(shards: int = 2, mode: str = "transition"):
    svc = replay_service.ShardedReplayService(shards, 512, mode=mode, scorer="max", seed=0)
    queue = TrajectoryQueue(64)
    return svc, queue, replay_shard.ReplayIngestFifo(svc, queue)


def test_facade_poison_blob_is_dropped_without_killing_shards():
    svc, queue, facade = _facade()
    try:
        assert facade.ingest_blob(b"\x00" * 64)
        assert all(not s.stats()["dead"] for s in svc.shards)
        blob = blobs_of("transition", 2, 1)[0]
        assert facade.ingest_blob(blob) and len(svc) == 8 and facade.size() == 0
    finally:
        facade.close()


def test_facade_demotes_when_every_shard_dies_and_revives():
    svc, queue, facade = _facade()
    try:
        blobs = blobs_of("transition", 3, 4)
        assert facade.ingest_blob(blobs[0])
        for shard in svc.shards:
            svc.note_shard_death(shard)
        assert not svc.healthy
        assert facade.ingest_blob(blobs[1])
        assert facade.demoted and facade.size() == 1 and len(queue) == 1
        item = queue.get(timeout=1.0)
        assert_batches_equal(item, codec.decode(blobs[1], copy=True))
        facade.reattach()
        assert svc.healthy and not facade.demoted
        assert facade.ingest_blob(blobs[2]) and len(svc) == 8
        assert [s.stats()["epoch"] for s in svc.shards] == [1, 1]
    finally:
        facade.close()
