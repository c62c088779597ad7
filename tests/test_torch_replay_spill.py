"""The port's spill tier (`data/replay_spill.py`) against the JAX
package's, on the CPU.

- Tier steps driven synchronously (plan -> `run_io` -> commit) in the
  same order in both packages, from the same seed: identical samples,
  and byte-identical segment files and manifests, in transition mode
  and in sequence mode (wire blobs stored as `LazyBlob`s).
- A spill directory written by the JAX `TieredStore` recovers in the
  port's, and the reverse, and both then sample the same items.
- A CRC-poisoned segment is dropped and counted in both.
- Proportional sampling under spill/promote churn passes the JAX
  package's chi-square bar, and a live 2-shard service with the tier
  gathers, routes updates and spills through its router thread.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest

from distributed_reinforcement_learning_tpu.data import replay_service as jax_rs
from distributed_reinforcement_learning_tpu.data import replay_spill as jax_spill
from distributed_reinforcement_learning_tpu_torch.data import codec, replay, replay_service
from distributed_reinforcement_learning_tpu_torch.data import replay_spill as spill

PKGS = {"port": (spill, replay_service), "jax": (jax_spill, jax_rs)}


def drain_tier(store, max_jobs: int = 64) -> int:
    """plan -> run_io -> commit (+ manifest write) on this thread, as
    `ReplayShard.tier_step` does; -> jobs run."""
    ran = 0
    for _ in range(max_jobs):
        job = store.plan_tier_work()
        if job is None:
            break
        job.run_io()
        snap = store.commit_tier_work(job)
        if snap is not None:
            store.write_manifest(snap)
        ran += 1
    return ran


def sample_full(store, n, rng):
    """One batch without forced pads: a pending step runs maintenance and
    retries, so every item is a full-distribution draw."""
    for _ in range(2000):
        out = store.sample_step(n, rng)
        if out is not None:
            return out
        drain_tier(store)
    raise AssertionError("sample never completed")


def make_items(n: int, seed: int = 41):
    rng = np.random.RandomState(seed)
    return [{"tag": np.int64(i), "obs": rng.rand(8, 6).astype(np.float32),
             "act": np.int32(i % 4)} for i in range(n)]


def make_store(pkg: str, directory, capacity=256, seg_items=4, hot_bytes=1500, mode="transition",
               fresh=False):
    mod = PKGS[pkg][0]
    cfg = mod.SpillConfig(directory=str(directory), hot_bytes=hot_bytes, seg_items=seg_items,
                          wait_s=10.0, fresh=fresh)
    return mod.TieredStore(capacity, cfg, mode=mode, seed=0)


def fill(pkg: str, store, n: int, mode: str):
    """n items (sequence mode: every third one a `LazyBlob` of its wire
    blob, the stamped-ingest form) at spread priorities."""
    errors = np.linspace(0.05, 2.0, n)
    lazy = PKGS[pkg][1].LazyBlob
    for i, item in enumerate(make_items(n)):
        if mode == "sequence" and i % 3 == 0:
            item = lazy(codec.encode(item))
        store.add(float(errors[i]), item)
    return errors


def resolve(item):
    return item.materialize() if hasattr(item, "materialize") else item


def assert_items_equal(a, b):
    a, b = resolve(a), resolve(b)
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def assert_dirs_identical(a: Path, b: Path):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    assert "manifest.json" in names and any(n.startswith("seg_") for n in names)
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def lockstep(stores, draws: int, batch: int, seed: int, update_every: int = 5):
    """Sample every store from its own RandomState(seed), drive the tiers
    and write priorities back identically; every step must agree."""
    rngs = [np.random.RandomState(seed) for _ in stores]
    errs = np.random.RandomState(seed + 1)
    for d in range(draws):
        outs = [sample_full(s, batch, r) for s, r in zip(stores, rngs)]
        for out in outs[1:]:
            np.testing.assert_array_equal(out[1], outs[0][1])
            np.testing.assert_array_equal(out[2], outs[0][2])
            for x, y in zip(out[0], outs[0][0]):
                assert_items_equal(x, y)
        for s in stores:
            drain_tier(s, max_jobs=4)
        if d % update_every == 0:
            e = errs.rand(batch) * 3
            for s, out in zip(stores, outs):
                s.update_batch(out[1], e)


@pytest.mark.parametrize("mode", ["transition", "sequence"])
def test_tier_matches_jax(mode, tmp_path):
    mine = make_store("port", tmp_path / "port", mode=mode)
    ref = make_store("jax", tmp_path / "jax", mode=mode)
    for pkg, store in (("port", mine), ("jax", ref)):
        fill(pkg, store, 40, mode)
        while drain_tier(store):
            pass
    assert mine.stats["spilled_segments"] == ref.stats["spilled_segments"] >= 3
    assert_dirs_identical(tmp_path / "port", tmp_path / "jax")
    lockstep([mine, ref], draws=60, batch=8, seed=7)
    for store in (mine, ref):
        while drain_tier(store):
            pass
    assert mine.tier_stats() == ref.tier_stats()
    assert mine.stats["promoted_segments"] > 0 and mine.stats["forced_pads"] == 0
    assert_dirs_identical(tmp_path / "port", tmp_path / "jax")
    snap_m, snap_r = mine.snapshot(), ref.snapshot()
    np.testing.assert_array_equal(snap_m["priorities"], snap_r["priorities"])
    for x, y in zip(snap_m["items"], snap_r["items"]):
        assert_items_equal(x, y)


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("mode", ["transition", "sequence"])
def test_spill_directory_recovers_across_packages(writer, reader, mode, tmp_path):
    """A directory one package spilled recovers in the other: the same
    segments and priorities, and the reader samples what a recovery in
    the writer's own package samples, the original contents."""
    src = make_store(writer, tmp_path / "src", mode=mode)
    fill(writer, src, 40, mode)
    while drain_tier(src):
        pass
    assert src.stats["spilled_segments"] >= 3
    src.close()
    shutil.copytree(tmp_path / "src", tmp_path / "a")
    shutil.copytree(tmp_path / "src", tmp_path / "b")
    got = make_store(reader, tmp_path / "a", mode=mode)
    own = make_store(writer, tmp_path / "b", mode=mode)
    assert got.stats["recovered_segments"] == own.stats["recovered_segments"] > 0
    assert got.stats["crc_dropped"] == 0 and len(got) == len(own)
    assert got.tree.total == own.tree.total
    lockstep([got, own], draws=20, batch=8, seed=11)
    items = make_items(40)
    for item in got.snapshot()["items"]:
        item = resolve(item)
        assert_items_equal(item, items[int(item["tag"])])


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_crc_poisoned_segment_is_dropped_and_counted(pkg, tmp_path):
    store = make_store(pkg, tmp_path, hot_bytes=0)
    fill(pkg, store, 24, "transition")
    while drain_tier(store):
        pass
    cold = [s for s in store._segments.values() if not s.resident]
    assert len(cold) >= 2
    victim = Path(cold[0].file)
    data = bytearray(victim.read_bytes())
    data[-1] ^= 0xFF
    victim.write_bytes(bytes(data))
    before = len(store)
    store._request_promote(cold[0].sid)
    while drain_tier(store):
        pass
    assert store.stats["crc_dropped"] == 1
    assert len(store) == before - cold[0].count
    assert cold[0].sid not in store._segments
    # The rest of the shard still samples, with no forced pad.
    out = sample_full(store, 8, np.random.RandomState(0))
    assert len(out[0]) == 8 and store.stats["forced_pads"] == 0


def test_chi_square_under_spill_churn(tmp_path):
    """Same 32 items, same raw priorities: the monolithic backend and a
    tier small enough that most segments live on disk match the priority
    distribution while segments spill and promote under the draws
    (chi-square, dof = 31, the JAX package's pinned bar)."""
    k, draws, batch = 32, 400, 16
    mono = replay.make_replay(256, backend="python", seed=0)
    store = make_store("port", tmp_path)
    errors = fill("port", store, k, "transition")
    for e, item in zip(errors, make_items(k)):
        mono.add(float(e), item)
    while drain_tier(store):
        pass
    assert store.stats["spilled_segments"] >= 3
    probs = replay.priority_transform(errors) / replay.priority_transform(errors).sum()

    def chi2(counts):
        exp = probs * counts.sum()
        return float(((counts - exp) ** 2 / exp).sum())

    rng_m, rng_t = np.random.RandomState(7), np.random.RandomState(8)
    counts_m, counts_t = np.zeros(k), np.zeros(k)
    for d in range(draws):
        for it in mono.sample(batch, rng_m)[0]:
            counts_m[int(it["tag"])] += 1
        got, idxs, _ = sample_full(store, batch, rng_t)
        for it in got:
            counts_t[int(it["tag"])] += 1
        drain_tier(store, max_jobs=4)
        if d % 25 == 0:
            store.update_batch(idxs, errors[[int(it["tag"]) for it in got]])
    assert store.stats["promoted_segments"] > 0 and store.stats["forced_pads"] == 0
    assert chi2(counts_m) < 61.1, chi2(counts_m)
    assert chi2(counts_t) < 61.1, chi2(counts_t)


def test_service_with_spill_gathers_and_routes(tmp_path):
    """A live 2-shard service over the tier: blobs ingested, segments
    spilled, a gather, routed updates applied, the tier quiesced."""
    from test_torch_replay_service import blobs_of

    cfg = spill.SpillConfig(directory=str(tmp_path), hot_bytes=2000, seg_items=8)
    svc = replay_service.ShardedReplayService(2, 512, mode="transition", scorer="max",
                                              seed=0, spill=cfg)
    try:
        for i, blob in enumerate(blobs_of("transition", 4, 16)):
            assert svc.shards[i % 2].ingest_blob(blob) == 8
            svc.shards[i % 2].tier_step()
        assert svc.flush_tier(timeout=10.0)
        stats = svc.tier_stats()
        assert sum(s["spilled_segments"] for s in stats) >= 2
        batch, idxs, weights = svc.sample(32, np.random.RandomState(0))
        assert len(batch) == 32 and weights.shape == (32,) and weights.max() == 1.0
        svc.update_batch(idxs, np.linspace(0.1, 3.0, 32))
        assert svc.flush_updates(timeout=10.0) and svc.flush_tier(timeout=10.0)
        assert sum(s.stats()["updates_applied"] for s in svc.shards) == 32
        for shard in svc.shards:
            assert (tmp_path / f"shard_{shard.shard_id:03d}" / "manifest.json").exists()
    finally:
        svc.close()


def test_make_replay_routes_spill_to_the_tier(tmp_path):
    cfg = spill.SpillConfig(directory=str(tmp_path))
    store = replay.make_replay(64, spill=cfg, mode="sequence")
    assert type(store) is spill.TieredStore and store.mode == "sequence"
    assert not store.stacked_samples
