"""The port's native data plane (`data/native.py`, `cpp/`) and its replay
backends (`data/replay.py`) against the JAX package's, on the CPU.

- `NativeSumTree`, `NativePrioritizedReplay` and `ArrayPrioritizedReplay`
  against the JAX package's own classes from the same seed: the same
  tree indices, IS weights bit for bit, and the same priorities after
  `update_batch`.
- `snapshot` / `restore`: exact round trips (the whole tree), and
  restores from the JAX package's snapshot forms.
- `NativeByteQueue` / `NativeTrajectoryQueue`: put, get, take,
  `get_batch`, backpressure, close.
- `make_replay`'s switch.
- The library builds from the port's own `cpp/` into the port's
  `cpp/build/`, once under the build lock when two processes ask at
  once, and the port never maps the JAX package's library nor writes
  into its `cpp/build/`.
"""

import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from distributed_reinforcement_learning_tpu.data import native as jax_native
from distributed_reinforcement_learning_tpu.data import replay as jax_replay
from distributed_reinforcement_learning_tpu_torch.data import native, replay
from distributed_reinforcement_learning_tpu_torch.data.fifo import tree_map

REPO = Path(__file__).resolve().parents[1]
PORT_CPP = REPO / "distributed_reinforcement_learning_tpu_torch" / "cpp"
JAX_BUILD = REPO / "distributed_reinforcement_learning_tpu" / "cpp" / "build"


def _batch(n, seed):
    rng = np.random.RandomState(seed)
    return {"obs": rng.randint(0, 256, (n, 3, 2)).astype(np.uint8),
            "r": rng.randn(n).astype(np.float32), "a": rng.randint(0, 4, n).astype(np.int32)}


def test_sum_tree_matches_jax():
    mine, ref = native.NativeSumTree(32), jax_native.NativeSumTree(32)
    rng = np.random.RandomState(0)
    p = rng.rand(40) * 3.0
    np.testing.assert_array_equal(mine.add_batch(p), ref.add_batch(p))
    assert len(mine) == len(ref) == 32 and mine.total == ref.total
    v = rng.rand(64) * mine.total
    for a, b in zip(mine.get_batch(v), ref.get_batch(v)):
        np.testing.assert_array_equal(a, b)
    idx = rng.randint(31, 63, 10)
    mine.update_batch(idx, p[:10])
    ref.update_batch(idx, p[:10])
    assert mine.total == ref.total
    np.testing.assert_array_equal(mine.leaf_priorities(0, 32), ref.leaf_priorities(0, 32))
    assert mine.leaf_priority(40) == ref.leaf_priority(40)


@pytest.mark.parametrize("backend", ["native", "array"])
@pytest.mark.parametrize("capacity, n_add", [(64, 40), (16, 50)])
def test_replay_backends_match_jax(backend, capacity, n_add):
    rng = np.random.RandomState(7)
    errors = (rng.rand(n_add) * 3.0).astype(np.float32)
    cls = {"native": (replay.NativePrioritizedReplay, jax_replay.NativePrioritizedReplay),
           "array": (replay.ArrayPrioritizedReplay, jax_replay.ArrayPrioritizedReplay)}[backend]
    mine, ref = cls[0](capacity, seed=0), cls[1](capacity, seed=0)
    if backend == "array":
        batch = _batch(n_add, seed=1)
        np.testing.assert_array_equal(mine.add_batch_stacked(errors, batch),
                                      ref.add_batch_stacked(errors, batch))
    else:
        items = list(range(n_add))
        assert mine.add_batch(errors, items) == ref.add_batch(errors, items)
    r_mine, r_ref = np.random.RandomState(11), np.random.RandomState(11)
    for _ in range(3):
        got, got_idx, got_w = mine.sample(8, r_mine)
        want, want_idx, want_w = ref.sample(8, r_ref)
        np.testing.assert_array_equal(got_idx, want_idx)
        np.testing.assert_array_equal(got_w, want_w)
        assert got_w.dtype == np.float32 and mine.beta == ref.beta
        if backend == "array":
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got == want
        new_err = r_mine.rand(8) * 2.0
        r_ref.rand(8)
        mine.update_batch(got_idx, new_err)
        ref.update_batch(want_idx, new_err)
        assert mine.tree.total == ref.tree.total
        np.testing.assert_array_equal(mine.tree.leaf_priorities(0, len(mine)),
                                      ref.tree.leaf_priorities(0, len(ref)))
    assert len(mine) == len(ref) == min(capacity, n_add)


def _fill(r, n=40, seed=3):
    rng = np.random.RandomState(seed)
    errors = rng.rand(n) * 2.0
    if getattr(r, "stacked_samples", False):
        r.add_batch_stacked(errors, _batch(n, seed))
    else:
        b = _batch(n, seed)
        r.add_batch(errors, [tree_map(lambda x: x[i], b) for i in range(n)])
    for _ in range(3):
        _, idx, _ = r.sample(8, rng)
        r.update_batch(idx, rng.rand(8))


def _draws(r, seed=5):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(3):
        items, idx, w = r.sample(8, rng)
        out.append((idx.tolist(), w.tobytes()))
    return out


BACKENDS = {"python": replay.PrioritizedReplay, "native": replay.NativePrioritizedReplay,
            "array": replay.ArrayPrioritizedReplay}


@pytest.mark.parametrize("src", sorted(BACKENDS))
@pytest.mark.parametrize("dst", sorted(BACKENDS))
def test_snapshot_restore_is_exact_across_backends(src, dst):
    """A restore of any backend's snapshot into any backend samples as
    the saved replay would: the same indices and IS weights."""
    a = BACKENDS[src](32, seed=0)
    _fill(a)
    snap = a.snapshot()
    b = BACKENDS[dst](32, seed=0)
    b.restore(snap)
    assert len(b) == len(a) and b.beta == a.beta
    assert b.snapshot()["tree"].tobytes() == snap["tree"].tobytes()
    assert _draws(b) == _draws(a)


@pytest.mark.parametrize("form", ["stacked", "items"])
def test_restore_takes_the_jax_snapshot_forms(form):
    """The JAX package's snapshots carry leaf priorities and `stacked` or
    `items`, no tree: the restore rebuilds the tree leaf by leaf."""
    ref = jax_replay.ArrayPrioritizedReplay(64, seed=0)
    rng = np.random.RandomState(4)
    ref.add_batch_stacked(rng.rand(50), _batch(50, seed=4))
    snap = ref.snapshot()
    if form == "items":
        snap = {"priorities": snap["priorities"], "beta": snap["beta"],
                "items": jax_replay._snapshot_items(snap)}
    for cls in BACKENDS.values():
        mine = cls(64, seed=0)
        mine.restore(snap)
        assert len(mine) == 50 and mine.beta == snap["beta"]
        got = mine.snapshot()
        leaves = got["priorities"] if "priorities" in got else got["tree"][63:113]
        np.testing.assert_array_equal(leaves, snap["priorities"])
    twin = jax_replay.ArrayPrioritizedReplay(64, seed=0)
    twin.restore(snap)
    mine = replay.ArrayPrioritizedReplay(64, seed=0)
    mine.restore(snap)
    r1, r2 = np.random.RandomState(9), np.random.RandomState(9)
    got, idx, w = mine.sample(8, r1)
    want, want_idx, want_w = twin.sample(8, r2)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(w, want_w)
    np.testing.assert_array_equal(got["obs"], want["obs"])


def test_array_snapshot_size_is_priced_without_a_copy():
    r = replay.ArrayPrioritizedReplay(100, seed=0)
    assert r.approx_snapshot_nbytes() == 0
    r.add_batch_stacked(np.ones(10), _batch(10, seed=0))
    per_item = 3 * 2 + 4 + 4
    assert r.approx_snapshot_nbytes() == 10 * per_item + 10 * 8 + 199 * 8


def test_byte_queue_put_get_and_backpressure():
    q = native.NativeByteQueue(2)
    assert q.put(b"abc") and q.put(b"de")
    assert not q.put(b"f", timeout=0.05)  # full
    assert len(q) == q.size() == 2
    assert q.get() == b"abc"
    assert q.get_batch_blobs(1, 8)[0].tobytes() == b"de"
    assert q.get(timeout=0.05) is None
    q.close()
    assert q.closed
    with pytest.raises(RuntimeError, match="closed"):
        q.put(b"x")


def test_trajectory_queue_put_get_take_and_get_batch():
    q = native.NativeTrajectoryQueue(8)
    items = [tree_map(lambda x: x[i], _batch(6, seed=2)) for i in range(6)]
    assert q.put(items[0]) and q.put_many(items[1:]) == 5
    got = q.get(timeout=1.0)
    for k in items[0]:
        np.testing.assert_array_equal(got[k], items[0][k])
    taken = q.take(2, timeout=1.0)
    assert [t["r"] for t in taken] == [items[1]["r"], items[2]["r"]]
    batch = q.get_batch(3, timeout=1.0)
    want = _batch(6, seed=2)
    for k in want:
        np.testing.assert_array_equal(batch[k], want[k][3:6])
    assert q.take(1, timeout=0.05) is None and q.get_batch(1, timeout=0.05) is None


def test_trajectory_queue_blocks_producers_until_the_learner_drains():
    q = native.NativeTrajectoryQueue(2)
    item = {"x": np.arange(4, dtype=np.float32)}
    assert q.put(item) and q.put(item)
    done = threading.Event()

    def producer():
        q.put(item)
        done.set()

    t = threading.Thread(target=producer)
    t.start()
    assert not done.wait(0.2)
    assert q.get(timeout=1.0) is not None
    assert done.wait(5.0)
    t.join(timeout=5.0)
    assert not t.is_alive() and q.size() == 2


def test_make_replay_switch(monkeypatch):
    assert type(replay.make_replay(8, backend="python")) is replay.PrioritizedReplay
    assert type(replay.make_replay(8, backend="native")) is replay.NativePrioritizedReplay
    assert type(replay.make_replay(8, backend="array")) is replay.ArrayPrioritizedReplay
    assert type(replay.make_replay(8)) is replay.ArrayPrioritizedReplay
    with pytest.raises(ValueError, match="item 9"):
        replay.make_replay(8, spill=object())
    with pytest.raises(ValueError, match="unknown replay backend"):
        replay.make_replay(8, backend="disk")
    monkeypatch.setattr(native, "native_available", lambda: False)
    assert type(replay.make_replay(8)) is replay.PrioritizedReplay
    with pytest.raises(RuntimeError, match="native library"):
        replay.make_replay(8, backend="array")


_BUILDER = """
import sys
from pathlib import Path
from distributed_reinforcement_learning_tpu_torch.data import native
native.BUILD_DIR = Path(sys.argv[1])
lib = native.build()
print(native.native_available(), native.loaded_path() == lib, lib.parent == native.BUILD_DIR)
"""

_FAKE_CXX = """#!/bin/sh
echo call >> {calls}
sleep 0.5
exec g++ "$@"
"""


def _wait(proc, timeout=120):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate(timeout=10)
        raise
    assert proc.returncode == 0, err[-2000:]
    return out


def test_library_builds_from_the_port_sources_once_under_the_lock(tmp_path):
    """Two processes ask for the library at once: one compiler call, from
    the port's `cpp/` sources, into the build directory; nothing of the
    port's is written into the JAX package's `cpp/build/` (whose own
    tests may build there meanwhile)."""
    calls = tmp_path / "calls"
    cxx = tmp_path / "cxx"
    cxx.write_text(_FAKE_CXX.format(calls=calls))
    cxx.chmod(0o755)
    build = tmp_path / "build"
    env = dict(os.environ, CXX=str(cxx))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, str(build)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              start_new_session=True) for _ in range(2)]
    outs = [_wait(p) for p in procs]
    assert [o.split() for o in outs] == [["True", "True", "True"]] * 2
    assert calls.read_text().split() == ["call"]
    libs = sorted(p.name for p in build.glob("*.so"))
    assert libs == [native.library_path().name]
    assert native.CPP_DIR == PORT_CPP
    assert sorted(p.name for p in PORT_CPP.glob("*.cc")) == sorted(native.SOURCES)
    assert native.BUILD_DIR == PORT_CPP / "build"
    assert not list(JAX_BUILD.glob("libdistrl_native-*"))


_MAPS = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "distributed_reinforcement_learning_tpu") or name.startswith(
                ("jax.", "distributed_reinforcement_learning_tpu.")):
            raise ImportError("blocked import: " + name)
sys.meta_path.insert(0, Block())
from distributed_reinforcement_learning_tpu_torch.data import native
from distributed_reinforcement_learning_tpu_torch.runtime.transport import _make_queue
q = _make_queue(4)
print(type(q).__name__)
for line in open("/proc/self/maps"):
    if "libdistrl_native" in line:
        print(line.split()[-1])
"""


def test_the_port_maps_only_its_own_library():
    out = subprocess.run([sys.executable, "-c", _MAPS], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.split()
    assert lines[0] == "NativeTrajectoryQueue"
    assert lines[1:] and all(Path(p).parent == PORT_CPP / "build" for p in lines[1:])
