"""Sharded weight publication in the port against the JAX package's.

The byte layer first: `data/bf16.py` rounds bit for bit as the JAX
module on every float32 class (NaN payloads of both signs, +-inf,
subnormals, +-0, ties); int8 and bf16 `quantize_leaves`, `delta_encode`
(with its bail and wrong-base cases), manifests and shard blobs equal
the JAX module's bytes on the same tree and the same plan, in float32,
bfloat16 and int8. The rule matcher given the JAX rule list (copied here
as data) and a flax-named tree gives the JAX plan; the port's own rules
give every parameter of every family (through `models/convert.py`'s name
map, at the config sections' widths, `xformer_moe` and the stacked
layout included) the shard key JAX gives its counterpart.

Then the plane, mirroring tests/test_weight_sharding.py without its
two-process drill (chip_smoke phase 41 runs one): `materialize` equals
the whole-blob decode; the store's lazy whole blob, unchanged-shard
elision, deltas, rollback and float32 in-process snapshot under a quant
mode; the shard-scoped TCP op (role-scoped pulls, a pinned int8 shard
keeping its own scales, demotion against an unsharded store); the
segmented board (changed shards only, a mid-pull flip, the oversize
latch and its TCP fill, the whole-board failures). Across the packages:
a JAX `ShardedRemoteWeights` pulls from a port server the arrays a port
client gets, and each package's board reader reads the other's
segmented board.
"""

import dataclasses
import json
import os
import socket
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.data import bf16 as jax_bf16
from distributed_reinforcement_learning_tpu.data import codec as jax_codec
from distributed_reinforcement_learning_tpu.data.fifo import TrajectoryQueue as JaxQueue
from distributed_reinforcement_learning_tpu.parallel import partition as jax_partition
from distributed_reinforcement_learning_tpu.runtime import launch as jax_launch
from distributed_reinforcement_learning_tpu.runtime import transport as jax_transport
from distributed_reinforcement_learning_tpu.runtime import weight_board as jax_board
from distributed_reinforcement_learning_tpu.runtime import weight_shards as jax_ws
from distributed_reinforcement_learning_tpu.runtime.weights import WeightStore as JaxStore
from distributed_reinforcement_learning_tpu.utils.config import load_config as jax_load_config
from distributed_reinforcement_learning_tpu_torch.data import bf16, codec
from distributed_reinforcement_learning_tpu_torch.data.fifo import TrajectoryQueue
from distributed_reinforcement_learning_tpu_torch.models import convert
from distributed_reinforcement_learning_tpu_torch.parallel import partition
from distributed_reinforcement_learning_tpu_torch.runtime import weight_board, weight_shards
from distributed_reinforcement_learning_tpu_torch.runtime.transport import (
    RemoteWeights, ShardedRemoteWeights, TransportClient, TransportServer)
from distributed_reinforcement_learning_tpu_torch.runtime.weight_board import (
    BoardClosed, BoardWeights, ShardedWeightBoard, WeightBoard, attach_any)
from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "config.json"


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


@pytest.fixture
def fresh_gates(monkeypatch):
    """All the gates unset, resolved afresh in both packages, and the
    cached flags restored afterwards."""
    for key in ("DRL_WEIGHTS_SHARDED", "DRL_WEIGHTS_QUANT", "DRL_WEIGHTS_DELTA",
                "DRL_WEIGHTS_KEYS"):
        monkeypatch.delenv(key, raising=False)
    weight_shards.refresh_flags()
    jax_ws.refresh_flags()
    yield monkeypatch
    weight_shards.refresh_flags()
    jax_ws.refresh_flags()


# -- trees in the port's layout: a flat {name: array} dict ---------------------


def _xformer(seed: int, d: int = 64, layers: int = 3) -> dict[str, np.ndarray]:
    """Stacked transformer names: a `pipe` shard, a `-,model` head and
    replicated LayerNorm rows, biases and an int leaf."""
    rng = np.random.RandomState(seed)
    return {
        "blocks_stacked.qkv_kernel": rng.standard_normal((layers, d, 3 * d)).astype(np.float32),
        "blocks_stacked.proj_kernel": rng.standard_normal((layers, d, d)).astype(np.float32),
        "blocks_stacked.ln1_scale": np.ones((layers, d), np.float32),
        "head.weight": rng.standard_normal((128, d)).astype(np.float32),
        "head.bias": np.zeros(128, np.float32),
        "step": np.array(seed, np.int64),
    }


def _moe(seed: int, e: int = 8, d: int = 32) -> dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    return {
        "blocks.0.moe.moe_gate": rng.standard_normal((d, e)).astype(np.float32),
        "blocks.0.moe.moe_w1": rng.standard_normal((e, d, 4 * d)).astype(np.float32),
        "blocks.0.moe.moe_b1": rng.standard_normal((e, 4 * d)).astype(np.float32),
        "blocks.0.moe.moe_w2": rng.standard_normal((e, 4 * d, d)).astype(np.float32),
        "head.weight": rng.standard_normal((256, d)).astype(np.float32),
    }


def _small(seed: int) -> dict[str, np.ndarray]:
    """Every leaf under the partition size: one replicated shard."""
    rng = np.random.RandomState(seed)
    return {"torso.conv0.weight": rng.standard_normal((8, 4, 3, 3)).astype(np.float32),
            "torso.conv0.bias": rng.standard_normal(8).astype(np.float32),
            "head.weight": rng.standard_normal((6, 32)).astype(np.float32)}


def _oversize(seed: int) -> dict[str, np.ndarray]:
    """A `-,model` shard too big for a 256 KiB arena beside small ones."""
    rng = np.random.RandomState(seed)
    return {"huge.weight": rng.standard_normal((512, 256)).astype(np.float32),
            "blocks_stacked.qkv_kernel": rng.standard_normal((2, 32, 96)).astype(np.float32),
            "step": np.array(1, np.int64)}


def _tensors(tree: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _host(params: dict) -> dict[str, np.ndarray]:
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in params.items()}


def _whole(tree: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    return codec.decode(codec.encode(tree))


def assert_bit_identical(a: dict, b: dict) -> None:
    a, b = _host(a), _host(b)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def _blobs(shards) -> dict[str, np.ndarray]:
    return {k: np.frombuffer(bytes(p), np.uint8) for k, _, _, p in shards}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sboard(tag: str, arena: int = 1 << 22, **kw) -> ShardedWeightBoard:
    return ShardedWeightBoard.create(f"drltest-tws-{tag}-{os.getpid()}", arena, **kw)


# -- the byte layer against the JAX package -----------------------------------


def _special_floats() -> np.ndarray:
    rng = np.random.RandomState(0)
    bits = rng.randint(0, 2**32, 1 << 18, dtype=np.uint64).astype(np.uint32)
    crafted = np.array([
        0x00000000, 0x80000000,  # +-0
        0x7F800000, 0xFF800000,  # +-inf
        0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FFFFFFF, 0xFFFFFFFF,  # NaNs
        0x00000001, 0x807FFFFF, 0x00008000, 0x00018000,  # subnormals, ties
        0x3F808000, 0x3F818000, 0x3F80FFFF, 0x7F7FFFFF, 0xFF7FFFFF,  # ties, max
        0x7F7F8000, 0x33800000, 0x00800000,
    ], np.uint32)
    return np.concatenate([crafted, bits]).view(np.float32)


def test_bf16_rounds_bit_for_bit_as_jax():
    x = _special_floats()
    got, want = bf16.f32_to_bf16_u16(x), jax_bf16.f32_to_bf16_u16(x)
    assert got.dtype == np.uint16 and got.tobytes() == want.tobytes()
    # ... and on a 2-d leaf, and every bfloat16 pattern back to float32.
    x2 = x[: 64 * 128].reshape(64, 128)
    assert bf16.f32_to_bf16_u16(x2).tobytes() == jax_bf16.f32_to_bf16_u16(x2).tobytes()
    every = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    assert bf16.bf16_u16_to_f32(every).tobytes() == jax_bf16.bf16_u16_to_f32(every).tobytes()


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_quantize_leaves_bytes_match_jax(mode):
    rng = np.random.RandomState(1)
    leaves = [(rng.standard_normal((64, 64)) * 3).astype(np.float32),
              np.zeros((16,), np.float32), np.arange(5, dtype=np.int32),
              _special_floats()[22:4096] if mode == "bf16" else np.float32([1.5, -2.0])]
    got, gmeta = weight_shards.quantize_leaves(leaves, mode)
    want, wmeta = jax_ws.quantize_leaves(leaves, mode)
    assert gmeta == wmeta
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for a, b in zip(weight_shards.dequantize_leaves(got, gmeta),
                    jax_ws.dequantize_leaves(want, wmeta)):
        assert a.tobytes() == b.tobytes()


def test_delta_bytes_match_jax_with_bail_and_wrong_base():
    rng = np.random.RandomState(2)
    base = rng.randint(0, 256, 1 << 16).astype(np.uint8)
    sparse = base.copy()
    for off in (0, 777, 40_000, base.size - 3):
        sparse[off:off + 3] ^= 0xA5
    dense = (base + 1).astype(np.uint8)
    for new in (sparse, base.copy(), dense, base[:-1]):
        got, want = weight_shards.delta_encode(new, base), jax_ws.delta_encode(new, base)
        assert got == want
    d = weight_shards.delta_encode(sparse, base)
    assert d is not None and len(d) < 200
    assert weight_shards.delta_apply(base, d).tobytes() == sparse.tobytes()
    assert len(weight_shards.delta_encode(base.copy(), base)) == 8  # identity: header only
    assert weight_shards.delta_encode(dense, base) is None  # bails
    with pytest.raises(ValueError, match="delta base"):
        weight_shards.delta_apply(base[:-1], d)
    with pytest.raises(ValueError, match="delta base"):
        jax_ws.delta_apply(base[:-1], d)


@pytest.mark.parametrize("quant", [None, "bf16", "int8"])
@pytest.mark.parametrize("make", [_xformer, _moe])
def test_bundle_bytes_match_jax(make, quant):
    """Manifest and shard blobs byte for byte the JAX module's, on the
    same tree and the same plan."""
    tree = make(3)
    plan = partition.shard_plan(tree)
    mine = weight_shards.build_bundle(tree, plan=plan, quant=quant)
    ref = jax_ws.build_bundle(tree, plan=plan, quant=quant)
    assert list(mine.blobs) == list(ref.blobs)
    for k in mine.blobs:
        assert np.asarray(mine.blobs[k]).tobytes() == np.asarray(ref.blobs[k]).tobytes()
    assert mine.nbytes_f32 == ref.nbytes_f32
    m = weight_shards.manifest_bytes(dict(mine.manifest, version=5))
    assert m == jax_ws.manifest_bytes(dict(ref.manifest, version=5))
    # Each package materializes the other's bundle to the same arrays.
    a = weight_shards.materialize(jax_ws.parse_manifest(m), ref.blobs)
    b = jax_ws.materialize(weight_shards.parse_manifest(m), mine.blobs)
    assert_bit_identical(a, b)


# -- the rule matcher and the port's rules ------------------------------------


def _jax_rules_as_data():
    """The JAX package's `default_partition_rules`, with each
    PartitionSpec written as the port's tuple."""
    return tuple((rule, tuple(spec)) for rule, spec in jax_partition.default_partition_rules())


def _flax_tree(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {"params": {
        "blocks_stacked": {"qkv_kernel": rng.standard_normal((2, 64, 192)).astype(np.float32),
                           "ln1_scale": np.ones((2, 64), np.float32)},
        "SelfAttentionBlock_0": {"moe": {
            "moe_w1": rng.standard_normal((4, 64, 256)).astype(np.float32),
            "moe_gate": rng.standard_normal((64, 128)).astype(np.float32)}},
        "head": {"w": rng.standard_normal((64, 128)).astype(np.float32),
                 "kernel": rng.standard_normal((64, 64)).astype(np.float32),
                 "bias": np.zeros(128, np.float32)},
        "torso": {"conv0_kernel": rng.standard_normal((8, 8, 4, 32)).astype(np.float32)},
        "embed_tokens": rng.standard_normal((128, 64)).astype(np.float32),
    }, "step": np.int64(seed)}


def test_matcher_with_the_jax_rules_gives_the_jax_plan():
    tree = _flax_tree(4)
    mine = partition.shard_plan(tree, rules=_jax_rules_as_data())
    ref = jax_partition.shard_plan(tree)
    assert mine.shards == ref.shards and mine.paths == ref.paths
    assert mine.specs == [tuple(s) for s in ref.specs]
    specs = partition.match_partition_rules(_jax_rules_as_data(), tree)
    assert specs["params"]["head"]["w"] == (None, "model") and specs["step"] == ()
    assert json.dumps(mine.skel) == json.dumps(ref.skel)


def test_matcher_edge_cases():
    greedy = ((r".*", ("data",)),)
    specs = partition.match_partition_rules(greedy, {"s": np.float32(1.0),
                                                     "one": np.ones(1, np.float32)})
    assert specs == {"s": (), "one": ()}  # scalars and size-1 leaves replicate
    with pytest.raises(ValueError, match="rule not found"):
        partition.match_partition_rules(((r"never", ()),), {"big": np.zeros((128, 128))})
    assert [partition.spec_key(s) for s in [(), (None,), (None, "model"), ("expert",)]] == \
        ["rep", "rep", "-,model", "expert"]
    plan = partition.shard_plan(_moe(2))
    assert sorted(i for idxs in plan.shards.values() for i in idxs) == list(range(len(plan.paths)))
    assert list(partition.shard_plan(_small(1)).shards) == ["rep"]
    by_path = dict(zip(plan.paths, plan.specs))
    assert by_path["blocks/0/moe/moe_w1"] == ("expert",)
    assert by_path["blocks/0/moe/moe_gate"] == ()  # under the partition size
    assert by_path["head/weight"] == (None, "model")


_CONVERT = {
    "impala": convert.impala_params_from_jax, "apex": convert.apex_params_from_jax,
    "r2d2": convert.r2d2_params_from_jax,
    "xformer": lambda t: convert.transformer_params_from_jax(t, head="dueling_q"),
    "ximpala": lambda t: convert.transformer_params_from_jax(t, head="actor_critic"),
}


@pytest.mark.parametrize("section,stacked", [
    ("impala", False), ("impala_resnet", False), ("r2d2", False), ("r2d2_pixel", False),
    ("apex", False), ("xformer", False), ("xformer_moe", False), ("xformer", True),
    ("ximpala", False)])
def test_port_shard_keys_equal_jax_for_each_family(section, stacked):
    """Every parameter lands in the shard JAX gives its counterpart. The
    JAX parameters are shapes only (`jax.eval_shape`), each leaf filled
    with its own index so that the converted name tells its source."""
    cfg, rt = jax_load_config(str(CONFIG), section)
    if stacked:
        cfg = dataclasses.replace(cfg, stacked=True)
    algo = jax_launch._algo_of(cfg)
    agent = jax_launch.make_agent(algo, cfg, rt)
    shapes = jax.eval_shape(lambda: agent.init_state(jax.random.PRNGKey(0)).params)
    flat = jax.tree.leaves(shapes)
    filled = jax.tree.unflatten(jax.tree.structure(shapes),
                                [np.full(s.shape, i, np.float32) for i, s in enumerate(flat)])
    jax_plan = jax_partition.shard_plan(filled)
    ported = {k: v.numpy() for k, v in _CONVERT[algo](filled).items()}
    plan = partition.shard_plan(ported)
    key_of_source = {}
    for key, idxs in jax_plan.shards.items():
        for i in idxs:
            key_of_source[jax_plan.paths[i]] = key
    jax_names = {i: p for i, p in enumerate(
        jax_partition.leaf_name(p) for p, _ in jax_codec.flatten_with_paths(filled)[1])}
    # leaf i of jax.tree.leaves and of the codec's flatten are the same
    # leaf (both sort dict keys): map each port name to its source.
    assert len(jax_names) == len(flat) == len(ported)
    for key, idxs in plan.shards.items():
        for i in idxs:
            source = jax_names[int(ported[plan.paths[i].replace("/", ".")].flat[0])]
            assert key == key_of_source[source], (plan.paths[i], source)
    assert sorted(plan.shards) == sorted(jax_plan.shards)
    if section == "xformer_moe":
        assert {"expert", "-,model", "rep"} <= set(plan.shards)
    if stacked:
        assert "pipe" in plan.shards


# -- bundles, the store and the transport ---------------------------------------


@pytest.mark.parametrize("make", [_small, _xformer, _moe])
def test_materialize_equals_the_whole_blob_decode(make):
    tree = make(3)
    bundle = weight_shards.build_bundle(tree)
    manifest = weight_shards.parse_manifest(
        weight_shards.manifest_bytes(dict(bundle.manifest, version=7)))
    assert_bit_identical(weight_shards.materialize(manifest, bundle.blobs), _whole(tree))
    partial = dict(bundle.blobs)
    gone = next(iter(partial))
    del partial[gone]
    with pytest.raises(KeyError):
        weight_shards.materialize(manifest, partial)
    corrupt = {k: np.array(v, copy=True) for k, v in bundle.blobs.items()}
    corrupt[gone][-1] ^= 0xFF
    with pytest.raises(ValueError, match="checksum"):
        weight_shards.materialize(manifest, corrupt)


def test_store_serves_shards_and_a_lazy_whole_blob():
    tree = _xformer(7)
    ws = WeightStore(sharded=True)
    ws.publish(_tensors(tree), 4)
    version, mbytes, shards = ws.get_sharded(-1)
    assert version == 4 and all(e == weight_shards.ENC_FULL for _, e, _, _ in shards)
    got = weight_shards.materialize(weight_shards.parse_manifest(mbytes), _blobs(shards))
    assert_bit_identical(got, _whole(tree))
    blob, bv = ws.get_blob()  # whole-blob clients: a direct encode's bytes
    assert bv == 4 and np.asarray(blob).tobytes() == np.asarray(codec.encode(tree)).tobytes()
    assert ws.get_sharded(4) is None  # version identity
    ws.publish(_tensors(_xformer(8)), 2)  # a rollback republish lands too
    assert ws.get_sharded(4)[0] == 2
    assert WeightStore(sharded=False).get_sharded(-1) is None


def test_store_elides_unchanged_shards_and_deltas_changed_ones(fresh_gates):
    fresh_gates.setenv("DRL_WEIGHTS_DELTA", "1")
    weight_shards.refresh_flags()
    tree = _xformer(8)
    ws = WeightStore(sharded=True)
    ws.publish(_tensors(tree), 0)
    tree["head.weight"][0, 0] += 1.0
    ws.publish(_tensors(tree), 1)
    _, _, shards = ws.get_sharded(0, base_version=0, accept_delta=True)
    encs = {k: e for k, e, _, _ in shards}
    assert encs == {"pipe": weight_shards.ENC_SKIP, "rep": weight_shards.ENC_SKIP,
                    "-,model": weight_shards.ENC_DELTA}
    _, _, shards = ws.get_sharded(0)  # no base: every shard full
    assert all(e == weight_shards.ENC_FULL for _, e, _, _ in shards)
    st = ws.shard_stats()
    assert st["deltas_encoded"] == 1 and st["shard_publishes"] == 2
    assert st["shards_changed"] == 3 + 1  # all three, then the head's


def test_quantized_store_keeps_float32_in_process(fresh_gates):
    fresh_gates.setenv("DRL_WEIGHTS_QUANT", "bf16")
    weight_shards.refresh_flags()
    tree = _xformer(17)
    ws = WeightStore(sharded=True)
    params = _tensors(tree)
    ws.publish(params, 1)
    snap, v = ws.get()
    assert v == 1 and all(snap[k].dtype == params[k].dtype for k in params)
    assert_bit_identical(snap, tree)  # the float32 snapshot, never cast
    _, mbytes, shards = ws.get_sharded(-1)
    manifest = weight_shards.parse_manifest(mbytes)
    assert all(sh["quant"]["mode"] == "bf16" for sh in manifest["shards"])
    pulled = weight_shards.materialize(manifest, _blobs(shards))
    want = jax_ws.materialize(manifest, _blobs(shards))  # JAX's bf16 round trip
    assert_bit_identical(pulled, want)
    np.testing.assert_allclose(pulled["head.weight"], tree["head.weight"], rtol=1 / 256)
    assert ws.shard_stats()["quant_bytes_saved"] > 0


def test_async_publication_builds_the_bundle_on_the_worker():
    ws = WeightStore(sharded=True)
    tree = _moe(5)
    ws.publish_async(_tensors(tree), 3)
    assert ws.flush_async(timeout=30.0)
    version, mbytes, shards = ws.get_sharded(-1)
    assert version == 3
    got = weight_shards.materialize(weight_shards.parse_manifest(mbytes), _blobs(shards))
    assert_bit_identical(got, _whole(tree))
    ws.close()


@pytest.fixture
def served():
    tree = _xformer(9)
    ws = WeightStore(sharded=True)
    ws.publish(_tensors(tree), 0)
    server = TransportServer(TrajectoryQueue(4), ws, host="127.0.0.1", port=_free_port()).start()
    client = TransportClient("127.0.0.1", server.port)
    try:
        yield tree, ws, server, client
    finally:
        client.close()
        server.stop()


def test_role_scoped_pull_returns_exactly_the_asked_shards(served):
    *_, client = served
    version, mbytes, shards = client.get_weights_sharded(-1, keys=["pipe"])
    assert [k for k, _, _, _ in shards] == ["pipe"]
    assert {sh["key"] for sh in weight_shards.parse_manifest(mbytes)["shards"]} == {
        "pipe", "-,model", "rep"}


def test_sharded_client_matches_the_whole_blob_client(served, fresh_gates):
    tree, ws, server, client = served
    srw = ShardedRemoteWeights(client)
    got, v = srw.get_if_newer(-1)
    whole, wv = RemoteWeights(client).get_if_newer(-1)
    assert v == wv == 0 and all(isinstance(t, torch.Tensor) for t in got.values())
    assert_bit_identical(got, whole)
    assert srw.get_if_newer(0) is None
    tree["blocks_stacked.qkv_kernel"][0, 0, 0] += 1.0
    ws.publish(_tensors(tree), 1)
    got2, v2 = srw.get_if_newer(0)  # through the cache: pipe changed, the rest skipped
    assert v2 == 1
    assert_bit_identical(got2, _whole(tree))
    s = srw.snapshot_stats()
    assert s["shard_pulls"] == 2 and s["whole_fallbacks"] == 0 and s["shards_skipped"] == 2
    assert server.snapshot_stats()["shard_skip_sends"] == 2


def test_jax_client_pulls_the_port_store_as_a_port_client_does(served):
    """Across the packages: a JAX `ShardedRemoteWeights` on a port server
    gets the arrays a port client gets (the port's names and bytes)."""
    tree, ws, server, client = served
    jclient = jax_transport.TransportClient("127.0.0.1", server.port)
    try:
        jtree, jv = jax_transport.ShardedRemoteWeights(jclient).get_if_newer(-1)
        mine, v = ShardedRemoteWeights(client).get_if_newer(-1)
        assert jv == v == 0
        assert_bit_identical(jtree, mine)
    finally:
        jclient.close()


def test_pinned_int8_shard_keeps_its_own_scales(fresh_gates):
    fresh_gates.setenv("DRL_WEIGHTS_QUANT", "int8")
    weight_shards.refresh_flags()
    tree = _xformer(30)
    ws = WeightStore(sharded=True)
    ws.publish(_tensors(tree), 0)
    server = TransportServer(TrajectoryQueue(4), ws, host="127.0.0.1", port=_free_port()).start()
    client = TransportClient("127.0.0.1", server.port)
    try:
        srw = ShardedRemoteWeights(client, keys=["rep"])
        got1, _ = srw.get_if_newer(-1)  # the first pull is always full
        tree["head.weight"] *= 2.0  # its amax, and so its int8 scale, moves
        tree["step"] = np.array(1, np.int64)
        ws.publish(_tensors(tree), 1)
        got2, v2 = srw.get_if_newer(0)
        assert v2 == 1 and int(got2["step"]) == 1  # the refreshed shard moved
        assert got1["head.weight"].numpy().tobytes() == got2["head.weight"].numpy().tobytes()
    finally:
        client.close()
        server.stop()


def test_unsharded_store_demotes_the_client_for_good():
    ws = WeightStore(sharded=False)
    ws.publish(_tensors(_small(1)), 5)
    server = TransportServer(TrajectoryQueue(4), ws, host="127.0.0.1", port=_free_port()).start()
    client = TransportClient("127.0.0.1", server.port)
    try:
        srw = ShardedRemoteWeights(client)
        got, v = srw.get_if_newer(-1)
        assert v == 5
        assert_bit_identical(got, _small(1))
        assert srw._plain and srw.snapshot_stats()["whole_fallbacks"] == 1
        assert srw.get_if_newer(5) is None
    finally:
        client.close()
        server.stop()


# -- the segmented board -------------------------------------------------------


def _seqs(board, manifest):
    return {sh["key"]: (sh["act"], board._read_u64(sh["seq"]), board._read_u64(sh["seq"] + 64))
            for sh in manifest["shards"]}


def test_board_round_trip_and_changed_shards_only():
    board = _sboard("rt")
    try:
        tree = _xformer(11)
        ws = WeightStore(sharded=True)
        ws.attach_board(board)
        ws.publish(_tensors(tree), 0)
        m1, blobs1, v1 = board.read_shards(-1)
        assert v1 == 0 and board.read_shards(0) is None
        assert_bit_identical(weight_shards.materialize(m1, blobs1), _whole(tree))
        tree["head.weight"][0, 0] += 1.0  # touches only "-,model"
        ws.publish(_tensors(tree), 1)
        m2, blobs2, v2 = board.read_shards(-1)
        s1, s2 = _seqs(board, m1), _seqs(board, m2)
        assert s2["-,model"] != s1["-,model"] and s2["pipe"] == s1["pipe"]
        assert s2["rep"] == s1["rep"]
        assert_bit_identical(weight_shards.materialize(m2, blobs2), _whole(tree))
    finally:
        board.close()
        board.unlink()


def test_board_mid_pull_flip_retries_to_a_consistent_version():
    writer = _sboard("flip")
    try:
        ws = WeightStore(sharded=True)
        ws.attach_board(writer)
        ws.publish(_tensors(_xformer(12)), 1)
        flip = {"armed": 2}

        class _FlipOnSlotRead(ShardedWeightBoard):
            def _pre_slot_read(self):
                while flip["armed"]:
                    flip["armed"] -= 1
                    ws.publish(_tensors(_xformer(20 + flip["armed"])), 100 + flip["armed"])

        reader = _FlipOnSlotRead.attach(writer.name)
        manifest, blobs, version = reader.read_shards(-1)
        assert reader.read_retries >= 1 and version in (100, 101)
        assert_bit_identical(weight_shards.materialize(manifest, blobs),
                             _whole(_xformer(20 + (version == 101))))
        reader.close()
    finally:
        writer.close()
        writer.unlink()


def test_oversize_shard_latches_itself_and_is_filled_over_tcp():
    board = _sboard("latch", arena=1 << 18)
    try:
        tree = _oversize(0)
        ws = WeightStore(sharded=True)
        ws.attach_board(board)
        ws.publish(_tensors(tree), 3)
        assert not board.writer_closed  # the board itself stays up
        manifest, blobs, _ = board.read_shards(-1)
        on_board = {sh["key"]: sh.get("board", True) for sh in manifest["shards"]}
        assert on_board == {"-,model": False, "pipe": True, "rep": True}
        assert "-,model" not in blobs

        class _ShardClient:
            def get_weights_sharded(self, have, keys=None, base_version=-2,
                                    accept_delta=False):
                return ws.get_sharded(have, keys=keys, base_version=base_version,
                                      accept_delta=accept_delta)

            def get_weights_if_newer(self, have):
                raise AssertionError("a whole pull was not expected")

        bw = BoardWeights(attach_any(board.name), _ShardClient())
        got, version = bw.get_if_newer(-1)
        assert version == 3
        assert_bit_identical(got, _whole(tree))
        s = bw.snapshot_stats()
        assert s["board_shard_fallbacks"] == 1 and s["tcp_fallbacks"] == 0
        assert s["shard_pulls"] == 1
        bw.close()
        tree["step"] = np.array(2, np.int64)
        ws.publish(_tensors(tree), 4)  # the surviving shards keep flowing
        assert board.read_shards(3)[2] == 4
    finally:
        board.close()
        board.unlink()


def test_board_failures_latch_the_whole_board():
    """A new shard key after layout, a manifest past its slot and a
    whole-blob store on a segmented board each latch the board off; the
    store keeps publishing."""
    cases = [("newkey", {}, True, [_xformer(13), _moe(13)]),
             ("mover", {"mslot_bytes": 64}, True, [_xformer(15)]),
             ("mismatch", {}, False, [_small(2)])]
    for tag, kw, sharded, trees in cases:
        board = _sboard(tag, **kw)
        try:
            ws = WeightStore(sharded=sharded)
            ws.attach_board(board)
            for v, tree in enumerate(trees):
                ws.publish(_tensors(tree), v)
            assert ws.version == len(trees) - 1 and board.writer_closed, tag
        finally:
            board.close()
            board.unlink()


def test_writer_closed_and_odd_seqlock_demote_the_reader():
    board = _sboard("closed")
    try:
        ws = WeightStore(sharded=True)
        ws.attach_board(board)
        ws.publish(_tensors(_xformer(14)), 1)

        class _Fake:
            pulls = 0

            def get_weights_if_newer(self, have):
                self.pulls += 1
                return {"tcp": np.ones(1, np.float32)}, 999

        fake = _Fake()
        bw = BoardWeights(attach_any(board.name), fake)
        assert bw.get_if_newer(-1)[1] == 1
        board._write_u64(64, board._read_u64(64) + 1)  # the meta seqlock stuck odd
        with pytest.raises(BoardClosed):
            board.read_shards(-1, timeout=0.3)
        with pytest.raises(BoardClosed):
            board.version(timeout=0.3)
        board._write_u64(64, board._read_u64(64) + 1)
        board.close_writer()
        assert bw.get_if_newer(1)[1] == 999 and fake.pulls == 1
        assert bw.snapshot_stats()["tcp_fallbacks"] == 1
        bw.close()
    finally:
        board.close()
        board.unlink()


def test_attach_any_and_serve_board_follow_the_gate(fresh_gates):
    classic = WeightBoard.create(f"drltest-tws-cls-{os.getpid()}", 8192)
    sharded = _sboard("disp")
    try:
        assert isinstance(attach_any(classic.name), WeightBoard)
        assert isinstance(attach_any(sharded.name), ShardedWeightBoard)
        with pytest.raises(ValueError, match="sharded"):
            ShardedWeightBoard.attach(classic.name)
    finally:
        for b in (classic, sharded):
            b.close()
            b.unlink()
    fresh_gates.setenv("DRL_WEIGHTS_SHARDED", "1")
    fresh_gates.setenv("DRL_SHM_WEIGHTS_MB", "1")
    weight_shards.refresh_flags()
    board = weight_board.serve_board(f"drltest-tws-serve-{os.getpid()}")
    try:
        assert isinstance(board, ShardedWeightBoard)
        assert WeightStore().sharded  # the store follows the same gate
    finally:
        board.close()
        board.unlink()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_segmented_board(writer):
    tree = _xformer(21)
    name = f"drltest-tws-x{writer}-{os.getpid()}"
    if writer == "port":
        board = ShardedWeightBoard.create(name, 1 << 22)
        ws = WeightStore(sharded=True)
        ws.attach_board(board)
        ws.publish(_tensors(tree), 6)
        reader = jax_board.ShardedWeightBoard.attach(name)
        manifest, blobs, version = reader.read_shards(-1)
        got = jax_ws.materialize(manifest, blobs)
    else:
        board = jax_board.ShardedWeightBoard.create(name, 1 << 22)
        jws = JaxStore(sharded=True, quant="")
        jws.attach_board(board)
        jws.publish(tree, 6)
        reader = ShardedWeightBoard.attach(name)
        bw = BoardWeights(reader, None)
        got, version = bw.get_if_newer(-1)
        bw.close()
    try:
        assert version == 6
        assert_bit_identical(got, _whole(tree))
    finally:
        reader.close()
        board.close()
        board.unlink()


# -- gates ---------------------------------------------------------------------


def test_gates_force_and_default_to_the_jax_verdict(fresh_gates):
    committed = json.loads((REPO / "benchmarks" / "weights_shard_verdict.json").read_text())
    for key in ("auto_enable", "quant_auto_enable", "quant_mode", "delta_auto_enable"):
        assert weight_shards.WEIGHTS_SHARD_VERDICT[key] == committed[key]
    assert weight_shards.sharded_enabled() is False
    assert weight_shards.quant_mode() is None and weight_shards.delta_enabled() is False
    assert weight_shards.role_keys() is None
    fresh_gates.setenv("DRL_WEIGHTS_SHARDED", "1")
    fresh_gates.setenv("DRL_WEIGHTS_QUANT", "int8")
    fresh_gates.setenv("DRL_WEIGHTS_DELTA", "1")
    fresh_gates.setenv("DRL_WEIGHTS_KEYS", "rep,expert")
    weight_shards.refresh_flags()
    assert weight_shards.sharded_enabled() and weight_shards.delta_enabled()
    assert weight_shards.quant_mode() == "int8"
    assert weight_shards.role_keys() == ["rep", "expert"]
    fresh_gates.setenv("DRL_WEIGHTS_QUANT", "1")
    weight_shards.refresh_flags()
    assert weight_shards.quant_mode() == "bf16"
    ws = WeightStore()
    assert ws.sharded and ws._quant == "bf16" and ws._delta_on
