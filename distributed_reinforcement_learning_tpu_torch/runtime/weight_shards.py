"""Sharded weight publication: manifests, quantized broadcast, deltas.

Counterpart of the JAX package's `runtime/weight_shards.py`, numpy only:
for the same parameter tree and the same plan, its manifests, shard
blobs, quantized bytes and deltas are the JAX module's byte for byte
(`tests/test_torch_weight_shards.py`). The byte layer of the sharded
weight plane (`runtime/weights.py`, `runtime/weight_board.py`,
`runtime/transport.py`):

- **Shard bundles**: a parameter tree splits along its partition-rule
  shards (`parallel/partition.py`) into one encode-once codec blob a
  shard plus ONE json manifest (version, shard keys, global leaf
  indices, sizes, crc32 checksums, quant metadata). Readers assemble the
  tree from manifest and shard blobs bit for bit as a whole-blob decode.
- **Quantized broadcast** (`DRL_WEIGHTS_QUANT=bf16|int8`): a cast at
  encode time for the actors' and replicas' bytes (they never
  backpropagate): bfloat16 (round to nearest even, `data/bf16.py`) or
  int8 with a scale a leaf, at half or a quarter of the bytes, while the
  learner's float32 snapshot stays as it is. `materialize` dequantizes,
  so every consumer of a pull sees float32 arrays.
- **Delta publication** (`DRL_WEIGHTS_DELTA=1`): byte-range deltas of
  each shard between consecutive versions for TCP pulls; a pull whose
  base version is the server's previous one gets only the changed
  ranges, or nothing for an untouched shard. The encoder bails past 75%
  of the full size.

The gates: `DRL_WEIGHTS_SHARDED`, `DRL_WEIGHTS_QUANT` and
`DRL_WEIGHTS_DELTA` force; unset takes `WEIGHTS_SHARD_VERDICT`, this
module's copy of the JAX package's
`benchmarks/weights_shard_verdict.json` (all three off).
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from typing import Any

import numpy as np

from distributed_reinforcement_learning_tpu_torch.data import bf16 as bf16_codec
from distributed_reinforcement_learning_tpu_torch.data import codec
from distributed_reinforcement_learning_tpu_torch.parallel import partition

MANIFEST_V = 1

# Per-shard encodings on the shard-scoped GET_WEIGHTS wire op and in
# WeightStore.get_sharded results.
ENC_FULL = 0   # payload = the broadcast blob
ENC_DELTA = 1  # payload = delta_encode(new, base-version blob)
ENC_SKIP = 2   # shard unchanged since the base version; no payload

_U32 = struct.Struct("<I")
_DELTA_HDR = struct.Struct("<II")   # (full_len, nrec)
_DELTA_REC = struct.Struct("<II")   # (offset, length)
_DELTA_GAP = 16       # merge diff runs closer than this (fewer records)
_DELTA_MAX_REC = 65536
_DELTA_BAIL = 0.75    # encoded >= this fraction of full -> send full

QUANT_MODES = ("bf16", "int8")


def crc32(buf) -> int:
    return zlib.crc32(memoryview(buf).cast("B")) & 0xFFFFFFFF


# -- feature gates ------------------------------------------------------------

# The JAX package's benchmarks/weights_shard_verdict.json as it stands:
# the whole-blob against sharded A/B's minimum 0.91x across its shapes
# (below its 1.2x bar), bf16 0.53x on loopback, deltas never adjudicated
# there; so sharded publication, quantization and deltas ship off.
WEIGHTS_SHARD_VERDICT = {"auto_enable": False, "quant_auto_enable": False,
                         "quant_mode": "bf16", "delta_auto_enable": False}

_flag_lock = threading.Lock()
_flags: dict[str, Any] = {"sharded": None, "quant": None, "delta": None}


def _resolve(name: str, compute) -> Any:
    with _flag_lock:
        cached = _flags[name]
    if cached is not None:
        return cached
    value = compute()
    with _flag_lock:
        _flags[name] = value
    return value


def sharded_enabled() -> bool:
    """DRL_WEIGHTS_SHARDED=1 forces per-shard publication on, =0 off;
    unset defers to `WEIGHTS_SHARD_VERDICT` (`auto_enable`). Resolved
    once a process; `refresh_flags()` resolves again (tests)."""

    def compute():
        env = os.environ.get("DRL_WEIGHTS_SHARDED", "").strip().lower()
        if env in ("1", "true", "yes", "on"):
            return True
        if env in ("0", "false", "no", "off"):
            return False
        return bool(WEIGHTS_SHARD_VERDICT.get("auto_enable", False))

    return _resolve("sharded", compute)


def quant_mode() -> str | None:
    """None (f32 broadcast), "bf16", or "int8". `DRL_WEIGHTS_QUANT`
    forces a mode (`1` means bf16, `0` disables); unset defers to
    `WEIGHTS_SHARD_VERDICT` (`quant_auto_enable` and its `quant_mode`). Only
    meaningful when sharded publication is active — the whole-blob path
    never quantizes."""

    def compute():
        env = os.environ.get("DRL_WEIGHTS_QUANT", "").strip().lower()
        if env in QUANT_MODES:
            return env
        if env in ("1", "true", "yes", "on"):
            return "bf16"
        if env in ("0", "false", "no", "off"):
            return "off"
        v = WEIGHTS_SHARD_VERDICT
        if not v.get("quant_auto_enable", False):
            return "off"
        mode = str(v.get("quant_mode", "bf16")).lower()
        return mode if mode in QUANT_MODES else "bf16"

    mode = _resolve("quant", compute)
    return None if mode == "off" else mode


def delta_enabled() -> bool:
    """DRL_WEIGHTS_DELTA=1 forces per-shard delta publication for TCP
    pulls, =0 off; unset defers to `WEIGHTS_SHARD_VERDICT`
    (`delta_auto_enable`)."""

    def compute():
        env = os.environ.get("DRL_WEIGHTS_DELTA", "").strip().lower()
        if env in ("1", "true", "yes", "on"):
            return True
        if env in ("0", "false", "no", "off"):
            return False
        return bool(WEIGHTS_SHARD_VERDICT.get("delta_auto_enable", False))

    return _resolve("delta", compute)


def refresh_flags() -> None:
    """Resolve the env and verdict gates again (tests)."""
    with _flag_lock:
        for k in _flags:
            _flags[k] = None


def role_keys() -> list[str] | None:
    """DRL_WEIGHTS_KEYS=key1,key2 scopes this role's shard REFRESHES to
    the listed shard keys (the first pull is always full — a pytree
    cannot assemble from a subset). None = refresh everything."""
    env = os.environ.get("DRL_WEIGHTS_KEYS", "").strip()
    if not env:
        return None
    return [k for k in (s.strip() for s in env.split(",")) if k]


# -- quantization -------------------------------------------------------------

# The bf16 rounding lives in data/bf16.py (the JAX package's module
# names it the same way).
_f32_to_bf16_u16 = bf16_codec.f32_to_bf16_u16
_bf16_u16_to_f32 = bf16_codec.bf16_u16_to_f32


def quantize_leaves(leaves: list[np.ndarray], mode: str
                    ) -> tuple[list[np.ndarray], dict]:
    """Cast f32 leaves for the broadcast blob. Returns (leaves', meta):
    meta = {"mode", "cast": [shard-local indices], "scales": [...] for
    int8}. Non-f32 leaves (ints, masks, f64 oddballs) pass through
    untouched — only what `materialize` can restore is ever cast."""
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {mode!r}")
    out: list[np.ndarray] = []
    cast: list[int] = []
    scales: list[float] = []
    for i, arr in enumerate(leaves):
        if arr.dtype != np.float32:
            out.append(arr)
            continue
        cast.append(i)
        if mode == "bf16":
            out.append(_f32_to_bf16_u16(np.ascontiguousarray(arr)))
        else:
            amax = float(np.max(np.abs(arr))) if arr.size else 0.0
            scale = amax / 127.0 if amax > 0 else 1.0
            scales.append(scale)
            out.append(np.clip(np.rint(arr / scale), -127, 127).astype(np.int8))
    meta: dict = {"mode": mode, "cast": cast}
    if mode == "int8":
        meta["scales"] = scales
    return out, meta


def dequantize_leaves(leaves: list[np.ndarray], meta: dict) -> list[np.ndarray]:
    """Inverse of `quantize_leaves` back to f32 (lossy by construction)."""
    mode = meta["mode"]
    out = list(leaves)
    for j, i in enumerate(meta["cast"]):
        if mode == "bf16":
            out[i] = _bf16_u16_to_f32(np.ascontiguousarray(out[i]))
        else:
            out[i] = out[i].astype(np.float32) * np.float32(meta["scales"][j])
    return out


# -- per-shard delta codec ----------------------------------------------------


def delta_encode(new, base) -> bytes | None:
    """Byte-range delta `base -> new`, or None when a delta would not
    pay (different lengths, too many scattered ranges, or encoded size
    past `_DELTA_BAIL` of the full blob). Format:
    [u32 full_len][u32 nrec] nrec*(u32 off, u32 len) [literal bytes].
    Literals are the NEW bytes of each range (not XOR): apply is a
    copy + scatter, no bit math."""
    a = np.frombuffer(memoryview(new).cast("B"), np.uint8)
    b = np.frombuffer(memoryview(base).cast("B"), np.uint8)
    if a.size != b.size:
        return None
    idx = np.flatnonzero(a != b)
    if idx.size == 0:
        return _DELTA_HDR.pack(a.size, 0)
    if idx.size > a.size // 2:
        return None  # majority of bytes moved: full blob is cheaper
    brk = np.flatnonzero(np.diff(idx) > _DELTA_GAP)
    starts = idx[np.r_[0, brk + 1]]
    ends = idx[np.r_[brk, idx.size - 1]] + 1
    nrec = starts.size
    lit = int((ends - starts).sum())
    size = _DELTA_HDR.size + nrec * _DELTA_REC.size + lit
    if nrec > _DELTA_MAX_REC or size >= _DELTA_BAIL * a.size:
        return None
    out = bytearray(size)
    _DELTA_HDR.pack_into(out, 0, a.size, nrec)
    pos = _DELTA_HDR.size
    for s, e in zip(starts.tolist(), ends.tolist()):
        _DELTA_REC.pack_into(out, pos, s, e - s)
        pos += _DELTA_REC.size
    view = memoryview(out)
    for s, e in zip(starts.tolist(), ends.tolist()):
        n = e - s
        view[pos:pos + n] = memoryview(a[s:e])
        pos += n
    return bytes(out)


def delta_apply(base, delta) -> np.ndarray:
    """Rebuild the new blob from `base` + a `delta_encode` payload.
    Returns an OWNED uint8 array (never aliases `base` — callers cache
    blobs across versions)."""
    view = memoryview(delta).cast("B")
    full_len, nrec = _DELTA_HDR.unpack_from(view, 0)
    b = np.frombuffer(memoryview(base).cast("B"), np.uint8)
    if b.size != full_len:
        raise ValueError(f"delta base is {b.size} bytes, expected {full_len}")
    out = b.copy()
    pos = _DELTA_HDR.size
    lit = pos + nrec * _DELTA_REC.size
    ov = memoryview(out)
    for _ in range(nrec):
        off, n = _DELTA_REC.unpack_from(view, pos)
        pos += _DELTA_REC.size
        ov[off:off + n] = view[lit:lit + n]
        lit += n
    return out


# -- shard bundles + manifests ------------------------------------------------


class ShardBundle:
    """One publication's shard set, built OFF the store lock:
    `blobs[key]` are the broadcast bytes (quantized when a mode is on),
    `manifest` is the json-ready dict (version filled in at apply
    time), and `host_leaves` are the f32 leaves (views into the f32
    blobs) the in-process snapshot assembles from — the learner's
    master copy is never quantized."""

    __slots__ = ("plan", "manifest", "blobs", "host_leaves", "nbytes_f32")

    def __init__(self, plan, manifest: dict, blobs: dict[str, np.ndarray],
                 host_leaves: list[np.ndarray], nbytes_f32: int):
        self.plan = plan
        self.manifest = manifest
        self.blobs = blobs
        self.host_leaves = host_leaves
        self.nbytes_f32 = nbytes_f32


def build_bundle(params: Any, plan=None, quant: str | None = None,
                 rules=None) -> ShardBundle:
    """params (a tree of host numpy arrays) -> one encode-once blob a
    shard and the manifest skeleton. Each shard is
    `codec.encode([leaves...], cache=True)` over its slice in global leaf
    order; the quantized pass, when on, reads the float32 views of that
    encode."""
    if plan is None:
        plan = partition.shard_plan(params, rules)
    _, pairs = codec.flatten_with_paths(params)
    if len(pairs) != len(plan.paths):
        raise ValueError("params do not match the shard plan's schema")
    leaves = [arr for _, arr in pairs]
    blobs: dict[str, np.ndarray] = {}
    host_leaves: list[np.ndarray] = [None] * len(leaves)  # type: ignore[list-item]
    shard_metas: list[dict] = []
    nbytes_f32 = 0
    for key, idxs in plan.shards.items():
        shard_leaves = [leaves[i] for i in idxs]
        f32_blob = codec.encode(shard_leaves, cache=True)
        nbytes_f32 += len(f32_blob)
        # In-process views come from the f32 blob, exactly like the
        # whole-blob snapshot's decode-of-own-encode.
        f32_views = list(codec.decode(f32_blob, cache=True))
        for i, arr in zip(idxs, f32_views):
            host_leaves[i] = arr
        meta: dict = {"key": key, "leaves": list(idxs)}
        if quant is None:
            blob = f32_blob
            meta["quant"] = None
        else:
            q_leaves, q_meta = quantize_leaves(
                [np.asarray(a) for a in f32_views], quant)
            blob = codec.encode(q_leaves, cache=True)
            meta["quant"] = q_meta
        meta["nbytes"] = int(len(blob))
        meta["crc"] = crc32(blob)
        blobs[key] = blob
        shard_metas.append(meta)
    manifest = {"v": MANIFEST_V, "version": -1, "nleaves": len(leaves),
                "skel": plan.skel, "shards": shard_metas}
    return ShardBundle(plan, manifest, blobs, host_leaves, nbytes_f32)


def manifest_bytes(manifest: dict) -> bytes:
    return json.dumps(manifest, separators=(",", ":")).encode()


def parse_manifest(buf) -> dict:
    m = json.loads(bytes(memoryview(buf).cast("B")))
    if m.get("v") != MANIFEST_V or "shards" not in m or "skel" not in m:
        raise ValueError("not a v1 weight-shard manifest")
    return m


def materialize(manifest: dict, blobs: dict[str, Any],
                verify: bool = True) -> Any:
    """manifest + shard blobs -> the full params pytree.

    Decodes each shard (layout cache forced — one stable schema per
    shard per run), dequantizes cast leaves back to f32, slots every
    leaf into its global index, and unflattens the manifest's skeleton.
    For un-quantized shards the leaves are BIT-IDENTICAL to a
    whole-blob decode (test-pinned). `verify` checks each blob's crc32
    against the manifest — defense in depth behind the board seqlock /
    TCP framing, cheap next to the copy the pull already paid."""
    leaves: list[Any] = [None] * int(manifest["nleaves"])
    for sh in manifest["shards"]:
        key = sh["key"]
        if key not in blobs:
            raise KeyError(f"shard {key!r} missing from pull")
        blob = blobs[key]
        if verify and crc32(blob) != sh["crc"]:
            raise ValueError(f"shard {key!r} checksum mismatch")
        arrs = list(codec.decode(blob, cache=True))
        if sh.get("quant"):
            arrs = dequantize_leaves([np.asarray(a) for a in arrs],
                                     sh["quant"])
        idxs = sh["leaves"]
        if len(arrs) != len(idxs):
            raise ValueError(f"shard {key!r} carries {len(arrs)} leaves, "
                             f"manifest says {len(idxs)}")
        for i, arr in zip(idxs, arrs):
            leaves[i] = arr
    if any(leaf is None for leaf in leaves):
        missing = sum(1 for leaf in leaves if leaf is None)
        raise ValueError(f"{missing} leaves unassigned after assembling "
                         f"{len(manifest['shards'])} shards")
    return codec.assemble(manifest["skel"], leaves)
