"""Zero-copy-ish pytree <-> bytes codec for the native queue and the wire.

Copy of the JAX package's `data/codec.py` (it imports no jax): the same
layout and the same bytes for the same tree, so the two packages read
each other's trajectory blobs. One change: the gates below take their
unset defaults from constants, not from files under `benchmarks/`.

The reference never serializes — TF's FIFOQueue kernel moves tensors
through its own gRPC runtime (`distributed_queue/buffer_queue.py:28-36`).
Our data plane is explicit: a trajectory pytree of numpy arrays is packed
into one contiguous blob (header + raw array bytes) that the C++ ring
queue and the TCP transport move without touching Python object graphs.

Layout: [u32 magic][u32 header_len][header json][payload]
  header = {"treedef": ..., "arrays": [{"dtype","shape","offset","nbytes"}]}
Payload arrays are C-contiguous raw bytes at 64-byte aligned offsets (so
a reader can np.frombuffer without copies and downstream device DMA sees
aligned hosts buffers).

Two hot-path accelerations live here (telemetry-driven: the committed
transport adjudication showed this host is ENCODE-bound — the shm ring
cut PUT latency ~100x and still missed the throughput bar because the
producer was busy re-flattening pytrees):

1. **Schema cache** (`_CACHES`): an actor re-encodes the same pytree
   schema (skeleton + dtypes + shapes) thousands of times per run. The
   first encode of a schema runs the full `_flatten` walk + json header
   build and caches the frozen header bytes, leaf offsets, and total
   size; every later encode is one structural key walk (O(leaves) — the
   per-call verification that invalidates on any dtype/shape/structure
   change), one buffer allocation, and per-leaf memcpys. Decode mirrors
   it with a layout cache keyed by the exact header bytes. Cache-hit
   blobs are byte-identical to cold encodes (pinned by
   tests/test_codec_fastpath.py). Gated by `DRL_CODEC_CACHE` (1 on,
   0 off; unset off, see `_DEFAULTS`).

2. **Frame-stack dedup** (`encode(..., dedup=True)`): Atari-style
   observations `[T, H, W, S]` stack S frames newest-last
   (`envs/atari.py`), so consecutive unroll steps share S-1 of S planes.
   Opt-in packing (`DRL_OBS_DEDUP`) transmits, per stacked leaf, the
   step-0 stack plus ONE new plane per step (a full stack again at each
   detected discontinuity, e.g. an episode reset zeroing the stack),
   ~S-fold cutting the dominant payload. Decode reconstructs
   BIT-IDENTICALLY before anything downstream sees the trajectory;
   leaves that don't match the stacking pattern (or save < 25%) are
   stored plain, so non-stacked schemas pass through unchanged. Packed
   blobs never enter a blob-native queue: `fifo.blob_ingest` routes them
   through `unpack_blob` first (the native batch-gather assumes the
   plain layout).
"""

from __future__ import annotations

import json
import os
import sys
import threading
from collections import namedtuple
from functools import lru_cache
from typing import Any

import numpy as np


@lru_cache(maxsize=None)
def _namedtuple_cls(name: str, fields: tuple[str, ...]):
    return namedtuple(name, fields)

_MAGIC = 0x445254A1  # "DRT" + version 1
_ALIGN = 64

# Stamp extension frame (ISSUE 18 sample-at-source): a self-delimiting
# prefix `[u32 ext_magic][u32 version][u32 ext_len][ext json]` carried
# IN FRONT of an unmodified codec blob. The per-blob priority summary
# must NOT ride the codec header json — the decode layout cache is
# keyed on exact header bytes, and per-blob content there would turn
# every lookup into a miss. The frame layout itself is pinned forever;
# `version` only versions the json semantics, so any reader can skip an
# extension it does not understand and fall through to the plain blob
# (forward compat: a v2 stamp decodes on a v1 learner as unstamped).
_EXT_MAGIC = 0x445254E5
_EXT_VERSION = 1
_EXT_HDR = 12  # magic + version + ext_len

# Below this, a 4-d uint8 leaf is not worth the per-call plane compare.
_DEDUP_MIN_BYTES = 4096
_PACK_FSTACK = "fstack"  # the one packing scheme: frame-stack delta planes


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _flatten(tree: Any, path: str, out: list[tuple[str, np.ndarray]]) -> Any:
    """Flatten nested dict/list/tuple/namedtuple of arrays; return skeleton."""
    if isinstance(tree, dict):
        return {k: _flatten(v, f"{path}.{k}", out) for k, v in sorted(tree.items())}
    if hasattr(tree, "_fields"):  # namedtuple
        vals = {f: _flatten(getattr(tree, f), f"{path}.{f}", out) for f in tree._fields}
        return {"__namedtuple__": type(tree).__name__, "fields": vals}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {
            "__seq__": kind,
            "items": [_flatten(v, f"{path}[{i}]", out) for i, v in enumerate(tree)],
        }
    arr = np.asarray(tree)
    if arr.ndim and not arr.flags["C_CONTIGUOUS"]:
        arr = np.ascontiguousarray(arr)  # 0-d stays 0-d (ascontiguousarray would promote it)
    out.append((path, arr))
    return {"__leaf__": len(out) - 1}


def _walk(tree: Any, leaves: list[np.ndarray]) -> tuple:
    """Cheap structural walk: collect leaf arrays in `_flatten` order and
    return a hashable schema key. This IS the per-call cache validation —
    the key covers structure, dtypes, and shapes, so a hit can only map
    to a layout that is correct for these leaves. No path strings, no
    skeleton dicts, no json: the whole point of the cache."""
    if isinstance(tree, dict):
        return ("d",) + tuple((k, _walk(v, leaves)) for k, v in sorted(tree.items()))
    if hasattr(tree, "_fields"):  # namedtuple
        return ("n", type(tree).__name__, tuple(tree._fields)) + tuple(
            _walk(getattr(tree, f), leaves) for f in tree._fields)
    if isinstance(tree, (list, tuple)):
        tag = "l" if isinstance(tree, list) else "t"
        return (tag,) + tuple(_walk(v, leaves) for v in tree)
    arr = np.asarray(tree)
    if arr.ndim and not arr.flags["C_CONTIGUOUS"]:
        arr = np.ascontiguousarray(arr)
    leaves.append(arr)
    return ("a", arr.dtype.str, arr.shape)


def _unflatten(skel: Any, arrays: list[np.ndarray]) -> Any:
    if isinstance(skel, dict):
        if "__leaf__" in skel:
            return arrays[skel["__leaf__"]]
        if "__seq__" in skel:
            items = [_unflatten(v, arrays) for v in skel["items"]]
            return items if skel["__seq__"] == "list" else tuple(items)
        if "__namedtuple__" in skel:
            # Rebuilt as a structurally-equal namedtuple (same type name and
            # fields) so consumers' attribute access keeps working after a
            # queue/wire round trip.
            fields = skel["fields"]
            cls = _namedtuple_cls(skel["__namedtuple__"], tuple(fields))
            return cls(**{k: _unflatten(v, arrays) for k, v in fields.items()})
        return {k: _unflatten(v, arrays) for k, v in skel.items()}
    raise ValueError(f"corrupt skeleton node: {skel!r}")


# -- schema / layout caches ---------------------------------------------------

# (header bytes, payload_start, per-leaf payload offsets, total blob size,
#  alignment-gap byte ranges to zero — the blob buffer is np.empty, not a
#  bytearray, so only the pad gaps are memset instead of the whole blob)
_EncodePlan = namedtuple("_EncodePlan", ["header", "payload_start", "offsets",
                                         "total", "gaps"])
# (skel, metas, payload_start, per-leaf (dtype, shape, nbytes, offset, pack))
_DecodePlan = namedtuple("_DecodePlan", ["skel", "metas", "payload_start",
                                         "leaves", "packed", "payload_nbytes"])


class _CodecCaches:
    """Process-wide schema/layout caches + counters.

    Concurrency map (tools/drlint lock-discipline): encode runs on actor
    loop threads AND the learner's weight-publish/serve threads; decode
    runs on transport serve threads, ring drainers, and prefetchers —
    all hitting this one singleton. Every access to the three maps and
    the counter dict goes through `_lock`. The cached plans are handed
    out lock-free after lookup; their namedtuple fields are never
    mutated in-module, but `skel`/`metas` hold PLAIN DICTS — public
    surfaces that expose them (`parse_layout`) copy the metas and
    document the skeleton as read-only, so a caller cannot poison the
    cache process-wide.
    """

    _GUARDED_BY = {
        "_encode": "_lock",
        "_dedup": "_lock",
        "_decode": "_lock",
        "stats": "_lock",
    }

    # Per-map entry cap. Eviction is least-recently-USED, one entry at a
    # time (lookups promote via pop/reinsert on the insertion-ordered
    # dict): dedup/decode keys embed content-dependent reset-step lists,
    # and FIFO or clear-the-map policies would let that churn wipe the
    # hot plain-schema plans every traffic class shares.
    MAX_SCHEMAS = 64

    def __init__(self):
        self._lock = threading.Lock()
        self._encode: dict[tuple, _EncodePlan] = {}
        self._dedup: dict[tuple, _EncodePlan] = {}
        self._decode: dict[bytes, _DecodePlan] = {}
        # dedup_plan_* is kept SEPARATE from encode_*: dedup plans are
        # keyed by (schema, reset steps) — content, not schema — so
        # reset-bearing traffic legitimately misses them per blob, and
        # folding that into the schema-cache hit rate would read as a
        # broken cache to an operator tuning DRL_CODEC_CACHE.
        self.stats = {"encode_hits": 0, "encode_misses": 0,
                      "decode_hits": 0, "decode_misses": 0,
                      "dedup_plan_hits": 0, "dedup_plan_misses": 0,
                      "dedup_blobs": 0, "dedup_bytes_saved": 0}

    def lookup_encode(self, key, dedup_key=None):
        with self._lock:
            cache = self._dedup if dedup_key is not None else self._encode
            k = dedup_key if dedup_key is not None else key
            plan = cache.get(k)
            if plan is not None:
                cache.pop(k)  # promote: eviction below is oldest-first,
                cache[k] = plan  # and hot plans must outlive churny ones
            kind = "dedup_plan" if dedup_key is not None else "encode"
            self.stats[f"{kind}_hits" if plan is not None
                       else f"{kind}_misses"] += 1
            return plan

    def store_encode(self, key, plan, dedup_key=None) -> None:
        with self._lock:
            cache = self._dedup if dedup_key is not None else self._encode
            if len(cache) >= self.MAX_SCHEMAS:
                cache.pop(next(iter(cache)))  # least recently used
            cache[dedup_key if dedup_key is not None else key] = plan

    def lookup_decode(self, header: bytes):
        with self._lock:
            plan = self._decode.get(header)
            if plan is not None:
                self._decode.pop(header)  # promote (see lookup_encode):
                self._decode[header] = plan  # dedup headers with reset-step
                # lists are per-blob unique and would otherwise FIFO-evict
                # the hot plain-schema plans they can never replace
            self.stats["decode_hits" if plan is not None else "decode_misses"] += 1
            return plan

    def store_decode(self, header: bytes, plan: _DecodePlan) -> None:
        with self._lock:
            if len(self._decode) >= self.MAX_SCHEMAS:
                self._decode.pop(next(iter(self._decode)))  # least recently used
            self._decode[header] = plan

    def bump_dedup(self, bytes_saved: int) -> None:
        with self._lock:
            self.stats["dedup_blobs"] += 1
            self.stats["dedup_bytes_saved"] += bytes_saved

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.stats)

    def stat(self, key: str) -> int:
        """One counter under the lock (telemetry counter providers poll
        this from the flush thread)."""
        with self._lock:
            return self.stats[key]

    def clear(self) -> None:
        with self._lock:
            self._encode.clear()
            self._dedup.clear()
            self._decode.clear()
            for k in self.stats:
                self.stats[k] = 0


_CACHES = _CodecCaches()


def cache_stats() -> dict:
    """Copy of the cache/dedup counters (telemetry providers, tests)."""
    return _CACHES.snapshot()


def cache_stat(key: str) -> int:
    return _CACHES.stat(key)


def clear_caches() -> None:
    """Drop all cached plans and zero the counters (tests, benchmarks)."""
    _CACHES.clear()


# -- feature gates ------------------------------------------------------------

# Unset-gate defaults. The JAX package reads them from
# `benchmarks/codec_verdict.json` (`cache_auto_enable`,
# `dedup_auto_enable`), TPU-era adjudications this package does not
# read; both are false there today, so both knobs stay opt-in here.
_DEFAULTS = {"cache_auto_enable": False, "dedup_auto_enable": False}

_flag_lock = threading.Lock()
_flags: dict[str, bool | None] = {"cache": None, "dedup": None}


def _resolve_flag(name: str, env_key: str, default_key: str) -> bool:
    with _flag_lock:
        cached = _flags[name]
    if cached is not None:
        return cached
    env = os.environ.get(env_key, "").strip().lower()
    if env in ("1", "true", "yes", "on"):
        value = True
    elif env in ("0", "false", "no", "off"):
        value = False
    else:
        value = _DEFAULTS[default_key]
    with _flag_lock:
        _flags[name] = value
    return value


def cache_enabled() -> bool:
    """DRL_CODEC_CACHE=1 forces the schema cache on, =0 off; unset takes
    `_DEFAULTS["cache_auto_enable"]` (off). Resolved once per process;
    `refresh_flags()` re-reads (tests)."""
    return _resolve_flag("cache", "DRL_CODEC_CACHE", "cache_auto_enable")


def obs_dedup_enabled() -> bool:
    """DRL_OBS_DEDUP=1 forces frame-stack dedup on the WIRE paths, =0
    off; unset takes `_DEFAULTS["dedup_auto_enable"]` (off).
    Wire-only: in-process queues never see packed blobs."""
    return _resolve_flag("dedup", "DRL_OBS_DEDUP", "dedup_auto_enable")


def refresh_flags() -> None:
    """Re-resolve the env/verdict gates (after monkeypatching env)."""
    with _flag_lock:
        _flags["cache"] = None
        _flags["dedup"] = None


# -- frame-stack dedup plumbing ----------------------------------------------


def _segments(T: int, full: tuple[int, ...]):
    """Segment starts = step 0 + each full (discontinuity) step; yields
    (t0, t1) half-open step ranges, each stored as stack(t0)+deltas."""
    starts = [0, *full, T]
    for i in range(len(starts) - 1):
        yield starts[i], starts[i + 1]


def _packed_nbytes(shape: tuple[int, ...], itemsize: int,
                   full: tuple[int, ...]) -> int:
    T, H, W, S = shape
    n_full = 1 + len(full)  # step 0 + each discontinuity
    n_delta = T - n_full
    return itemsize * H * W * (n_full * S + n_delta)


def _shifted_same(arr: np.ndarray) -> np.ndarray:
    """Per-step `[T-1]` bool: did the stack shift exactly one plane
    (arr[t,:,:,:-1] == arr[t-1,:,:,1:])? For the dominant S=4 uint8 case
    on little-endian hosts the S axis collapses into one uint32 word and
    the shifted compare becomes mask/shift word ops — ~13x cheaper than
    the elementwise strided compare, which stays as the general path."""
    T = arr.shape[0]
    if arr.shape[3] == 4 and sys.byteorder == "little":
        # The word decomposition below assumes byte 0 is the low byte;
        # on a big-endian host the masks would test the REVERSED shift
        # and silently mis-pack, so such hosts take the general path.
        words = arr.view(np.uint32).reshape(T, -1)
        # word = p0 | p1<<8 | p2<<16 | p3<<24 (planes oldest-first), so
        # "planes 0..2 of t == planes 1..3 of t-1" is a mask/shift match.
        return ((words[1:] & np.uint32(0x00FFFFFF))
                == (words[:-1] >> np.uint32(8))).all(axis=1)
    same = np.equal(arr[1:, :, :, :-1], arr[:-1, :, :, 1:])
    return same.reshape(T - 1, -1).all(axis=1)


def _dedup_plan_for(leaves: list[np.ndarray]) -> tuple[tuple, int]:
    """-> (((leaf_idx, full_steps), ...), bytes_saved) for leaves worth
    packing. A step t >= 1 is a delta step when the leaf's planes shifted
    exactly one slot (arr[t,:,:,:-1] == arr[t-1,:,:,1:]) — newest-last
    stacking, `envs/atari.py`. Content-dependent, so computed per call;
    only the header build is cacheable."""
    packable = []
    saved_total = 0
    for i, arr in enumerate(leaves):
        if (arr.ndim != 4 or arr.dtype != np.uint8 or arr.shape[0] < 2
                or not 2 <= arr.shape[3] <= 8 or arr.nbytes < _DEDUP_MIN_BYTES):
            continue
        same = _shifted_same(arr)
        full = tuple(int(t) for t in np.flatnonzero(~same) + 1)
        saved = arr.nbytes - _packed_nbytes(arr.shape, arr.itemsize, full)
        if saved * 4 < arr.nbytes:  # < 25% saved: not worth the repack
            continue
        packable.append((i, full))
        saved_total += saved
    return tuple(packable), saved_total


def _write_packed_leaf(view: memoryview, start: int, arr: np.ndarray,
                       full: tuple[int, ...]) -> None:
    """Store stack(t0) + one new plane per delta step, per segment.
    `arr[t0]` is a contiguous slice of the C-order leaf (one memcpy);
    the delta planes of a segment are gathered in ONE strided copy."""
    T, H, W, S = arr.shape
    stack_nb = H * W * S * arr.itemsize
    plane_nb = H * W * arr.itemsize
    pos = start
    for t0, t1 in _segments(T, full):
        view[pos:pos + stack_nb] = memoryview(arr[t0].reshape(-1)).cast("B")
        pos += stack_nb
        if t1 - t0 > 1:
            deltas = np.ascontiguousarray(arr[t0 + 1:t1, :, :, S - 1])
            nb = (t1 - t0 - 1) * plane_nb
            view[pos:pos + nb] = memoryview(deltas.reshape(-1)).cast("B")
            pos += nb


def _read_packed_leaf(view: memoryview, start: int, dtype: np.dtype,
                      shape: tuple[int, ...], full: tuple[int, ...]) -> np.ndarray:
    """Reconstruct the full [T, H, W, S] leaf bit-identically. Per
    segment: the plane timeline is stack(t0)'s S planes followed by the
    stored deltas, and out[t,:,:,j] == planes[(t-t0)+j] — re-interleaved
    by one np.stack over S shifted timeline views straight into the
    output slice (measured ~3.5x faster than copying a sliding-window
    view, whose scattered 1-byte inner axis defeats the iterator)."""
    T, H, W, S = shape
    out = np.empty(shape, dtype)
    stack_n = H * W * S
    plane_n = H * W
    pos = start
    for t0, t1 in _segments(T, full):
        n_steps = t1 - t0
        n_planes = S + (n_steps - 1)
        planes = np.empty((n_planes, H, W), dtype)
        stack = np.frombuffer(view[pos:pos + stack_n * dtype.itemsize],
                              dtype=dtype).reshape(H, W, S)
        planes[:S] = np.moveaxis(stack, -1, 0)
        pos += stack_n * dtype.itemsize
        if n_steps > 1:
            nb = (n_steps - 1) * plane_n * dtype.itemsize
            planes[S:] = np.frombuffer(view[pos:pos + nb],
                                       dtype=dtype).reshape(n_steps - 1, H, W)
            pos += nb
        np.stack([planes[j:j + n_steps] for j in range(S)], axis=-1,
                 out=out[t0:t1])  # channel j of step t is plane (t-t0)+j
    return out


# -- encode -------------------------------------------------------------------


def _build_plan(leaves: list[np.ndarray], skel: Any,
                packable: tuple = ()) -> _EncodePlan:
    """Slow path: compute metas + header json for these leaves (packed
    per `packable`), freeze the reusable parts."""
    pack_map = dict(packable)
    metas = []
    gaps = []
    offset = 0
    for i, arr in enumerate(leaves):
        aligned = _align(offset)
        if aligned > offset:
            gaps.append((offset, aligned))  # payload-relative; fixed up below
        offset = aligned
        meta = {"dtype": arr.dtype.str, "shape": list(arr.shape),
                "offset": offset}
        if i in pack_map:
            meta["pack"] = _PACK_FSTACK
            meta["full"] = list(pack_map[i])
            offset += _packed_nbytes(arr.shape, arr.itemsize, pack_map[i])
        else:
            offset += arr.nbytes
        metas.append(meta)
    header = json.dumps({"skel": skel, "arrays": metas}).encode()
    payload_start = _align(8 + len(header))
    gaps = [(8 + len(header), payload_start)] + [
        (payload_start + a, payload_start + b) for a, b in gaps]
    return _EncodePlan(header, payload_start,
                       tuple(m["offset"] for m in metas), payload_start + offset,
                       tuple((a, b) for a, b in gaps if b > a))


def _blob_from_plan(plan: _EncodePlan, leaves: list[np.ndarray],
                    packable: tuple = ()) -> np.ndarray:
    header, payload_start, offsets, total, gaps = plan
    # np.empty, not bytearray: a bytearray memsets its whole length, and
    # at trajectory sizes that zero-fill was ~half the warm-encode cost.
    # Only the alignment gaps are zeroed (determinism: cache-hit blobs
    # stay byte-identical to cold encodes), every other byte is written.
    buf = np.empty(total, np.uint8)
    view = memoryview(buf)
    view[0:4] = _MAGIC.to_bytes(4, "little")
    view[4:8] = len(header).to_bytes(4, "little")
    view[8:8 + len(header)] = header
    for a, b in gaps:
        buf[a:b] = 0
    pack_map = dict(packable)
    for i, arr in enumerate(leaves):
        start = payload_start + offsets[i]
        if i in pack_map:
            _write_packed_leaf(view, start, arr, pack_map[i])
        else:
            view[start:start + arr.nbytes] = memoryview(arr.reshape(-1)).cast("B")
    return buf


def encode(tree: Any, dedup: bool = False, cache: bool | None = None) -> np.ndarray:
    """Pack a pytree of numpy arrays into one contiguous blob.

    Returns a uint8 ndarray (bytes-like everywhere it's consumed) and
    writes each array exactly once via buffer assignment — the hot path
    moves every trajectory and every weight snapshot, so no intermediate
    `tobytes()` copies and no final `bytes()` copy.

    `dedup=True` additionally packs frame-stacked observation leaves
    (see the module docstring); decode reconstructs bit-identically, and
    when no leaf qualifies the blob is byte-identical to a plain encode.
    Schema-cached when `cache_enabled()`: a warm encode skips the
    `_flatten` walk and the json header build entirely. `cache`
    overrides that gate per call (cache-hit blobs are byte-identical to
    cold encodes, so overriding changes cost, never bytes): the weight
    plane forces it on — its per-version publish encode has a stable
    schema and is not what the committed trajectory-path verdict
    adjudicated.
    """
    if not (cache_enabled() if cache is None else cache):
        # Pre-cache behavior, kept as the adjudication baseline and the
        # DRL_CODEC_CACHE=0 escape hatch.
        pairs: list[tuple[str, np.ndarray]] = []
        skel = _flatten(tree, "$", pairs)
        leaves = [arr for _, arr in pairs]
        packable, saved = _dedup_plan_for(leaves) if dedup else ((), 0)
        if packable:
            _note_dedup(saved)
        return _blob_from_plan(_build_plan(leaves, skel, packable),
                               leaves, packable)
    leaves = []
    key = _walk(tree, leaves)
    packable, saved = _dedup_plan_for(leaves) if dedup else ((), 0)
    dedup_key = (key, packable) if packable else None
    plan = _CACHES.lookup_encode(key, dedup_key)
    if plan is None:
        pairs: list[tuple[str, np.ndarray]] = []
        skel = _flatten(tree, "$", pairs)
        plan = _build_plan(leaves, skel, packable)
        _CACHES.store_encode(key, plan, dedup_key)
    if packable:
        _note_dedup(saved)
    return _blob_from_plan(plan, leaves, packable)


def _note_dedup(saved: int) -> None:
    # Telemetry rides the counter PROVIDERS run_role registers over
    # cache_stats() — a direct _OBS.count here would emit the same
    # cumulative series twice per flush (and the two would diverge after
    # a clear_caches()).
    _CACHES.bump_dedup(saved)


# -- stamp extension ----------------------------------------------------------


def stamp_frame(stamp: dict) -> bytes:
    """Serialize a priority-summary dict into the extension frame bytes
    (see `_EXT_MAGIC`). The frame is sent as a separate wire part in
    front of the blob (`runtime/transport.py` payload-parts path) or
    concatenated by `stamp_blob` where the consumer needs one buffer."""
    body = json.dumps(stamp, separators=(",", ":")).encode()
    return (_EXT_MAGIC.to_bytes(4, "little")
            + _EXT_VERSION.to_bytes(4, "little")
            + len(body).to_bytes(4, "little") + body)


def stamp_blob(blob, stamp: dict) -> np.ndarray:
    """Prepend a stamp extension frame to a codec blob -> one contiguous
    uint8 buffer (the shm ring path moves single buffers)."""
    frame = stamp_frame(stamp)
    view = memoryview(blob).cast("B")
    out = np.empty(len(frame) + len(view), np.uint8)
    mv = memoryview(out)
    mv[:len(frame)] = frame
    mv[len(frame):] = view
    return out


def split_stamp(buf) -> tuple[dict | None, "memoryview"]:
    """-> (stamp | None, inner blob view).

    Unstamped buffers return `(None, view)` untouched. A stamped buffer
    with the CURRENT extension version returns its parsed summary dict;
    an UNKNOWN (greater) version returns `(None, inner)` — the frame is
    self-delimiting, so old readers skip what they cannot interpret and
    treat the blob as plain (rolling-upgrade contract, pinned by
    tests/test_admission.py). Only true corruption raises: an extension
    frame whose declared length overruns the buffer, or whose json does
    not parse — those are poison, not version skew."""
    view = memoryview(buf).cast("B")
    if len(view) < _EXT_HDR or int.from_bytes(view[0:4], "little") != _EXT_MAGIC:
        return None, view
    version = int.from_bytes(view[4:8], "little")
    ext_len = int.from_bytes(view[8:12], "little")
    end = _EXT_HDR + ext_len
    if end > len(view):
        raise ValueError("corrupt stamp extension: length overruns buffer")
    inner = view[end:]
    if version != _EXT_VERSION:
        return None, inner  # future stamp: skip, decode inner as plain
    try:
        stamp = json.loads(bytes(view[_EXT_HDR:end]))
    except ValueError as e:
        raise ValueError(f"corrupt stamp extension: {e}") from e
    if not isinstance(stamp, dict):
        raise ValueError("corrupt stamp extension: summary not a dict")
    return stamp, inner


def _skip_ext(view: memoryview) -> memoryview:
    """Drop a leading stamp extension frame, any version (decode paths
    are stamp-transparent: the summary is ingest metadata, the tree is
    the inner blob). Malformed frames pass through untouched and fail
    at the blob magic check, exactly like any other junk bytes."""
    if len(view) >= _EXT_HDR and int.from_bytes(view[0:4], "little") == _EXT_MAGIC:
        end = _EXT_HDR + int.from_bytes(view[8:12], "little")
        if end <= len(view):
            return view[end:]
    return view


def strip_stamp(blob):
    """Drop a leading stamp extension frame (any version), returning the
    inner plain blob; an unstamped buffer is returned AS-IS (same
    object, no copy). Blob-native queues route through this — their
    batch-gather assumes the blob starts at the codec magic."""
    view = memoryview(blob).cast("B")
    inner = _skip_ext(view)
    return blob if len(inner) == len(view) else inner


def is_stamped(buf) -> bool:
    """True when this buffer carries a stamp extension frame (any
    version — use `split_stamp` to learn whether it is readable)."""
    view = memoryview(buf).cast("B")
    return (len(view) >= _EXT_HDR
            and int.from_bytes(view[0:4], "little") == _EXT_MAGIC)


# -- decode -------------------------------------------------------------------


def parse_layout(blob: bytes | memoryview) -> tuple[Any, list[dict], int]:
    """Header of a blob -> (skeleton, array metas, payload_start).

    The header fully determines the layout, so a consumer holding many
    same-schema blobs (the native queue's batch pop) can parse ONE
    header and gather every field across blobs — see
    `data/native.py` `NativeTrajectoryQueue.get_batch`.

    The metas are FRESH dicts with FRESH nested lists per call
    (pre-cache behavior: json.loads built new objects every time), so
    callers may annotate/mutate them. The skeleton is the cached plan's
    shared object — treat it as read-only.
    """
    plan = _layout_plan(memoryview(blob))
    metas = [dict(m, shape=list(m["shape"]),
                  **({"full": list(m["full"])} if "full" in m else {}))
             for m in plan.metas]
    return plan.skel, metas, plan.payload_start


def _layout_plan(view: memoryview, cache: bool | None = None) -> _DecodePlan:
    view = _skip_ext(view)
    if int.from_bytes(view[0:4], "little") != _MAGIC:
        raise ValueError("bad magic: not a codec blob")
    header_len = int.from_bytes(view[4:8], "little")
    header = bytes(view[8:8 + header_len])
    use_cache = cache_enabled() if cache is None else cache
    if use_cache:
        plan = _CACHES.lookup_decode(header)
        if plan is not None:
            return plan
    parsed = json.loads(header)
    skel, metas = parsed["skel"], parsed["arrays"]
    payload_start = _align(8 + header_len)
    leaves = []
    packed = False
    end = 0
    for meta in metas:
        dtype, shape, nbytes = meta_layout(meta)
        full = meta.get("full")
        pack = None
        stored = nbytes
        if meta.get("pack") == _PACK_FSTACK:
            packed = True
            pack = tuple(full or ())
            stored = _packed_nbytes(shape, dtype.itemsize, pack)
        leaves.append((dtype, shape, nbytes, meta["offset"], pack))
        end = max(end, meta["offset"] + stored)
    plan = _DecodePlan(skel, metas, payload_start, tuple(leaves), packed, end)
    if use_cache:
        _CACHES.store_decode(header, plan)
    return plan


def meta_layout(meta: dict) -> tuple[np.dtype, tuple[int, ...], int]:
    """Array meta dict -> (dtype, shape, nbytes): the single
    interpretation of the header's per-array encoding, shared by
    `decode` and the native batch-gather. For a PACKED meta these are
    the logical (reconstructed) values — packed blobs never reach the
    native gather (`fifo.blob_ingest` unpacks first)."""
    dtype = np.dtype(meta["dtype"])
    shape = tuple(meta["shape"])
    nbytes = dtype.itemsize * int(np.prod(shape, dtype=np.int64)) if shape else dtype.itemsize
    return dtype, shape, nbytes


def assemble(skel: Any, arrays: list[np.ndarray]) -> Any:
    """Rebuild the pytree from a skeleton and its (possibly batched)
    leaf arrays, in `parse_layout` order."""
    return _unflatten(skel, arrays)


def flatten_with_paths(tree: Any) -> tuple[Any, list[tuple[str, np.ndarray]]]:
    """Canonical flatten: (skeleton, [(path, array), ...]) in the EXACT
    leaf order every codec blob uses (sorted dict keys, namedtuple
    fields in declaration order). The sharded weight plane
    (parallel/partition.py, runtime/weight_shards.py) keys its shard
    plans off these paths so "leaf i" means the same array to the
    partition pass, the per-shard blobs, and a whole-blob encode —
    the agreement its bit-identity contract rests on."""
    pairs: list[tuple[str, np.ndarray]] = []
    skel = _flatten(tree, "$", pairs)
    return skel, pairs


def is_packed(blob: bytes | memoryview) -> bool:
    """True when any leaf of this blob is dedup-packed."""
    return _layout_plan(memoryview(blob)).packed


def check_blob(blob) -> None:
    """Raise ValueError unless the header parses and the payload extent
    fits — WITHOUT decoding. The stamped sequence ingest stores blobs
    for deferred decode (`data/replay_service.LazyBlob`), so poison must
    fail here on the ingest thread, not at sample time on the learner.

    cache=True for the same reason ingest's `decode` forces it: every
    caller is an ingest/promote path that sees one stable schema per
    run, and an uncached header parse costs ~3x the whole fast-accept
    it is guarding."""
    view = _skip_ext(memoryview(blob).cast("B"))
    plan = _layout_plan(view, cache=True)
    if plan.payload_start + plan.payload_nbytes > len(view):
        raise ValueError("truncated codec blob payload")


def unpack_blob(blob):
    """Dedup-packed blob -> plain-layout blob; a plain blob is returned
    AS-IS (same object, no copy). `fifo.blob_ingest` routes every wire
    blob through this before a blob-native queue, so the native
    batch-gather only ever sees the plain layout.

    The common (plain) case must cost what the old identity `prepare`
    cost: a `"pack"` substring scan over the header bytes decides
    without parsing json. A false positive (a schema whose key contains
    "pack") merely takes the exact parse below; malformed bytes pass
    through untouched, exactly like the pre-dedup ingest, and fail at
    decode time."""
    outer = memoryview(blob).cast("B")
    view = _skip_ext(outer)
    if len(view) < 8 or int.from_bytes(view[0:4], "little") != _MAGIC:
        return blob
    header_len = int.from_bytes(view[4:8], "little")
    if b'"pack"' not in bytes(view[8:8 + header_len]):
        return blob
    plan = _layout_plan(view)
    if not plan.packed:
        return blob
    plain = encode(decode(view))
    if len(view) != len(outer):  # stamped: keep the ext frame intact in
        #   front of the repacked inner blob (the stamp is ingest
        #   metadata about the SAME logical trajectory)
        return _reframe(outer, view, plain)
    return plain


def _reframe(outer: memoryview, inner: memoryview, plain) -> np.ndarray:
    """Re-attach `outer`'s leading extension frame bytes to a repacked
    inner blob (frame bytes copied verbatim — version-agnostic)."""
    frame_len = len(outer) - len(inner)
    pv = memoryview(plain).cast("B")
    out = np.empty(frame_len + len(pv), np.uint8)
    mv = memoryview(out)
    mv[:frame_len] = outer[:frame_len]
    mv[frame_len:] = pv
    return out


def decode(blob: bytes | memoryview, copy: bool = False,
           cache: bool | None = None) -> Any:
    """Unpack a blob; arrays view the blob unless copy=True (packed
    leaves are always materialized as owned arrays).

    copy=True allocates ONE owned payload buffer and copies the blob's
    payload region into it in a single memcpy — not one slice+copy per
    leaf, which double-touched multi-MB observation leaves. `cache`
    overrides the layout-cache gate per call (see `encode`): the weight
    plane and the replay shards' decode-at-ingest
    (data/replay_service.py) both force it on — each sees ONE stable
    schema per run, so the layout cache is a pure win there regardless
    of the committed trajectory-path verdict.
    """
    view = _skip_ext(memoryview(blob).cast("B"))
    plan = _layout_plan(view, cache)
    payload_start = plan.payload_start
    src = view
    base_off = payload_start
    if copy and plan.payload_nbytes:
        owned = np.empty(plan.payload_nbytes, np.uint8)
        memoryview(owned)[:] = view[payload_start:payload_start + plan.payload_nbytes]
        src = memoryview(owned)
        base_off = 0
    arrays = []
    for dtype, shape, nbytes, offset, pack in plan.leaves:
        start = base_off + offset
        if pack is not None:
            arrays.append(_read_packed_leaf(src, start, dtype, shape, pack))
        else:
            arr = np.frombuffer(src[start:start + nbytes], dtype=dtype).reshape(shape)
            arrays.append(arr)
    return _unflatten(plan.skel, arrays)
