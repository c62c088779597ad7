"""Round-to-nearest-even float32 -> bfloat16 codec on numpy.

Copy of the JAX package's `data/bf16.py` (numpy only, no jax): the
quantized broadcast shards of the sharded weight plane
(`runtime/weight_shards.py`) round through it, bit for bit as the JAX
package does, NaN, +-inf, subnormals and +-0 included
(`tests/test_torch_weight_shards.py`). bfloat16 travels as uint16, since
numpy has no bfloat16 dtype and the codec moves raw buffers.
"""

from __future__ import annotations

import sys

import numpy as np


def f32_to_bf16_u16(a: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even f32 -> bf16, carried as uint16 (numpy has
    no bf16 dtype; the codec moves raw buffers either way). All-uint32
    arithmetic — a uint64 promotion here measured ~14x slower at real
    publish sizes. The +0x7FFF(+1) add can only wrap for negative-NaN
    bit patterns (u >= 0xFFFF8001), and every NaN is overwritten by the
    fixup below (mantissa forced non-zero so a NaN cannot round into
    Inf), so the wraparound is unobservable."""
    u = a.reshape(-1).view(np.uint32)
    bias = (u >> np.uint32(16)) & np.uint32(1)
    bias += np.uint32(0x7FFF)
    bias += u  # in-place: bias IS the rounded word now
    if sys.byteorder == "little":
        # High half of each u32, gathered in one strided copy (the
        # >>16 + astype chain costs two more full passes).
        r = np.ascontiguousarray(bias.view(np.uint16)[1::2]).reshape(a.shape)
    else:
        r = (bias >> np.uint32(16)).astype(np.uint16).reshape(a.shape)
    nan = np.isnan(a)
    if nan.any():
        r[nan] = ((u.reshape(a.shape)[nan] >> np.uint32(16))
                  | np.uint32(0x0040)).astype(np.uint16)
    return r


def bf16_u16_to_f32(u: np.ndarray) -> np.ndarray:
    """Zero-extend u16 into the high half of a u32 word: one zeroed
    buffer + one strided 16-bit copy (little-endian hosts), ~5x the
    astype+shift chain at pull sizes. The big-endian fallback keeps the
    readable form."""
    flat = np.ascontiguousarray(u).reshape(-1)
    if sys.byteorder == "little":
        out = np.zeros(flat.size, np.uint32)
        out.view(np.uint16)[1::2] = flat
        return out.view(np.float32).reshape(u.shape)
    return (flat.astype(np.uint32) << np.uint32(16)).view(
        np.float32).reshape(u.shape)
