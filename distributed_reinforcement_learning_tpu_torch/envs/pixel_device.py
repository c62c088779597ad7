"""The on-device Atari observation pipeline shared by the pixel envs.

Counterpart of the JAX package's `envs/pixel_jax.py`: the stages of
`envs.atari.AtariPreprocessor` over `[N, ...]` tensors. A 2-frame max over
consecutive post-frameskip raw frames, luma, the INTER_AREA resize (the
separable overlap weights of `atari._area_weights`, the row weights
pre-cropped to rows 18:102 of the 110-row resize), a cast to uint8 and
the newest-last 4-frame stack. `breakout_device`, `pong_device` and
`invaders_device` all use it, so the crop window, the stack shift and the
reset stack cannot drift apart between games.

Frames are equal across devices and to the JAX pipeline's, bit for bit.
The cast to uint8 truncates, so a resized value one rounding below an
integer (a uniform region's 95.0 computed as 94.99999) loses a level: a
matmul, whose summation order is the library's and the device's (cuBLAS
split-K, TF32), cannot promise equal frames. So the products and sums are
written out in the order XLA's CPU dot takes them, each rounded once to
float32: luma as fused multiply-adds r, g, b in turn; each resized row as
a chain of fused multiply-adds over its (at most three, adjacent) source
rows; each resized column as two such chains, over the even and the odd
source columns, then their sum. A fused multiply-add of float32 values is
exact in float64 (the product of two float32 values fits), so each is one
float64 multiply and add rounded to float32, the same on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.envs.atari import _area_weights

H, W = 210, 160

_WH_CROP = np.asarray(_area_weights(H, 110))[18:102, :]  # [84, 210]
_WW = np.asarray(_area_weights(W, 84))  # [84, 160]
_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


def _taps(weights: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """`[out, src]` area weights -> (first source index j0 `[out]`, the
    weights of sources j0, j0 + 1, j0 + 2 `[out, 3]`, 0 where absent).
    Every output overlaps two or three adjacent sources."""
    first, taps = [], []
    for row in weights:
        nz = np.flatnonzero(row)
        assert 2 <= len(nz) <= 3 and (np.diff(nz) == 1).all()
        first.append(nz[0])
        taps.append(np.concatenate([row[nz], np.zeros(3 - len(nz), row.dtype)]))
    return np.asarray(first), np.asarray(taps, np.float64)


_ROW_J0, _ROW_W = _taps(_WH_CROP)
_COL_J0, _COL_W = _taps(_WW)

_CONSTS: dict[torch.device, dict[str, torch.Tensor]] = {}


def canonical(device: str | torch.device) -> torch.device:
    """`device` with its index (`cuda` -> `cuda:0`), as tensors report it."""
    return torch.empty(0, device=device).device


def _consts(device: torch.device) -> dict[str, torch.Tensor]:
    """The luma weights and the resize taps on `device`, made once."""
    got = _CONSTS.get(device)
    if got is None:
        rows = {f"row_j{i}": torch.from_numpy(np.minimum(_ROW_J0 + i, H - 1)) for i in range(3)}
        cols = {f"col_j{i}": torch.from_numpy(np.minimum(_COL_J0 + i, W - 1)) for i in range(3)}
        got = _CONSTS[device] = {k: v.to(device) for k, v in dict(
            luma=torch.from_numpy(_LUMA.astype(np.float64)), row_w=torch.from_numpy(_ROW_W),
            col_w=torch.from_numpy(_COL_W), **rows, **cols).items()}
    return got


def _round(x: torch.Tensor) -> torch.Tensor:
    """A float64 value rounded to float32, kept in float64."""
    return x.to(torch.float32).to(torch.float64)


def preprocess(rgb: torch.Tensor) -> torch.Tensor:
    """`[N, 210, 160, 3]` u8 -> `[N, 84, 84]` u8 (luma, area resize, crop),
    in the rounding order set out in the module docstring."""
    c = _consts(rgb.device)
    w = c["luma"]
    luma = _round(rgb[..., 0].to(torch.float64) * w[0])
    luma = _round(rgb[..., 1].to(torch.float64) * w[1] + luma)
    luma = _round(rgb[..., 2].to(torch.float64) * w[2] + luma)  # [N, 210, 160]

    rw = c["row_w"][:, :, None]  # [84, 3, 1]
    m = _round(luma[:, c["row_j0"], :] * rw[:, 0])
    m = _round(luma[:, c["row_j1"], :] * rw[:, 1] + m)
    m = _round(luma[:, c["row_j2"], :] * rw[:, 2] + m)  # [N, 84, 160]

    cw = c["col_w"]  # [84, 3]
    even = _round(m[:, :, c["col_j2"]] * cw[:, 2] + _round(m[:, :, c["col_j0"]] * cw[:, 0]))
    odd = _round(m[:, :, c["col_j1"]] * cw[:, 1])
    return (even + odd).to(torch.float32).to(torch.uint8)  # [N, 84, 84]


def observe(raw: torch.Tensor, prev_raw: torch.Tensor, stack: torch.Tensor) -> torch.Tensor:
    """The next stack: a 2-frame max with the previous step's raw frame,
    preprocess, shift the newest-last 4-stack."""
    frame = preprocess(torch.maximum(raw, prev_raw))
    return torch.cat([stack[..., 1:], frame[..., None]], dim=-1)


def reset_stack(raw0: torch.Tensor) -> torch.Tensor:
    """The stack right after a reset: zeros with the reset frame newest."""
    frame0 = preprocess(raw0)
    stack = torch.zeros(frame0.shape + (4,), dtype=torch.uint8, device=raw0.device)
    stack[..., -1] = frame0
    return stack


def make_pick(game_over: torch.Tensor):
    """-> pick(reset_val, cont_val): the auto-reset value in game-over
    slots, the mask broadcast over trailing dims."""
    n = game_over.shape[0]

    def pick(reset_val: torch.Tensor, cont_val: torch.Tensor) -> torch.Tensor:
        mask = game_over.reshape((n,) + (1,) * (cont_val.dim() - 1))
        return torch.where(mask, reset_val, cont_val)

    return pick
