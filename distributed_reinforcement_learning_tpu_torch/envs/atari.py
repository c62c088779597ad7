"""Atari preprocessing pipeline in pure numpy.

Copy of the JAX package's `envs/atari.py` (the reference's `wrappers.py`
behaviour without gym or cv2):

- `area_resize`: separable pixel-area-overlap downscale, the algorithm
  behind `cv2.resize(..., interpolation=cv2.INTER_AREA)`.
- `preprocess_frame`: luma 0.299/0.587/0.114, resize to 110x84, crop rows
  18:102 -> `[84, 84]` uint8.
- `AtariPreprocessor`: 2-frame max, fire-reset, 4-frame stacking to
  `[84, 84, 4]` uint8, life counter in `info`.
- `SyntheticAtari`: a `RawFrameEnv` of deterministic pseudo-frames with
  an ALE-style life counter, for the Atari titles no in-tree simulator
  plays.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any

import numpy as np

from distributed_reinforcement_learning_tpu_torch.envs.base import RawFrameEnv


@lru_cache(maxsize=16)
def _area_weights(src: int, dst: int) -> np.ndarray:
    """`[dst, src]` row-overlap weight matrix for 1-D area interpolation."""
    w = np.zeros((dst, src), np.float32)
    scale = src / dst
    for i in range(dst):
        start = i * scale
        end = (i + 1) * scale
        j0 = int(np.floor(start))
        j1 = int(np.ceil(end))
        for j in range(j0, min(j1, src)):
            overlap = min(end, j + 1) - max(start, j)
            w[i, j] = overlap / scale
    return w


def area_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Separable area-interpolation resize of a `[H, W]` float image."""
    wh = _area_weights(img.shape[0], out_h)
    ww = _area_weights(img.shape[1], out_w)
    return wh @ img @ ww.T


def preprocess_frame(frame: np.ndarray) -> np.ndarray:
    """RGB `[H, W, 3]` -> `[84, 84]` uint8: luma, area-resize 110x84, crop.

    Parity with `wrappers.py:63-74` (including the 250-row variant)."""
    if frame.shape[:2] not in ((210, 160), (250, 160)):
        raise ValueError(f"unexpected Atari frame shape {frame.shape}")
    img = frame.astype(np.float32)
    luma = img[:, :, 0] * 0.299 + img[:, :, 1] * 0.587 + img[:, :, 2] * 0.114
    resized = area_resize(luma, 110, 84)
    return resized[18:102, :].astype(np.uint8)


class AtariPreprocessor:
    """Stateful frame pipeline over any `RawFrameEnv`: the reference's
    `make_uint8_env` composition (`wrappers.py:123-131`).

    Emits `[84, 84, 4]` uint8 observations (4 newest-last stacked frames).
    """

    def __init__(self, env: RawFrameEnv, fire_reset: bool = True, frame_max: int = 2):
        self.env = env
        self.num_actions = env.num_actions
        self.obs_shape = (84, 84, 4)
        self._fire_reset = fire_reset
        self._frame_max = frame_max
        self._raw_buffer: list[np.ndarray] = []
        self._stack = np.zeros((84, 84, 4), np.uint8)

    def _observe(self, raw: np.ndarray) -> np.ndarray:
        self._raw_buffer.append(raw)
        if len(self._raw_buffer) > self._frame_max:
            self._raw_buffer.pop(0)
        maxed = np.max(np.stack(self._raw_buffer), axis=0)
        frame = preprocess_frame(maxed)
        self._stack[:, :, :-1] = self._stack[:, :, 1:]
        self._stack[:, :, -1] = frame
        return self._stack.copy()

    def reset(self) -> np.ndarray:
        self._raw_buffer.clear()
        self._stack[:] = 0
        raw = self.env.reset()
        if self._fire_reset and self.env.num_actions >= 3:
            # FIRE then a second action to unstick, like `wrappers.py:16-23`.
            raw, _, done, _ = self.env.step(1)
            if done:
                raw = self.env.reset()
            raw, _, done, _ = self.env.step(2)
            if done:
                raw = self.env.reset()
        return self._observe(raw)

    def step(self, action: int) -> tuple[np.ndarray, float, bool, dict[str, Any]]:
        raw, reward, done, info = self.env.step(action)
        info = dict(info)
        info.setdefault("lives", self.env.lives())
        return self._observe(raw), reward, done, info

    def lives(self) -> int:
        return self.env.lives()


class SyntheticAtari:
    """Deterministic pseudo-Atari `RawFrameEnv` for tests and benchmarks.

    Produces 210x160x3 uint8 frames from a cheap per-step pattern, a
    5-life counter that decrements on a fixed cadence, and +1 reward on a
    fixed cadence. No emulator, no I/O: designed so the preprocessing +
    data-plane + learner path can be driven at full speed.
    """

    def __init__(self, num_actions: int = 18, seed: int = 0, episode_len: int = 512,
                 life_every: int = 128, reward_every: int = 16):
        self.num_actions = num_actions
        self._seed = seed
        self._episode_len = episode_len
        self._life_every = life_every
        self._reward_every = reward_every
        self._t = 0
        self._lives = 5
        self._base = np.random.RandomState(seed).randint(0, 255, (210, 160, 3)).astype(np.uint8)

    def _frame(self) -> np.ndarray:
        # Cheap deterministic variation: roll the base pattern by step count.
        return np.roll(self._base, self._t * 3, axis=0)

    def reset(self) -> np.ndarray:
        self._t = 0
        self._lives = 5
        return self._frame()

    def step(self, action: int):
        self._t += 1
        if self._t % self._life_every == 0 and self._lives > 0:
            self._lives -= 1
        reward = 1.0 if self._t % self._reward_every == 0 else 0.0
        done = self._t >= self._episode_len or self._lives == 0
        return self._frame(), reward, done, {"lives": self._lives}

    def lives(self) -> int:
        return self._lives
