"""Gymnasium adapter: third-party envs behind the port's env seams.

Copy of the JAX package's `envs/gymnasium_env.py`. `GymnasiumEnv` adapts
any gymnasium env to the `Env` protocol, and `GymnasiumRawFrames` adapts
an ALE-style RGB env to the `RawFrameEnv` protocol so the in-tree Atari
preprocessing pipeline (`envs/atari.py`) runs over it. Gymnasium is
imported only when an adapter is built.

Differences from the in-tree envs the adapter papers over:
- gymnasium's 5-tuple step (`terminated`/`truncated`) is collapsed to a
  single `done` flag (either ends the episode), with `truncated` in
  `info`;
- `reset()` returns `(obs, info)` in gymnasium; the info is dropped;
- ALE life counters surface through `info["lives"]` / `.lives()` for
  life-loss shaping.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def gymnasium_available() -> bool:
    try:
        import gymnasium  # noqa: F401

        return True
    except ImportError:
        return False


def ale_available() -> bool:
    """True when gymnasium can actually construct Atari envs."""
    try:
        import ale_py  # noqa: F401

        return True
    except ImportError:
        return False


class GymnasiumEnv:
    """`Env`-protocol adapter over `gymnasium.make(name)`."""

    def __init__(self, name: str, seed: int | None = None, **make_kwargs: Any):
        import gymnasium

        self._env = gymnasium.make(name, **make_kwargs)
        self._seed = seed
        self._first_reset = True
        self.num_actions = int(self._env.action_space.n)
        space_shape = getattr(self._env.observation_space, "shape", None)
        self.obs_shape = tuple(space_shape) if space_shape else None

    def reset(self) -> np.ndarray:
        # Seed once on the first reset (gymnasium's seeding surface), then
        # let the env's own RNG evolve like gym's usage.
        if self._first_reset:
            obs, _ = self._env.reset(seed=self._seed)
            self._first_reset = False
        else:
            obs, _ = self._env.reset()
        return np.asarray(obs, dtype=np.float32 if np.asarray(obs).dtype != np.uint8 else np.uint8)

    def step(self, action: int) -> tuple[np.ndarray, float, bool, dict[str, Any]]:
        obs, reward, terminated, truncated, info = self._env.step(int(action))
        obs = np.asarray(obs)
        if obs.dtype != np.uint8:
            obs = obs.astype(np.float32)
        done = bool(terminated or truncated)
        out_info: dict[str, Any] = {"truncated": bool(truncated and not terminated)}
        if "lives" in info:
            out_info["lives"] = int(info["lives"])
        return obs, float(reward), done, out_info

    def close(self) -> None:
        self._env.close()


class GymnasiumRawFrames:
    """`RawFrameEnv`-protocol adapter: raw RGB frames + ALE life counter.

    Wraps `gymnasium.make(name)` for an Atari name (needs `ale-py`). The
    in-tree `AtariPreprocessor` then applies the pipeline (2-frame max,
    luma, area resize, crop, 4-stack) on top, as it does over
    `SyntheticAtari`.
    """

    def __init__(self, name: str, seed: int | None = None):
        import gymnasium

        # The name encodes the emulator frameskip (`*Deterministic-v4` =
        # built-in skip 4, `*NoFrameskip-v4` = skip 1); the preprocessing
        # adds only a 2-frame max over the post-skip frames, so take the
        # registration's native frameskip unmodified.
        self._env = gymnasium.make(name)
        self._seed = seed
        self._first_reset = True
        self.num_actions = int(self._env.action_space.n)
        self._lives = 0

    def reset(self) -> np.ndarray:
        if self._first_reset:
            obs, info = self._env.reset(seed=self._seed)
            self._first_reset = False
        else:
            obs, info = self._env.reset()
        self._lives = int(info.get("lives", 0))
        return np.asarray(obs, np.uint8)

    def step(self, action: int) -> tuple[np.ndarray, float, bool, dict[str, Any]]:
        obs, reward, terminated, truncated, info = self._env.step(int(action))
        self._lives = int(info.get("lives", self._lives))
        return (
            np.asarray(obs, np.uint8),
            float(reward),
            bool(terminated or truncated),
            {"lives": self._lives},
        )

    def lives(self) -> int:
        return self._lives

    def close(self) -> None:
        self._env.close()
