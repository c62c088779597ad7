"""Env registry: name -> constructor.

Counterpart of the JAX package's `envs/registry.py`, with its resolution
order:

- a factory registered with `register_env` always wins;
- `CartPole-v0` / `CartPole-v1` go through gymnasium when it imports,
  and through the in-tree numpy physics (200 / 500 step limit) under
  `DRL_NO_GYMNASIUM=1` or without gymnasium;
- Atari names (`*Deterministic-v4`, `*NoFrameskip-v4`) use gymnasium and
  `ale-py` when the emulator imports; otherwise `Breakout*`, `Pong*` and
  `SpaceInvaders*` fall back to the in-tree simulators (through the
  `GymnasiumRawFrames` adapter when gymnasium imports, else their raw
  classes), Breakout with fire-reset and the other two without it, and
  other titles to `SyntheticAtari` with `num_actions` actions. Each
  fallback says so on stderr once per name (`DRL_SYNTHETIC_ATARI=1`
  silences it). The Deterministic name means ALE's built-in frameskip
  of 4.
"""

from __future__ import annotations

import os
import re
import sys
from typing import Callable

from distributed_reinforcement_learning_tpu_torch.envs.atari import (
    AtariPreprocessor, SyntheticAtari)
from distributed_reinforcement_learning_tpu_torch.envs.base import Env
from distributed_reinforcement_learning_tpu_torch.envs.cartpole import CartPoleEnv

_REGISTRY: dict[str, Callable[..., Env]] = {}

_ATARI_PATTERN = re.compile(r".*(Deterministic|NoFrameskip)-v\d+$")
_warned_synthetic: set[str] = set()


def register_env(name: str, factory: Callable[..., Env]) -> None:
    _REGISTRY[name] = factory


def _use_gymnasium() -> bool:
    if os.environ.get("DRL_NO_GYMNASIUM", "0") == "1":
        return False
    from distributed_reinforcement_learning_tpu_torch.envs.gymnasium_env import (
        gymnasium_available)

    return gymnasium_available()


def _warn_once(name: str, what: str) -> None:
    if name not in _warned_synthetic and os.environ.get("DRL_SYNTHETIC_ATARI") != "1":
        _warned_synthetic.add(name)
        print(f"[envs] WARNING: no ALE emulator available; {name!r} resolves to {what}. "
              "Install ale-py for the real game.", file=sys.stderr)


def _sim_fallback(name: str, sim_mod, id_prefix: str, seed: int, fire_reset: bool,
                  raw_cls, game: str) -> Env:
    """The no-ALE fallback: warn once, then route through gymnasium's
    registration of the in-tree simulator (the `GymnasiumRawFrames`
    adapter an ale-py install would use) or its raw class."""
    _warn_once(name, f"the in-tree {game} simulator (real game dynamics, not the 2600 ROM)")
    skip = 4 if "Deterministic" in name else 1
    if _use_gymnasium() and sim_mod.register_gymnasium():
        from distributed_reinforcement_learning_tpu_torch.envs.gymnasium_env import (
            GymnasiumRawFrames)

        sim_name = f"drl_torch/{id_prefix}Deterministic-v0" if skip == 4 else \
            f"drl_torch/{id_prefix}-v0"
        return AtariPreprocessor(GymnasiumRawFrames(sim_name, seed=seed), fire_reset=fire_reset)
    return AtariPreprocessor(raw_cls(seed=seed, frameskip=skip), fire_reset=fire_reset)


def make_env(name: str, seed: int = 0, num_actions: int = 18) -> Env:
    if name in _REGISTRY:
        return _REGISTRY[name](seed=seed)
    if name in ("CartPole-v0", "CartPole-v1"):
        if _use_gymnasium():
            from distributed_reinforcement_learning_tpu_torch.envs.gymnasium_env import (
                GymnasiumEnv)

            return GymnasiumEnv(name, seed=seed)
        return CartPoleEnv(seed=seed, max_steps=200 if name.endswith("v0") else 500)
    if _ATARI_PATTERN.match(name):
        if _use_gymnasium():
            from distributed_reinforcement_learning_tpu_torch.envs.gymnasium_env import (
                GymnasiumRawFrames, ale_available)

            if ale_available():
                return AtariPreprocessor(GymnasiumRawFrames(name, seed=seed))
        if name.startswith("Breakout"):
            from distributed_reinforcement_learning_tpu_torch.envs import breakout_sim

            return _sim_fallback(name, breakout_sim, "BreakoutSim", seed, fire_reset=True,
                                 raw_cls=breakout_sim.BreakoutSimRaw, game="Breakout")
        if name.startswith("Pong"):
            from distributed_reinforcement_learning_tpu_torch.envs import pong_sim

            return _sim_fallback(name, pong_sim, "PongSim", seed, fire_reset=False,
                                 raw_cls=pong_sim.PongSimRaw, game="Pong")
        if name.startswith("SpaceInvaders"):
            from distributed_reinforcement_learning_tpu_torch.envs import invaders_sim

            return _sim_fallback(name, invaders_sim, "SpaceInvadersSim", seed,
                                 fire_reset=False, raw_cls=invaders_sim.InvadersSimRaw,
                                 game="Space-Invaders")
        _warn_once(name, "SyntheticAtari (random frames through the real preprocessing "
                         "pipeline)")
        return AtariPreprocessor(SyntheticAtari(num_actions=num_actions, seed=seed))
    raise ValueError(f"unknown env {name!r}; register a factory with register_env")
