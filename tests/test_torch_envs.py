"""The port's env registry and its Pong and SpaceInvaders simulators
against the JAX package's, on the CPU.

- Each simulator steps alongside its JAX twin from one seed under one
  seeded action stream: frames, rewards, dones and lives equal, raw and
  through `make_env` (the Atari preprocessing, the registry's wrapper).
- `make_env` resolves each name to the class the JAX registry picks,
  with gymnasium and under `DRL_NO_GYMNASIUM=1`, and the first frames of
  both agree.
"""

import numpy as np
import pytest

from distributed_reinforcement_learning_tpu.envs import invaders_sim as jax_invaders
from distributed_reinforcement_learning_tpu.envs import pong_sim as jax_pong
from distributed_reinforcement_learning_tpu.envs import registry as jax_registry
from distributed_reinforcement_learning_tpu_torch.envs import invaders_sim, pong_sim, registry
from distributed_reinforcement_learning_tpu_torch.envs.atari import SyntheticAtari

SIMS = {
    "pong": (pong_sim.PongSimRaw, jax_pong.PongSimRaw),
    "invaders": (invaders_sim.InvadersSimRaw, jax_invaders.InvadersSimRaw),
}
STEPS = 300


def _lockstep(mine, ref, num_actions: int, seed: int) -> int:
    """Step both envs under one action stream; -> episodes finished."""
    np.testing.assert_array_equal(mine.reset(), ref.reset())
    rng = np.random.RandomState(seed)
    ends = 0
    for t in range(STEPS):
        a = int(rng.randint(num_actions))
        got, want = mine.step(a), ref.step(a)
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"frame at step {t}")
        assert got[1:3] == want[1:3], t  # reward, done
        assert got[3].get("lives") == want[3].get("lives"), t
        if got[2]:
            ends += 1
            np.testing.assert_array_equal(mine.reset(), ref.reset())
    return ends


@pytest.mark.parametrize("frameskip", [1, 4])
@pytest.mark.parametrize("game", sorted(SIMS))
def test_sim_steps_as_its_jax_twin(game, frameskip):
    mine_cls, ref_cls = SIMS[game]
    mine = mine_cls(seed=3, frameskip=frameskip, max_frames=400)
    ref = ref_cls(seed=3, frameskip=frameskip, max_frames=400)
    assert mine.num_actions == ref.num_actions == 6
    _lockstep(mine, ref, 6, seed=frameskip)
    assert mine.lives() == ref.lives()


def test_synthetic_atari_matches_jax():
    from distributed_reinforcement_learning_tpu.envs.atari import SyntheticAtari as JaxSynth

    mine, ref = SyntheticAtari(num_actions=9, seed=5), JaxSynth(num_actions=9, seed=5)
    assert _lockstep(mine, ref, 9, seed=0) >= 0


NAMES = ["CartPole-v0", "CartPole-v1", "BreakoutDeterministic-v4", "PongDeterministic-v4",
         "PongNoFrameskip-v4", "SpaceInvadersDeterministic-v4", "AsterixDeterministic-v4"]


def _inner(env):
    """The class chain the registry built: the env, its raw frame source,
    and (through gymnasium) the simulator behind it."""
    chain = [type(env).__name__]
    raw = getattr(env, "env", None)
    if raw is not None:
        chain.append(type(raw).__name__)
        gym_env = getattr(raw, "_env", None)
        if gym_env is not None:
            chain.append(type(gym_env.unwrapped).__name__)
    return chain


@pytest.mark.parametrize("no_gym", ["0", "1"])
@pytest.mark.parametrize("name", NAMES)
def test_make_env_resolves_as_the_jax_registry(name, no_gym, monkeypatch):
    monkeypatch.setenv("DRL_NO_GYMNASIUM", no_gym)
    monkeypatch.setenv("DRL_SYNTHETIC_ATARI", "1")  # no stderr warning
    mine = registry.make_env(name, seed=2, num_actions=7)
    ref = jax_registry.make_env(name, seed=2, num_actions=7)
    assert _inner(mine) == _inner(ref)
    assert mine.num_actions == ref.num_actions
    np.testing.assert_array_equal(mine.reset(), ref.reset())
    rng = np.random.RandomState(4)
    for t in range(16):
        a = int(rng.randint(mine.num_actions))
        got, want = mine.step(a), ref.step(a)
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"{name} step {t}")
        assert got[1:3] == want[1:3], (name, t)
        if got[2]:
            np.testing.assert_array_equal(mine.reset(), ref.reset())


def test_register_env_wins_and_unknown_names_raise(monkeypatch):
    monkeypatch.setattr(registry, "_REGISTRY", {})
    registry.register_env("CartPole-v0", lambda seed: ("mine", seed))
    assert registry.make_env("CartPole-v0", seed=9) == ("mine", 9)
    with pytest.raises(ValueError, match="unknown env"):
        registry.make_env("NoSuchEnv-v0")
