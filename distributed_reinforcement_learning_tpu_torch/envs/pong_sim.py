"""Pong simulator: game dynamics at ALE specs, in numpy.

Copy of the JAX package's `envs/pong_sim.py`. A faithful implementation
of the game at Atari specs (not the 2600 ROM), exercising what Breakout
cannot:

- a different minimal action set (6: NOOP/FIRE/RIGHT/LEFT/RIGHTFIRE/
  LEFTFIRE, ALE Pong's, where RIGHT=up and LEFT=down), driving the
  per-task `env` / `available_action` lists of a config section and the
  actor's `action % available_action` aliasing;
- negative rewards (-1 when the agent's side is scored on);
- the no-fire-reset wrapper path: the registry adapts Pong with
  `fire_reset=False`; serves happen on FIRE or auto-serve, like the ROM;
- no lives: `info["lives"]` is always 0, so life-loss shaping must
  no-op.

Fidelity targets (vs ALE Pong):
- 210x160x3 uint8 frames in the ALE Pong palette: brown background
  (144, 72, 17), white bounds/ball (236, 236, 236), orange enemy paddle
  (213, 130, 74) on the left, green agent paddle (92, 186, 92) on the
  right; a blocky score strip that the preprocessing crop removes.
- Playfield rows [34, 194): paddles 4x16 at x=16/x=140, ball 2x4,
  rally speed-up, hit-offset deflection, first to 21 ends the episode.
- `*Deterministic` registration = frameskip 4, like ALE's.

`register_gymnasium` registers `drl_torch/PongSim-v0` (+`Deterministic`)
so that the `GymnasiumRawFrames` adapter, the code path a real ALE
install would use, is what the registry drives; the `drl_torch/`
namespace keeps the JAX package's registrations in the same process its
own.
"""

from __future__ import annotations

from typing import Any

import numpy as np

# ALE Pong palette (NTSC).
BACKGROUND = (144, 72, 17)
BOUNDS = (236, 236, 236)      # top/bottom bounds, ball, score glyphs
ENEMY = (213, 130, 74)        # left (computer) paddle
PLAYER = (92, 186, 92)        # right (agent) paddle

H, W = 210, 160
FIELD_TOP = 34                # first playfield scanline (score strip above)
FIELD_BOT = 194               # one past the last playfield scanline
BOUND_H = 10                  # white strips: [24, 34) and [194, 204)
PADDLE_H = 16
PADDLE_W = 4
ENEMY_X = 16
PLAYER_X = 140
BALL_W, BALL_H = 2, 4
WIN_SCORE = 21
SERVE_DELAY = 36              # emulated frames before auto-serve

NOOP, FIRE, RIGHT, LEFT, RIGHTFIRE, LEFTFIRE = range(6)
_UP_ACTIONS = (RIGHT, RIGHTFIRE)      # ALE Pong: RIGHT moves the paddle up
_DOWN_ACTIONS = (LEFT, LEFTFIRE)
_FIRE_ACTIONS = (FIRE, RIGHTFIRE, LEFTFIRE)


class PongCore:
    """Game state + renderer.

    `frameskip` follows ALE's built-in action repeat (see
    `breakout_sim.BreakoutCore` for why Deterministic names must bake
    skip=4 into the sim rather than serving skip-1 dynamics).
    """

    num_actions = 6

    def __init__(self, seed: int = 0, max_frames: int = 20_000, frameskip: int = 1):
        self._rng = np.random.RandomState(seed)
        self._max_frames = max_frames
        self.frameskip = max(1, frameskip)
        self.reset()

    def reset(self) -> np.ndarray:
        self.player_score = 0
        self.enemy_score = 0
        self.frames = 0
        self.player_y = (FIELD_TOP + FIELD_BOT - PADDLE_H) // 2
        self.enemy_y = self.player_y
        self._ball_dead = True
        self._serve_timer = SERVE_DELAY
        self._serve_dir = 1.0  # toward the agent first, like the ROM
        self._rally = 0
        self.ball_x = 0.0
        self.ball_y = 0.0
        self.vx = 0.0
        self.vy = 0.0
        return self.render()

    def _serve(self) -> None:
        self.ball_x = float(W // 2)
        self.ball_y = float(self._rng.randint(FIELD_TOP + 20, FIELD_BOT - 20))
        self.vx = 2.0 * self._serve_dir
        self.vy = float(self._rng.choice([-1.0, -0.5, 0.5, 1.0]))
        self._rally = 0
        self._ball_dead = False

    def step(self, action: int) -> tuple[np.ndarray, float, bool, dict[str, Any]]:
        if not 0 <= action < self.num_actions:
            # ALE raises on out-of-range actions (see breakout_sim.step).
            raise ValueError(
                f"action {action} outside Pong's {self.num_actions}-action set "
                f"(alias the policy head with `action % available_action` first)")
        reward = 0.0
        done = False
        for _ in range(self.frameskip):  # action held for every skipped frame
            r, done = self._emulate_frame(action)
            reward += r
            if done:
                break
        # ALE reports lives=0 for Pong throughout: scoring is the reward
        # channel, not a life counter — shaping must no-op on this.
        return self.render(), reward, done, {"lives": 0}

    def _emulate_frame(self, action: int) -> tuple[float, bool]:
        self.frames += 1
        reward = 0.0

        # Agent paddle (right). 2600 paddle speed ~2px/frame.
        if action in _UP_ACTIONS:
            self.player_y = max(FIELD_TOP, self.player_y - 2)
        elif action in _DOWN_ACTIONS:
            self.player_y = min(FIELD_BOT - PADDLE_H, self.player_y + 2)

        # Serve: FIRE serves immediately; otherwise auto-serve when the
        # timer runs out (the ROM serves on its own after a beat).
        if self._ball_dead:
            self._serve_timer -= 1
            if action in _FIRE_ACTIONS or self._serve_timer <= 0:
                self._serve()

        # Computer paddle (left): tracks the ball with capped speed and a
        # dead zone — beatable by steering the ball off the paddle edge,
        # like the ROM's AI, not a perfect wall.
        if not self._ball_dead and self.vx < 0:
            target = self.ball_y + BALL_H / 2 - PADDLE_H / 2
            diff = target - self.enemy_y
            if abs(diff) > 3:
                self.enemy_y += int(np.clip(diff, -2, 2))
        self.enemy_y = int(np.clip(self.enemy_y, FIELD_TOP, FIELD_BOT - PADDLE_H))

        if not self._ball_dead:
            # Sub-step so the ball cannot tunnel a 4px paddle at speed 3+.
            for _ in range(2):
                self.ball_x += self.vx / 2.0
                self.ball_y += self.vy / 2.0
                r = self._collide()
                reward += r
                if self._ball_dead:
                    break

        done = (self.player_score >= WIN_SCORE or self.enemy_score >= WIN_SCORE
                or self.frames >= self._max_frames)
        return reward, done

    def _deflect(self, paddle_y: int) -> None:
        """Hit position steers vy; rallies speed the ball up, like the ROM."""
        off = (self.ball_y + BALL_H / 2 - paddle_y - PADDLE_H / 2) / (PADDLE_H / 2)
        self.vy = float(np.clip(self.vy + 1.5 * off, -3.0, 3.0))
        self._rally += 1
        speed = min(2.0 + 0.25 * self._rally, 3.5)
        self.vx = speed if self.vx < 0 else -speed  # reverse + speed-up

    def _collide(self) -> float:
        # Top/bottom bounds.
        if self.ball_y <= FIELD_TOP:
            self.ball_y = float(FIELD_TOP)
            self.vy = abs(self.vy)
        elif self.ball_y >= FIELD_BOT - BALL_H:
            self.ball_y = float(FIELD_BOT - BALL_H)
            self.vy = -abs(self.vy)
        # Agent paddle (right): only when moving toward it.
        if (self.vx > 0 and PLAYER_X - BALL_W <= self.ball_x <= PLAYER_X + PADDLE_W
                and self.player_y - BALL_H <= self.ball_y <= self.player_y + PADDLE_H):
            self.ball_x = float(PLAYER_X - BALL_W)
            self._deflect(self.player_y)
        # Enemy paddle (left).
        if (self.vx < 0 and ENEMY_X - BALL_W <= self.ball_x <= ENEMY_X + PADDLE_W
                and self.enemy_y - BALL_H <= self.ball_y <= self.enemy_y + PADDLE_H):
            self.ball_x = float(ENEMY_X + PADDLE_W)
            self._deflect(self.enemy_y)
        # Scoring: ball crosses either edge. The agent owns the RIGHT
        # side, so right-edge = scored on (-1), left-edge = scored (+1);
        # the signed reward is the point of this env (soft_asymmetric).
        if self.ball_x >= W - BALL_W:
            self.enemy_score += 1
            self._point_over(serve_dir=1.0)  # loser receives the serve
            return -1.0
        if self.ball_x <= 0:
            self.player_score += 1
            self._point_over(serve_dir=-1.0)
            return 1.0
        return 0.0

    def _point_over(self, serve_dir: float) -> None:
        self._ball_dead = True
        self._serve_timer = SERVE_DELAY
        self._serve_dir = serve_dir

    def render(self) -> np.ndarray:
        f = np.empty((H, W, 3), np.uint8)
        f[:] = BACKGROUND
        # Bounds strips.
        f[FIELD_TOP - BOUND_H:FIELD_TOP, :] = BOUNDS
        f[FIELD_BOT:FIELD_BOT + BOUND_H, :] = BOUNDS
        # Score strip: blocky glyph regions (statistics, not digits — the
        # preprocessing crop removes rows [0, 34), the reference wrappers).
        for b in range(min(10, self.enemy_score)):
            f[6:18, 16 + 4 * b:18 + 4 * b] = ENEMY
        for b in range(min(10, self.player_score)):
            f[6:18, 96 + 4 * b:98 + 4 * b] = PLAYER
        # Paddles.
        f[self.enemy_y:self.enemy_y + PADDLE_H, ENEMY_X:ENEMY_X + PADDLE_W] = ENEMY
        f[self.player_y:self.player_y + PADDLE_H,
          PLAYER_X:PLAYER_X + PADDLE_W] = PLAYER
        # Ball.
        if not self._ball_dead:
            y = int(np.clip(self.ball_y, FIELD_TOP, FIELD_BOT - BALL_H))
            x = int(np.clip(self.ball_x, 0, W - BALL_W))
            f[y:y + BALL_H, x:x + BALL_W] = BOUNDS
        return f


class PongSimRaw:
    """`RawFrameEnv`-protocol surface over `PongCore` (no gymnasium)."""

    def __init__(self, seed: int = 0, max_frames: int = 20_000, frameskip: int = 1):
        self._core = PongCore(seed=seed, max_frames=max_frames,
                              frameskip=frameskip)
        self.num_actions = PongCore.num_actions

    def reset(self) -> np.ndarray:
        return self._core.reset()

    def step(self, action: int):
        return self._core.step(int(action))

    def lives(self) -> int:
        return 0


_GYM_REGISTERED = False


def register_gymnasium() -> bool:
    """Register `PongSim-v0` with gymnasium (idempotent); mirrors
    `breakout_sim.register_gymnasium` so the same real-adapter path is
    under test."""
    global _GYM_REGISTERED
    try:
        import gymnasium
        from gymnasium import spaces
    except ImportError:
        return False
    if _GYM_REGISTERED:
        return True

    class _GymPongSim(gymnasium.Env):
        metadata = {"render_modes": []}

        def __init__(self, max_frames: int = 20_000, frameskip: int = 1):
            self._max_frames = max_frames
            self._frameskip = frameskip
            self._core: PongCore | None = None
            self.action_space = spaces.Discrete(PongCore.num_actions)
            self.observation_space = spaces.Box(0, 255, (H, W, 3), np.uint8)

        def reset(self, *, seed=None, options=None):
            super().reset(seed=seed)
            if self._core is None or seed is not None:
                self._core = PongCore(seed=seed or 0, max_frames=self._max_frames,
                                      frameskip=self._frameskip)
            obs = self._core.reset()
            return obs, {"lives": 0}

        def step(self, action):
            obs, reward, done, info = self._core.step(int(action))
            return obs, reward, done, False, info

    gymnasium.register(id="drl_torch/PongSim-v0", entry_point=lambda **kw: _GymPongSim(**kw))
    gymnasium.register(
        id="drl_torch/PongSimDeterministic-v0",
        entry_point=lambda **kw: _GymPongSim(**{"frameskip": 4, **kw}))
    _GYM_REGISTERED = True
    return True
