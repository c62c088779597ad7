"""Breakout simulator: game dynamics at ALE specs, in numpy.

Copy of the JAX package's `envs/breakout_sim.py`. Its gymnasium
registration uses the `drl_torch/` namespace, so that the JAX package's
registrations in the same process stay its own.

Fidelity targets (vs ALE Breakout):
- 210x160x3 uint8 frames; gray walls, black background, the six brick
  rows in the 2600 row colors; paddle/ball in the red sprite color.
- Minimal action set NOOP/FIRE/RIGHT/LEFT (ALE `Breakout-v*` = 4
  actions), so the actor's 18-way `action % available_action` aliasing
  is exercised for real.
- FIRE launches the ball, 5 lives with `info["lives"]`, row scores
  1/1/4/4/7/7.
"""

from __future__ import annotations

from typing import Any

import numpy as np

# ALE Breakout palette (NTSC): row colors top->bottom, walls, sprites.
ROW_COLORS = (
    (200, 72, 72),    # red     (7 points)
    (198, 108, 58),   # orange  (7)
    (180, 122, 48),   # tan     (4)
    (162, 162, 42),   # yellow  (4)
    (72, 160, 72),    # green   (1)
    (66, 72, 200),    # blue    (1)
)
ROW_POINTS = (7, 7, 4, 4, 1, 1)
WALL = (142, 142, 142)
SPRITE = (200, 72, 72)

H, W = 210, 160
WALL_TOP = 32          # rows [WALL_TOP, WALL_TOP+4) are the top wall
WALL_SIDE = 8          # px of wall on each side
BRICK_TOP = 57         # first brick row's top scanline
BRICK_H = 6            # scanlines per brick row
BRICK_W = 8            # px per brick; (160 - 2*8)/8 = 18 bricks per row
PADDLE_Y = 189         # paddle top scanline
PADDLE_H = 4
PADDLE_W = 16
BALL_SIZE = 2

NOOP, FIRE, RIGHT, LEFT = 0, 1, 2, 3


class BreakoutCore:
    """Game state + renderer.

    `frameskip`: ALE's built-in action repeat — the action is applied for
    `frameskip` emulated frames, rewards sum, and the LAST frame is
    returned (exactly what a `*Deterministic-v4` registration does;
    `*NoFrameskip-v4` = 1). Serving a skip-1 game under a Deterministic
    name would make dynamics 4x slower per action than the real env this
    proxies, silently breaking configs the moment ale-py appears.
    """

    num_actions = 4

    def __init__(self, seed: int = 0, max_frames: int = 10_000, frameskip: int = 1):
        self._rng = np.random.RandomState(seed)
        self._max_frames = max_frames
        self.frameskip = max(1, frameskip)
        self._consume_reward = 0.0
        self.reset()

    def reset(self) -> np.ndarray:
        self.bricks = np.ones((6, 18), bool)
        self.lives = 5
        self.score = 0
        self.frames = 0
        self.paddle_x = (W - PADDLE_W) // 2
        self._ball_dead = True  # awaiting FIRE
        self.ball_x = 0.0
        self.ball_y = 0.0
        self.vx = 0.0
        self.vy = 0.0
        return self.render()

    def _launch(self) -> None:
        self.ball_x = float(self.paddle_x + PADDLE_W // 2)
        self.ball_y = float(PADDLE_Y - 8)
        self.vx = self._rng.choice([-2.0, -1.0, 1.0, 2.0])
        self.vy = -3.0
        self._ball_dead = False

    def step(self, action: int) -> tuple[np.ndarray, float, bool, dict[str, Any]]:
        if not 0 <= action < self.num_actions:
            # ALE raises on out-of-range actions; silently NOOP-ing here
            # would mask an action-space/config mismatch (e.g. an 18-way
            # head with available_action left at 18) that a real emulator
            # surfaces immediately.
            raise ValueError(
                f"action {action} outside Breakout's {self.num_actions}-action set "
                f"(alias the policy head with `action % available_action` first)")
        reward = 0.0
        done = False
        for _ in range(self.frameskip):  # action held for every skipped frame
            r, done = self._emulate_frame(action)
            reward += r
            if done:
                break
        return self.render(), reward, done, {"lives": self.lives}

    def _emulate_frame(self, action: int) -> tuple[float, bool]:
        """One emulated frame under a held action -> (reward, done)."""
        self.frames += 1
        reward = 0.0
        if action == RIGHT:
            self.paddle_x = min(W - WALL_SIDE - PADDLE_W, self.paddle_x + 4)
        elif action == LEFT:
            self.paddle_x = max(WALL_SIDE, self.paddle_x - 4)
        elif action == FIRE and self._ball_dead and self.lives > 0:
            self._launch()

        if not self._ball_dead:
            # Sub-stepping keeps the ball from tunnelling through a
            # 6-scanline brick row at 3+ px/frame.
            for _ in range(2):
                self.ball_x += self.vx / 2.0
                self.ball_y += self.vy / 2.0
                self._collide()
                reward += self._consume_reward
                self._consume_reward = 0.0
                if self._ball_dead:
                    break

        done = self.lives <= 0 or not self.bricks.any() or self.frames >= self._max_frames
        return reward, done

    def _collide(self) -> None:
        # Side walls.
        if self.ball_x <= WALL_SIDE:
            self.ball_x = float(WALL_SIDE)
            self.vx = abs(self.vx)
        elif self.ball_x >= W - WALL_SIDE - BALL_SIZE:
            self.ball_x = float(W - WALL_SIDE - BALL_SIZE)
            self.vx = -abs(self.vx)
        # Top wall.
        if self.ball_y <= WALL_TOP + 4:
            self.ball_y = float(WALL_TOP + 4)
            self.vy = abs(self.vy)
        # Bricks.
        row = int((self.ball_y - BRICK_TOP) // BRICK_H)
        if 0 <= row < 6:
            col = int((self.ball_x - WALL_SIDE) // BRICK_W)
            if 0 <= col < 18 and self.bricks[row, col]:
                self.bricks[row, col] = False
                self._consume_reward += float(ROW_POINTS[row])
                self.score += ROW_POINTS[row]
                self.vy = -self.vy
        # Paddle.
        if (self.vy > 0 and PADDLE_Y - BALL_SIZE <= self.ball_y <= PADDLE_Y + PADDLE_H
                and self.paddle_x - BALL_SIZE <= self.ball_x <= self.paddle_x + PADDLE_W):
            self.vy = -abs(self.vy)
            # Hit position steers the ball, like the real paddle.
            off = (self.ball_x + BALL_SIZE / 2 - self.paddle_x - PADDLE_W / 2) / (PADDLE_W / 2)
            self.vx = float(np.clip(self.vx + 2.0 * off, -3.0, 3.0))
            if abs(self.vx) < 0.5:
                self.vx = 0.5 if off >= 0 else -0.5
        # Bottom: life lost.
        if self.ball_y >= H - BALL_SIZE:
            self.lives -= 1
            self._ball_dead = True

    def render(self) -> np.ndarray:
        f = np.zeros((H, W, 3), np.uint8)
        # Walls.
        f[WALL_TOP:WALL_TOP + 4, :] = WALL
        f[WALL_TOP:, :WALL_SIDE] = WALL
        f[WALL_TOP:, W - WALL_SIDE:] = WALL
        # Score strip: blocky gray digits region (statistics, not glyphs —
        # the preprocessing crop removes it anyway, `wrappers.py:74`).
        score_blocks = min(12, self.score // 8)
        for b in range(score_blocks):
            f[6:18, 36 + 8 * b:42 + 8 * b] = WALL
        f[6:18, 16:22] = WALL  # lives indicator block
        # Bricks.
        for r in range(6):
            y = BRICK_TOP + r * BRICK_H
            cols = np.flatnonzero(self.bricks[r])
            for c in cols:
                x = WALL_SIDE + c * BRICK_W
                f[y:y + BRICK_H, x:x + BRICK_W] = ROW_COLORS[r]
        # Paddle.
        f[PADDLE_Y:PADDLE_Y + PADDLE_H, self.paddle_x:self.paddle_x + PADDLE_W] = SPRITE
        # Ball.
        if not self._ball_dead:
            y, x = int(self.ball_y), int(self.ball_x)
            f[y:y + BALL_SIZE, x:x + BALL_SIZE] = SPRITE
        return f


class BreakoutSimRaw:
    """`RawFrameEnv`-protocol surface over `BreakoutCore` (no gymnasium)."""

    def __init__(self, seed: int = 0, max_frames: int = 10_000, frameskip: int = 1):
        self._core = BreakoutCore(seed=seed, max_frames=max_frames,
                                  frameskip=frameskip)
        self.num_actions = BreakoutCore.num_actions

    def reset(self) -> np.ndarray:
        return self._core.reset()

    def step(self, action: int):
        return self._core.step(int(action))

    def lives(self) -> int:
        return self._core.lives


_GYM_REGISTERED = False


def register_gymnasium() -> bool:
    """Register `drl_torch/BreakoutSim-v0` with gymnasium (idempotent);
    returns whether the registration is usable. Routing the simulator
    through a real `gymnasium.make` means `GymnasiumRawFrames`, the
    adapter a real ALE install would use, is the code under test."""
    global _GYM_REGISTERED
    try:
        import gymnasium
        from gymnasium import spaces
    except ImportError:
        return False
    if _GYM_REGISTERED:
        return True

    class _GymBreakoutSim(gymnasium.Env):
        metadata = {"render_modes": []}

        def __init__(self, max_frames: int = 10_000, frameskip: int = 1):
            self._max_frames = max_frames
            self._frameskip = frameskip
            self._core: BreakoutCore | None = None
            self.action_space = spaces.Discrete(BreakoutCore.num_actions)
            self.observation_space = spaces.Box(0, 255, (H, W, 3), np.uint8)

        def reset(self, *, seed=None, options=None):
            super().reset(seed=seed)
            if self._core is None or seed is not None:
                self._core = BreakoutCore(seed=seed or 0, max_frames=self._max_frames,
                                          frameskip=self._frameskip)
            obs = self._core.reset()
            return obs, {"lives": self._core.lives}

        def step(self, action):
            obs, reward, done, info = self._core.step(int(action))
            return obs, reward, done, False, info

    # Mirror ALE's registrations: the Deterministic id bakes in the
    # emulator frameskip of 4, NoFrameskip/plain = 1.
    gymnasium.register(id="drl_torch/BreakoutSim-v0", entry_point=lambda **kw: _GymBreakoutSim(**kw))
    gymnasium.register(
        id="drl_torch/BreakoutSimDeterministic-v0",
        entry_point=lambda **kw: _GymBreakoutSim(**{"frameskip": 4, **kw}))
    _GYM_REGISTERED = True
    return True
