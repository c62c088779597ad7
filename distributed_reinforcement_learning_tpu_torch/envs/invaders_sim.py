"""Space-Invaders simulator: game dynamics at ALE specs, in numpy.

Copy of the JAX package's `envs/invaders_sim.py`. Like `breakout_sim.py`
and `pong_sim.py` it is a faithful implementation at Atari specs (not the
2600 ROM), with a structurally different objective: a marching 6x6 alien
grid that speeds up as it thins, enemy bombs the player must dodge,
destructible shields, combined move+fire actions, and lives that matter
mid-episode (a bomb hit costs a life and respawns the cannon with the
wave still descending).

Fidelity targets (vs ALE SpaceInvaders):
- 210x160x3 uint8 frames; black background, row-tinted alien sprites,
  green cannon/shields, white projectiles; a score strip that the
  preprocessing crop removes.
- Minimal action set NOOP/FIRE/RIGHT/LEFT/RIGHTFIRE/LEFTFIRE (ALE
  `SpaceInvaders-v*` = 6 actions).
- Row scores 30/25/20/15/10/5 top->bottom (the 2600's values), one
  player missile in flight at a time, up to 2 alien bombs, 3 lives with
  `info["lives"]`.
- Wave clear respawns the grid one step lower and faster; game over
  when lives run out or the grid reaches the cannon row.

Deliberate simplifications: aliens are solid 8x6 blocks (no per-frame
sprite animation), shields are solid blocks that shrink as they erode
(hit points, not per-pixel damage), and there is no mystery ship.

`register_gymnasium` registers `drl_torch/SpaceInvadersSim-v0`
(+`Deterministic`) so that the `GymnasiumRawFrames` adapter is the code
path under test, as for the other two games.
"""

from __future__ import annotations

from typing import Any

import numpy as np

H, W = 210, 160

# Alien grid geometry: 6 rows x 6 cols of 8x6 sprites on a 16x12 pitch.
ROWS, COLS = 6, 6
ALIEN_W, ALIEN_H = 8, 6
PITCH_X, PITCH_Y = 16, 12
GRID_SPAN = (COLS - 1) * PITCH_X + ALIEN_W  # 88 px
GRID_X0 = 20.0          # spawn offset (left edge of the grid)
GRID_Y0 = 40.0
GRID_X_MIN, GRID_X_MAX = 8.0, float(W - 8 - GRID_SPAN)
ROW_POINTS = (30, 25, 20, 15, 10, 5)  # top row is worth most (2600 values)

CANNON_Y = 185          # cannon top scanline
CANNON_W, CANNON_H = 8, 8
CANNON_SPEED = 2
MISSILE_SPEED = 4.0     # player shot, px/frame upward
BOMB_SPEED = 2.0        # alien bomb, px/frame downward
MAX_BOMBS = 2
SHIELD_Y = 157          # shield top scanline
SHIELD_W, SHIELD_H = 16, 10
SHIELD_HP = 8
SHIELD_XS = (28, 76, 124)
PROJ_W, PROJ_H = 2, 6   # missile/bomb sprite

ALIEN_ROW_COLORS = (
    (180, 122, 48),   # top rows tan
    (180, 122, 48),
    (162, 162, 42),   # middle yellow
    (162, 162, 42),
    (72, 160, 72),    # bottom green
    (72, 160, 72),
)
CANNON_RGB = (50, 132, 50)
SHIELD_RGB = (72, 160, 72)
PROJ_RGB = (228, 228, 228)
WALL = (142, 142, 142)

NOOP, FIRE, RIGHT, LEFT, RIGHTFIRE, LEFTFIRE = 0, 1, 2, 3, 4, 5
WALL_TOP_Y = 20  # missiles vanish above this scanline


def march_period(alive: int) -> int:
    """Frames between grid steps — the thinning grid speeds up (36
    aliens: every 8 frames; last alien: every frame)."""
    return 1 + (7 * alive) // (ROWS * COLS)


class InvadersCore:
    """Game state + renderer (`BreakoutCore` conventions: frameskip holds
    the action, rewards sum, last frame returned)."""

    num_actions = 6

    def __init__(self, seed: int = 0, max_frames: int = 10_000, frameskip: int = 1):
        self._rng = np.random.RandomState(seed)
        self._max_frames = max_frames
        self.frameskip = max(1, frameskip)
        self.reset()

    def reset(self) -> np.ndarray:
        self.aliens = np.ones((ROWS, COLS), bool)
        self.grid_x = GRID_X0
        self.grid_y = GRID_Y0
        self.direction = 1
        self.march_count = 0
        self.wave = 0
        self.cannon_x = float((W - CANNON_W) // 2)
        self.missile_live = False
        self.missile_x = 0.0
        self.missile_y = 0.0
        self.bomb_live = np.zeros(MAX_BOMBS, bool)
        self.bomb_x = np.zeros(MAX_BOMBS)
        self.bomb_y = np.zeros(MAX_BOMBS)
        self.shield_hp = np.full(len(SHIELD_XS), SHIELD_HP)
        self.lives = 3
        self.score = 0
        self.frames = 0
        return self.render()

    def step(self, action: int) -> tuple[np.ndarray, float, bool, dict[str, Any]]:
        if not 0 <= action < self.num_actions:
            raise ValueError(
                f"action {action} outside SpaceInvaders' {self.num_actions}-action "
                "set (alias the policy head with `action % available_action` first)")
        reward = 0.0
        done = False
        for _ in range(self.frameskip):
            r, done = self._emulate_frame(action)
            reward += r
            if done:
                break
        return self.render(), reward, done, {"lives": self.lives}

    # -- one emulated frame ---------------------------------------------
    def _emulate_frame(self, action: int) -> tuple[float, bool]:
        self.frames += 1
        reward = 0.0

        # Cannon move + fire (combined actions do both).
        if action in (RIGHT, RIGHTFIRE):
            self.cannon_x = min(float(W - 8 - CANNON_W), self.cannon_x + CANNON_SPEED)
        elif action in (LEFT, LEFTFIRE):
            self.cannon_x = max(8.0, self.cannon_x - CANNON_SPEED)
        if action in (FIRE, RIGHTFIRE, LEFTFIRE) and not self.missile_live:
            self.missile_live = True
            self.missile_x = self.cannon_x + CANNON_W / 2 - PROJ_W / 2
            self.missile_y = float(CANNON_Y - PROJ_H)

        # Grid march: step every march_period(alive) frames; drop a row
        # and flip direction at the walls.
        alive = int(self.aliens.sum())
        self.march_count += 1
        if alive > 0 and self.march_count >= march_period(alive):
            self.march_count = 0
            nx = self.grid_x + self.direction * 2.0
            if nx < GRID_X_MIN or nx > GRID_X_MAX:
                self.direction = -self.direction
                self.grid_y += PITCH_Y // 2
            else:
                self.grid_x = nx

        # Alien bombs: lowest alive alien of a random column drops one.
        if alive > 0 and self._rng.random() < 0.04:
            slot = int(np.argmin(self.bomb_live))  # first free slot, if any
            if not self.bomb_live[slot]:
                cols = np.flatnonzero(self.aliens.any(axis=0))
                col = int(self._rng.choice(cols))
                row = int(np.max(np.flatnonzero(self.aliens[:, col])))
                self.bomb_live[slot] = True
                self.bomb_x[slot] = (self.grid_x + col * PITCH_X
                                     + ALIEN_W / 2 - PROJ_W / 2)
                self.bomb_y[slot] = self.grid_y + row * PITCH_Y + ALIEN_H

        # Player missile flight + hits.
        if self.missile_live:
            self.missile_y -= MISSILE_SPEED
            reward += self._missile_collide()
            if self.missile_y < WALL_TOP_Y:
                self.missile_live = False

        # Bombs fall; erode shields; hit the cannon.
        for b in range(MAX_BOMBS):
            if not self.bomb_live[b]:
                continue
            self.bomb_y[b] += BOMB_SPEED
            if self._shield_absorb(self.bomb_x[b], self.bomb_y[b] + PROJ_H):
                self.bomb_live[b] = False
            elif (self.bomb_y[b] + PROJ_H >= CANNON_Y
                  and self.cannon_x - PROJ_W <= self.bomb_x[b]
                  <= self.cannon_x + CANNON_W):
                self.bomb_live[b] = False
                self.lives -= 1
                # Cannon respawns centered; in-flight bombs clear (the
                # 2600's brief respawn invulnerability, simplified).
                self.bomb_live[:] = False
                self.cannon_x = float((W - CANNON_W) // 2)
                break
            elif self.bomb_y[b] >= H:
                self.bomb_live[b] = False

        # Wave cleared: next wave spawns lower and the march starts
        # faster (the 2600's escalation).
        if not self.aliens.any():
            self.wave += 1
            self.aliens[:] = True
            self.grid_x = GRID_X0
            self.grid_y = GRID_Y0 + min(3, self.wave) * (PITCH_Y // 2)
            self.direction = 1
            self.march_count = 0

        landed = (self.grid_y + (ROWS - 1) * PITCH_Y + ALIEN_H >= SHIELD_Y
                  and self.aliens.any())
        done = self.lives <= 0 or landed or self.frames >= self._max_frames
        return reward, done

    def _missile_collide(self) -> float:
        """Missile vs shields, then the alien grid (one kill per frame)."""
        if self._shield_absorb(self.missile_x, self.missile_y):
            self.missile_live = False
            return 0.0
        # Bombs: a missile can shoot a bomb down (both vanish, no score).
        for b in range(MAX_BOMBS):
            if (self.bomb_live[b]
                    and abs(self.bomb_x[b] - self.missile_x) < PROJ_W + 1
                    and abs(self.bomb_y[b] - self.missile_y) < PROJ_H):
                self.bomb_live[b] = False
                self.missile_live = False
                return 0.0
        col = int((self.missile_x + PROJ_W / 2 - self.grid_x) // PITCH_X)
        row = int((self.missile_y - self.grid_y) // PITCH_Y)
        if 0 <= row < ROWS and 0 <= col < COLS and self.aliens[row, col]:
            # Inside the 8-px sprite (the pitch leaves 8-px gaps)?
            within = (self.missile_x + PROJ_W / 2
                      - (self.grid_x + col * PITCH_X)) < ALIEN_W
            tall = (self.missile_y - (self.grid_y + row * PITCH_Y)) < ALIEN_H
            if within and tall:
                self.aliens[row, col] = False
                self.missile_live = False
                self.score += ROW_POINTS[row]
                return float(ROW_POINTS[row])
        return 0.0

    def _shield_absorb(self, x: float, y: float) -> bool:
        """Projectile tip at (x, y) vs the shrinking shield blocks."""
        for s, sx in enumerate(SHIELD_XS):
            if self.shield_hp[s] <= 0:
                continue
            height = SHIELD_H * self.shield_hp[s] // SHIELD_HP
            if (sx <= x + PROJ_W / 2 <= sx + SHIELD_W
                    and SHIELD_Y <= y <= SHIELD_Y + height):
                self.shield_hp[s] -= 1
                return True
        return False

    # -- rendering -------------------------------------------------------
    def render(self) -> np.ndarray:
        f = np.zeros((H, W, 3), np.uint8)
        # Score strip blocks (cropped by preprocessing, like breakout_sim).
        score_blocks = min(12, self.score // 40)
        for b in range(score_blocks):
            f[6:18, 36 + 8 * b:42 + 8 * b] = WALL
        f[6:18, 16:22] = WALL  # lives indicator block
        # Ground line.
        f[H - 4:H - 2, :] = CANNON_RGB
        # Aliens.
        gy = int(self.grid_y)
        gx = int(self.grid_x)
        for r in range(ROWS):
            y = gy + r * PITCH_Y
            for c in np.flatnonzero(self.aliens[r]):
                x = gx + int(c) * PITCH_X
                f[y:y + ALIEN_H, x:x + ALIEN_W] = ALIEN_ROW_COLORS[r]
        # Shields (height erodes with hp).
        for s, sx in enumerate(SHIELD_XS):
            if self.shield_hp[s] > 0:
                height = SHIELD_H * self.shield_hp[s] // SHIELD_HP
                f[SHIELD_Y:SHIELD_Y + height, sx:sx + SHIELD_W] = SHIELD_RGB
        # Cannon.
        cx = int(self.cannon_x)
        f[CANNON_Y:CANNON_Y + CANNON_H, cx:cx + CANNON_W] = CANNON_RGB
        # Projectiles.
        if self.missile_live:
            y, x = int(self.missile_y), int(self.missile_x)
            f[max(y, 0):max(y, 0) + PROJ_H, x:x + PROJ_W] = PROJ_RGB
        for b in range(MAX_BOMBS):
            if self.bomb_live[b]:
                y, x = int(self.bomb_y[b]), int(self.bomb_x[b])
                f[y:min(y + PROJ_H, H), x:x + PROJ_W] = PROJ_RGB
        return f


class InvadersSimRaw:
    """`RawFrameEnv`-protocol surface over `InvadersCore` (no gymnasium)."""

    def __init__(self, seed: int = 0, max_frames: int = 10_000, frameskip: int = 1):
        self._core = InvadersCore(seed=seed, max_frames=max_frames,
                                  frameskip=frameskip)
        self.num_actions = InvadersCore.num_actions

    def reset(self) -> np.ndarray:
        return self._core.reset()

    def step(self, action: int):
        return self._core.step(int(action))

    def lives(self) -> int:
        return self._core.lives


_GYM_REGISTERED = False


def register_gymnasium() -> bool:
    """Register `SpaceInvadersSim-v0` with gymnasium (idempotent), like
    `breakout_sim.register_gymnasium`."""
    global _GYM_REGISTERED
    try:
        import gymnasium
        from gymnasium import spaces
    except ImportError:
        return False
    if _GYM_REGISTERED:
        return True

    class _GymInvadersSim(gymnasium.Env):
        metadata = {"render_modes": []}

        def __init__(self, max_frames: int = 10_000, frameskip: int = 1):
            self._max_frames = max_frames
            self._frameskip = frameskip
            self._core: InvadersCore | None = None
            self.action_space = spaces.Discrete(InvadersCore.num_actions)
            self.observation_space = spaces.Box(0, 255, (H, W, 3), np.uint8)

        def reset(self, *, seed=None, options=None):
            super().reset(seed=seed)
            if self._core is None or seed is not None:
                self._core = InvadersCore(seed=seed or 0,
                                          max_frames=self._max_frames,
                                          frameskip=self._frameskip)
            obs = self._core.reset()
            return obs, {"lives": self._core.lives}

        def step(self, action):
            obs, reward, done, info = self._core.step(int(action))
            return obs, reward, done, False, info

    gymnasium.register(id="drl_torch/SpaceInvadersSim-v0",
                       entry_point=lambda **kw: _GymInvadersSim(**kw))
    gymnasium.register(
        id="drl_torch/SpaceInvadersSimDeterministic-v0",
        entry_point=lambda **kw: _GymInvadersSim(**{"frameskip": 4, **kw}))
    _GYM_REGISTERED = True
    return True
