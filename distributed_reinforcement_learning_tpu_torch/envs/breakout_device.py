"""Breakout as batched tensor functions: the on-device (Anakin) pixel env.

Counterpart of the JAX package's `envs/breakout_jax.py`. The game of
`envs.breakout_sim.BreakoutCore`, line for line (paddle 4 px a frame, two
collision substeps, hit-position steering, row-scored bricks, 5 lives,
the frameskip's held action), over a batch of N games, with the
observation pipeline of `envs.pixel_device` on the same device.

As the JAX env, it differs from the numpy sim on purpose in these ways:
float32 physics; the launch-velocity draw is an input (`draws`, one
`randint(0, 4)` per emulated frame and env, used only by a FIRE on a dead
ball); the score strip and lives block are not rendered (the crop removes
those scanlines); no fire-reset wrapper. A lost life is a `done` for the
learner, with the step's reward replaced by -1 unless the game ended
(`life_loss`), while the game restarts only on a true game over. The
frameskip loop's break on game over is a mask (`halted`), so a step never
reads a device value on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.envs import breakout_sim as sim
from distributed_reinforcement_learning_tpu_torch.envs import pixel_device

NUM_ACTIONS = sim.BreakoutCore.num_actions  # NOOP / FIRE / RIGHT / LEFT
OBS_SHAPE = (84, 84, 4)

H, W = sim.H, sim.W
_BALL = sim.BALL_SIZE

_YS = np.arange(H)[:, None]  # [210, 1]
_XS = np.arange(W)[None, :]  # [1, 160]

# Walls, drawn below everything else (breakout_sim.render's order).
_BASE = np.zeros((H, W, 3), np.uint8)
_BASE[sim.WALL_TOP:sim.WALL_TOP + 4, :] = sim.WALL
_BASE[sim.WALL_TOP:, :sim.WALL_SIDE] = sim.WALL
_BASE[sim.WALL_TOP:, W - sim.WALL_SIDE:] = sim.WALL

# The brick (row, col) each pixel belongs to, and the brick field's mask.
_ROW_IDX = np.clip((_YS - sim.BRICK_TOP) // sim.BRICK_H, 0, 5)[:, 0]  # [210]
_COL_IDX = np.clip((_XS - sim.WALL_SIDE) // sim.BRICK_W, 0, 17)[0, :]  # [160]
_IN_FIELD = (
    (_YS >= sim.BRICK_TOP) & (_YS < sim.BRICK_TOP + 6 * sim.BRICK_H)
    & (_XS >= sim.WALL_SIDE) & (_XS < sim.WALL_SIDE + 18 * sim.BRICK_W)
)  # [210, 160]
_ROW_RGB = np.asarray(sim.ROW_COLORS, np.uint8)[_ROW_IDX]  # [210, 3]
_SPRITE = np.asarray(sim.SPRITE, np.uint8)
_ROW_POINTS = np.asarray(sim.ROW_POINTS, np.float32)
_LAUNCH_VX = np.asarray([-2.0, -1.0, 1.0, 2.0], np.float32)

_TABLES: dict[torch.device, dict[str, torch.Tensor]] = {}
_RESETS: dict[tuple[int, torch.device], tuple[dict, torch.Tensor, torch.Tensor]] = {}


def _tables(device: torch.device) -> dict[str, torch.Tensor]:
    got = _TABLES.get(device)
    if got is None:
        got = _TABLES[device] = {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in dict(
                base=_BASE, row_idx=_ROW_IDX, col_idx=_COL_IDX, in_field=_IN_FIELD,
                row_rgb=_ROW_RGB, sprite=_SPRITE, row_points=_ROW_POINTS,
                launch_vx=_LAUNCH_VX, ys=_YS, xs=_XS).items()}
    return got


class BreakoutState(NamedTuple):
    """Batched game and observation-pipeline state (`[N, ...]` tensors)."""

    bricks: torch.Tensor     # [N, 6, 18] bool
    lives: torch.Tensor      # [N] i32
    frames: torch.Tensor     # [N] i32 emulated frames this episode
    paddle_x: torch.Tensor   # [N] f32 (integer-valued)
    ball_dead: torch.Tensor  # [N] bool, awaiting FIRE
    ball_x: torch.Tensor     # [N] f32
    ball_y: torch.Tensor     # [N] f32
    vx: torch.Tensor         # [N] f32
    vy: torch.Tensor         # [N] f32
    prev_raw: torch.Tensor   # [N, 210, 160, 3] u8, the last step's frame
    stack: torch.Tensor      # [N, 84, 84, 4] u8, the current observation
    returns: torch.Tensor    # [N] f32 raw (unclipped) episode return


def render(bricks, paddle_x, ball_dead, ball_x, ball_y) -> torch.Tensor:
    """`[N, 210, 160, 3]` uint8 frames in `breakout_sim.render`'s order."""
    t = _tables(bricks.device)
    ys, xs = t["ys"], t["xs"]
    alive = bricks[:, t["row_idx"]][:, :, t["col_idx"]]  # [N, 210, 160]
    mask = alive & t["in_field"]
    f = torch.where(mask[..., None], t["row_rgb"][:, None, :], t["base"])

    px = paddle_x.to(torch.int32)[:, None, None]
    paddle = ((ys >= sim.PADDLE_Y) & (ys < sim.PADDLE_Y + sim.PADDLE_H)
              & (xs >= px) & (xs < px + sim.PADDLE_W))
    f = torch.where(paddle[..., None], t["sprite"], f)

    by = ball_y.to(torch.int32)[:, None, None]
    bx = ball_x.to(torch.int32)[:, None, None]
    ball = ((~ball_dead)[:, None, None] & (ys >= by) & (ys < by + _BALL)
            & (xs >= bx) & (xs < bx + _BALL))
    return torch.where(ball[..., None], t["sprite"], f)


def _collide(bricks, paddle_x, lives, x, y, vx, vy, dead, reward):
    """One `breakout_sim._collide` pass over every env."""
    t = _tables(bricks.device)
    # Side walls.
    x = torch.clamp(x, sim.WALL_SIDE, W - sim.WALL_SIDE - _BALL)
    vx = torch.where(x <= sim.WALL_SIDE, vx.abs(), vx)
    vx = torch.where(x >= W - sim.WALL_SIDE - _BALL, -vx.abs(), vx)
    # Top wall.
    vy = torch.where(y <= sim.WALL_TOP + 4, vy.abs(), vy)
    y = torch.clamp(y, min=float(sim.WALL_TOP + 4))
    # Bricks (the moving ball can hit at most one a substep).
    row = torch.floor((y - sim.BRICK_TOP) / sim.BRICK_H).to(torch.int32)
    col = torch.floor((x - sim.WALL_SIDE) / sim.BRICK_W).to(torch.int32)
    rc = row.clamp(0, 5).long()
    cc = col.clamp(0, 17).long()
    n = torch.arange(bricks.shape[0], device=bricks.device)
    hit = ((row >= 0) & (row < 6) & (col >= 0) & (col < 18)
           & bricks[n, rc, cc] & ~dead)
    knock = (hit[:, None, None]
             & (torch.arange(6, device=rc.device)[None, :, None] == rc[:, None, None])
             & (torch.arange(18, device=cc.device)[None, None, :] == cc[:, None, None]))
    bricks = bricks & ~knock
    reward = reward + torch.where(hit, t["row_points"][rc], 0.0)
    vy = torch.where(hit, -vy, vy)
    # Paddle (the hit position steers, the sim's formula).
    on_paddle = ((vy > 0)
                 & (y >= sim.PADDLE_Y - _BALL) & (y <= sim.PADDLE_Y + sim.PADDLE_H)
                 & (x >= paddle_x - _BALL) & (x <= paddle_x + sim.PADDLE_W)
                 & ~dead)
    off = (x + _BALL / 2 - paddle_x - sim.PADDLE_W / 2) / (sim.PADDLE_W / 2)
    steered = torch.clamp(vx + 2.0 * off, -3.0, 3.0)
    steered = torch.where(steered.abs() < 0.5,
                          torch.where(off >= 0, 0.5, -0.5), steered)
    vx = torch.where(on_paddle, steered, vx)
    vy = torch.where(on_paddle, -vy.abs(), vy)
    # Bottom: a life lost.
    lost = (y >= H - _BALL) & ~dead
    lives = lives - lost.to(torch.int32)
    dead = dead | lost
    return bricks, lives, x, y, vx, vy, dead, reward


def _emulate_frame(carry, action, launch_vx, max_frames):
    """One emulated frame under the held action (`_emulate_frame`). The
    carry's `halted` is set once a game ended mid-frameskip and freezes
    the remaining frames, as the numpy loop's `break` does."""
    (bricks, lives, frames, paddle_x, dead, x, y, vx, vy, reward, halted) = carry
    live = ~halted
    frames = frames + live.to(torch.int32)

    paddle_x = torch.where(live & (action == sim.RIGHT),
                           torch.clamp(paddle_x + 4, max=float(W - sim.WALL_SIDE - sim.PADDLE_W)),
                           paddle_x)
    paddle_x = torch.where(live & (action == sim.LEFT),
                           torch.clamp(paddle_x - 4, min=float(sim.WALL_SIDE)), paddle_x)
    fire = live & (action == sim.FIRE) & dead & (lives > 0)
    x = torch.where(fire, paddle_x + sim.PADDLE_W // 2, x)
    y = torch.where(fire, float(sim.PADDLE_Y - 8), y)
    vx = torch.where(fire, launch_vx, vx)
    vy = torch.where(fire, -3.0, vy)
    dead = dead & ~fire

    # Two collision substeps (anti-tunnelling, `breakout_sim.py:130-140`).
    for _ in range(2):
        moving = live & ~dead
        x = x + torch.where(moving, vx / 2.0, 0.0)
        y = y + torch.where(moving, vy / 2.0, 0.0)
        bricks2, lives2, x2, y2, vx2, vy2, dead2, reward2 = _collide(
            bricks, paddle_x, lives, x, y, vx, vy, dead, reward)
        bricks = torch.where(moving[:, None, None], bricks2, bricks)
        lives = torch.where(moving, lives2, lives)
        x = torch.where(moving, x2, x)
        y = torch.where(moving, y2, y)
        vx = torch.where(moving, vx2, vx)
        vy = torch.where(moving, vy2, vy)
        dead = torch.where(moving, dead2, dead)
        reward = torch.where(moving, reward2, reward)

    game_over = (lives <= 0) | ~bricks.flatten(1).any(1) | (frames >= max_frames)
    halted = halted | (live & game_over)
    return (bricks, lives, frames, paddle_x, dead, x, y, vx, vy, reward, halted)


def _reset_fields(n: int, device: torch.device) -> dict[str, torch.Tensor]:
    return dict(
        bricks=torch.ones((n, 6, 18), dtype=torch.bool, device=device),
        lives=torch.full((n,), 5, dtype=torch.int32, device=device),
        frames=torch.zeros((n,), dtype=torch.int32, device=device),
        paddle_x=torch.full((n,), float((W - sim.PADDLE_W) // 2), device=device),
        ball_dead=torch.ones((n,), dtype=torch.bool, device=device),
        ball_x=torch.zeros((n,), device=device),
        ball_y=torch.zeros((n,), device=device),
        vx=torch.zeros((n,), device=device),
        vy=torch.zeros((n,), device=device),
        returns=torch.zeros((n,), device=device),
    )


def _fresh(n: int, device: torch.device):
    """(reset fields, reset raw frame, reset stack) for n games, made once
    per size and device: the reset is deterministic."""
    key = (n, device)
    got = _RESETS.get(key)
    if got is None:
        f = _reset_fields(n, device)
        raw0 = render(f["bricks"], f["paddle_x"], f["ball_dead"], f["ball_x"], f["ball_y"])
        got = _RESETS[key] = (f, raw0, pixel_device.reset_stack(raw0))
    return got


def reset(num_envs: int, generator: torch.Generator) -> tuple[BreakoutState, torch.Tensor]:
    """-> (state, obs `[N, 84, 84, 4]` u8) on `generator`'s device. The
    reset is deterministic (centred paddle, a dead ball awaiting FIRE);
    the generator names the device, for the cartpole_device signature."""
    f, raw0, stack0 = _fresh(num_envs, pixel_device.canonical(generator.device))
    state = BreakoutState(prev_raw=raw0.clone(), stack=stack0.clone(),
                          **{k: v.clone() for k, v in f.items()})
    return state, state.stack


def draws(generator: torch.Generator, n: int, frameskip: int = 4) -> torch.Tensor:
    """The `[frameskip, n]` launch-velocity indices one step consumes."""
    return torch.randint(0, 4, (frameskip, n), generator=generator, device=generator.device)


def step(state: BreakoutState, actions: torch.Tensor, launch_draws: torch.Tensor,
         max_frames: int = 10_000, life_loss: bool = True):
    """-> (state', obs', reward, done, episode_return), the cartpole_device
    contract: `obs'` holds the reset observation in game-over slots and
    `episode_return` the completed raw return where the game ended. `done`
    is the training signal: game over or, with `life_loss`, a lost life.
    `launch_draws` is `[frameskip, N]` (`draws`); its first dim sets the
    frameskip."""
    n = state.lives.shape[0]
    device = state.lives.device
    lives_before = state.lives
    launch_vx = _tables(device)["launch_vx"][launch_draws.long()]

    carry = (state.bricks, state.lives, state.frames, state.paddle_x, state.ball_dead,
             state.ball_x, state.ball_y, state.vx, state.vy,
             torch.zeros((n,), device=device), torch.zeros((n,), dtype=torch.bool, device=device))
    actions = actions.to(torch.int32)
    for i in range(launch_draws.shape[0]):  # the held action, break as a mask
        carry = _emulate_frame(carry, actions, launch_vx[i], max_frames)
    (bricks, lives, frames, paddle_x, ball_dead, ball_x, ball_y, vx, vy,
     reward, game_over) = carry

    raw = render(bricks, paddle_x, ball_dead, ball_x, ball_y)
    stack = pixel_device.observe(raw, state.prev_raw, state.stack)

    returns = state.returns + reward
    episode_return = torch.where(game_over, returns, 0.0)
    lost_life = lives < lives_before
    done = (game_over | lost_life) if life_loss else game_over
    if life_loss:
        # -1 in place of the step's reward on a lost life that does not
        # end the game (`breakout_jax.py:296-310`); `returns` keeps the
        # raw score.
        reward = torch.where(lost_life & ~game_over, -1.0, reward)

    fresh, raw0, stack0 = _fresh(n, device)
    pick = pixel_device.make_pick(game_over)
    new_state = BreakoutState(
        bricks=pick(fresh["bricks"], bricks),
        lives=pick(fresh["lives"], lives),
        frames=pick(fresh["frames"], frames),
        paddle_x=pick(fresh["paddle_x"], paddle_x),
        ball_dead=pick(fresh["ball_dead"], ball_dead),
        ball_x=pick(fresh["ball_x"], ball_x),
        ball_y=pick(fresh["ball_y"], ball_y),
        vx=pick(fresh["vx"], vx),
        vy=pick(fresh["vy"], vy),
        prev_raw=pick(raw0, raw),
        stack=pick(stack0, stack),
        returns=pick(fresh["returns"], returns),
    )
    return new_state, new_state.stack, reward, done, episode_return


def completed_episode_mask(done: torch.Tensor, new_state: BreakoutState) -> torch.Tensor:
    """The `done` slots that ended a game, not a life: the reset restores
    5 lives, a life-loss done leaves at most 4."""
    return done & (new_state.lives == 5)
