"""Pong as batched tensor functions: the second on-device pixel env.

Counterpart of the JAX package's `envs/pong_jax.py`. The game of
`envs.pong_sim.PongCore`, line for line (2 px a frame paddle, serve timer
and auto-serve, the capped-speed tracking AI with its dead zone, two
collision substeps, hit-offset deflection and the rally speed-up, first
to 21), over a batch of N games, with `envs.pixel_device`'s observation
pipeline. Pong has no lives: every `done` is a game's end, and
`completed_episode_mask` is the identity.

As the JAX env: float32 physics; the serve draws are inputs (`draws`:
a serve row in [FIELD_TOP + 20, FIELD_BOT - 20) and an index into the
four serve slopes, one each per emulated frame and env); the score strip
is not rendered (the crop removes it; the bound strips are rendered).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.envs import pixel_device
from distributed_reinforcement_learning_tpu_torch.envs import pong_sim as sim

NUM_ACTIONS = sim.PongCore.num_actions  # NOOP/FIRE/RIGHT/LEFT/RIGHTFIRE/LEFTFIRE
OBS_SHAPE = (84, 84, 4)

H, W = sim.H, sim.W

# Background and the two bound strips (the score strip stays background).
_BASE = np.empty((H, W, 3), np.uint8)
_BASE[:] = sim.BACKGROUND
_BASE[sim.FIELD_TOP - sim.BOUND_H:sim.FIELD_TOP, :] = sim.BOUNDS
_BASE[sim.FIELD_BOT:sim.FIELD_BOT + sim.BOUND_H, :] = sim.BOUNDS

_TABLES: dict[torch.device, dict[str, torch.Tensor]] = {}
_RESETS: dict[tuple[int, torch.device], tuple[dict, torch.Tensor, torch.Tensor]] = {}


def _tables(device: torch.device) -> dict[str, torch.Tensor]:
    got = _TABLES.get(device)
    if got is None:
        got = _TABLES[device] = {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in dict(
                base=_BASE, ys=np.arange(H)[:, None], xs=np.arange(W)[None, :],
                enemy=np.asarray(sim.ENEMY, np.uint8), player=np.asarray(sim.PLAYER, np.uint8),
                bounds=np.asarray(sim.BOUNDS, np.uint8),
                serve_vy=np.asarray([-1.0, -0.5, 0.5, 1.0], np.float32)).items()}
    return got


class PongState(NamedTuple):
    """Batched game and observation-pipeline state (`[N, ...]` tensors)."""

    player_score: torch.Tensor  # [N] i32
    enemy_score: torch.Tensor   # [N] i32
    frames: torch.Tensor        # [N] i32 emulated frames this episode
    player_y: torch.Tensor      # [N] i32 (the agent's paddle, right)
    enemy_y: torch.Tensor       # [N] i32 (the AI's paddle, left)
    ball_dead: torch.Tensor     # [N] bool, between points
    serve_timer: torch.Tensor   # [N] i32 frames until the auto-serve
    serve_dir: torch.Tensor     # [N] f32 (+1 toward the agent)
    rally: torch.Tensor         # [N] i32 hits this rally (speed-up)
    ball_x: torch.Tensor        # [N] f32
    ball_y: torch.Tensor        # [N] f32
    vx: torch.Tensor            # [N] f32
    vy: torch.Tensor            # [N] f32
    prev_raw: torch.Tensor      # [N, 210, 160, 3] u8
    stack: torch.Tensor         # [N, 84, 84, 4] u8
    returns: torch.Tensor       # [N] f32 signed episode return


def render(player_y, enemy_y, ball_dead, ball_x, ball_y) -> torch.Tensor:
    """`[N, 210, 160, 3]` uint8 frames in `pong_sim.render`'s order."""
    t = _tables(player_y.device)
    ys, xs = t["ys"], t["xs"]
    ey = enemy_y[:, None, None]
    enemy = ((ys >= ey) & (ys < ey + sim.PADDLE_H)
             & (xs >= sim.ENEMY_X) & (xs < sim.ENEMY_X + sim.PADDLE_W))
    f = torch.where(enemy[..., None], t["enemy"], t["base"])
    py = player_y[:, None, None]
    player = ((ys >= py) & (ys < py + sim.PADDLE_H)
              & (xs >= sim.PLAYER_X) & (xs < sim.PLAYER_X + sim.PADDLE_W))
    f = torch.where(player[..., None], t["player"], f)
    by = torch.clamp(ball_y, sim.FIELD_TOP, sim.FIELD_BOT - sim.BALL_H).to(torch.int32)
    bx = torch.clamp(ball_x, 0, W - sim.BALL_W).to(torch.int32)
    by, bx = by[:, None, None], bx[:, None, None]
    ball = ((~ball_dead)[:, None, None] & (ys >= by) & (ys < by + sim.BALL_H)
            & (xs >= bx) & (xs < bx + sim.BALL_W))
    return torch.where(ball[..., None], t["bounds"], f)


def _deflect(vy, vx, rally, ball_y, paddle_y):
    """Hit-offset steering and the rally speed-up (`pong_sim._deflect`)."""
    off = (ball_y + sim.BALL_H / 2 - paddle_y - sim.PADDLE_H / 2) / (sim.PADDLE_H / 2)
    vy = torch.clamp(vy + 1.5 * off, -3.0, 3.0)
    rally = rally + 1
    speed = torch.clamp(2.0 + 0.25 * rally.to(torch.float32), max=3.5)
    vx = torch.where(vx < 0, speed, -speed)  # reverse and speed up
    return vy, vx, rally


def _collide(player_y, enemy_y, x, y, vx, vy, rally, dead,
             player_score, enemy_score, serve_timer, serve_dir, reward):
    """One `pong_sim._collide` pass over every env."""
    # Top and bottom bounds.
    vy = torch.where(y <= sim.FIELD_TOP, vy.abs(), vy)
    vy = torch.where(y >= sim.FIELD_BOT - sim.BALL_H, -vy.abs(), vy)
    y = torch.clamp(y, sim.FIELD_TOP, sim.FIELD_BOT - sim.BALL_H)
    # The agent's paddle (right), only when the ball moves toward it.
    pyf = player_y.to(torch.float32)
    hit_p = ((vx > 0) & ~dead
             & (x >= sim.PLAYER_X - sim.BALL_W) & (x <= sim.PLAYER_X + sim.PADDLE_W)
             & (y >= pyf - sim.BALL_H) & (y <= pyf + sim.PADDLE_H))
    x = torch.where(hit_p, float(sim.PLAYER_X - sim.BALL_W), x)
    dvy, dvx, drally = _deflect(vy, vx, rally, y, pyf)
    vy = torch.where(hit_p, dvy, vy)
    vx = torch.where(hit_p, dvx, vx)
    rally = torch.where(hit_p, drally, rally)
    # The enemy's paddle (left).
    eyf = enemy_y.to(torch.float32)
    hit_e = ((vx < 0) & ~dead
             & (x >= sim.ENEMY_X - sim.BALL_W) & (x <= sim.ENEMY_X + sim.PADDLE_W)
             & (y >= eyf - sim.BALL_H) & (y <= eyf + sim.PADDLE_H))
    x = torch.where(hit_e, float(sim.ENEMY_X + sim.PADDLE_W), x)
    dvy, dvx, drally = _deflect(vy, vx, rally, y, eyf)
    vy = torch.where(hit_e, dvy, vy)
    vx = torch.where(hit_e, dvx, vx)
    rally = torch.where(hit_e, drally, rally)
    # Scoring: the agent owns the right side.
    scored_on = (x >= W - sim.BALL_W) & ~dead
    scored = (x <= 0) & ~dead & ~scored_on
    enemy_score = enemy_score + scored_on.to(torch.int32)
    player_score = player_score + scored.to(torch.int32)
    point = scored_on | scored
    dead = dead | point
    serve_timer = torch.where(point, sim.SERVE_DELAY, serve_timer)
    serve_dir = torch.where(scored_on, 1.0, torch.where(scored, -1.0, serve_dir))
    reward = reward - scored_on.to(torch.float32) + scored.to(torch.float32)
    return (x, y, vx, vy, rally, dead, player_score, enemy_score, serve_timer,
            serve_dir, reward)


def _emulate_frame(carry, action, serve_y, serve_vy, max_frames):
    """One emulated frame under the held action (`_emulate_frame`)."""
    (player_score, enemy_score, frames, player_y, enemy_y, dead, serve_timer,
     serve_dir, rally, x, y, vx, vy, reward, halted) = carry
    live = ~halted
    frames = frames + live.to(torch.int32)

    up = (action == sim.RIGHT) | (action == sim.RIGHTFIRE)
    down = (action == sim.LEFT) | (action == sim.LEFTFIRE)
    fire = (action == sim.FIRE) | (action == sim.RIGHTFIRE) | (action == sim.LEFTFIRE)
    player_y = torch.where(live & up, torch.clamp(player_y - 2, min=sim.FIELD_TOP), player_y)
    player_y = torch.where(live & down,
                           torch.clamp(player_y + 2, max=sim.FIELD_BOT - sim.PADDLE_H), player_y)

    # Serve: FIRE serves at once; otherwise the timer auto-serves.
    serve_timer = serve_timer - (live & dead).to(torch.int32)
    serving = live & dead & (fire | (serve_timer <= 0))
    x = torch.where(serving, float(W // 2), x)
    y = torch.where(serving, serve_y, y)
    vx = torch.where(serving, 2.0 * serve_dir, vx)
    vy = torch.where(serving, serve_vy, vy)
    rally = torch.where(serving, 0, rally)
    dead = dead & ~serving

    # The computer's paddle: capped-speed tracking with a dead zone.
    track = live & ~dead & (vx < 0)
    target = y + sim.BALL_H / 2 - sim.PADDLE_H / 2
    diff = target - enemy_y.to(torch.float32)
    step_px = torch.clamp(diff, -2.0, 2.0).to(torch.int32)
    enemy_y = torch.where(track & (diff.abs() > 3), enemy_y + step_px, enemy_y)
    enemy_y = torch.clamp(enemy_y, sim.FIELD_TOP, sim.FIELD_BOT - sim.PADDLE_H)

    # Two collision substeps (anti-tunnelling, `pong_sim.py:150-158`).
    for _ in range(2):
        moving = live & ~dead
        x = x + torch.where(moving, vx / 2.0, 0.0)
        y = y + torch.where(moving, vy / 2.0, 0.0)
        new = _collide(player_y, enemy_y, x, y, vx, vy, rally, dead, player_score,
                       enemy_score, serve_timer, serve_dir, reward)
        (x, y, vx, vy, rally, dead, player_score, enemy_score, serve_timer, serve_dir,
         reward) = (torch.where(moving, a, b) for a, b in zip(new, (
             x, y, vx, vy, rally, dead, player_score, enemy_score, serve_timer,
             serve_dir, reward)))

    game_over = ((player_score >= sim.WIN_SCORE) | (enemy_score >= sim.WIN_SCORE)
                 | (frames >= max_frames))
    halted = halted | (live & game_over)
    return (player_score, enemy_score, frames, player_y, enemy_y, dead, serve_timer,
            serve_dir, rally, x, y, vx, vy, reward, halted)


def _reset_fields(n: int, device: torch.device) -> dict[str, torch.Tensor]:
    mid = (sim.FIELD_TOP + sim.FIELD_BOT - sim.PADDLE_H) // 2
    i32 = dict(dtype=torch.int32, device=device)
    return dict(
        player_score=torch.zeros((n,), **i32),
        enemy_score=torch.zeros((n,), **i32),
        frames=torch.zeros((n,), **i32),
        player_y=torch.full((n,), mid, **i32),
        enemy_y=torch.full((n,), mid, **i32),
        ball_dead=torch.ones((n,), dtype=torch.bool, device=device),
        serve_timer=torch.full((n,), sim.SERVE_DELAY, **i32),
        serve_dir=torch.ones((n,), device=device),  # toward the agent first
        rally=torch.zeros((n,), **i32),
        ball_x=torch.zeros((n,), device=device),
        ball_y=torch.zeros((n,), device=device),
        vx=torch.zeros((n,), device=device),
        vy=torch.zeros((n,), device=device),
        returns=torch.zeros((n,), device=device),
    )


def _fresh(n: int, device: torch.device):
    """(reset fields, reset raw frame, reset stack), made once per size
    and device: the reset is deterministic."""
    key = (n, device)
    got = _RESETS.get(key)
    if got is None:
        f = _reset_fields(n, device)
        raw0 = render(f["player_y"], f["enemy_y"], f["ball_dead"], f["ball_x"], f["ball_y"])
        got = _RESETS[key] = (f, raw0, pixel_device.reset_stack(raw0))
    return got


def reset(num_envs: int, generator: torch.Generator) -> tuple[PongState, torch.Tensor]:
    """-> (state, obs `[N, 84, 84, 4]` u8) on `generator`'s device;
    deterministic (paddles centred, a serve pending)."""
    f, raw0, stack0 = _fresh(num_envs, pixel_device.canonical(generator.device))
    state = PongState(prev_raw=raw0.clone(), stack=stack0.clone(),
                      **{k: v.clone() for k, v in f.items()})
    return state, state.stack


def draws(generator: torch.Generator, n: int, frameskip: int = 4):
    """-> (serve rows, serve-slope indices), each `[frameskip, n]` int."""
    kw = dict(generator=generator, device=generator.device)
    serve_y = torch.randint(sim.FIELD_TOP + 20, sim.FIELD_BOT - 20, (frameskip, n), **kw)
    return serve_y, torch.randint(0, 4, (frameskip, n), **kw)


def step(state: PongState, actions: torch.Tensor, serve_draws, max_frames: int = 20_000):
    """-> (state', obs', reward, done, episode_return), the cartpole_device
    contract; every `done` is a game's end (first to 21 or the frame cap).
    `serve_draws` is `draws`' pair; its first dim sets the frameskip."""
    n = state.frames.shape[0]
    device = state.frames.device
    serve_rows, slope_idx = serve_draws
    serve_y = serve_rows.to(torch.float32)
    serve_vy = _tables(device)["serve_vy"][slope_idx.long()]

    carry = (state.player_score, state.enemy_score, state.frames, state.player_y,
             state.enemy_y, state.ball_dead, state.serve_timer, state.serve_dir, state.rally,
             state.ball_x, state.ball_y, state.vx, state.vy,
             torch.zeros((n,), device=device), torch.zeros((n,), dtype=torch.bool, device=device))
    actions = actions.to(torch.int32)
    for i in range(serve_y.shape[0]):  # the held action, break as a mask
        carry = _emulate_frame(carry, actions, serve_y[i], serve_vy[i], max_frames)
    (player_score, enemy_score, frames, player_y, enemy_y, ball_dead, serve_timer,
     serve_dir, rally, ball_x, ball_y, vx, vy, reward, game_over) = carry

    raw = render(player_y, enemy_y, ball_dead, ball_x, ball_y)
    stack = pixel_device.observe(raw, state.prev_raw, state.stack)
    returns = state.returns + reward
    episode_return = torch.where(game_over, returns, 0.0)

    fresh, raw0, stack0 = _fresh(n, device)
    pick = pixel_device.make_pick(game_over)
    fields = dict(player_score=player_score, enemy_score=enemy_score, frames=frames,
                  player_y=player_y, enemy_y=enemy_y, ball_dead=ball_dead,
                  serve_timer=serve_timer, serve_dir=serve_dir, rally=rally, ball_x=ball_x,
                  ball_y=ball_y, vx=vx, vy=vy, returns=returns)
    new_state = PongState(prev_raw=pick(raw0, raw), stack=pick(stack0, stack),
                          **{k: pick(fresh[k], v) for k, v in fields.items()})
    return new_state, new_state.stack, reward, game_over, episode_return


def completed_episode_mask(done: torch.Tensor, new_state: PongState) -> torch.Tensor:
    """Pong has no lives: every `done` is a finished game."""
    del new_state
    return done
