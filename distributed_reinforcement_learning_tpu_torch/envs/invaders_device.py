"""Space Invaders as batched tensor functions: the third on-device pixel env.

Counterpart of the JAX package's `envs/invaders_jax.py`. The game of
`envs.invaders_sim.InvadersCore` over a batch of N games, with the
per-frame update order of `invaders_sim._emulate_frame` statement for
statement (cannon and fire, march, bomb spawn, missile flight and hits,
bombs falling, wave respawn, landed and done), and `envs.pixel_device`'s
observation pipeline. It stresses what the paddle games do not: a 36-alien
grid, enemy projectiles, destructible shields, combined move-and-fire
actions and mid-episode lives.

As the JAX env: float32 physics (every speed is integral, so the
arithmetic is exact); the bomb-spawn draws are inputs (`draws`: two
uniforms per emulated frame and env, spawn or not and the column);
`bomb_prob` is an argument, so a test can set it to 0; the score strip is
not rendered.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.envs import invaders_sim as sim
from distributed_reinforcement_learning_tpu_torch.envs import pixel_device

NUM_ACTIONS = sim.InvadersCore.num_actions  # NOOP/FIRE/R/L/RFIRE/LFIRE
OBS_SHAPE = (84, 84, 4)

H, W = sim.H, sim.W
_ROWS, _COLS = sim.ROWS, sim.COLS

# The ground line only: the score strip never reaches an observation.
_BASE = np.zeros((H, W, 3), np.uint8)
_BASE[H - 4:H - 2, :] = sim.CANNON_RGB

_TABLES: dict[torch.device, dict[str, torch.Tensor]] = {}
_RESETS: dict[tuple[int, torch.device], tuple[dict, torch.Tensor, torch.Tensor]] = {}


def _tables(device: torch.device) -> dict[str, torch.Tensor]:
    got = _TABLES.get(device)
    if got is None:
        got = _TABLES[device] = {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in dict(
                base=_BASE, ys=np.arange(H)[:, None], xs=np.arange(W)[None, :],
                alien_rgb=np.asarray(sim.ALIEN_ROW_COLORS, np.uint8),
                cannon=np.asarray(sim.CANNON_RGB, np.uint8),
                shield=np.asarray(sim.SHIELD_RGB, np.uint8),
                proj=np.asarray(sim.PROJ_RGB, np.uint8),
                row_points=np.asarray(sim.ROW_POINTS, np.float32),
                rows=np.arange(_ROWS), cols=np.arange(_COLS),
                slots=np.arange(sim.MAX_BOMBS)).items()}
    return got


class InvadersState(NamedTuple):
    """Batched game and observation-pipeline state (`[N, ...]` tensors)."""

    aliens: torch.Tensor        # [N, 6, 6] bool
    grid_x: torch.Tensor        # [N] f32 grid origin
    grid_y: torch.Tensor        # [N] f32
    direction: torch.Tensor     # [N] i32 (+-1)
    march_count: torch.Tensor   # [N] i32
    wave: torch.Tensor          # [N] i32
    cannon_x: torch.Tensor      # [N] f32
    missile_live: torch.Tensor  # [N] bool
    missile_x: torch.Tensor     # [N] f32
    missile_y: torch.Tensor     # [N] f32
    bomb_live: torch.Tensor     # [N, 2] bool
    bomb_x: torch.Tensor        # [N, 2] f32
    bomb_y: torch.Tensor        # [N, 2] f32
    shield_hp: torch.Tensor     # [N, 3] i32
    lives: torch.Tensor         # [N] i32
    frames: torch.Tensor        # [N] i32
    prev_raw: torch.Tensor      # [N, 210, 160, 3] u8
    stack: torch.Tensor         # [N, 84, 84, 4] u8
    returns: torch.Tensor       # [N] f32 raw episode return


def _b(v: torch.Tensor) -> torch.Tensor:
    """`[N]` -> `[N, 1, 1]`, to broadcast against the pixel grid."""
    return v[:, None, None]


def render(aliens, grid_x, grid_y, cannon_x, missile_live, missile_x, missile_y,
           bomb_live, bomb_x, bomb_y, shield_hp) -> torch.Tensor:
    """`[N, 210, 160, 3]` uint8 frames in `invaders_sim.render`'s order."""
    t = _tables(aliens.device)
    ys, xs = t["ys"], t["xs"]
    n = aliens.shape[0]

    # Aliens: each pixel's (row, col) in the marching grid.
    ry = ys - _b(grid_y)  # [N, 210, 1]
    rx = xs - _b(grid_x)  # [N, 1, 160]
    r = torch.floor(ry / sim.PITCH_Y).to(torch.int32)
    c = torch.floor(rx / sim.PITCH_X).to(torch.int32)
    in_r = (r >= 0) & (r < _ROWS) & (ry - r * sim.PITCH_Y < sim.ALIEN_H)
    in_c = (c >= 0) & (c < _COLS) & (rx - c * sim.PITCH_X < sim.ALIEN_W)
    rc = r.clamp(0, _ROWS - 1).long()
    cc = c.clamp(0, _COLS - 1).long()
    alive = aliens[torch.arange(n, device=aliens.device)[:, None, None], rc, cc]
    mask = alive & in_r & in_c  # [N, 210, 160]
    colors = t["alien_rgb"][rc[:, :, 0]]  # [N, 210, 3]
    f = torch.where(mask[..., None], colors[:, :, None, :], t["base"])

    # Shields (height erodes with hp; integer division, as the sim).
    for s, sx in enumerate(sim.SHIELD_XS):
        height = _b(sim.SHIELD_H * shield_hp[:, s] // sim.SHIELD_HP)
        m = ((ys >= sim.SHIELD_Y) & (ys < sim.SHIELD_Y + height)
             & (xs >= sx) & (xs < sx + sim.SHIELD_W))
        f = torch.where(m[..., None], t["shield"], f)

    # Cannon.
    cx = _b(cannon_x.to(torch.int32))
    m = ((ys >= sim.CANNON_Y) & (ys < sim.CANNON_Y + sim.CANNON_H)
         & (xs >= cx) & (xs < cx + sim.CANNON_W))
    f = torch.where(m[..., None], t["cannon"], f)

    # The player's missile (clamped to the screen, as the numpy slice).
    my = _b(torch.clamp(missile_y.to(torch.int32), min=0))
    mx = _b(missile_x.to(torch.int32))
    m = (_b(missile_live) & (ys >= my) & (ys < my + sim.PROJ_H)
         & (xs >= mx) & (xs < mx + sim.PROJ_W))
    f = torch.where(m[..., None], t["proj"], f)

    # Bombs.
    for b in range(sim.MAX_BOMBS):
        by = _b(bomb_y[:, b].to(torch.int32))
        bx = _b(bomb_x[:, b].to(torch.int32))
        m = (_b(bomb_live[:, b]) & (ys >= by) & (ys < torch.clamp(by + sim.PROJ_H, max=H))
             & (xs >= bx) & (xs < bx + sim.PROJ_W))
        f = torch.where(m[..., None], t["proj"], f)
    return f


def _shield_absorb(active, shield_hp, x, y):
    """A projectile's tip at (x, y) against the shields -> (absorbed,
    hp'). The three blocks do not overlap, so at most one is hit."""
    tip = x + sim.PROJ_W / 2
    hits = []
    for s, sx in enumerate(sim.SHIELD_XS):
        height = sim.SHIELD_H * shield_hp[:, s] // sim.SHIELD_HP
        hits.append(active & (shield_hp[:, s] > 0)
                    & (sx <= tip) & (tip <= sx + sim.SHIELD_W)
                    & (sim.SHIELD_Y <= y) & (y <= sim.SHIELD_Y + height))
    hit = torch.stack(hits, dim=1)  # [N, 3]
    return hit.any(1), shield_hp - hit.to(torch.int32)


def _missile_collide(aliens, grid_x, grid_y, shield_hp, bomb_live, bomb_x, bomb_y,
                     missile_live, x, y, reward):
    """`invaders_sim._missile_collide`'s order: shields, bombs, grid."""
    t = _tables(aliens.device)
    absorbed, shield_hp = _shield_absorb(missile_live, shield_hp, x, y)
    missile_live = missile_live & ~absorbed

    # Bombs: the first matching bomb only (the sim's loop and return).
    prior = torch.zeros_like(missile_live)
    new_live = []
    for b in range(sim.MAX_BOMBS):
        hit_b = (missile_live & bomb_live[:, b] & ~prior
                 & ((bomb_x[:, b] - x).abs() < sim.PROJ_W + 1)
                 & ((bomb_y[:, b] - y).abs() < sim.PROJ_H))
        new_live.append(bomb_live[:, b] & ~hit_b)
        prior = prior | hit_b
    bomb_live = torch.stack(new_live, dim=1)
    missile_live = missile_live & ~prior

    # The alien grid (one kill a frame).
    col = torch.floor((x + sim.PROJ_W / 2 - grid_x) / sim.PITCH_X).to(torch.int32)
    row = torch.floor((y - grid_y) / sim.PITCH_Y).to(torch.int32)
    rc = row.clamp(0, _ROWS - 1)
    cc = col.clamp(0, _COLS - 1)
    within = (x + sim.PROJ_W / 2 - (grid_x + cc * sim.PITCH_X)) < sim.ALIEN_W
    tall = (y - (grid_y + rc * sim.PITCH_Y)) < sim.ALIEN_H
    n = torch.arange(aliens.shape[0], device=aliens.device)
    kill = (missile_live & (row >= 0) & (row < _ROWS) & (col >= 0) & (col < _COLS)
            & aliens[n, rc.long(), cc.long()] & within & tall)
    knock = (kill[:, None, None] & (t["rows"][None, :, None] == rc[:, None, None])
             & (t["cols"][None, None, :] == cc[:, None, None]))
    aliens = aliens & ~knock
    reward = reward + torch.where(kill, t["row_points"][rc.long()], 0.0)
    missile_live = missile_live & ~kill
    return aliens, shield_hp, bomb_live, missile_live, reward


def _emulate_frame(carry, action, u_spawn, u_col, bomb_prob, max_frames):
    """One emulated frame under the held action (`_emulate_frame`)."""
    (aliens, grid_x, grid_y, direction, march_count, wave, cannon_x, missile_live,
     missile_x, missile_y, bomb_live, bomb_x, bomb_y, shield_hp, lives, frames,
     reward, halted) = carry
    t = _tables(aliens.device)
    n = aliens.shape[0]
    live = ~halted
    frames = frames + live.to(torch.int32)

    # Cannon move and fire (the combined actions do both).
    move_r = live & ((action == sim.RIGHT) | (action == sim.RIGHTFIRE))
    move_l = live & ((action == sim.LEFT) | (action == sim.LEFTFIRE))
    cannon_x = torch.where(
        move_r, torch.clamp(cannon_x + sim.CANNON_SPEED, max=float(W - 8 - sim.CANNON_W)),
        cannon_x)
    cannon_x = torch.where(move_l, torch.clamp(cannon_x - sim.CANNON_SPEED, min=8.0), cannon_x)
    fire = (live & ~missile_live
            & ((action == sim.FIRE) | (action == sim.RIGHTFIRE) | (action == sim.LEFTFIRE)))
    missile_x = torch.where(fire, cannon_x + sim.CANNON_W / 2 - sim.PROJ_W / 2, missile_x)
    missile_y = torch.where(fire, float(sim.CANNON_Y - sim.PROJ_H), missile_y)
    missile_live = missile_live | fire

    # Grid march, on the alien count at the frame's start (the sim reads
    # `alive` before the missile section).
    alive_n = aliens.flatten(1).sum(1).to(torch.int32)
    period = 1 + (7 * alive_n) // (_ROWS * _COLS)
    march_count = march_count + live.to(torch.int32)
    stepping = live & (alive_n > 0) & (march_count >= period)
    nx = grid_x + direction.to(torch.float32) * 2.0
    bounce = (nx < sim.GRID_X_MIN) | (nx > sim.GRID_X_MAX)
    direction = torch.where(stepping & bounce, -direction, direction)
    grid_y = torch.where(stepping & bounce, grid_y + sim.PITCH_Y // 2, grid_y)
    grid_x = torch.where(stepping & ~bounce, nx, grid_x)
    march_count = torch.where(stepping, 0, march_count)

    # Alien bombs: the lowest live alien of a random column drops one into
    # the first free slot (the sim's order: spawn check, slot check).
    alive_cols = aliens.any(1)  # [N, 6]
    slot_free = ~bomb_live  # [N, 2]
    slot = torch.argmax(slot_free.to(torch.int32), dim=1)  # first free
    spawn = live & (alive_n > 0) & (u_spawn < bomb_prob) & slot_free.any(1)
    count = alive_cols.sum(1).to(torch.int32)
    k = torch.minimum(torch.clamp((u_col * count).to(torch.int32), min=0), count - 1)
    col = torch.argmax((torch.cumsum(alive_cols.to(torch.int32), 1) > k[:, None])
                       .to(torch.int32), dim=1)
    col_alive = aliens[torch.arange(n, device=aliens.device), :, col]  # [N, 6]
    row = torch.where(col_alive, t["rows"], -1).amax(1)
    sel = (t["slots"] == slot[:, None]) & spawn[:, None]  # [N, 2]
    bomb_x = torch.where(sel, (grid_x + col * sim.PITCH_X + sim.ALIEN_W / 2
                               - sim.PROJ_W / 2)[:, None], bomb_x)
    bomb_y = torch.where(sel, (grid_y + row * sim.PITCH_Y + sim.ALIEN_H)[:, None], bomb_y)
    bomb_live = bomb_live | sel

    # The player's missile flies and hits.
    missile_y = torch.where(live & missile_live, missile_y - sim.MISSILE_SPEED, missile_y)
    aliens, shield_hp, bomb_live, missile_live, reward = _missile_collide(
        aliens, grid_x, grid_y, shield_hp, bomb_live, bomb_x, bomb_y,
        live & missile_live, missile_x, missile_y, reward)
    missile_live = missile_live & (missile_y >= sim.WALL_TOP_Y)

    # Bombs fall, erode shields and hit the cannon, one after the other as
    # the sim's loop: a cannon hit clears every bomb and stops the pass.
    cannon_hit_any = torch.zeros_like(live)
    new_live, new_y = [], []
    for b in range(sim.MAX_BOMBS):
        active = live & bomb_live[:, b] & ~cannon_hit_any
        y2 = torch.where(active, bomb_y[:, b] + sim.BOMB_SPEED, bomb_y[:, b])
        absorbed, shield_hp = _shield_absorb(active, shield_hp, bomb_x[:, b], y2 + sim.PROJ_H)
        cannon_hit = (active & ~absorbed & (y2 + sim.PROJ_H >= sim.CANNON_Y)
                      & (cannon_x - sim.PROJ_W <= bomb_x[:, b])
                      & (bomb_x[:, b] <= cannon_x + sim.CANNON_W))
        off = active & (y2 >= H)
        new_live.append(bomb_live[:, b] & ~(absorbed | cannon_hit | off))
        new_y.append(y2)
        cannon_hit_any = cannon_hit_any | cannon_hit
    bomb_live = torch.stack(new_live, dim=1)
    bomb_y = torch.stack(new_y, dim=1)
    lives = lives - cannon_hit_any.to(torch.int32)
    bomb_live = bomb_live & ~cannon_hit_any[:, None]
    cannon_x = torch.where(cannon_hit_any, float((W - sim.CANNON_W) // 2), cannon_x)

    # A cleared wave respawns lower and faster (before `landed`, as the sim).
    cleared = live & ~aliens.flatten(1).any(1)
    wave = wave + cleared.to(torch.int32)
    aliens = aliens | cleared[:, None, None]
    grid_x = torch.where(cleared, sim.GRID_X0, grid_x)
    grid_y = torch.where(
        cleared,
        sim.GRID_Y0 + torch.clamp(wave, max=3).to(torch.float32) * (sim.PITCH_Y // 2),
        grid_y)
    direction = torch.where(cleared, 1, direction)
    march_count = torch.where(cleared, 0, march_count)

    landed = ((grid_y + (_ROWS - 1) * sim.PITCH_Y + sim.ALIEN_H >= sim.SHIELD_Y)
              & aliens.flatten(1).any(1))
    game_over = (lives <= 0) | landed | (frames >= max_frames)
    halted = halted | (live & game_over)
    return (aliens, grid_x, grid_y, direction, march_count, wave, cannon_x, missile_live,
            missile_x, missile_y, bomb_live, bomb_x, bomb_y, shield_hp, lives, frames,
            reward, halted)


def _reset_fields(n: int, device: torch.device) -> dict[str, torch.Tensor]:
    i32 = dict(dtype=torch.int32, device=device)
    nb = sim.MAX_BOMBS
    return dict(
        aliens=torch.ones((n, _ROWS, _COLS), dtype=torch.bool, device=device),
        grid_x=torch.full((n,), sim.GRID_X0, device=device),
        grid_y=torch.full((n,), sim.GRID_Y0, device=device),
        direction=torch.ones((n,), **i32),
        march_count=torch.zeros((n,), **i32),
        wave=torch.zeros((n,), **i32),
        cannon_x=torch.full((n,), float((W - sim.CANNON_W) // 2), device=device),
        missile_live=torch.zeros((n,), dtype=torch.bool, device=device),
        missile_x=torch.zeros((n,), device=device),
        missile_y=torch.zeros((n,), device=device),
        bomb_live=torch.zeros((n, nb), dtype=torch.bool, device=device),
        bomb_x=torch.zeros((n, nb), device=device),
        bomb_y=torch.zeros((n, nb), device=device),
        shield_hp=torch.full((n, len(sim.SHIELD_XS)), sim.SHIELD_HP, **i32),
        lives=torch.full((n,), 3, **i32),
        frames=torch.zeros((n,), **i32),
        returns=torch.zeros((n,), device=device),
    )


def _render_fields(f: dict) -> torch.Tensor:
    return render(f["aliens"], f["grid_x"], f["grid_y"], f["cannon_x"], f["missile_live"],
                  f["missile_x"], f["missile_y"], f["bomb_live"], f["bomb_x"], f["bomb_y"],
                  f["shield_hp"])


def _fresh(n: int, device: torch.device):
    """(reset fields, reset raw frame, reset stack), made once per size
    and device: the reset is deterministic."""
    key = (n, device)
    got = _RESETS.get(key)
    if got is None:
        f = _reset_fields(n, device)
        raw0 = _render_fields(f)
        got = _RESETS[key] = (f, raw0, pixel_device.reset_stack(raw0))
    return got


def reset(num_envs: int, generator: torch.Generator) -> tuple[InvadersState, torch.Tensor]:
    """-> (state, obs `[N, 84, 84, 4]` u8) on `generator`'s device;
    deterministic."""
    f, raw0, stack0 = _fresh(num_envs, pixel_device.canonical(generator.device))
    state = InvadersState(prev_raw=raw0.clone(), stack=stack0.clone(),
                          **{k: v.clone() for k, v in f.items()})
    return state, state.stack


def draws(generator: torch.Generator, n: int, frameskip: int = 4):
    """-> (spawn uniforms, column uniforms), each `[frameskip, n]`."""
    kw = dict(generator=generator, device=generator.device)
    return torch.rand((frameskip, n), **kw), torch.rand((frameskip, n), **kw)


def step(state: InvadersState, actions: torch.Tensor, bomb_draws, max_frames: int = 10_000,
         life_loss: bool = True, bomb_prob: float = 0.04):
    """-> (state', obs', reward, done, episode_return), the breakout_device
    contract: an auto-reset on game over with the reset observation in
    `obs'`; `done` is game over or, with `life_loss`, a lost life, whose
    step reward becomes -1 unless the game ended; `returns` keeps the raw
    score. `bomb_draws` is `draws`' pair; its first dim sets the
    frameskip."""
    n = state.lives.shape[0]
    device = state.lives.device
    lives_before = state.lives
    u_spawn, u_col = bomb_draws

    carry = (state.aliens, state.grid_x, state.grid_y, state.direction, state.march_count,
             state.wave, state.cannon_x, state.missile_live, state.missile_x, state.missile_y,
             state.bomb_live, state.bomb_x, state.bomb_y, state.shield_hp, state.lives,
             state.frames, torch.zeros((n,), device=device),
             torch.zeros((n,), dtype=torch.bool, device=device))
    actions = actions.to(torch.int32)
    for i in range(u_spawn.shape[0]):  # the held action, break as a mask
        carry = _emulate_frame(carry, actions, u_spawn[i], u_col[i], bomb_prob, max_frames)
    (aliens, grid_x, grid_y, direction, march_count, wave, cannon_x, missile_live,
     missile_x, missile_y, bomb_live, bomb_x, bomb_y, shield_hp, lives, frames,
     reward, game_over) = carry

    fields = dict(
        aliens=aliens, grid_x=grid_x, grid_y=grid_y, direction=direction,
        march_count=march_count, wave=wave, cannon_x=cannon_x, missile_live=missile_live,
        missile_x=missile_x, missile_y=missile_y, bomb_live=bomb_live, bomb_x=bomb_x,
        bomb_y=bomb_y, shield_hp=shield_hp, lives=lives, frames=frames,
        returns=state.returns + reward)
    raw = _render_fields(fields)
    stack = pixel_device.observe(raw, state.prev_raw, state.stack)

    episode_return = torch.where(game_over, fields["returns"], 0.0)
    lost_life = lives < lives_before
    done = (game_over | lost_life) if life_loss else game_over
    if life_loss:
        # As breakout_device: -1 in place of the reward on a lost life
        # that does not end the game.
        reward = torch.where(lost_life & ~game_over, -1.0, reward)

    fresh, raw0, stack0 = _fresh(n, device)
    pick = pixel_device.make_pick(game_over)
    new_state = InvadersState(prev_raw=pick(raw0, raw), stack=pick(stack0, stack),
                              **{k: pick(fresh[k], fields[k]) for k in fresh})
    return new_state, new_state.stack, reward, done, episode_return


def completed_episode_mask(done: torch.Tensor, new_state: InvadersState) -> torch.Tensor:
    """The `done` slots that ended a game, not a life: the reset restores
    3 lives, a life-loss done leaves at most 2."""
    return done & (new_state.lives == 3)
