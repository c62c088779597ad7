"""Config loading: the IMPALA and R2D2 sections of the repo's `config.json`.

Counterpart of the JAX package's `utils/config.py`, IMPALA and R2D2
branches. Loads one section into an agent config and a `RuntimeConfig`
and applies the same validation (actor, env and action-set counts
agree). Keys that select what the port does not run yet (another
algorithm, several optimizer steps per call) raise instead of being
ignored.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from distributed_reinforcement_learning_tpu_torch.agents.impala import ImpalaConfig
from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Config


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Topology and data-plane settings of one section."""

    num_actors: int = 1
    envs: tuple[str, ...] = ("CartPole-v0",)
    available_action: tuple[int, ...] = (2,)
    queue_size: int = 128
    batch_size: int = 32
    envs_per_actor: int = 1
    publish_interval: int = 1
    replay_capacity: int = 100_000
    target_sync_interval: int = 100
    # r2d2 actors: residual exploration floor (None = the actor's own
    # default, 0.0: reference parity).
    epsilon_floor: float | None = None


def check_config(rt: RuntimeConfig, num_actions: int) -> None:
    for a in rt.available_action:
        if num_actions < a:
            raise ValueError(f"available_action {a} exceeds model_output {num_actions}")
    if rt.num_actors != len(rt.available_action):
        raise ValueError("num_actors != len(available_action)")
    if rt.num_actors != len(rt.envs):
        raise ValueError("num_actors != len(env)")


def load_config(path: str | Path, section: str):
    """One config section -> (ImpalaConfig or R2D2Config, RuntimeConfig)."""
    d = json.loads(Path(path).read_text())[section]
    algorithm = d.get("algorithm", section.split("_")[0])
    if algorithm not in ("impala", "r2d2"):
        raise ValueError(f"section {section!r} is {algorithm!r}; the PyTorch port "
                         "runs the IMPALA and R2D2 families only")
    if d.get("updates_per_call", 1) != 1:
        raise ValueError("updates_per_call > 1 is not ported")
    rt = RuntimeConfig(
        num_actors=d.get("num_actors", 1),
        envs=tuple(d.get("env", ("CartPole-v0",))),
        available_action=tuple(d.get("available_action", (d.get("model_output", 2),))),
        queue_size=d.get("queue_size", 128),
        batch_size=d.get("batch_size", 32),
        envs_per_actor=d.get("envs_per_actor", 1),
        publish_interval=d.get("publish_interval", 1),
        replay_capacity=int(d.get("replay_capacity", 1e5)),
        target_sync_interval=d.get("target_sync_interval", 100),
        epsilon_floor=d.get("epsilon_floor"),
    )
    if algorithm == "r2d2":
        agent_cfg = R2D2Config(
            obs_shape=tuple(d["model_input"]),
            num_actions=d["model_output"],
            seq_len=d.get("seq_len", 10),
            burn_in=d.get("burn_in", 5),
            lstm_size=d.get("lstm_size", 512),
            discount_factor=d.get("discount_factor", 0.997),
            learning_rate=d.get("start_learning_rate", 1e-4),
            priority_eta=d.get("priority_eta", None),
            # NOT the section's `gradient_clip_norm`: the reference
            # carries that key but never applies it to R2D2; the distinct
            # `adam_clip_norm` key opts in to a clip.
            gradient_clip_norm=d.get("adam_clip_norm", None),
            torso=d.get("torso", "mlp"),
            torso_width=d.get("torso_width", 1),
            fold_normalize=d.get("fold_normalize", False),
        )
        check_config(rt, agent_cfg.num_actions)
        return agent_cfg, rt
    agent_cfg = ImpalaConfig(
        obs_shape=tuple(d["model_input"]),
        num_actions=d["model_output"],
        trajectory=d.get("trajectory", 20),
        lstm_size=d.get("lstm_size", 256),
        discount_factor=d.get("discount_factor", 0.99),
        baseline_loss_coef=d.get("baseline_loss_coef", 1.0),
        entropy_coef=d.get("entropy_coef", 0.05),
        gradient_clip_norm=d.get("gradient_clip_norm", 40.0),
        reward_clipping=d.get("reward_clipping", "abs_one"),
        start_learning_rate=d.get("start_learning_rate", 6e-4),
        end_learning_rate=d.get("end_learning_rate", 0.0),
        learning_frame=int(d.get("learning_frame", 1e9)),
        fold_normalize=d.get("fold_normalize", False),
        torso=d.get("torso", "nature"),
        torso_width=d.get("torso_width", 1),
    )
    check_config(rt, agent_cfg.num_actions)
    return agent_cfg, rt
