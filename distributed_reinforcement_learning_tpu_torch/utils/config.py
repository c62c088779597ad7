"""Config loading: the IMPALA, Ape-X, R2D2 and Transformer-IMPALA
sections of the repo's `config.json`.

Counterpart of the JAX package's `utils/config.py`, IMPALA, Ape-X, R2D2
and ximpala branches. Loads one section into an agent config and a
`RuntimeConfig` and applies the same validation (actor, env and
action-set counts agree). Keys that select what the port does not run
yet (another algorithm, several optimizer steps per call for the IMPALA
families, a non-dense transformer body) raise instead of being ignored.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from distributed_reinforcement_learning_tpu_torch.agents.apex import ApexConfig
from distributed_reinforcement_learning_tpu_torch.agents.impala import ImpalaConfig
from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Config
from distributed_reinforcement_learning_tpu_torch.agents.xformer import check_dense_body
from distributed_reinforcement_learning_tpu_torch.agents.ximpala import XImpalaConfig


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Topology and data-plane settings of one section."""

    server_ip: str = "localhost"  # the learner's address, for actors
    server_port: int = 8000
    num_actors: int = 1
    envs: tuple[str, ...] = ("CartPole-v0",)
    available_action: tuple[int, ...] = (2,)
    queue_size: int = 128
    batch_size: int = 32
    envs_per_actor: int = 1
    publish_interval: int = 1
    replay_capacity: int = 100_000
    target_sync_interval: int = 100
    # Prioritized updates per train call (the replay families).
    updates_per_call: int = 1
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
    """One config section -> (ImpalaConfig, ApexConfig, R2D2Config or
    XImpalaConfig, RuntimeConfig)."""
    d = json.loads(Path(path).read_text())[section]
    algorithm = d.get("algorithm", section.split("_")[0])
    if algorithm not in ("impala", "apex", "r2d2", "ximpala"):
        raise ValueError(f"section {section!r} is {algorithm!r}; the PyTorch port runs the "
                         "IMPALA, Ape-X, R2D2 and Transformer-IMPALA families only")
    if d.get("updates_per_call", 1) != 1 and algorithm not in ("apex", "r2d2"):
        raise ValueError("updates_per_call > 1 for the IMPALA families (scan_learn) is "
                         "not ported (ROADMAP item 15)")
    rt = RuntimeConfig(
        server_ip=d.get("server_ip", "localhost"),
        server_port=d.get("server_port", 8000),
        num_actors=d.get("num_actors", 1),
        envs=tuple(d.get("env", ("CartPole-v0",))),
        available_action=tuple(d.get("available_action", (d.get("model_output", 2),))),
        queue_size=d.get("queue_size", 128),
        batch_size=d.get("batch_size", 32),
        envs_per_actor=d.get("envs_per_actor", 1),
        publish_interval=d.get("publish_interval", 1),
        replay_capacity=int(d.get("replay_capacity", 1e5)),
        target_sync_interval=d.get("target_sync_interval", 100),
        updates_per_call=d.get("updates_per_call", 1),
        epsilon_floor=d.get("epsilon_floor"),
    )
    if algorithm == "apex":
        agent_cfg = ApexConfig(
            obs_shape=tuple(d["model_input"]),
            num_actions=d["model_output"],
            discount_factor=d.get("discount_factor", 0.99),
            reward_clipping=d.get("reward_clipping", "abs_one"),
            gradient_clip_norm=d.get("gradient_clip_norm", 40.0),
            start_learning_rate=d.get("start_learning_rate", 1e-4),
            end_learning_rate=d.get("end_learning_rate", 0.0),
            learning_frame=int(d.get("learning_frame", 1e9)),
            fold_normalize=d.get("fold_normalize", False),
        )
        check_config(rt, agent_cfg.num_actions)
        return agent_cfg, rt
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
    if algorithm == "ximpala":
        agent_cfg = _ximpala_config(d)
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


def _ximpala_config(d: dict) -> XImpalaConfig:
    """The ximpala branch, with the JAX package's keys and defaults. The
    body knobs that need what is not ported (sequence-parallel attention,
    experts, pipelined, stacked or rematerialised layers) raise."""
    cfg = XImpalaConfig(
        obs_shape=tuple(d["model_input"]),
        num_actions=d["model_output"],
        trajectory=d.get("trajectory", 20),
        d_model=d.get("d_model", 128),
        num_heads=d.get("num_heads", 4),
        num_layers=d.get("num_layers", 2),
        discount_factor=d.get("discount_factor", 0.99),
        baseline_loss_coef=d.get("baseline_loss_coef", 1.0),
        entropy_coef=d.get("entropy_coef", 0.05),
        gradient_clip_norm=d.get("gradient_clip_norm", 40.0),
        reward_clipping=d.get("reward_clipping", "abs_one"),
        start_learning_rate=d.get("start_learning_rate", 6e-4),
        end_learning_rate=d.get("end_learning_rate", 0.0),
        learning_frame=int(d.get("learning_frame", 1e9)),
        attention=d.get("attention", "dense"),
        num_experts=d.get("num_experts", 0),
        moe_top_k=d.get("moe_top_k", 2),
        moe_capacity_factor=d.get("moe_capacity_factor", 2.0),
        moe_aux_weight=d.get("moe_aux_weight", 1e-2),
        pipeline=d.get("pipeline", False),
        pipeline_microbatches=d.get("pipeline_microbatches", 2),
        pipeline_stages=d.get("pipeline_stages", 0),
        stacked=d.get("stacked", False),
        remat=d.get("remat", False),
    )
    check_dense_body(cfg)
    return cfg
