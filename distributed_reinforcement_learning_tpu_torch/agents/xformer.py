"""Transformer model construction shared by the transformer agents.

Counterpart of `build_transformer_models` and `init_transformer_params`
in the JAX package's `agents/xformer.py`, for the dense single-device
body: `TransformerQNet` with plain causal attention, which dispatches
onto the flash kernels by shape (`ops/attention.py:causal_attention`).
The body features that need a mesh or another parameter layout
(sequence-parallel attention, mixture of experts, pipelined or stacked
layers, remat) are not ported and raise. `XformerAgent`
(Transformer-R2D2) is not ported yet.
"""

from __future__ import annotations

import torch

from distributed_reinforcement_learning_tpu_torch.models.transformer_net import TransformerQNet


def check_dense_body(cfg) -> None:
    """Raise on any body feature of a transformer config beyond the dense
    single-device body."""
    features = {
        "attention": cfg.attention != "dense",
        "num_experts": bool(cfg.num_experts),
        "pipeline": bool(cfg.pipeline),
        "stacked": bool(cfg.stacked),
        "remat": bool(cfg.remat),
    }
    asked = [name for name, on in features.items() if on]
    if asked:
        raise ValueError(f"transformer body feature(s) {asked} are not ported: the "
                         "port runs the dense single-device body")


def build_transformer_models(cfg, mesh=None, *, seq_len: int, head: str = "dueling_q",
                             generator: torch.Generator | None = None):
    """(model, plain-apply twin) for a transformer-family config. With the
    dense body the twin is the model itself, as in the JAX package when no
    sharded feature is on."""
    if mesh is not None:
        raise ValueError("a mesh is not ported: the port runs on one device")
    check_dense_body(cfg)
    model = TransformerQNet(
        num_actions=cfg.num_actions, obs_shape=cfg.obs_shape, d_model=cfg.d_model,
        num_heads=cfg.num_heads, num_layers=cfg.num_layers, max_len=max(seq_len, 16),
        head=head, generator=generator)
    return model, model


def init_transformer_params(cfg, *, seq_len: int, seed: int,
                            head: str = "dueling_q") -> dict[str, torch.Tensor]:
    """Fresh parameters drawn on the CPU from `seed` (Glorot-uniform
    kernels, zero biases, unit LayerNorm scales)."""
    model, _ = build_transformer_models(cfg, seq_len=seq_len, head=head,
                                        generator=torch.Generator().manual_seed(seed))
    return model.state_dict()
