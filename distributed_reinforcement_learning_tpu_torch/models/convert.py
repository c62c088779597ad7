"""Flax parameters -> the port's `state_dict`.

The JAX package's parameter tree, as nested dicts of numpy arrays (for
example `params/torso/conv0_kernel (8, 8, 4, 32)`,
`params/lstm/gates_kernel (3648, 1024)`,
`params/policy_head/Dense_2/kernel (256, 18)`), maps onto the port's
module names and layouts (`ImpalaActorCritic`, `R2D2Net`, the Ape-X
networks) by one set of rules:

- conv kernels HWIO -> OIHW; Dense `[in, out]` -> Linear `[out, in]`;
- `Dense_{i}` -> `layers.{i}`; `conv{i}_kernel` / `conv{i}_bias` ->
  `conv{i}.weight` / `conv{i}.bias`; nested `kernel` / `bias` ->
  `weight` / `bias` (ResNetTorso's `section*` convs and `trunk_out`);
- the LSTM keeps its fused `[F+H, 4H]` kernel as it is.

The feature order after a flatten needs no permutation: the port's
torsos flatten NHWC, as the JAX torsos do.

`upgrade_nature_conv_params` is the JAX package's map from the old
NatureConv nesting (`Conv_{i}/{kernel, bias}`) to the explicit leaves:
the converters apply it, and `utils/checkpoint.py` retries a failed
restore through its form over dotted names.

`TransformerQNet` takes flax's automatic names through a table instead
(`transformer_params_from_jax`), and LayerNorm's `scale` becomes
`weight` with no transpose. Its `moe` groups and `blocks_stacked` keep
their names and layouts (the port computes the same einsums and
products).
"""

from __future__ import annotations

import re

import numpy as np
import torch

_CONV_LEAF = re.compile(r"conv(\d+)_(kernel|bias)$")
_DENSE = re.compile(r"Dense_(\d+)$")
_OLD_CONV_NAME = re.compile(r"(^|\.)Conv_(\d+)\.(weight|bias)$")


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def impala_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """-> a state_dict for `ImpalaActorCritic.load_state_dict(strict=True)`."""
    return _params_from_jax(tree, "IMPALA")


def r2d2_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """-> a state_dict for `R2D2Net.load_state_dict(strict=True)`
    (`state_fc1/kernel` -> `state_fc1.weight`, `cell/gates_kernel` ->
    `cell.gates_kernel`, `torso/conv0_kernel` -> `torso.conv0.weight`)."""
    return _params_from_jax(tree, "R2D2")


def apex_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """-> a state_dict for `DuelingQNetwork` or `SimpleQNetwork`
    (`load_state_dict(strict=True)`): `torso/conv0_kernel` ->
    `torso.conv0.weight`, `value/Dense_2/kernel` -> `value.layers.2.weight`,
    `action_embed/Dense_1/bias` -> `action_embed.layers.1.bias`,
    SimpleQNetwork's `Dense_3/kernel` -> `layers.3.weight`."""
    return _params_from_jax(tree, "Ape-X")


# Flax's automatic names in TransformerQNet -> the port's module names.
_XF_TOP = {"Dense_0": "obs_fc1", "Dense_1": "obs_fc2", "ActionEmbedding_0": "action_embed",
           "Dense_2": "embed", "LayerNorm_0": "final_ln", "Dense_3": "head_fc"}
_XF_HEADS = {"actor_critic": {"Dense_4": "logits", "Dense_5": "value"},
             "dueling_q": {"Dense_4": "q", "Dense_5": "mean"}}
_XF_BLOCK = {"LayerNorm_0": "ln1", "Dense_0": "qkv", "Dense_1": "proj", "LayerNorm_1": "ln2",
             "Dense_2": "mlp1", "Dense_3": "mlp2"}
_XF_BLOCK_NAME = re.compile(r"SelfAttentionBlock_(\d+)$")


def transformer_params_from_jax(tree, head: str = "dueling_q") -> dict[str, torch.Tensor]:
    """-> a state_dict for `TransformerQNet(head=head).load_state_dict(strict=True)`
    (`SelfAttentionBlock_1/Dense_0/kernel` -> `blocks.1.qkv.weight`,
    `ActionEmbedding_0/Dense_1/bias` -> `action_embed.layers.1.bias`,
    `LayerNorm_0/scale` -> `final_ln.weight`,
    `SelfAttentionBlock_0/moe/moe_w1` -> `blocks.0.moe.moe_w1`,
    `blocks_stacked/qkv_kernel` -> `blocks_stacked.qkv_kernel`). Remat
    leaves flax's names as they are, so one table serves both."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    top = {**_XF_TOP, **_XF_HEADS[head]}
    out = {}
    for path, arr in _flatten(tree):
        arr = np.asarray(arr, np.float32)
        *scope, leaf = path
        block = _XF_BLOCK_NAME.match(scope[0])
        if (block and scope[1:] == ["moe"]) or scope == ["blocks_stacked"]:
            names = ["blocks", block.group(1), "moe"] if block else ["blocks_stacked"]
            out[".".join(names + [leaf])] = torch.tensor(np.ascontiguousarray(arr))
            continue
        if block and len(scope) == 2 and scope[1] in _XF_BLOCK:
            names = ["blocks", block.group(1), _XF_BLOCK[scope[1]]]
        elif scope[0] == "ActionEmbedding_0" and len(scope) == 2 and _DENSE.match(scope[1]):
            names = ["action_embed", "layers", _DENSE.match(scope[1]).group(1)]
        elif len(scope) == 1 and scope[0] in top:
            names = [top[scope[0]]]
        else:
            raise KeyError(f"unknown transformer parameter {'/'.join(path)}")
        if leaf == "kernel":
            names.append("weight")
            arr = arr.T
        elif leaf in ("scale", "bias"):
            names.append("weight" if leaf == "scale" else "bias")
        else:
            raise KeyError(f"unknown transformer parameter {'/'.join(path)}")
        out[".".join(names)] = torch.tensor(np.ascontiguousarray(arr))
    return out


def flax_last_dim(name: str, ndim: int) -> int:
    """The dimension of the port's `ndim`-D leaf `name` that holds its
    flax counterpart's last one, by the rules above: a `weight` of two or
    more dimensions was a kernel, transposed (Dense `[in, out]` ->
    Linear `[out, in]`, HWIO -> OIHW), so dim 0; every leaf kept as it is
    (the LSTM's fused `gates_kernel [F+H, 4H]`, the `moe` and
    `blocks_stacked` leaves, biases, LayerNorm weights) its last."""
    return 0 if ndim >= 2 and name.rsplit(".", 1)[-1] == "weight" else ndim - 1


def upgrade_nature_conv_params(tree):
    """The JAX package's `models/torso.py:upgrade_nature_conv_params`:
    rewrite the old NatureConv nesting `Conv_{i}: {kernel, bias}` (flax
    `nn.Conv`) to the explicit `conv{i}_kernel` / `conv{i}_bias` leaves,
    at any depth. Returns a new tree; other subtrees pass through."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for key, val in tree.items():
        if key.startswith("Conv_") and isinstance(val, dict) and set(val) <= {"kernel", "bias"}:
            i = key.split("_", 1)[1]
            for pname, pval in val.items():
                out[f"conv{i}_{pname}"] = pval
        else:
            out[key] = upgrade_nature_conv_params(val)
    return out


def upgrade_nature_conv_names(flat: dict) -> dict:
    """`upgrade_nature_conv_params` over a state_dict's dotted names: an
    old-layout tree converted by the rules above names its convs
    `torso.Conv_{i}.weight` / `.bias`; they become `torso.conv{i}.weight`
    / `.bias`. Other names pass through."""
    return {_OLD_CONV_NAME.sub(r"\1conv\2.\3", k): v for k, v in flat.items()}


def _params_from_jax(tree, family: str) -> dict[str, torch.Tensor]:
    if set(tree) == {"params"}:
        tree = tree["params"]
    tree = upgrade_nature_conv_params(tree)  # trees saved with the old conv nesting
    out = {}
    for path, arr in _flatten(tree):
        arr = np.asarray(arr, np.float32)
        *scope, leaf = path
        names = [f"layers.{_DENSE.match(s).group(1)}" if _DENSE.match(s) else s for s in scope]
        conv = _CONV_LEAF.match(leaf)
        if leaf in ("gates_kernel", "gates_bias"):
            names.append(leaf)
        elif conv:
            names += [f"conv{conv.group(1)}", "weight" if conv.group(2) == "kernel" else "bias"]
        elif leaf in ("kernel", "bias"):
            names.append("weight" if leaf == "kernel" else "bias")
        else:
            raise KeyError(f"unknown {family} parameter {'/'.join(path)}")
        if names[-1] == "weight":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        out[".".join(names)] = torch.tensor(np.ascontiguousarray(arr))
    return out
