"""Flax parameters -> the port's `state_dict`.

The JAX package's parameter tree, as nested dicts of numpy arrays (for
example `params/torso/conv0_kernel (8, 8, 4, 32)`,
`params/lstm/gates_kernel (3648, 1024)`,
`params/policy_head/Dense_2/kernel (256, 18)`), maps onto the port's
module names and layouts (`ImpalaActorCritic`, `R2D2Net`) by one set of
rules:

- conv kernels HWIO -> OIHW; Dense `[in, out]` -> Linear `[out, in]`;
- `Dense_{i}` -> `layers.{i}`; `conv{i}_kernel` / `conv{i}_bias` ->
  `conv{i}.weight` / `conv{i}.bias`; nested `kernel` / `bias` ->
  `weight` / `bias` (ResNetTorso's `section*` convs and `trunk_out`);
- the LSTM keeps its fused `[F+H, 4H]` kernel as it is.

The feature order after a flatten needs no permutation: the port's
torsos flatten NHWC, as the JAX torsos do.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_CONV_LEAF = re.compile(r"conv(\d+)_(kernel|bias)$")
_DENSE = re.compile(r"Dense_(\d+)$")


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


def _params_from_jax(tree, family: str) -> dict[str, torch.Tensor]:
    if set(tree) == {"params"}:
        tree = tree["params"]
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
