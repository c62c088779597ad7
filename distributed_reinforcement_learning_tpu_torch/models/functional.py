"""`functional_call`: run a module under explicit parameter tensors.

The agents keep their parameters as explicit tensors (the JAX package's
functional style) and run a structure-only module under them. This is
`torch.func.functional_call` for that use, without its per-call
bookkeeping: a module's parameter (and buffer) slots are looked up once
and cached on the module, and a call writes the given tensors into the
slots, runs the module and puts the module's own tensors back. The
arithmetic is the module's own, so outputs and gradients are the same
bits as through `torch.func.functional_call`, for less host time a call
(`tests/test_torch_models.py`). No port model shares a tensor between
two names, and a module that does is refused.

Each thread needs a module of its own (the agents hold one a thread,
`agents/common.ThreadLocalModelMixin`): the slots are the module's
state while a call runs.
"""

from __future__ import annotations

from typing import Any

import torch


def _slots(module: torch.nn.Module) -> dict[str, tuple[dict, str]]:
    """name -> (the owning `_parameters` or `_buffers` dict, leaf name),
    built once a module. Raises ValueError when a tensor has two names."""
    if "_functional_slots" in module.__dict__:
        return module.__dict__["_functional_slots"]
    slots: dict[str, tuple[dict, str]] = {}
    seen: dict[int, str] = {}
    for kind, named in (("_parameters", module.named_parameters(remove_duplicate=False)),
                        ("_buffers", module.named_buffers(remove_duplicate=False))):
        for name, tensor in named:
            if id(tensor) in seen:
                raise ValueError(f"functional_call: {name!r} is tied to {seen[id(tensor)]!r}; "
                                 "the port's models share no tensor between two names")
            seen[id(tensor)] = name
            owner, _, leaf = name.rpartition(".")
            slots[name] = (getattr(module.get_submodule(owner), kind), leaf)
    module.__dict__["_functional_slots"] = slots
    return slots


def functional_call(module: torch.nn.Module, params: dict[str, torch.Tensor], args: Any,
                    kwargs: dict | None = None) -> Any:
    """`module(*args, **kwargs)` with `params` (a subset of its parameter
    and buffer names) in place of its own tensors, which are back in
    place when the call returns or raises."""
    slots = _slots(module)
    if not isinstance(args, tuple):
        args = (args,)
    saved = []
    try:
        for name, tensor in params.items():
            owner, leaf = slots[name]
            saved.append((owner, leaf, owner[leaf]))
            owner[leaf] = tensor
        return module(*args, **(kwargs or {}))
    finally:
        for owner, leaf, own in reversed(saved):
            owner[leaf] = own
