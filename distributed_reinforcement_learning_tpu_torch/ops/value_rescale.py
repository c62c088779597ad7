"""R2D2 value-function rescaling h(x) and its closed-form inverse.

Counterpart of the JAX package's `ops/value_rescale.py` (R2D2 paper,
table 2; "Observe and Look Further", Prop. A.2).
"""

from __future__ import annotations

import torch


def value_rescale(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """h(x) = sign(x) * (sqrt(|x| + 1) - 1) + eps * x."""
    return torch.sign(x) * (torch.sqrt(torch.abs(x) + 1.0) - 1.0) + eps * x


def inverse_value_rescale(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """h^{-1}(x), exact closed form for the eps-regularised rescaling."""
    return torch.sign(x) * (
        torch.square((torch.sqrt(1.0 + 4.0 * eps * (torch.abs(x) + 1.0 + eps)) - 1.0)
                     / (2.0 * eps)) - 1.0)
