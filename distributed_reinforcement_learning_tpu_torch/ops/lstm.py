"""LSTM cell update and sequence recursion, shared by the recurrent models.

Counterpart of the JAX package's `ops/lstm.py`. Gate math is TF1
`LSTMCell` parity with forget bias 1.0:

    i, f, g, o = split(gates, 4)
    c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(g)
    h' = sigmoid(o) * tanh(c')

Done-masking: the carried (h, c) are zeroed AFTER the step at which
done[t] is set; the emitted h_t is pre-mask.

`lstm_scan` runs the recursion through `ops/kernels/lstm.py:LSTMFunction`
on either device: the CUDA kernels (forward and BPTT) for CUDA tensors,
their plain versions for CPU tensors. The JAX package resolves `auto` to
its `lax.scan` on a TPU and takes the Pallas pair only when asked; the
port has no such switch, so on the card every unroll goes through the
kernels. `_scan_reference` is the plain differentiable loop, the
yardstick autograd differentiates in the tests.

Shapes (batch-major, as the models use them):
    xg   [B, T, 4H]   input projection + bias
    wh   [H, 4H]      recurrent weights
    keep [B, T]       1.0 - done
    h0/c0 [B, H]      sequence-start stored state
Returns (h_all [B, T, H], (hT [B, H], cT [B, H])).
"""

from __future__ import annotations

import torch

from distributed_reinforcement_learning_tpu_torch.ops.kernels.lstm import LSTMFunction


def lstm_step(gates: torch.Tensor, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One cell update from pre-activation gates `[N, 4H]` -> (h', c')."""
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    new_c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    return new_h, new_c


def _scan_reference(xg_tm, wh, keep_tm, h0, c0):
    """Time-major plain loop; autograd provides its gradient."""
    h, c = h0, c0
    outs = []
    for t in range(xg_tm.shape[0]):
        new_h, new_c = lstm_step(xg_tm[t] + h @ wh, c)
        outs.append(new_h)
        k = keep_tm[t][:, None]
        h, c = new_h * k, new_c * k
    return torch.stack(outs), (h, c)


def lstm_scan(xg: torch.Tensor, wh: torch.Tensor, keep: torch.Tensor,
              h0: torch.Tensor, c0: torch.Tensor):
    """Run the recursion; see the module docstring for shapes."""
    xg_tm = xg.transpose(0, 1).contiguous()
    keep_tm = keep.transpose(0, 1).to(xg.dtype).contiguous()
    h_all_tm, hT, cT = LSTMFunction.apply(xg_tm, wh.contiguous(), keep_tm,
                                          h0.contiguous(), c0.contiguous())
    return h_all_tm.transpose(0, 1), (hT, cT)
