"""LSTM cell of the recurrent agents.

Counterpart of the JAX package's `models/recurrent.py:LSTMCell`. One fused
`[input+hidden, 4*hidden]` kernel over `[x; h]` plus a `[4*hidden]` bias,
TF1 `LSTMCell` parity with forget bias 1.0 (`ops/lstm.py:lstm_step`).
`torch.nn.LSTMCell` keeps separate input and recurrent matrices, two
biases and no forget bias, so it is not used.

- The single step (`forward`) serves the act paths and stored-state
  IMPALA, which applies the cell to a flattened `[B*T]` batch. It stays
  plain on every device, as the JAX cell pins its single step to the
  reference scan.
- `unroll` runs a `[B, T]` sequence with done-masked resets (R2D2): the
  input half of the kernel projects all steps in one product, and only
  the recurrent half enters the recursion (`ops/lstm.py:lstm_scan`, the
  CUDA kernels on the card).

Under a bfloat16 model (`dtype`) the cell's input arrives in bfloat16 and
is promoted to the float32 kernel's type before the input projection, as
the JAX cell's `jnp.dot(bf16, f32)` promotes: the gates, the carry and
the recursion stay float32.
"""

from __future__ import annotations

import torch
from torch import nn

from distributed_reinforcement_learning_tpu_torch.models.torso import glorot_uniform_
from distributed_reinforcement_learning_tpu_torch.ops.lstm import lstm_scan, lstm_step


class LSTMCell(nn.Module):
    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.gates_kernel = nn.Parameter(torch.empty(input_size + hidden_size, 4 * hidden_size))
        self.gates_bias = nn.Parameter(torch.zeros(4 * hidden_size))

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        rows, cols = self.gates_kernel.shape
        glorot_uniform_(self.gates_kernel, rows, cols, generator)
        with torch.no_grad():
            self.gates_bias.zero_()

    def forward(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        """Single step on an `[N, F]` batch -> (h', c'), each `[N, hidden]`.

        The same sums as the JAX cell: the input projection plus bias
        first, then the recurrent projection."""
        feat = x.shape[-1]
        xg = x.to(self.gates_kernel.dtype) @ self.gates_kernel[:feat] + self.gates_bias
        return lstm_step(xg + h @ self.gates_kernel[feat:], c)

    def unroll(self, z_seq: torch.Tensor, done_seq: torch.Tensor, h: torch.Tensor,
               c: torch.Tensor):
        """`[B, T, F]` inputs, `[B, T]` bool dones, `[B, hidden]` start
        state -> (h_all `[B, T, hidden]` pre-mask outputs, (hT, cT) masked
        carry). (h, c) are zeroed AFTER any step where done is set."""
        feat = z_seq.shape[-1]
        xg = z_seq.to(self.gates_kernel.dtype) @ self.gates_kernel[:feat] + self.gates_bias
        keep = 1.0 - done_seq.to(xg.dtype)
        return lstm_scan(xg, self.gates_kernel[feat:], keep, h, c)
