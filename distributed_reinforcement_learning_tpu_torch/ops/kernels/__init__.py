"""Hand-written CUDA kernels for the hot ops, with their plain versions.

Counterpart of the JAX package's `ops/pallas/`. There a backend resolver
picks the Pallas kernel on a TPU; here the choice follows the tensors:
CUDA tensors go to the kernel, CPU tensors to the plain PyTorch version
beside it. Nothing chooses by option or environment variable, and
nothing falls back: on CUDA tensors a kernel launches or raises.

Each kernel module keeps, beside its wrapper, the plain version (the CPU
path and the reference the kernel is checked against on the card) and a
plain-int `launches` count on the wrapper, raised once per launch.

Sources live in `csrc/`; `_build` compiles them with nvcc for sm_90a on
first use and loads them with ctypes.
"""

from __future__ import annotations

import torch


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; raises on a mix or on any other device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count in this process."""
    from distributed_reinforcement_learning_tpu_torch.ops.kernels import attention as kattn
    from distributed_reinforcement_learning_tpu_torch.ops.kernels import lstm as klstm
    from distributed_reinforcement_learning_tpu_torch.ops.kernels import vtrace as kvt

    return {"vtrace": kvt.vtrace_cuda.launches, "lstm_fwd": klstm.lstm_fwd_cuda.launches,
            "lstm_bwd": klstm.lstm_bwd_cuda.launches,
            "attention_fwd": kattn.flash_fwd_cuda.launches,
            "attention_dq": kattn.flash_dq_cuda.launches,
            "attention_dkv": kattn.flash_dkv_cuda.launches}
