"""V-trace recursion: the CUDA kernel (`csrc/vtrace.cu`) and its plain version.

Replaces `ops/pallas/vtrace.py` of the JAX package. Time-major `[T, B]`
inputs and a `[B]` bootstrap value; returns `(vs, clipped_rhos)`, both
`[T, B]` float32. The kernel computes in float32: bfloat16 inputs are
cast to float32 by the wrappers before the kernel or the plain version
sees them, where `vtrace_pallas` casts its inputs (`astype(float32)`). The caller stops gradients at both ends
(`ops/vtrace.py:from_importance_weights`), so there is no backward.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_reinforcement_learning_tpu_torch.ops.kernels import _build, on_cuda


def _check_inputs(log_rhos, discounts, rewards, values, bootstrap_value) -> None:
    if log_rhos.dim() != 2:
        raise ValueError(f"log_rhos must be [T, B], got {tuple(log_rhos.shape)}")
    T, B = log_rhos.shape
    if T < 1 or B < 1:
        raise ValueError(f"empty V-trace problem: T={T}, B={B}")
    for name, t, shape in (("discounts", discounts, (T, B)), ("rewards", rewards, (T, B)),
                           ("values", values, (T, B)), ("bootstrap_value", bootstrap_value, (B,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for t in (log_rhos, discounts, rewards, values, bootstrap_value):
        if t.dtype != torch.float32:
            raise TypeError(f"V-trace takes float32 tensors, got {t.dtype}")


def _as_float32(*tensors) -> tuple[torch.Tensor, ...]:
    """The announced cast: bfloat16 inputs become float32 (the kernel's
    type, as the JAX wrapper casts); other types pass to the checks."""
    return tuple(t.float() if t.dtype == torch.bfloat16 else t for t in tensors)


def vtrace_plain(log_rhos, discounts, rewards, values, bootstrap_value,
                 clip_rho_threshold: float | None = 1.0,
                 clip_c_threshold: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """The recursion in plain PyTorch, the same arithmetic as the JAX
    package's `lax.scan` reference (`ops/vtrace.py:108-130` there)."""
    rhos = torch.exp(log_rhos)
    clipped = rhos if clip_rho_threshold is None else torch.clamp(rhos, max=clip_rho_threshold)
    cs = torch.clamp(rhos, max=clip_c_threshold)
    values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped * (rewards + discounts * values_t_plus_1 - values)
    acc = torch.zeros_like(bootstrap_value)
    rows = [None] * log_rhos.shape[0]
    for t in reversed(range(log_rhos.shape[0])):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        rows[t] = acc
    return torch.stack(rows) + values, clipped


def _signature(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.drl_vtrace.argtypes = [p, p, p, p, p, p, p, i, i, f, i, f, i, p]
    lib.drl_vtrace.restype = ctypes.c_int


def vtrace_cuda(log_rhos, discounts, rewards, values, bootstrap_value,
                clip_rho_threshold: float | None = 1.0,
                clip_c_threshold: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream of the tensors' device.

    Takes contiguous float32 (or bfloat16, cast to float32 here) CUDA
    tensors only; raises on anything else, on a failed build and on a
    refused launch."""
    tensors = _as_float32(log_rhos, discounts, rewards, values, bootstrap_value)
    log_rhos, discounts, rewards, values, bootstrap_value = tensors
    _check_inputs(*tensors)
    if not on_cuda(*tensors):
        raise ValueError("vtrace_cuda takes CUDA tensors")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("vtrace_cuda takes contiguous tensors")
    lib = _build.load("vtrace", _signature)
    T, B = log_rhos.shape
    vs = torch.empty_like(values)
    clipped = torch.empty_like(values)
    device = log_rhos.device
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.drl_vtrace(
        log_rhos.data_ptr(), discounts.data_ptr(), rewards.data_ptr(),
        values.data_ptr(), bootstrap_value.data_ptr(), vs.data_ptr(),
        clipped.data_ptr(), T, B,
        1.0 if clip_rho_threshold is None else float(clip_rho_threshold),
        0 if clip_rho_threshold is None else 1,
        float(clip_c_threshold), device.index, stream)
    _build.check(lib, err, "vtrace kernel launch")
    vtrace_cuda.launches += 1
    return vs, clipped


vtrace_cuda.launches = 0


def vtrace(log_rhos, discounts, rewards, values, bootstrap_value,
           clip_rho_threshold: float | None = 1.0,
           clip_c_threshold: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    args = (log_rhos, discounts, rewards, values, bootstrap_value,
            clip_rho_threshold, clip_c_threshold)
    if on_cuda(*args[:5]):
        return vtrace_cuda(*args)
    tensors = _as_float32(*args[:5])
    _check_inputs(*tensors)
    return vtrace_plain(*tensors, clip_rho_threshold, clip_c_threshold)
