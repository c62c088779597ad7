"""LSTM recursion: the CUDA kernels (`csrc/lstm.cu`) and their plain versions.

Replaces `ops/pallas/lstm.py` of the JAX package: the forward K2a
(`_fwd_kernel`) and the hand-derived BPTT backward K2b (`_bwd_kernel`),
glued by `LSTMFunction` as `jax.custom_vjp` glues the Pallas pair.
Time-major float32 throughout:

    xg [T, B, 4H]   input projection plus bias
    wh [H, 4H]      recurrent weights
    keep [T, B]     1 - done: the carry is zeroed after step t when 0
    h0, c0 [B, H]   sequence-start state

The forward returns the pre-mask `h_all`, `c_all` `[T, B, H]` and the
masked final carry `hT`, `cT`; the backward takes the gradients of
`h_all`, `hT`, `cT` and returns those of `xg`, `h0`, `c0`. `dWh` is one
batched product over the emitted `dxg`, outside the kernels, as in the
JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_reinforcement_learning_tpu_torch.ops.kernels import _build, on_cuda


def _check_inputs(xg, wh, keep, h0, c0) -> None:
    if xg.dim() != 3 or xg.shape[2] % 4:
        raise ValueError(f"xg must be [T, B, 4H], got {tuple(xg.shape)}")
    T, B, G = xg.shape
    H = G // 4
    if T < 1 or B < 1 or H < 1:
        raise ValueError(f"empty LSTM problem: T={T}, B={B}, H={H}")
    for name, t, shape in (("wh", wh, (H, G)), ("keep", keep, (T, B)),
                           ("h0", h0, (B, H)), ("c0", c0, (B, H))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for t in (xg, wh, keep, h0, c0):
        if t.dtype != torch.float32:
            raise TypeError(f"the LSTM kernels take float32 tensors, got {t.dtype}")


def lstm_fwd_plain(xg, wh, keep, h0, c0):
    """The recursion in plain PyTorch, step by step as the JAX package's
    `lax.scan` reference -> (h_all, c_all, hT, cT). The cell update is
    `ops/lstm.py:lstm_step`'s."""
    h, c = h0, c0
    hs, cs = [], []
    for t in range(xg.shape[0]):
        i, f, g, o = torch.chunk(xg[t] + h @ wh, 4, dim=-1)
        new_c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        hs.append(new_h)
        cs.append(new_c)
        k = keep[t][:, None]
        h, c = new_h * k, new_c * k
    return torch.stack(hs), torch.stack(cs), h, c


def lstm_bwd_plain(xg, wh, keep, h0, c0, h_all, c_all, dh_all, dhT, dcT):
    """The hand-derived BPTT of `_bwd_kernel` in plain PyTorch: walk t
    backwards, recompute the gates, carry dh and dc -> (dxg, dh0, dc0)."""
    dh_carry, dc_carry = dhT, dcT
    dxg = torch.empty_like(xg)
    for t in reversed(range(xg.shape[0])):
        if t == 0:
            h_prev, c_in = h0, c0
        else:
            k_prev = keep[t - 1][:, None]
            h_prev, c_in = h_all[t - 1] * k_prev, c_all[t - 1] * k_prev
        i, f, g, o = torch.chunk(xg[t] + h_prev @ wh, 4, dim=-1)
        si, sf, sg, so = torch.sigmoid(i), torch.sigmoid(f + 1.0), torch.tanh(g), torch.sigmoid(o)
        tc = torch.tanh(c_all[t])
        k = keep[t][:, None]
        dh = dh_all[t] + k * dh_carry
        dc = k * dc_carry + dh * so * (1.0 - tc * tc)
        dgates = torch.cat([dc * sg * si * (1.0 - si), dc * c_in * sf * (1.0 - sf),
                            dc * si * (1.0 - sg * sg), dh * tc * so * (1.0 - so)], dim=-1)
        dxg[t] = dgates
        dh_carry = dgates @ wh.T
        dc_carry = dc * sf
    return dxg, dh_carry, dc_carry


def _signature(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.drl_lstm_fwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.drl_lstm_fwd.restype = ctypes.c_int
    lib.drl_lstm_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.drl_lstm_bwd.restype = ctypes.c_int
    lib.drl_lstm_max_hidden.argtypes = []
    lib.drl_lstm_max_hidden.restype = ctypes.c_int


def _load_for(tensors, what: str) -> ctypes.CDLL:
    """Check that `tensors` are contiguous CUDA tensors of one device and
    the hidden size fits the kernels; -> the loaded library."""
    if not on_cuda(*tensors):
        raise ValueError(f"{what} takes CUDA tensors")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")
    lib = _build.load("lstm", _signature)
    H = tensors[1].shape[0]
    if H % 4 or H > lib.drl_lstm_max_hidden():
        raise ValueError(f"{what}: hidden size {H} must be a multiple of 4 and at "
                         f"most {lib.drl_lstm_max_hidden()}")
    return lib


def lstm_fwd_cuda(xg, wh, keep, h0, c0):
    """K2a: T launches (one per step) on the current stream of the
    tensors' device -> (h_all, c_all, hT, cT). Takes contiguous float32
    CUDA tensors only; raises on anything else, on a failed build and on
    a refused launch."""
    tensors = (xg, wh, keep, h0, c0)
    _check_inputs(*tensors)
    lib = _load_for(tensors, "lstm_fwd_cuda")
    T, B, G = xg.shape
    h_all = xg.new_empty((T, B, G // 4))
    c_all = torch.empty_like(h_all)
    hT, cT = torch.empty_like(h0), torch.empty_like(c0)
    device = xg.device
    err = lib.drl_lstm_fwd(
        xg.data_ptr(), wh.data_ptr(), keep.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        h_all.data_ptr(), c_all.data_ptr(), hT.data_ptr(), cT.data_ptr(), T, B, G // 4,
        device.index, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, err, "LSTM forward kernel launch")
    lstm_fwd_cuda.launches += 1
    return h_all, c_all, hT, cT


lstm_fwd_cuda.launches = 0


def lstm_bwd_cuda(xg, wh, keep, h0, c0, h_all, c_all, dh_all, dhT, dcT):
    """K2b: a transpose of Wh, then two launches per step, on the current
    stream -> (dxg, dh0, dc0). Same contract as `lstm_fwd_cuda`."""
    tensors = (xg, wh, keep, h0, c0, h_all, c_all, dh_all, dhT, dcT)
    _check_inputs(*tensors[:5])
    T, B, G = xg.shape
    for name, t, shape in (("h_all", h_all, (T, B, G // 4)), ("c_all", c_all, (T, B, G // 4)),
                           ("dh_all", dh_all, (T, B, G // 4)), ("dhT", dhT, (B, G // 4)),
                           ("dcT", dcT, (B, G // 4))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}, got {t.dtype} {tuple(t.shape)}")
    lib = _load_for(tensors, "lstm_bwd_cuda")
    dxg = torch.empty_like(xg)
    # The kernels carry dh and dc in these buffers: dhT, dcT in, dh0, dc0 out.
    dh0, dc0 = dhT.clone(), dcT.clone()
    wh_t = wh.new_empty((G, G // 4))
    device = xg.device
    err = lib.drl_lstm_bwd(
        xg.data_ptr(), wh.data_ptr(), keep.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        h_all.data_ptr(), c_all.data_ptr(), dh_all.data_ptr(), dxg.data_ptr(),
        dh0.data_ptr(), dc0.data_ptr(), wh_t.data_ptr(), T, B, G // 4, device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, err, "LSTM backward kernel launch")
    lstm_bwd_cuda.launches += 1
    return dxg, dh0, dc0


lstm_bwd_cuda.launches = 0


def lstm_fwd(xg, wh, keep, h0, c0):
    """K2a for CUDA tensors, the plain version for CPU tensors."""
    if on_cuda(xg, wh, keep, h0, c0):
        return lstm_fwd_cuda(xg, wh, keep, h0, c0)
    _check_inputs(xg, wh, keep, h0, c0)
    return lstm_fwd_plain(xg, wh, keep, h0, c0)


def lstm_bwd(xg, wh, keep, h0, c0, h_all, c_all, dh_all, dhT, dcT):
    """K2b for CUDA tensors, the plain version for CPU tensors."""
    args = (xg, wh, keep, h0, c0, h_all, c_all, dh_all, dhT, dcT)
    if on_cuda(*args):
        return lstm_bwd_cuda(*args)
    _check_inputs(*args[:5])
    return lstm_bwd_plain(*args)


class LSTMFunction(torch.autograd.Function):
    """`(xg, wh, keep, h0, c0) -> (h_all, hT, cT)` with the BPTT kernel
    as its backward (the `jax.custom_vjp` of `ops/pallas/lstm.py:193-219`)."""

    @staticmethod
    def forward(ctx, xg, wh, keep, h0, c0):
        h_all, c_all, hT, cT = lstm_fwd(xg, wh, keep, h0, c0)
        ctx.save_for_backward(xg, wh, keep, h0, c0, h_all, c_all)
        return h_all, hT, cT

    @staticmethod
    def backward(ctx, dh_all, dhT, dcT):
        xg, wh, keep, h0, c0, h_all, c_all = ctx.saved_tensors
        dxg, dh0, dc0 = lstm_bwd(xg, wh, keep, h0, c0, h_all, c_all, dh_all.contiguous(),
                                 dhT.contiguous(), dcT.contiguous())
        # dWh: each step's input h against its dgates, one [H, T*B] x
        # [T*B, 4H] product.
        h_prev = torch.cat([h0[None], h_all[:-1] * keep[:-1, :, None]])
        H = h0.shape[1]
        dwh = h_prev.reshape(-1, H).T @ dxg.reshape(-1, 4 * H)
        dkeep = torch.zeros_like(keep) if ctx.needs_input_grad[2] else None
        return dxg, dwh, dkeep, dh0, dc0
