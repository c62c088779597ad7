"""Flash attention: the CUDA kernels (`csrc/attention.cu`) and their plain versions.

Replaces `ops/pallas/attention.py` of the JAX package: the forward K3a
(`_fwd_kernel`), dq K3b (`_dq_kernel`) and dk/dv K3c (`_dkv_kernel`),
glued by `FlashAttentionFunction` as `_make_flash`'s `jax.custom_vjp`
glues the Pallas kernels. Causal attention over `[BH, T, D]` (batch x
heads leading) with `[BH, T]` int32 segment ids; query i attends key j
iff j <= i and their segment ids agree.

The port keeps the per-row vectors (segment ids, `lse`, `delta`) as
`[BH, T]`, where the TPU kernels carry `[BH, T, 1]` for the (8, 128)
tiling rule.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_reinforcement_learning_tpu_torch.ops.attention import _MASK_VALUE
from distributed_reinforcement_learning_tpu_torch.ops.kernels import _build, on_cuda

_BLOCK_Q = 128
_BLOCK_KV = 128
# Head dims the CUDA kernels are built for: 32 is the transformer
# sections' (d_model 64 over 2 heads), 64 the longer-context shapes'.
HEAD_DIMS = (32, 64, 128)
_TINY = torch.finfo(torch.float32).tiny


def flash_blocks(t: int, cap: int = _BLOCK_Q) -> int:
    """Largest power-of-two block <= cap dividing t (>= 8), or 0 if none."""
    b = cap
    while b >= 8:
        if t % b == 0:
            return b
        b //= 2
    return 0


def _check_inputs(q, k, v, qs, ks, *rows) -> None:
    if q.dim() != 3:
        raise ValueError(f"q must be [BH, T, D], got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q {q.dtype} {tuple(q.shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (qs, ks, *rows):
        if tuple(t.shape) != tuple(q.shape[:2]):
            raise ValueError(f"segment ids and row vectors must be {tuple(q.shape[:2])}, "
                             f"got {tuple(t.shape)}")


def _block_mask(q0: int, k0: int, nq: int, nk: int, qs, ks) -> torch.Tensor:
    """[BH, nq, nk] causal & same-segment mask of query rows q0.. against
    keys k0.."""
    rows = torch.arange(q0, q0 + nq, device=qs.device)[:, None]
    cols = torch.arange(k0, k0 + nk, device=qs.device)[None, :]
    return (rows >= cols)[None] & (qs[:, q0:q0 + nq, None] == ks[:, None, k0:k0 + nk])


def _first_row(k0: int, block_q: int) -> int:
    """First query row of the first q block that reaches kv position k0
    (earlier blocks are wholly in its past: the TPU kernels' clamp)."""
    return k0 // block_q * block_q


def flash_fwd_plain(q, k, v, qs, ks, block_q: int = _BLOCK_Q, block_kv: int = _BLOCK_KV):
    """K3a's arithmetic in plain PyTorch -> (o [BH, T, D], lse [BH, T] f32).

    The online softmax of `_fwd_kernel`, one kv block at a time, over all
    the query rows that reach it at once."""
    bh, t, d = q.shape
    scale = d ** -0.5
    m = torch.full((bh, t), _MASK_VALUE, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, t, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, t, block_kv):
        r0 = _first_row(k0, block_q)
        k_blk, v_blk = k[:, k0:k0 + block_kv], v[:, k0:k0 + block_kv]
        s = torch.matmul(q[:, r0:], k_blk.transpose(1, 2)).to(torch.float32) * scale
        msk = _block_mask(r0, k0, t - r0, k_blk.shape[1], qs, ks)
        s = torch.where(msk, s, _MASK_VALUE)
        m_old = m[:, r0:]
        m_new = torch.maximum(m_old, s.amax(-1))
        p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m_old - m_new)
        m[:, r0:] = m_new
        l[:, r0:] = l[:, r0:] * alpha + p.sum(-1)
        acc[:, r0:] = acc[:, r0:] * alpha[..., None] + torch.matmul(p, v_blk.to(torch.float32))
    l_safe = torch.clamp(l, min=_TINY)
    return (acc / l_safe[..., None]).to(q.dtype), m + torch.log(l_safe)


def flash_bwd_plain(q, k, v, qs, ks, do, lse, delta, block_q: int = _BLOCK_Q,
                    block_kv: int = _BLOCK_KV):
    """K3b's and K3c's arithmetic in plain PyTorch -> (dq, dk, dv).

    Recomputes `p = exp(s - lse)` from the given `lse` and uses the given
    `delta = rowsum(dO * o)`, one kv block at a time (not autograd)."""
    bh, t, d = q.shape
    scale = d ** -0.5
    f32 = torch.float32
    dq = torch.zeros((bh, t, d), dtype=f32, device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    for k0 in range(0, t, block_kv):
        r0 = _first_row(k0, block_q)
        k_blk, v_blk = k[:, k0:k0 + block_kv].to(f32), v[:, k0:k0 + block_kv].to(f32)
        q_rows, do_rows = q[:, r0:].to(f32), do[:, r0:].to(f32)
        s = torch.matmul(q_rows, k_blk.transpose(1, 2)) * scale
        msk = _block_mask(r0, k0, t - r0, k_blk.shape[1], qs, ks)
        p = torch.where(msk, torch.exp(s - lse[:, r0:, None]), 0.0)
        dv[:, k0:k0 + block_kv] = torch.matmul(p.transpose(1, 2), do_rows)
        dp = torch.matmul(do_rows, v_blk.transpose(1, 2))
        ds = p * (dp - delta[:, r0:, None]) * scale
        dk[:, k0:k0 + block_kv] = torch.matmul(ds.transpose(1, 2), q_rows)
        dq[:, r0:] += torch.matmul(ds, k_blk)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _signature(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.drl_flash_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, f, i, p]
    lib.drl_flash_fwd.restype = ctypes.c_int
    lib.drl_flash_dq.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, f, i, p]
    lib.drl_flash_dq.restype = ctypes.c_int
    lib.drl_flash_dkv.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, f, i, p]
    lib.drl_flash_dkv.restype = ctypes.c_int


def _load_for(what: str, q, k, v, qs, ks, *rows, do=None) -> ctypes.CDLL:
    """Check the kernels' contract (contiguous CUDA tensors of one device,
    float32 q/k/v/dO and row vectors, int32 segment ids, q/k/v/dO and the
    segment ids aligned to 16 bytes, D in HEAD_DIMS, T a multiple of 8)
    -> the loaded library. Raises on anything else."""
    _check_inputs(q, k, v, qs, ks, *rows)
    mats = (q, k, v) if do is None else (q, k, v, do)
    if do is not None and (do.shape != q.shape or do.dtype != q.dtype):
        raise ValueError(f"{what}: dO must match q {q.dtype} {tuple(q.shape)}, got "
                         f"{do.dtype} {tuple(do.shape)}")
    tensors = (*mats, qs, ks, *rows)
    if not on_cuda(*tensors):
        raise ValueError(f"{what} takes CUDA tensors")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")
    for t in (*mats, qs, ks):
        if t.data_ptr() % 16:  # the kernels load rows of these 16 bytes at a time
            raise ValueError(f"{what} takes q, k, v, dO and segment ids aligned to 16 bytes")
    for t in (q, *rows):
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes float32 tensors, got {t.dtype}")
    for t in (qs, ks):
        if t.dtype != torch.int32:
            raise TypeError(f"{what} takes int32 segment ids, got {t.dtype}")
    bh, t, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} is not one of {HEAD_DIMS}")
    if bh < 1 or t < 8 or t % 8:
        raise ValueError(f"{what}: T={t} must be a positive multiple of 8 (BH={bh})")
    return _build.load("attention", _signature)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_fwd_cuda(q, k, v, qs, ks):
    """K3a: one launch on the current stream -> (o, lse)."""
    lib = _load_for("flash_fwd_cuda", q, k, v, qs, ks)
    bh, t, d = q.shape
    o = torch.empty_like(q)
    lse = q.new_empty((bh, t))
    err = lib.drl_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), qs.data_ptr(),
                            ks.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, t, d,
                            d ** -0.5, q.device.index, _stream(q))
    _build.check(lib, err, "flash attention forward kernel launch")
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


def flash_dq_cuda(q, k, v, qs, ks, do, lse, delta):
    """K3b: one launch on the current stream -> dq."""
    lib = _load_for("flash_dq_cuda", q, k, v, qs, ks, lse, delta, do=do)
    bh, t, d = q.shape
    dq = torch.empty_like(q)
    err = lib.drl_flash_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), qs.data_ptr(),
                           ks.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                           dq.data_ptr(), bh, t, d, d ** -0.5, q.device.index, _stream(q))
    _build.check(lib, err, "flash attention dq kernel launch")
    flash_dq_cuda.launches += 1
    return dq


flash_dq_cuda.launches = 0


def flash_dkv_cuda(q, k, v, qs, ks, do, lse, delta):
    """K3c: one launch on the current stream -> (dk, dv)."""
    lib = _load_for("flash_dkv_cuda", q, k, v, qs, ks, lse, delta, do=do)
    bh, t, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = lib.drl_flash_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), qs.data_ptr(),
                            ks.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                            dk.data_ptr(), dv.data_ptr(), bh, t, d, d ** -0.5,
                            q.device.index, _stream(q))
    _build.check(lib, err, "flash attention dk/dv kernel launch")
    flash_dkv_cuda.launches += 1
    return dk, dv


flash_dkv_cuda.launches = 0


def flash_fwd(q, k, v, qs, ks, block_q: int = _BLOCK_Q, block_kv: int = _BLOCK_KV):
    """K3a for CUDA tensors, the plain version for CPU tensors."""
    if on_cuda(q, k, v, qs, ks):
        return flash_fwd_cuda(q, k, v, qs, ks)
    _check_inputs(q, k, v, qs, ks)
    return flash_fwd_plain(q, k, v, qs, ks, block_q, block_kv)


def flash_bwd(q, k, v, qs, ks, do, lse, delta, block_q: int = _BLOCK_Q,
              block_kv: int = _BLOCK_KV):
    """K3b and K3c for CUDA tensors, the plain version for CPU tensors
    -> (dq, dk, dv)."""
    args = (q, k, v, qs, ks, do, lse, delta)
    if on_cuda(*args):
        return (flash_dq_cuda(*args), *flash_dkv_cuda(*args))
    _check_inputs(q, k, v, qs, ks, lse, delta)
    return flash_bwd_plain(*args, block_q, block_kv)


class FlashAttentionFunction(torch.autograd.Function):
    """`(q, k, v, qs, ks, block_q, block_kv) -> o` with the flash
    backward (the `jax.custom_vjp` of `ops/pallas/attention.py:289-308`).
    No gradient flows to the segment ids."""

    @staticmethod
    def forward(ctx, q, k, v, qs, ks, block_q, block_kv):
        o, lse = flash_fwd(q, k, v, qs, ks, block_q, block_kv)
        ctx.save_for_backward(q, k, v, qs, ks, o, lse)
        ctx.blocks = (block_q, block_kv)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, qs, ks, o, lse = ctx.saved_tensors
        # One reduction outside the kernels, as `f_bwd` computes it.
        delta = torch.sum(do.to(torch.float32) * o.to(torch.float32), dim=-1)
        dq, dk, dv = flash_bwd(q, k, v, qs, ks, do.contiguous(), lse, delta, *ctx.blocks)
        return dq, dk, dv, None, None, None, None


def flash_attention_bhtd(q, k, v, q_seg, k_seg, block_q: int = _BLOCK_Q,
                         block_kv: int = _BLOCK_KV) -> torch.Tensor:
    """Causal flash attention on `[BH, T, D]` with `[BH, T]` segment ids.

    T must divide by both block sizes (choose them with `flash_blocks`),
    as in the JAX package. The blocks shape the plain version's loop; the
    CUDA kernels pick their own tiling, and the result does not depend on
    the blocks beyond rounding. Differentiable through K3b and K3c."""
    bh, t, _ = q.shape
    if t % block_q or t % block_kv:
        raise ValueError(f"T={t} not divisible by blocks ({block_q}, {block_kv})")
    qs = q_seg.to(torch.int32).reshape(bh, t).contiguous()
    ks = k_seg.to(torch.int32).reshape(bh, t).contiguous()
    return FlashAttentionFunction.apply(q, k, v, qs, ks, block_q, block_kv)
