"""Multi-head attention ops: the dense reference, the blockwise online
softmax, and the causal dispatch onto the flash kernels.

Counterpart of the JAX package's `ops/attention.py`. Conventions:
`q/k/v` are `[B, T, H, D]` (batch, time, heads, head_dim); positions are
absolute; segment ids `[B, T]` (episode indices from cumsum(done))
confine attention within an episode.
"""

from __future__ import annotations

import torch

# Finite stand-in for -inf in masked logits: big enough that exp(x - m)
# underflows against any real logit, small enough that subtracting two of
# them is exact (no nan from inf - inf in the online-softmax rescale).
_MASK_VALUE = -0.5 * float(torch.finfo(torch.float32).max)


def _combined_mask(causal: bool, q_pos, k_pos, q_seg, k_seg):
    """[B|1, 1, Tq, Tk] bool mask, or None when nothing constrains."""
    mask = None
    if causal:
        mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
    if q_seg is not None:
        seg = q_seg[:, None, :, None] == k_seg[:, None, None, :]
        mask = seg if mask is None else (mask & seg)
    return mask


def dense_attention(q, k, v, *, causal: bool = True, q_offset: int = 0, kv_offset: int = 0,
                    q_seg=None, k_seg=None) -> torch.Tensor:
    """Plain softmax(QKᵀ/√d)V: the reference the blockwise and flash
    paths are held against, and the path for short sequences."""
    dim = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (dim ** -0.5)
    q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
    k_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
    mask = _combined_mask(causal, q_pos, k_pos, q_seg, k_seg)
    if mask is not None:
        logits = torch.where(mask, logits, _MASK_VALUE)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    if mask is not None:
        # A fully-masked row (no same-segment key) must output zeros, not
        # a uniform average of _MASK_VALUE logits.
        probs = torch.where(mask, probs, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def attention_block_init(q):
    """(m, l, o) accumulator for online softmax over KV blocks: the
    running row max `[B, H, Tq]`, the running denominator `[B, H, Tq]`
    and the unnormalised numerator `[B, Tq, H, D]`, all float32."""
    b, t, h, _ = q.shape
    m = torch.full((b, h, t), _MASK_VALUE, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    return m, l, o


def attention_block_step(acc, q, k_block, v_block, *, causal: bool, q_pos, k_pos,
                         q_seg=None, k_seg=None):
    """Fold one KV block into the accumulator (the flash recurrence).
    Masked probabilities are zeroed explicitly, so a fully-masked block
    contributes exactly nothing."""
    m, l, o = acc
    dim = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_block).to(torch.float32) * (dim ** -0.5)
    mask = _combined_mask(causal, q_pos, k_pos, q_seg, k_seg)
    if mask is not None:
        s = torch.where(mask, s, _MASK_VALUE)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    scale = torch.exp(m - m_new)
    l_new = l * scale + p.sum(-1)
    o_new = o * scale.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, v_block.to(torch.float32))
    return m_new, l_new, o_new


def attention_block_finish(acc, dtype) -> torch.Tensor:
    """Normalise the accumulator into the attention output `[B, T, H, D]`."""
    _, l, o = acc
    denom = torch.clamp(l, min=torch.finfo(torch.float32).tiny)
    return (o / denom.transpose(1, 2)[..., None]).to(dtype)


def blockwise_attention(q, k, v, *, causal: bool = True, block_size: int = 512,
                        segment_ids=None, kv_segment_ids=None) -> torch.Tensor:
    """Attention computed block by block over keys: memory O(T·block)
    instead of O(T²). `kv_segment_ids` defaults to `segment_ids`."""
    t_kv = k.shape[1]
    block_size = min(block_size, t_kv)
    if t_kv % block_size != 0:
        raise ValueError(f"kv length {t_kv} not divisible by block {block_size}")
    q_pos = torch.arange(q.shape[1], device=q.device)
    kv_seg = segment_ids if kv_segment_ids is None else kv_segment_ids
    acc = attention_block_init(q)
    for start in range(0, t_kv, block_size):
        end = start + block_size
        acc = attention_block_step(
            acc, q, k[:, start:end], v[:, start:end], causal=causal, q_pos=q_pos,
            k_pos=torch.arange(start, end, device=q.device), q_seg=segment_ids,
            k_seg=None if kv_seg is None else kv_seg[:, start:end])
    return attention_block_finish(acc, q.dtype)


def causal_attention(q, k, v, *, q_seg=None, k_seg=None) -> torch.Tensor:
    """Causal (optionally segment-masked) MHA with the JAX package's
    shape rule plus one of the port's own: the flash route when T divides
    by a power-of-two block of at least 8 and the head dim is one the
    flash kernels are built for (`HEAD_DIMS`; the CUDA kernels on CUDA
    tensors, their plain version on CPU tensors), else dense softmax up
    to T = 1024 and the blockwise online softmax above it. The rule looks
    at shapes only, on every device: it never catches a failed build or
    launch."""
    from distributed_reinforcement_learning_tpu_torch.ops.kernels.attention import (
        HEAD_DIMS, flash_attention_bhtd, flash_blocks)

    if (q_seg is None) != (k_seg is None):
        raise ValueError("q_seg and k_seg must be provided together")
    b, t, h, d = q.shape
    block = flash_blocks(t)
    if block > 0 and d in HEAD_DIMS:
        zeros = torch.zeros((b, t), dtype=torch.int32, device=q.device)
        qs = zeros if q_seg is None else q_seg.to(torch.int32)
        ks = zeros if k_seg is None else k_seg.to(torch.int32)

        def flat(x):
            # At b = 1 the reshape is a view of the transpose, not a copy:
            # the kernels take contiguous rows.
            return x.transpose(1, 2).reshape(b * h, t, d).contiguous()

        out = flash_attention_bhtd(
            flat(q), flat(k), flat(v), qs.repeat_interleave(h, dim=0),
            ks.repeat_interleave(h, dim=0), block_q=block, block_kv=block)
        return out.reshape(b, h, t, d).transpose(1, 2)
    if t <= 1024:
        return dense_attention(q, k, v, causal=True, q_seg=q_seg, k_seg=k_seg)
    return blockwise_attention(q, k, v, causal=True, block_size=512, segment_ids=q_seg,
                               kv_segment_ids=k_seg)
