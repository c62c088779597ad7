"""Sequence parallelism: ring attention and all-to-all (Ulysses) over the
`seq` axis of a mesh of ranks.

Counterpart of the JAX package's `parallel/sequence.py`. There one
`shard_map` runs a per-device body over a device mesh; here each rank is
one process and runs that body on its own shard, calling the mesh's
collectives (`parallel/mesh.py`):

- **Ring attention** (`ring_attention`): each rank keeps its queries
  `[B, T/n, H, D]`; the key/value blocks travel round the ring
  (`mesh.shift`, JAX's `lax.ppermute`) while each rank folds them into
  the online-softmax accumulator of `ops/attention.py`. With
  `schedule="zigzag"` (causal only) each rank holds the chunks (i,
  2n-1-i), so every rank does the same work at every hop.
- **Ulysses** (`ulysses_attention`): two all-to-alls reshard sequence ->
  heads, dense attention over the whole sequence for H/n heads, then
  back; the heads must divide by the axis.

Both confine attention within episodes by segment ids (which travel with
their key/value block round the ring, or are all-gathered for Ulysses)
and are differentiable: each collective's backward is its transpose.
JAX's `lax.cond` skips of causally future blocks are Python branches
here, uniform per rank. The rotation runs at every hop on every rank
whatever the branch took, so the ring's collectives stay in step: the
n - 1 rotations of a call are one autograd node (`_RingRotations`) that
every rank reads at hop 0, so its backward (the reverse rotations,
carrying the blocks' cotangents home) runs on every rank even where the
skips left later blocks unread. JAX's scan makes an n-th rotation whose
result no device reads; it is not made here.

So in this form the ring is an all-gather of the key/value blocks done
in n - 1 serial hops: every rank holds all n blocks before its first
block step, and no hop's transfer overlaps a block step (gloo's
point-to-point calls block). The two things a ring normally buys, one
block in memory at a time and transfers hidden behind compute, are not
claimed here; what it keeps is JAX's numbers, hop order and bytes a hop.

Two levels, as in JAX: the per-rank bodies (`ring_shard`,
`ring_shard_zigzag`, `ulysses_shard`) take this rank's shard and are
what the transformer calls on its sequence-sharded stream
(`models/transformer_net.py`); `ring_attention` and `ulysses_attention`
take the whole sequence of this rank's rows (the same on every rank of
the `seq` axis, as JAX's global arrays are) and return the whole
attention output. `batch_axis` is JAX's argument; in the port a rank's
rows are already its own, so it changes nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_reinforcement_learning_tpu_torch.ops import attention as att
from distributed_reinforcement_learning_tpu_torch.parallel import mesh as mesh_lib
from distributed_reinforcement_learning_tpu_torch.parallel.mesh import SEQ_AXIS, RankMesh


class _RingRotations(torch.autograd.Function):
    """The packed key/value block after 0, 1, ..., n-1 hops round the
    ring. Backward: the hops' cotangents carried back hop by hop (the
    reverse shift, summing in each hop's own), the same n - 1 collectives
    on every rank."""

    @staticmethod
    def forward(ctx, kv, mesh):
        ctx.mesh = mesh
        blocks = [kv]
        for _ in range(mesh.size(SEQ_AXIS) - 1):
            blocks.append(mesh.shift(blocks[-1], SEQ_AXIS))
        return tuple(blocks)

    @staticmethod
    def backward(ctx, *grads):
        mesh = ctx.mesh
        carry = grads[-1]
        for g in reversed(grads[:-1]):
            carry = g + mesh.shift(carry, SEQ_AXIS, -1)
        return carry, None


def _ring_blocks(mesh: RankMesh, k, v, seg) -> list:
    """[(k, v, segment ids) after h hops] for h = 0..n-1: the blocks that
    started on ranks idx, idx-1, ... (mod n)."""
    kvs = _RingRotations.apply(torch.stack([k, v]), mesh)
    segs = [seg]
    for _ in range(len(kvs) - 1):
        segs.append(None if seg is None else mesh.shift(segs[-1], SEQ_AXIS))
    return [(kv[0], kv[1], s) for kv, s in zip(kvs, segs)]


def ring_shard(mesh: RankMesh, q, k, v, seg, *, causal: bool) -> torch.Tensor:
    """Per-rank body: this rank's queries against the rotating KV ring.
    `q, k, v` `[B, T/n, H, D]` are the rank's contiguous chunk, `seg`
    `[B, T/n]` its segment ids or None."""
    n, idx = mesh.size(SEQ_AXIS), mesh.coords[SEQ_AXIS]
    t = q.shape[1]
    ar = torch.arange(t, device=q.device)
    q_pos = idx * t + ar
    acc = att.attention_block_init(q)
    for hop, (k_blk, v_blk, k_seg) in enumerate(_ring_blocks(mesh, k, v, seg)):
        # After `hop` rotations this rank holds the block that started on
        # rank (idx - hop) mod n. A block wholly in this shard's future is
        # masked: skip its products.
        src = (idx - hop) % n
        if not (causal and src > idx):
            acc = att.attention_block_step(
                acc, q, k_blk, v_blk, causal=causal, q_pos=q_pos, k_pos=src * t + ar,
                q_seg=seg, k_seg=k_seg)
    return att.attention_block_finish(acc, q.dtype)


def ring_shard_zigzag(mesh: RankMesh, q, k, v, seg, *, causal: bool) -> torch.Tensor:
    """Per-rank body of the balanced causal ring: rank i's shard is chunk
    i then chunk 2n-1-i of the sequence. Of the four quadrants a hop,
    early queries x late keys are always future (never computed), late
    queries x early keys always past (no causal mask), and the two
    same-half quadrants are needed about half the hops."""
    if not causal:
        raise ValueError("zigzag schedule only pays for causal attention")
    n, idx = mesh.size(SEQ_AXIS), mesh.coords[SEQ_AXIS]
    c = q.shape[1] // 2
    ar = torch.arange(c, device=q.device)
    qe, ql = q[:, :c], q[:, c:]
    qe_pos, ql_pos = idx * c + ar, (2 * n - 1 - idx) * c + ar
    seg_e = None if seg is None else seg[:, :c]
    seg_l = None if seg is None else seg[:, c:]
    acc_e, acc_l = att.attention_block_init(qe), att.attention_block_init(ql)
    for hop, (k_blk, v_blk, k_seg) in enumerate(_ring_blocks(mesh, k, v, seg)):
        src = (idx - hop) % n
        ke, kl = k_blk[:, :c], k_blk[:, c:]
        ve, vl = v_blk[:, :c], v_blk[:, c:]
        ke_pos, kl_pos = src * c + ar, (2 * n - 1 - src) * c + ar
        ks_e = None if k_seg is None else k_seg[:, :c]
        ks_l = None if k_seg is None else k_seg[:, c:]
        if src <= idx:  # early x early: the diagonal masked inside
            acc_e = att.attention_block_step(acc_e, qe, ke, ve, causal=True, q_pos=qe_pos,
                                             k_pos=ke_pos, q_seg=seg_e, k_seg=ks_e)
        # late x early: always past, only the segments mask.
        acc_l = att.attention_block_step(acc_l, ql, ke, ve, causal=False, q_pos=ql_pos,
                                         k_pos=ke_pos, q_seg=seg_l, k_seg=ks_e)
        if src >= idx:  # late x late
            acc_l = att.attention_block_step(acc_l, ql, kl, vl, causal=True, q_pos=ql_pos,
                                             k_pos=kl_pos, q_seg=seg_l, k_seg=ks_l)
    return torch.cat([att.attention_block_finish(acc_e, q.dtype),
                      att.attention_block_finish(acc_l, q.dtype)], dim=1)


def ulysses_shard(mesh: RankMesh, q, k, v, seg, *, causal: bool) -> torch.Tensor:
    """Per-rank body: reshard sequence -> heads (one all-to-all of q, k
    and v packed), dense attention over the whole sequence, reshard
    back."""
    n = mesh.size(SEQ_AXIS)
    if q.shape[2] % n != 0:
        raise ValueError(f"ulysses needs heads ({q.shape[2]}) divisible by seq axis ({n}); "
                         "use ring_attention otherwise")
    qkv = mesh_lib.all_to_all(mesh, torch.stack([q, k, v]), SEQ_AXIS, split_dim=3,
                              concat_dim=2)  # [3, B, T, H/n, D]
    if seg is not None:
        # Segments have no head axis to scatter: every rank needs the
        # whole sequence's ids for its whole-sequence heads.
        seg = mesh.all_gather(seg, SEQ_AXIS, dim=1)
    out = att.dense_attention(qkv[0], qkv[1], qkv[2], causal=causal, q_seg=seg, k_seg=seg)
    return mesh_lib.all_to_all(mesh, out, SEQ_AXIS, split_dim=1, concat_dim=2)


def zigzag_perm(t: int, n: int) -> np.ndarray:
    """Time permutation placing chunks (i, 2n-1-i) on rank i (JAX's
    `_zigzag_perm`)."""
    c = t // (2 * n)
    out = []
    for i in range(n):
        out.append(np.arange(i * c, (i + 1) * c))
        out.append(np.arange((2 * n - 1 - i) * c, (2 * n - i) * c))
    return np.concatenate(out)


def zigzag_permutation(t: int, n: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(perm, inverse) time-axis permutations for the zigzag layout, as
    int tuples."""
    perm = zigzag_perm(t, n)
    return tuple(int(i) for i in perm), tuple(int(i) for i in np.argsort(perm))


def _sp_attention(mesh: RankMesh, body, q, k, v, segment_ids, *, causal: bool,
                  perm=None) -> torch.Tensor:
    """The whole sequence in (the same on every rank of the axis), this
    rank's shard through `body`, the whole output back. `perm` holds the
    stream in another layout for the body (zigzag) and restores it."""
    n, idx = mesh.size(SEQ_AXIS), mesh.coords[SEQ_AXIS]
    t = q.shape[1]
    own = torch.arange(idx * (t // n), (idx + 1) * (t // n))
    if perm is not None:
        own = torch.as_tensor(perm[0])[own]
    own = own.to(q.device)
    take = lambda x: mesh_lib.enter(mesh, x, SEQ_AXIS).index_select(1, own)
    seg = None if segment_ids is None else segment_ids.index_select(1, own)
    out = mesh_lib.gather_invariant(
        mesh, body(mesh, take(q), take(k), take(v), seg, causal=causal), SEQ_AXIS, 1)
    if perm is not None:
        out = out.index_select(1, torch.as_tensor(perm[1], device=q.device))
    return out


def ring_attention(mesh: RankMesh, q, k, v, *, causal: bool = True, batch_axis=None,
                   segment_ids=None, schedule: str = "contiguous",
                   pre_permuted: bool = False) -> torch.Tensor:
    """Causal MHA with the sequence split over `mesh`'s `seq` axis: `q, k,
    v` `[B, T, H, D]` (this rank's rows, the whole T), segment ids `[B,
    T]`; T must divide by the axis. `schedule="zigzag"` (causal only, T %
    2n == 0) is the balanced ring; the inputs are permuted into its layout
    here (and the output back) unless `pre_permuted`."""
    _check(mesh, q, heads_divide=False)
    if schedule == "zigzag":
        n, t = mesh.size(SEQ_AXIS), q.shape[1]
        if not causal:
            raise ValueError("zigzag schedule only pays for causal attention")
        if t % (2 * n) != 0:
            raise ValueError(f"zigzag needs T ({t}) divisible by 2*seq axis ({2 * n})")
        return _sp_attention(mesh, ring_shard_zigzag, q, k, v, segment_ids, causal=causal,
                             perm=None if pre_permuted else zigzag_permutation(t, n))
    if schedule != "contiguous":
        raise ValueError(f"unknown schedule {schedule!r}")
    return _sp_attention(mesh, ring_shard, q, k, v, segment_ids, causal=causal)


def ulysses_attention(mesh: RankMesh, q, k, v, *, causal: bool = True, batch_axis=None,
                      segment_ids=None) -> torch.Tensor:
    """All-to-all sequence parallelism; needs heads % seq axis == 0."""
    _check(mesh, q, heads_divide=True)
    return _sp_attention(mesh, ulysses_shard, q, k, v, segment_ids, causal=causal)


def _check(mesh: RankMesh, q, *, heads_divide: bool) -> None:
    n = mesh.shape.get(SEQ_AXIS)
    if n is None:
        raise ValueError(f"mesh {dict(mesh.shape)} has no '{SEQ_AXIS}' axis")
    if q.shape[1] % n != 0:
        raise ValueError(f"sequence length {q.shape[1]} not divisible by seq axis {n}")
    if heads_divide and q.shape[2] % n != 0:
        raise ValueError(f"ulysses needs heads ({q.shape[2]}) divisible by seq axis ({n}); "
                         "use ring_attention otherwise")
