"""The port's attention ops and flash-kernel plain versions against the
JAX package's, on the CPU.

The same numpy inputs (seeded, ~8% dones in the segment ids) go through
the Pallas kernels in interpret mode (`_fwd_call`, `_bwd_call`,
`flash_attention_bhtd`) or the XLA reference (`dense_attention`) and
through the port, whose CPU path is the plain versions of the CUDA
kernels K3a, K3b and K3c. Tolerances are the JAX package's own
(`tests/test_sequence.py:276-300`): atol 1e-5 on values, 1e-4 on
gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_reinforcement_learning_tpu.ops import attention as jattn
from distributed_reinforcement_learning_tpu.ops.pallas import attention as jflash
from distributed_reinforcement_learning_tpu_torch.ops import attention as attn
from distributed_reinforcement_learning_tpu_torch.ops.kernels import attention as kattn

BLOCK = 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(B, T, H, D, seed):
    rng = np.random.RandomState(seed)
    return tuple((rng.randn(B, T, H, D) * 0.3).astype(np.float32) for _ in range(3))


def _segments(B, T, seed):
    rng = np.random.RandomState(seed)
    return np.cumsum(rng.rand(B, T) < 0.08, axis=1).astype(np.int32)


def _bhtd(B=2, T=48, H=3, D=16, seed=0):
    """[BH, T, D] q, k, v, dO and [BH, T] segment ids, as numpy."""
    q, k, v = (x.transpose(0, 2, 1, 3).reshape(B * H, T, D) for x in _qkv(B, T, H, D, seed))
    segs = np.repeat(_segments(B, T, seed + 1), H, axis=0)
    do = (np.random.RandomState(seed + 2).randn(B * H, T, D) * 0.5).astype(np.float32)
    return q, k, v, segs, do


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_flash_blocks_matches_jax():
    for t in range(1, 301):
        assert kattn.flash_blocks(t) == jflash.flash_blocks(t), t
    assert kattn.flash_blocks(16) == 16 and kattn.flash_blocks(10) == 0


@pytest.mark.parametrize("T", [16, 48])
def test_forward_plain_matches_pallas_interpret(T):
    q, k, v, segs, _ = _bhtd(T=T)
    want_o, want_lse = jflash._fwd_call(q, k, v, segs[..., None], segs[..., None], BLOCK, BLOCK,
                                        interpret=True)
    before = kattn.flash_fwd_cuda.launches
    o, lse = kattn.flash_fwd(*_t(q, k, v, segs, segs), BLOCK, BLOCK)
    assert kattn.flash_fwd_cuda.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], atol=1e-5)


@pytest.mark.parametrize("T", [16, 48])
def test_backward_plain_matches_pallas_interpret(T):
    """dq, dk, dv from the same lse and delta as the Pallas `_bwd_call`."""
    q, k, v, segs, do = _bhtd(T=T, seed=3)
    o, lse = jflash._fwd_call(q, k, v, segs[..., None], segs[..., None], BLOCK, BLOCK,
                              interpret=True)
    delta = np.sum(do * np.asarray(o), axis=-1, keepdims=True).astype(np.float32)
    want = jflash._bwd_call(q, k, v, segs[..., None], segs[..., None], do, lse, delta,
                            BLOCK, BLOCK, interpret=True)
    before = (kattn.flash_dq_cuda.launches, kattn.flash_dkv_cuda.launches)
    got = kattn.flash_bwd(*_t(q, k, v, segs, segs, do, np.asarray(lse)[..., 0], delta[..., 0]),
                          BLOCK, BLOCK)
    assert (kattn.flash_dq_cuda.launches, kattn.flash_dkv_cuda.launches) == before
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, err_msg=name)


def test_plain_result_does_not_depend_on_blocks():
    q, k, v, segs, _ = _bhtd(T=64, seed=5)
    args = _t(q, k, v, segs, segs)
    o16, lse16 = kattn.flash_fwd_plain(*args, 16, 16)
    for bq, bkv in ((8, 32), (64, 8), (32, 32)):
        o, lse = kattn.flash_fwd_plain(*args, bq, bkv)
        torch.testing.assert_close(o, o16, atol=1e-6, rtol=0)
        torch.testing.assert_close(lse, lse16, atol=1e-6, rtol=0)


def _loss_weights(shape, seed=9):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_function_gradients_match_jax():
    """dq, dk, dv through `FlashAttentionFunction` (the plain flash
    backward on the CPU) against jax.grad of the Pallas
    `flash_attention_bhtd` in interpret mode and of `dense_attention`."""
    B, T, H, D = 2, 32, 2, 16
    q, k, v, segs, _ = _bhtd(B, T, H, D, seed=7)
    w = _loss_weights(q.shape)

    def jax_loss(fn):
        return lambda q, k, v: jnp.sum(fn(q, k, v) * w)

    flash = lambda q, k, v: jflash.flash_attention_bhtd(
        q, k, v, segs, segs, block_q=BLOCK, block_kv=BLOCK, interpret=True)

    def dense(q, k, v):
        unflat = lambda x: x.reshape(B, H, T, D).transpose(0, 2, 1, 3)
        seg = jnp.asarray(segs[::H])
        out = jattn.dense_attention(unflat(q), unflat(k), unflat(v), causal=True, q_seg=seg,
                                    k_seg=seg)
        return out.transpose(0, 2, 1, 3).reshape(B * H, T, D)

    leaves = [x.requires_grad_(True) for x in _t(q, k, v)]
    out = kattn.flash_attention_bhtd(*leaves, torch.from_numpy(segs), torch.from_numpy(segs),
                                     BLOCK, BLOCK)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    for fn in (flash, dense):
        want = jax.grad(jax_loss(fn), argnums=(0, 1, 2))(q, k, v)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("backend", ["pallas_interpret", "reference"])
@pytest.mark.parametrize("T", [16, 32, 10])
def test_causal_attention_matches_jax(T, backend):
    """T = 16 and 32 take the flash route, T = 10 the dense one (in both
    packages: flash_blocks(10) == 0)."""
    B, H, D = 2, 2, 16
    q, k, v = _qkv(B, T, H, D, seed=T)
    segs = _segments(B, T, seed=T + 1)
    want = jattn.causal_attention(q, k, v, q_seg=segs, k_seg=segs, backend=backend)
    got = attn.causal_attention(*_t(q, k, v), q_seg=torch.from_numpy(segs),
                                k_seg=torch.from_numpy(segs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    plain = attn.causal_attention(*_t(q, k, v))
    np.testing.assert_allclose(plain.numpy(), np.asarray(jattn.dense_attention(q, k, v)),
                               atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_dense_and_blockwise_match_jax(causal):
    B, T, H, D = 2, 64, 2, 8
    q, k, v = _qkv(B, T, H, D, seed=11)
    segs = _segments(B, T, seed=12)
    want = jattn.dense_attention(q, k, v, causal=causal, q_seg=segs, k_seg=segs)
    got = attn.dense_attention(*_t(q, k, v), causal=causal, q_seg=torch.from_numpy(segs),
                               k_seg=torch.from_numpy(segs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    want_b = jattn.blockwise_attention(q, k, v, causal=causal, block_size=16, segment_ids=segs)
    got_b = attn.blockwise_attention(*_t(q, k, v), causal=causal, block_size=16,
                                     segment_ids=torch.from_numpy(segs))
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), atol=1e-5)


def test_long_sequence_takes_blockwise_route():
    """T = 1025 has no flash block and exceeds the dense limit, so both
    packages take the blockwise path, whose block 512 does not divide it."""
    arrays = _qkv(1, 1025, 1, 8, seed=0)
    with pytest.raises(ValueError, match="not divisible"):
        jattn.causal_attention(*arrays)
    with pytest.raises(ValueError, match="not divisible"):
        attn.causal_attention(*_t(*arrays))


def test_rejects_lone_segment_arg():
    q, k, v = _t(*_qkv(2, 16, 2, 8, seed=0))
    with pytest.raises(ValueError, match="together"):
        attn.causal_attention(q, k, v, q_seg=torch.zeros(2, 16, dtype=torch.int32))


@pytest.mark.parametrize("T", [16, 10])
def test_no_attention_across_episodes(T):
    """Changing the keys and values of one episode leaves every other
    episode's outputs as they were, on both routes."""
    B, H, D = 2, 2, 16
    q, k, v = _qkv(B, T, H, D, seed=21)
    segs = np.zeros((B, T), np.int32)
    segs[:, T // 2:] = 1
    k2, v2 = k.copy(), v.copy()
    k2[:, T // 2:] += 5.0
    v2[:, T // 2:] -= 3.0
    seg_t = torch.from_numpy(segs)
    out1 = attn.causal_attention(*_t(q, k, v), q_seg=seg_t, k_seg=seg_t)
    out2 = attn.causal_attention(*_t(q, k2, v2), q_seg=seg_t, k_seg=seg_t)
    torch.testing.assert_close(out1[:, :T // 2], out2[:, :T // 2], atol=0, rtol=0)
    assert not torch.allclose(out1[:, T // 2:], out2[:, T // 2:])
