"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: each test skips where no CUDA device is present. The file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Tolerances: V-trace atol 2e-6 on vs, as the JAX package's kernel tests;
atol 1e-7 plus rtol 2e-7 on the clipped rhos (one to two ulps of expf).
LSTM forward atol 1e-5 at H >= 256 (H-term float32 sums taken in another
order than cuBLAS takes them) and 1e-6 at H <= 64; LSTM gradients atol
5e-5. Flash attention: forward atol 1e-5 (o and lse), dq, dk and dv atol
1e-4 x max(1, max |ref|), the JAX package's attention tolerances.
"""

import numpy as np
import pytest
import torch

from distributed_reinforcement_learning_tpu_torch.ops.attention import dense_attention
from distributed_reinforcement_learning_tpu_torch.ops.kernels import attention as kattn
from distributed_reinforcement_learning_tpu_torch.ops.kernels import lstm as klstm
from distributed_reinforcement_learning_tpu_torch.ops.kernels import vtrace as kvt
from distributed_reinforcement_learning_tpu_torch.ops.lstm import _scan_reference


def _inputs(T, B, seed):
    rng = np.random.RandomState(seed)
    arrays = [
        (rng.randn(T, B) * 0.3).astype(np.float32),
        ((rng.rand(T, B) > 0.1) * 0.99).astype(np.float32),
        rng.randn(T, B).astype(np.float32),
        rng.randn(T, B).astype(np.float32),
        rng.randn(B).astype(np.float32),
    ]
    return [torch.from_numpy(a).cuda() for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("clip_rho", [1.0, None])
@pytest.mark.parametrize("T,B", [(18, 32), (20, 256), (20, 65536)])
def test_vtrace_kernel_matches_plain(T, B, clip_rho):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _inputs(T, B, seed=T + B)
    before = kvt.vtrace_cuda.launches
    vs, rhos = kvt.vtrace(*args, clip_rho_threshold=clip_rho)
    torch.cuda.synchronize()
    assert kvt.vtrace_cuda.launches == before + 1
    want_vs, want_rhos = kvt.vtrace_plain(*args, clip_rho_threshold=clip_rho)
    torch.testing.assert_close(vs, want_vs, atol=2e-6, rtol=0)
    torch.testing.assert_close(rhos, want_rhos, atol=1e-7, rtol=2e-7)


@pytest.mark.gpu
def test_vtrace_kernel_rejects_strided_input():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _inputs(6, 8, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        kvt.vtrace_cuda(args[0].T.contiguous().T, *args[1:])


def _lstm_inputs(T, B, H, seed):
    """Time-major (xg, wh, keep, h0, c0) with ~15% dones."""
    rng = np.random.RandomState(seed)
    arrays = [
        (rng.randn(T, B, 4 * H) * 0.5).astype(np.float32),
        (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
        (rng.rand(T, B) > 0.15).astype(np.float32),
        (rng.randn(B, H) * 0.1).astype(np.float32),
        (rng.randn(B, H) * 0.1).astype(np.float32),
    ]
    return [torch.from_numpy(a).cuda() for a in arrays]


LSTM_SHAPES = [(10, 32, 512), (20, 32, 256), (10, 8, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("T,B,H", LSTM_SHAPES)
def test_lstm_forward_kernel_matches_plain(T, B, H):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _lstm_inputs(T, B, H, seed=T + B + H)
    before = klstm.lstm_fwd_cuda.launches
    got = klstm.lstm_fwd(*args)
    torch.cuda.synchronize()
    assert klstm.lstm_fwd_cuda.launches == before + 1
    atol = 1e-6 if H <= 64 else 1e-5
    for a, b in zip(got, klstm.lstm_fwd_plain(*args)):
        torch.testing.assert_close(a, b, atol=atol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("T,B,H", LSTM_SHAPES)
def test_lstm_backward_kernel_matches_plain(T, B, H):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    xg, wh, keep, h0, c0 = _lstm_inputs(T, B, H, seed=T * B)
    h_all, c_all, _, _ = klstm.lstm_fwd_plain(xg, wh, keep, h0, c0)
    rng = np.random.RandomState(1)
    grads = [torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda()
             for s in ((T, B, H), (B, H), (B, H))]
    args = (xg, wh, keep, h0, c0, h_all, c_all, *grads)
    before = klstm.lstm_bwd_cuda.launches
    got = klstm.lstm_bwd(*args)
    torch.cuda.synchronize()
    assert klstm.lstm_bwd_cuda.launches == before + 1
    for a, b in zip(got, klstm.lstm_bwd_plain(*args)):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("T,B,H", LSTM_SHAPES[:2])
def test_lstm_function_gradients_match_autograd(T, B, H):
    """`LSTMFunction` (K2a + K2b + the dWh product) against autograd of
    the plain loop, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    xg, wh, keep, h0, c0 = _lstm_inputs(T, B, H, seed=5)

    def loss(h_all, hT, cT):
        w = torch.cos(torch.arange(H, device="cuda", dtype=torch.float32))
        return (h_all * w).sum() + (hT ** 2).sum() + 0.3 * cT.sum()

    leaves = [t.clone().requires_grad_(True) for t in (xg, wh, h0, c0)]
    out = klstm.LSTMFunction.apply(leaves[0], leaves[1], keep, leaves[2], leaves[3])
    got = torch.autograd.grad(loss(*out), leaves)
    ref = [t.clone().requires_grad_(True) for t in (xg, wh, h0, c0)]
    h_ref, (hT_ref, cT_ref) = _scan_reference(ref[0], ref[1], keep, ref[2], ref[3])
    want = torch.autograd.grad(loss(h_ref, hT_ref, cT_ref), ref)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=0)


@pytest.mark.gpu
def test_lstm_kernels_reject_strided_input():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xg, wh, keep, h0, c0 = _lstm_inputs(4, 8, 32, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        klstm.lstm_fwd_cuda(xg, wh.T.contiguous().T, keep, h0, c0)
    h_all, c_all, _, _ = klstm.lstm_fwd_plain(xg, wh, keep, h0, c0)
    strided = torch.zeros(4, 8, 64, device="cuda")[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        klstm.lstm_bwd_cuda(xg, wh, keep, h0, c0, h_all, c_all, strided, h0, c0)


# Flash attention (B, H, T, D): the ximpala section's act and learn shape,
# bench.py's ximpala_learn shape, D = 128 with a partial last tile, and a
# sequence of more than 32 tiles (the kernels test 32 tiles per pass).
ATTN_SHAPES = [(16, 2, 16, 32), (64, 4, 32, 64), (2, 2, 200, 128), (1, 2, 1096, 64)]


def _attn_inputs(B, H, T, D, seed):
    """q, k, v, dO [BH, T, D] and [BH, T] int32 segment ids (~8% dones)."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy((rng.randn(B * H, T, D) * s).astype(np.float32)).cuda()
                   for s in (0.3, 0.3, 0.3, 0.5))
    segs = np.repeat(np.cumsum(rng.rand(B, T) < 0.08, axis=1).astype(np.int32), H, axis=0)
    return q, k, v, torch.from_numpy(segs).cuda(), do


def _grad_close(got, want):
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4 * max(1.0, float(b.abs().max())), rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,D", ATTN_SHAPES)
def test_attention_kernels_match_plain(B, H, T, D):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, segs, do = _attn_inputs(B, H, T, D, seed=T + D)
    blk = kattn.flash_blocks(T)
    before = (kattn.flash_fwd_cuda.launches, kattn.flash_dq_cuda.launches,
              kattn.flash_dkv_cuda.launches)
    o, lse = kattn.flash_fwd(q, k, v, segs, segs)
    want_o, want_lse = kattn.flash_fwd_plain(q, k, v, segs, segs, blk, blk)
    delta = (do * want_o).sum(-1)
    got = kattn.flash_bwd(q, k, v, segs, segs, do, want_lse, delta)
    torch.cuda.synchronize()
    assert (kattn.flash_fwd_cuda.launches, kattn.flash_dq_cuda.launches,
            kattn.flash_dkv_cuda.launches) == tuple(n + 1 for n in before)
    torch.testing.assert_close(o, want_o, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0)
    _grad_close(got, kattn.flash_bwd_plain(q, k, v, segs, segs, do, want_lse, delta, blk, blk))


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,D", ATTN_SHAPES[:2])
def test_attention_function_gradients_match_dense_autograd(B, H, T, D):
    """`FlashAttentionFunction` (K3a + K3b + K3c) against autograd of the
    plain `dense_attention`, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, segs, do = _attn_inputs(B, H, T, D, seed=3)
    blk = kattn.flash_blocks(T)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = kattn.flash_attention_bhtd(*leaves, segs, segs, blk, blk)
    got = torch.autograd.grad(out, leaves, do)

    def unflat(x):
        return x.reshape(B, H, T, D).transpose(1, 2)

    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = dense_attention(*map(unflat, ref_leaves), q_seg=segs[::H], k_seg=segs[::H])
    ref = ref.transpose(1, 2).reshape(B * H, T, D)
    want = torch.autograd.grad(ref, ref_leaves, do)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    _grad_close(got, want)


@pytest.mark.gpu
def test_attention_kernels_reject_unsupported_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, segs, do = _attn_inputs(2, 2, 16, 32, seed=0)
    with pytest.raises(TypeError, match="float32"):
        kattn.flash_fwd_cuda(q.double(), k.double(), v.double(), segs, segs)
    q48, k48, v48 = (torch.zeros(4, 16, 48, device="cuda") for _ in range(3))
    with pytest.raises(ValueError, match="head dim 48"):
        kattn.flash_fwd_cuda(q48, k48, v48, segs, segs)
    strided = torch.zeros(4, 32, 16, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kattn.flash_fwd_cuda(strided, k, v, segs, segs)
    shifted = torch.zeros(q.numel() + 1, device="cuda")[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        kattn.flash_fwd_cuda(shifted, k, v, segs, segs)
    _, lse = kattn.flash_fwd_plain(q, k, v, segs, segs, 16, 16)
    with pytest.raises(ValueError, match="contiguous"):
        kattn.flash_dq_cuda(q, k, v, segs, segs, do.transpose(1, 2).contiguous().transpose(1, 2),
                            lse, lse)
    with pytest.raises(TypeError, match="int32"):
        kattn.flash_dkv_cuda(q, k, v, segs.long(), segs.long(), do, lse, lse)
    with pytest.raises(ValueError, match="multiple of 8"):
        kattn.flash_fwd_cuda(q[:, :12].contiguous(), k[:, :12].contiguous(),
                             v[:, :12].contiguous(), segs[:, :12].contiguous(),
                             segs[:, :12].contiguous())
