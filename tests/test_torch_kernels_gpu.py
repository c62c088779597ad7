"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: each test skips where no CUDA device is present. The file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Tolerances: V-trace atol 2e-6 on vs, as the JAX package's kernel tests;
atol 1e-7 plus rtol 2e-7 on the clipped rhos (one to two ulps of expf).
LSTM forward atol 1e-5 at H >= 256 (H-term float32 sums taken in another
order than cuBLAS takes them) and 1e-6 at H <= 64; LSTM gradients atol
5e-5.
"""

import numpy as np
import pytest
import torch

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
