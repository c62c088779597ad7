"""The port's LSTM recursion against the JAX package's, on the CPU.

The same numpy inputs (seeded, ~15% dones) go through the JAX
`lstm_scan` (the `lax.scan` reference and the Pallas kernel pair in
interpret mode) and through the port's `lstm_scan`, whose CPU path is
the plain versions of the CUDA kernels behind `LSTMFunction`.
Tolerances are the JAX package's own (`tests/test_pallas.py`): atol 1e-6
on the forward outputs, 5e-6 on the gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from distributed_reinforcement_learning_tpu.ops.lstm import lstm_scan as jax_lstm_scan
from distributed_reinforcement_learning_tpu_torch.ops.kernels import lstm as klstm
from distributed_reinforcement_learning_tpu_torch.ops.lstm import _scan_reference, lstm_scan

JAX_BACKENDS = ["reference", "pallas_interpret"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # One thread for torch and for numpy's BLAS pool: OpenBLAS spreads the
    # Atari resize's small matmuls over every core, which costs far more
    # than the matmuls once several test workers share the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _lstm_inputs(B=8, T=10, H=32, seed=1):
    """The inputs of `tests/test_pallas.py:_lstm_inputs`."""
    rng = np.random.RandomState(seed)
    return (
        (rng.randn(B, T, 4 * H) * 0.5).astype(np.float32),
        (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
        (rng.rand(B, T) > 0.15).astype(np.float32),
        (rng.randn(B, H) * 0.1).astype(np.float32),
        (rng.randn(B, H) * 0.1).astype(np.float32),
    )


def _torch(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("B,T,H", [(8, 10, 32), (16, 5, 64), (128, 4, 32)])
def test_forward_matches_jax(B, T, H, backend):
    xg, wh, keep, h0, c0 = _lstm_inputs(B, T, H)
    want_h, (want_hT, want_cT) = jax_lstm_scan(xg, wh, keep, h0, c0, backend=backend)
    before = klstm.lstm_fwd_cuda.launches
    got_h, (got_hT, got_cT) = lstm_scan(*_torch(xg, wh, keep, h0, c0))
    assert klstm.lstm_fwd_cuda.launches == before  # CPU tensors take the plain version
    assert got_h.shape == (B, T, H)
    for got, want in ((got_h, want_h), (got_hT, want_hT), (got_cT, want_cT)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)


def _jax_loss(backend, keep, H):
    def f(args):
        xg, wh, h0, c0 = args
        h_all, (hT, cT) = jax_lstm_scan(xg, wh, keep, h0, c0, backend=backend)
        return jnp.sum(h_all * jnp.cos(jnp.arange(H))) + jnp.sum(hT ** 2) + 0.3 * jnp.sum(cT)
    return f


def _torch_loss(h_all, hT, cT):
    w = torch.cos(torch.arange(h_all.shape[-1], dtype=torch.float32))
    return (h_all * w).sum() + (hT ** 2).sum() + 0.3 * cT.sum()


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_gradients_match_jax(backend):
    """dxg, dwh, dh0, dc0 through `LSTMFunction` (the plain BPTT on the
    CPU) against jax.grad, with the loss of the JAX package's test."""
    xg, wh, keep, h0, c0 = _lstm_inputs()
    want_v, want_g = jax.value_and_grad(_jax_loss(backend, keep, h0.shape[-1]))(
        tuple(map(jnp.asarray, (xg, wh, h0, c0))))
    leaves = _torch(xg, wh, h0, c0, grad=True)
    h_all, (hT, cT) = lstm_scan(leaves[0], leaves[1], torch.from_numpy(keep), *leaves[2:])
    loss = _torch_loss(h_all, hT, cT)
    before = klstm.lstm_bwd_cuda.launches
    grads = torch.autograd.grad(loss, leaves)
    assert klstm.lstm_bwd_cuda.launches == before
    assert abs(float(loss.detach()) - float(want_v)) < 1e-4
    for name, got, want in zip(("dxg", "dwh", "dh0", "dc0"), grads, want_g):
        err = np.abs(got.numpy() - np.asarray(want)).max()
        assert err < 5e-6, f"{name}: {err}"


@pytest.mark.parametrize("B,T,H", [(8, 10, 32), (4, 6, 16)])
def test_plain_bptt_matches_autograd(B, T, H):
    """The hand-derived backward against torch autograd of the plain loop."""
    xg, wh, keep, h0, c0 = _lstm_inputs(B, T, H, seed=3)
    keep_t = torch.from_numpy(keep)
    leaves = _torch(xg, wh, h0, c0, grad=True)
    h_all, (hT, cT) = lstm_scan(leaves[0], leaves[1], keep_t, *leaves[2:])
    grads = torch.autograd.grad(_torch_loss(h_all, hT, cT), leaves)
    ref = _torch(xg, wh, h0, c0, grad=True)
    h_ref, (hT_ref, cT_ref) = _scan_reference(ref[0].transpose(0, 1), ref[1], keep_t.T,
                                              ref[2], ref[3])
    want = torch.autograd.grad(_torch_loss(h_ref.transpose(0, 1), hT_ref, cT_ref), ref)
    for name, got, w in zip(("dxg", "dwh", "dh0", "dc0"), grads, want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=5e-6, err_msg=name)


def test_plain_versions_match_reference_directly():
    """`lstm_fwd_plain` / `lstm_bwd_plain` (the kernels' CPU twins) on
    time-major inputs, against the plain loop and its autograd."""
    xg, wh, keep, h0, c0 = _torch(*_lstm_inputs(B=4, T=7, H=16, seed=4))
    xg_tm, keep_tm = xg.transpose(0, 1).contiguous(), keep.T.contiguous()
    h_all, c_all, hT, cT = klstm.lstm_fwd_plain(xg_tm, wh, keep_tm, h0, c0)
    h_ref, (hT_ref, cT_ref) = _scan_reference(xg_tm, wh, keep_tm, h0, c0)
    torch.testing.assert_close(h_all, h_ref, atol=1e-6, rtol=0)
    torch.testing.assert_close(hT, hT_ref, atol=1e-6, rtol=0)
    torch.testing.assert_close(cT, cT_ref, atol=1e-6, rtol=0)
    rng = np.random.RandomState(0)
    dh_all, dhT, dcT = _torch(*(rng.randn(*s).astype(np.float32)
                                for s in (h_all.shape, hT.shape, cT.shape)))
    dxg, dh0, dc0 = klstm.lstm_bwd_plain(xg_tm, wh, keep_tm, h0, c0, h_all, c_all,
                                         dh_all, dhT, dcT)
    leaves = [t.clone().requires_grad_(True) for t in (xg_tm, h0, c0)]
    out_h, (out_hT, out_cT) = _scan_reference(leaves[0], wh, keep_tm, leaves[1], leaves[2])
    want = torch.autograd.grad((out_h * dh_all).sum() + (out_hT * dhT).sum()
                               + (out_cT * dcT).sum(), leaves)
    for name, got, w in zip(("dxg", "dh0", "dc0"), (dxg, dh0, dc0), want):
        torch.testing.assert_close(got, w, atol=5e-6, rtol=0, msg=lambda m, n=name: f"{n}: {m}")


def test_done_mask_resets_state():
    """A done at step t zeroes the carry entering t+1: the output after
    the done equals a fresh-state run of the tail."""
    xg, wh, _, h0, c0 = _lstm_inputs(B=4, T=6, H=16)
    keep = np.ones((4, 6), np.float32)
    keep[:, 2] = 0.0  # episode boundary after step 2
    h_all, _ = lstm_scan(*_torch(xg, wh, keep, h0, c0))
    zero = np.zeros_like(h0)
    tail, _ = lstm_scan(*_torch(np.ascontiguousarray(xg[:, 3:]), wh,
                                np.ascontiguousarray(keep[:, 3:]), zero, zero))
    np.testing.assert_allclose(h_all[:, 3:].detach().numpy(), tail.detach().numpy(), atol=1e-6)


def test_wrappers_reject_bad_inputs():
    xg, wh, keep, h0, c0 = _torch(*_lstm_inputs(B=2, T=3, H=8))
    tm = (xg.transpose(0, 1).contiguous(), wh, keep.T.contiguous(), h0, c0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        klstm.lstm_fwd_cuda(*tm)
    with pytest.raises(ValueError, match="wh must be"):
        klstm.lstm_fwd(tm[0], wh[:4], *tm[2:])
    with pytest.raises(TypeError, match="float32"):
        klstm.lstm_fwd(tm[0].double(), *tm[1:])


def _r2d2_lstm_sizes():
    """Every `lstm_size` of a config.json section that R2D2 trains."""
    import json
    from pathlib import Path

    cfg = json.loads((Path(__file__).resolve().parents[1] / "config.json").read_text())
    return sorted({sec["lstm_size"] for name, sec in cfg.items()
                   if name.startswith("r2d2") and "lstm_size" in sec})


H100_SMS = 132


def test_plan_covers_r2d2_sizes_and_1024():
    sizes = _r2d2_lstm_sizes()
    assert {512, 256} <= set(sizes)
    assert klstm.max_hidden(H100_SMS) >= max(sizes + [1024])


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("T,B", [(1, 1), (10, 13), (10, 16), (10, 32), (20, 256)])
@pytest.mark.parametrize("H", [64, 256, 268, 512, 532, 1024, "limit"])
def test_launch_plan_fits_an_h100(H, T, B, backward):
    """The persistent kernels' plan: a grid no larger than one block per
    SM of a 132-SM card (so it is co-resident), every unit owned by one
    block, at most 232,448 bytes of shared memory a block, and regions
    large enough for what `csrc/lstm.cu` puts in them."""
    if H == "limit":
        H = klstm.max_hidden(H100_SMS)
    p = klstm.lstm_plan(T, B, H, H100_SMS, backward)
    assert p.blocks <= H100_SMS
    assert (p.blocks - 1) * p.units < H <= p.blocks * p.units
    assert p.smem_bytes <= 232_448
    assert p.rows % klstm.ROW_TILE == 0 and min(B, klstm.MAX_ROWS) <= p.rows <= klstm.MAX_ROWS
    assert p.rows_all % klstm.ROW_TILE == 0 and klstm.ROW_TILE <= p.rows_all <= klstm.MAX_ROWS
    assert p.rows * p.units <= 4 * klstm.THREADS  # kMaxOut cell outputs a thread
    C = 4 * p.units
    rows = p.rows_all if backward else p.rows
    items = (rows // klstm.ROW_TILE) * (C // klstm.COL_TILE)
    lanes, warp_groups = klstm._split_layout(rows, C)
    # Every 8 x 4 output tile has its lanes, a power of two within a warp.
    assert lanes & (lanes - 1) == 0 and lanes * items <= klstm.THREADS and warp_groups >= 1
    assert p.w_floats >= H * C + H
    assert p.red_floats >= warp_groups * rows * C
    assert p.stage_floats >= rows * (min(H, klstm.MIN_K_CHUNK) + 4)
    if backward:
        assert p.stage_floats >= 2 * p.rows_all * (H + 4)  # two chunks of the recompute
        assert p.red_floats >= p.rows * (C + 4)  # a chunk's dgates
        assert p.stage_floats >= 4 * (p.rows * p.units + 4)  # 4 owners' partials of a chunk
        Bp = -(-B // p.rows) * p.rows
        assert p.part_floats == 2 * p.blocks * p.blocks * Bp * p.units
    else:
        assert p.part_floats == 0
    # Float4 alignment of the regions.
    assert p.w_floats % 4 == 0 and p.red_floats % 4 == 0


@pytest.mark.parametrize("H", [6, "above"])
def test_launch_plan_refuses_what_does_not_fit(H):
    if H == "above":
        H = klstm.max_hidden(H100_SMS) + 4
    with pytest.raises(ValueError, match="multiple of 4 and at most"):
        klstm.lstm_plan(10, 32, H, H100_SMS)


@pytest.mark.parametrize("H,fits", [(512, True), (1056, True), (1060, False)])
def test_hidden_size_check_at_132_sms(H, fits):
    """The check an R2D2 agent runs when it is built on a CUDA device
    (`agents/r2d2.py`): 1056 is the largest H the kernels take on a
    132-SM card."""
    if fits:
        klstm.check_hidden_size(H, H100_SMS)
    else:
        with pytest.raises(ValueError, match="at most 1056"):
            klstm.check_hidden_size(H, H100_SMS)
