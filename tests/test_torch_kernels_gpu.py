"""The port's CUDA kernels against their plain versions, on the card, and
the multi-process data plane there (the pinned prefetch, async weight
snapshots, a learner process started through `run_role`).

Marked `gpu`: each test skips where no CUDA device is present. The file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Tolerances: V-trace none: the kernel runs the plain version's operations
in its order, each rounded on its own, so the two agree bit for bit,
NaN and inf included (any NaN equal to any NaN). LSTM forward atol 1e-5 at H >= 256 (H-term float32 sums taken in another
order than cuBLAS takes them) and 1e-6 at H <= 64; LSTM gradients atol
5e-5. Flash attention: forward atol 1e-5 (o and lse), dq, dk and dv atol
1e-4 x max(1, max |ref|), the JAX package's attention tolerances. The
data plane: none, bit for bit.
"""

import re

import numpy as np
import pytest
import torch

from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import R2D2Agent, R2D2Config
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


def _bit_equal(a, b):
    """The same bits everywhere, any NaN equal to any NaN."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a.masked_fill(nan, 0).view(torch.int32),
                            b.masked_fill(nan, 0).view(torch.int32)))


def _special(args):
    """NaN, +inf and -inf log-rhos spread over the columns."""
    flat = args[0].view(-1)
    flat[0::7] = float("nan")
    flat[3::11] = float("inf")
    flat[5::13] = float("-inf")
    return args


# (T, B): the impala path's shape and chip_smoke's larger ones; one step;
# one column; a ragged last slab (33, 1000: B not a multiple of 32, and
# 33 not of 4, so rows are not 16-byte aligned); T longer than one chunk
# of 32 rows (70: two full chunks and a partial one).
VTRACE_SHAPES = [(18, 32), (20, 256), (20, 65536), (1, 32), (1, 1), (18, 1), (20, 33),
                 (20, 1000), (70, 1000), (70, 33), (64, 65536)]


@pytest.mark.gpu
@pytest.mark.parametrize("clip_rho", [1.0, None])
@pytest.mark.parametrize("T,B", VTRACE_SHAPES)
def test_vtrace_kernel_matches_plain(T, B, clip_rho):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _inputs(T, B, seed=T + B)
    before = kvt.vtrace_cuda.launches
    vs, rhos = kvt.vtrace(*args, clip_rho_threshold=clip_rho)
    torch.cuda.synchronize()
    assert kvt.vtrace_cuda.launches == before + 1
    want_vs, want_rhos = kvt.vtrace_plain(*args, clip_rho_threshold=clip_rho)
    assert _bit_equal(vs, want_vs) and _bit_equal(rhos, want_rhos)


@pytest.mark.gpu
@pytest.mark.parametrize("clip_rho", [1.0, None])
@pytest.mark.parametrize("T,B", [(18, 32), (20, 33), (70, 1000), (20, 65536)])
def test_vtrace_kernel_propagates_nan_and_inf_as_plain(T, B, clip_rho):
    """NaN, +inf and -inf log-rhos: the kernel's clips propagate a NaN rho
    (as `torch.clamp` does, where `fminf` would return the bound), and
    the kernel gives the plain version's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _special(_inputs(T, B, seed=T + B))
    vs, rhos = kvt.vtrace_cuda(*args, clip_rho_threshold=clip_rho)
    want_vs, want_rhos = kvt.vtrace_plain(*args, clip_rho_threshold=clip_rho)
    assert torch.isnan(want_rhos).any() and torch.isnan(want_vs).any()
    assert _bit_equal(vs, want_vs) and _bit_equal(rhos, want_rhos)


@pytest.mark.gpu
@pytest.mark.parametrize("T,B", [(18, 32), (70, 1000)])
def test_vtrace_kernel_takes_unaligned_rows(T, B):
    """Inputs that start 4 bytes past a 16-byte boundary take the 4-byte
    copies, with the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = []
    for a in _inputs(T, B, seed=1):
        buf = torch.empty(a.numel() + 1, device="cuda")[1:]
        args.append(buf.view(a.shape).copy_(a))
    assert args[0].data_ptr() % 16 == 4
    got = kvt.vtrace_cuda(*args)
    for a, b in zip(got, kvt.vtrace_plain(*args)):
        assert _bit_equal(a, b)


@pytest.mark.gpu
def test_vtrace_wrapper_call_is_one_device_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _inputs(18, 32, seed=0)
    _one_kernel_per_call(lambda: kvt.vtrace_cuda(*args), "vtrace", "vtrace_kernel")


def _device_kernels(fn, name, calls=3):
    """{kernel: launches} of the device kernels whose names hold `name`
    that `calls` synchronised calls of `fn` run, through torch.profiler,
    each name cut to its function's name, and the number of kernel
    launches the host made. The profiler drops a device record now and
    then, so the host's count is the one to hold to `calls`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    device: dict[str, int] = {}
    api = 0
    for e in prof.key_averages():  # a kernel's records may come in several groups
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            if name in e.key:
                kernel = re.search(r"\w+_kernel", e.key).group(0)
                device[kernel] = device.get(kernel, 0) + e.count
        elif e.key.startswith(("cudaLaunch", "cuLaunch")):
            api += e.count
    return device, api


def _one_kernel_per_call(fn, name, kernel, calls=3):
    device, api = _device_kernels(fn, name, calls)
    assert api == calls, (api, device)
    assert list(device) == [kernel] and 0 < device[kernel] <= calls, device


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
# Shapes that stress the persistent kernels' partition: a batch that is
# not a multiple of the 8-row tile, one row, several 64-row chunks, one
# step, H = 1024 (8 units a block, K staged in chunks), and hidden sizes
# that leave the last block partly filled on a 132-SM card (268: 90
# blocks of 3 units; 532: 107 blocks of 5).
LSTM_STRESS_SHAPES = [(10, 13, 512), (6, 1, 256), (4, 256, 512), (1, 32, 512),
                      (5, 16, 1024), (3, 3, 64), (1, 32, 268), (10, 13, 532)]


@pytest.mark.gpu
@pytest.mark.parametrize("T,B,H", LSTM_SHAPES + LSTM_STRESS_SHAPES)
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
@pytest.mark.parametrize("T,B,H", LSTM_SHAPES + LSTM_STRESS_SHAPES)
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


def _lstm_bwd_args(xg, wh, keep, h0, c0, seed=1):
    """The backward's inputs: the plain forward's h_all, c_all and seeded
    gradients of h_all, hT, cT."""
    T, B, H = keep.shape + (wh.shape[0],)
    h_all, c_all, _, _ = klstm.lstm_fwd_plain(xg, wh, keep, h0, c0)
    rng = np.random.RandomState(seed)
    grads = [torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda()
             for s in ((T, B, H), (B, H), (B, H))]
    return (xg, wh, keep, h0, c0, h_all, c_all, *grads)


@pytest.mark.gpu
@pytest.mark.parametrize("dones", ["all", "first_step"])
def test_lstm_kernels_done_masks(dones):
    """keep all zeros (a done at every step: every carry restarts from
    zero) and a done at t = 0 only, forward and backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    xg, wh, keep, h0, c0 = _lstm_inputs(8, 32, 512, seed=11)
    keep = torch.zeros_like(keep) if dones == "all" else torch.ones_like(keep)
    if dones == "first_step":
        keep[0] = 0.0
    got = klstm.lstm_fwd_cuda(xg, wh, keep, h0, c0)
    for a, b in zip(got, klstm.lstm_fwd_plain(xg, wh, keep, h0, c0)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    args = _lstm_bwd_args(xg, wh, keep, h0, c0)
    for a, b in zip(klstm.lstm_bwd_cuda(*args), klstm.lstm_bwd_plain(*args)):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("T,B,H", [(10, 32, 512), (4, 256, 512)])
def test_lstm_kernels_are_bit_identical_across_calls(T, B, H):
    """One writer per output and no atomics: two calls give equal bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _lstm_inputs(T, B, H, seed=2)
    first, second = klstm.lstm_fwd_cuda(*args), klstm.lstm_fwd_cuda(*args)
    bwd_args = _lstm_bwd_args(*args)
    first += klstm.lstm_bwd_cuda(*bwd_args)
    second += klstm.lstm_bwd_cuda(*bwd_args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_lstm_kernels_refuse_hidden_sizes_past_the_limit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    H = klstm.max_hidden(sms) + 4
    xg, wh, keep, h0, c0 = _lstm_inputs(2, 8, H, seed=0)
    with pytest.raises(ValueError, match="at most"):
        klstm.lstm_fwd_cuda(xg, wh, keep, h0, c0)
    with pytest.raises(ValueError, match="at most"):
        klstm.lstm_bwd_cuda(xg, wh, keep, h0, c0, *(torch.zeros(2, 8, H, device="cuda"),) * 3,
                            h0, c0)


@pytest.mark.gpu
@pytest.mark.parametrize("region", ["w_floats", "red_floats", "stage_floats"])
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_lstm_launch_refuses_a_plan_smaller_than_the_kernels_need(which, region, monkeypatch):
    """The kernels' entry points check the caller's plan against the
    shared-memory regions they index: a region cut to 4 floats is a
    refused launch, not a kernel that runs past it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    args = _lstm_inputs(4, 32, 512, seed=0)
    if which == "bwd":
        args = _lstm_bwd_args(*args)
    fn = klstm.lstm_fwd_cuda if which == "fwd" else klstm.lstm_bwd_cuda
    fn(*args)  # the plan as it is launches
    plan = klstm.lstm_plan
    monkeypatch.setattr(klstm, "lstm_plan",
                        lambda *a, **k: dataclasses.replace(plan(*a, **k), **{region: 4}))
    before = fn.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        fn(*args)
    assert fn.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_lstm_wrapper_call_is_one_device_kernel(which):
    """Through torch.profiler: each wrapper call runs exactly one LSTM
    kernel on the device, and nothing per step (3 calls, 3 kernels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    args = _lstm_inputs(10, 32, 512, seed=4)
    if which == "bwd":
        args = _lstm_bwd_args(*args)
    fn = klstm.lstm_fwd_cuda if which == "fwd" else klstm.lstm_bwd_cuda
    fn(*args)
    torch.cuda.synchronize()
    calls = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    device = {e.key: e.count for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")}
    kernels = {k: n for k, n in device.items() if "lstm" in k}
    assert list(kernels.values()) == [calls], device
    assert f"lstm_{which}_kernel" in next(iter(kernels))


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
# bench.py's ximpala_learn shape, D = 128 with a partial last tile, a
# sequence of more than 32 tiles (the kernels test 32 tiles per pass),
# half of one 16-row tile (T = 8) and a partial second one (T = 24).
ATTN_SHAPES = [(16, 2, 16, 32), (64, 4, 32, 64), (2, 2, 200, 128), (1, 2, 1096, 64),
               (3, 2, 8, 32), (2, 3, 24, 64)]


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


def _edge_segments(kind, B, H, T):
    """[BH, T] segment ids: episodes that start in the middle of a 16-row
    tile (rows 5 and 21, then every 11), all zeros (plain causal), or ids
    that alternate every 3 rows (not increasing, so no tile is skipped)."""
    t = np.arange(T)
    if kind == "mid_tile":
        ids = (t >= 5).astype(np.int32) + np.maximum(0, (t - 21) // 11 + 1)
    elif kind == "zeros":
        ids = np.zeros(T, np.int32)
    else:
        ids = (t // 3) % 2
    return torch.from_numpy(np.tile(ids.astype(np.int32), (B * H, 1))).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mid_tile", "zeros", "alternating"])
@pytest.mark.parametrize("B,H,T,D", [(2, 2, 48, 32), (1, 3, 72, 64)])
def test_attention_kernels_segment_edges(B, H, T, D, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, _, do = _attn_inputs(B, H, T, D, seed=T + D)
    segs = _edge_segments(kind, B, H, T)
    blk = kattn.flash_blocks(T)
    o, lse = kattn.flash_fwd_cuda(q, k, v, segs, segs)
    want_o, want_lse = kattn.flash_fwd_plain(q, k, v, segs, segs, blk, blk)
    torch.testing.assert_close(o, want_o, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0)
    delta = (do * want_o).sum(-1)
    got = kattn.flash_bwd(q, k, v, segs, segs, do, want_lse, delta)
    _grad_close(got, kattn.flash_bwd_plain(q, k, v, segs, segs, do, want_lse, delta, blk, blk))


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,D", ATTN_SHAPES)
def test_attention_dq_kernel_matches_plain(B, H, T, D):
    """K3b alone, through `flash_dq_cuda`: one launch, dq to the bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, segs, do = _attn_inputs(B, H, T, D, seed=T + D + 1)
    blk = kattn.flash_blocks(T)
    want_o, lse = kattn.flash_fwd_plain(q, k, v, segs, segs, blk, blk)
    delta = (do * want_o).sum(-1)
    before = kattn.flash_dq_cuda.launches
    dq = kattn.flash_dq_cuda(q, k, v, segs, segs, do, lse, delta)
    torch.cuda.synchronize()
    assert kattn.flash_dq_cuda.launches == before + 1
    want = kattn.flash_bwd_plain(q, k, v, segs, segs, do, lse, delta, blk, blk)[0]
    _grad_close([dq], [want])


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["fwd", "dq", "dkv"])
def test_attention_wrapper_call_is_one_device_kernel(which):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, segs, do = _attn_inputs(16, 2, 16, 32, seed=0)
    o, lse = kattn.flash_fwd_plain(q, k, v, segs, segs, 16, 16)
    args = (q, k, v, segs, segs, do, lse, (do * o).sum(-1))
    fn = {"fwd": lambda: kattn.flash_fwd_cuda(*args[:5]),
          "dq": lambda: kattn.flash_dq_cuda(*args),
          "dkv": lambda: kattn.flash_dkv_cuda(*args)}[which]
    _one_kernel_per_call(fn, "flash", f"flash_{which}_kernel")


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,D", [(16, 2, 16, 32), (1, 2, 1096, 64), (2, 2, 200, 128)])
def test_attention_kernels_are_bit_identical_across_calls(B, H, T, D):
    """One writer per output and no atomics: two calls of K3a, of K3b and
    of K3c give equal bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, segs, do = _attn_inputs(B, H, T, D, seed=6)
    first = kattn.flash_fwd_cuda(q, k, v, segs, segs)
    second = kattn.flash_fwd_cuda(q, k, v, segs, segs)
    lse, delta = first[1], (do * first[0]).sum(-1)
    bwd_args = (q, k, v, segs, segs, do, lse, delta)
    first += (kattn.flash_dq_cuda(*bwd_args), *kattn.flash_dkv_cuda(*bwd_args))
    second += (kattn.flash_dq_cuda(*bwd_args), *kattn.flash_dkv_cuda(*bwd_args))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,D", ATTN_SHAPES[:3])
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


@pytest.mark.gpu
def test_r2d2_agent_refuses_a_hidden_size_the_kernels_cannot_take():
    """An LSTM of 1100 units is past what the kernels take on an H100 (1056
    on 132 SMs): building the agent on the card raises, naming the limit,
    before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    limit = klstm.max_hidden(sms)
    assert limit < 1100
    before = (klstm.lstm_fwd_cuda.launches, klstm.lstm_bwd_cuda.launches)
    with pytest.raises(ValueError, match=f"at most {limit}"):
        R2D2Agent(R2D2Config(lstm_size=1100), device="cuda")
    assert (klstm.lstm_fwd_cuda.launches, klstm.lstm_bwd_cuda.launches) == before
    R2D2Agent(R2D2Config(lstm_size=limit), device="cuda")


# -- the multi-process data plane on the card ----------------------------------

def _impala_items(B: int, T: int, seed: int):
    from distributed_reinforcement_learning_tpu_torch.agents.impala import ImpalaBatch

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(B):
        logits = rng.randn(T, 4)
        out.append(ImpalaBatch(
            state=rng.randint(0, 256, (T, 84, 84, 4)).astype(np.uint8),
            reward=rng.randn(T).astype(np.float32), action=rng.randint(0, 4, T).astype(np.int32),
            done=rng.rand(T) < 0.05,
            behavior_policy=(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
                             ).astype(np.float32),
            previous_action=rng.randint(0, 4, T).astype(np.int32),
            initial_h=rng.randn(T, 16).astype(np.float32),
            initial_c=rng.randn(T, 16).astype(np.float32)))
    return out


@pytest.mark.gpu
def test_pinned_prefetch_gives_the_pageable_copys_batch():
    """The prefetcher's pinned buffers and copy stream give, field for
    field and bit for bit, what a pageable `np.stack` + copy gives, for
    more batches than it has buffers (their reuse included)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from distributed_reinforcement_learning_tpu_torch.agents.common import batch_to_device
    from distributed_reinforcement_learning_tpu_torch.data.fifo import (
        TrajectoryQueue, stack_pytrees)
    from distributed_reinforcement_learning_tpu_torch.data.prefetch import DevicePrefetcher

    items = _impala_items(24, 20, seed=1)
    queue = TrajectoryQueue(64)
    for it in items:
        queue.put(it)
    pre = DevicePrefetcher(queue, batch_size=4, device=torch.device("cuda"))
    try:
        for i in range(6):
            got = batch_to_device(pre.get_batch(timeout=30.0), torch.device("cuda"))
            want = batch_to_device(stack_pytrees(items[4 * i: 4 * i + 4]), torch.device("cuda"))
            for name, x, y in zip(got._fields, got, want):
                assert x.is_cuda and x.dtype == y.dtype and torch.equal(x, y), name
    finally:
        pre.close()
    assert len(pre.h2d_ms()) == 6


@pytest.mark.gpu
def test_async_snapshot_is_not_changed_by_the_next_learn_step():
    """publish_async clones on the compute stream; the next CUDA learn step
    updates the parameters in place right behind it. The landed snapshot
    (device tensors and blob) holds the parameters of its own version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from distributed_reinforcement_learning_tpu_torch.agents.impala import (
        ImpalaAgent, ImpalaConfig)
    from distributed_reinforcement_learning_tpu_torch.data import codec
    from distributed_reinforcement_learning_tpu_torch.data.fifo import stack_pytrees
    from distributed_reinforcement_learning_tpu_torch.runtime.weights import WeightStore

    agent = ImpalaAgent(ImpalaConfig(num_actions=4, lstm_size=16, trajectory=20),
                        device="cuda")
    state = agent.init_state(seed=0)
    batch = stack_pytrees(_impala_items(8, 20, seed=2))
    store = WeightStore()
    agent.learn(state, batch)
    want = {k: v.detach().clone() for k, v in state.params.items()}
    store.publish_async(state.params, 1)
    agent.learn(state, batch)  # in place, queued right behind the clone
    assert store.flush_async(timeout=60.0)
    got, version = store.get()
    host = codec.decode(store.get_blob()[0], copy=True)
    assert version == 1
    assert any(not torch.equal(state.params[k].detach(), v) for k, v in want.items())
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        assert host[k].tobytes() == v.cpu().numpy().tobytes(), k
    store.close()


@pytest.mark.gpu
def test_run_role_learner_on_cuda_launches_vtrace_twice_a_step(tmp_path):
    """A learner process started through run_role on the card, fed by one
    CPU actor process over TCP: K1 launches twice per learn step in the
    learner's own process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json
    import os
    import signal
    import socket
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, DRL_LEARNER_ADDR=f"127.0.0.1:{port}")
    base = [sys.executable, "-m", "distributed_reinforcement_learning_tpu_torch.train_impala",
            "--config", str(repo / "config.json"), "--section", "impala_cartpole"]
    procs = [subprocess.Popen(base + args, cwd=repo, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, start_new_session=True)
             for args, e in ((["--mode", "learner", "--updates", "4"], env),
                             (["--mode", "actor", "--task", "0", "--device", "cpu",
                               "--actor_grace", "2"], dict(env, CUDA_VISIBLE_DEVICES="")))]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate(timeout=10)
    assert [p.returncode for p in procs] == [0, 0], "\n".join(o[-2000:] for o in outs)
    summary = json.loads(outs[0].strip().splitlines()[-1])
    assert summary["device"].startswith("cuda") and summary["train_steps"] == 4
    assert summary["launches"]["vtrace"] == 8
    assert len(summary["h2d_ms"]) >= 4 and summary["h2d_ms_per_batch"] > 0


@pytest.mark.gpu
def test_r2d2_learn_many_on_cuda_runs_the_lstm_kernels_each_step():
    """`learn_many` over K = 2 batches on the card: K2a twice and K2b once
    a step, and the priorities and losses of K `learn` calls on the same
    batches (rtol 1e-5: the gather's backward on CUDA adds with atomics,
    in no fixed order); the parameters within Adam's bound of 2 lr a
    step, which a gradient at float32's noise floor can take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from distributed_reinforcement_learning_tpu_torch.agents.r2d2 import (
        R2D2Agent, R2D2Batch, R2D2Config)
    from distributed_reinforcement_learning_tpu_torch.ops.kernels import lstm as klstm

    agent = R2D2Agent(R2D2Config(lstm_size=64), device="cuda")
    rng = np.random.RandomState(0)
    K, B, T = 2, 8, 10
    batches = R2D2Batch(
        state=rng.randint(0, 255, (K, B, T, 2)).astype(np.int32),
        previous_action=rng.randint(0, 2, (K, B, T)).astype(np.int32),
        action=rng.randint(0, 2, (K, B, T)).astype(np.int32),
        reward=rng.randn(K, B, T).astype(np.float32), done=rng.rand(K, B, T) < 0.1,
        initial_h=rng.randn(K, B, 64).astype(np.float32),
        initial_c=rng.randn(K, B, 64).astype(np.float32))
    weights = rng.rand(K, B).astype(np.float32)
    a, b = agent.init_state(0), agent.init_state(0)
    fwd, bwd = klstm.lstm_fwd_cuda.launches, klstm.lstm_bwd_cuda.launches
    a, prio, metrics = agent.learn_many(a, batches, weights)
    assert (klstm.lstm_fwd_cuda.launches - fwd, klstm.lstm_bwd_cuda.launches - bwd) == (2 * K, K)
    for i in range(K):
        b, p, m = agent.learn(b, R2D2Batch(*(x[i] for x in batches)), weights[i])
        torch.testing.assert_close(prio[i], p, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(metrics["loss"][i], m["loss"], rtol=1e-5, atol=1e-6)
    lr = agent.cfg.learning_rate
    for key in a.params:
        torch.testing.assert_close(a.params[key], b.params[key], rtol=1e-5, atol=K * 2 * lr)


@pytest.mark.gpu
def test_apex_learn_step_on_cuda_matches_the_cpu():
    """`td_error` and one Ape-X learn step (`grads` then `apply_grads`,
    which together are `learn`; 84x84x4 uint8 frames, folded /255, a
    target network that differs from the main one) from the same
    parameters on the card and on the CPU, TF32 off: rtol 1e-4 on the
    loss, the grad norm, the gradients (atol 1e-5 of each tensor's
    largest) and the TD vector. The parameters after the step: rtol 1e-4
    (atol 1% of lr) where the two gradients agree to 0.1%; elsewhere a
    gradient at float32's noise floor gets Adam's lr-sized step either
    way, and the two may differ by the 2 lr that bounds it. The Ape-X
    path launches no kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from distributed_reinforcement_learning_tpu_torch.agents.apex import (
        ApexAgent, ApexBatch, ApexConfig)

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = ApexConfig(fold_normalize=True)
        lr = cfg.start_learning_rate
        rng = np.random.RandomState(3)
        B = 8
        batch = ApexBatch(
            state=rng.randint(0, 256, (B, 84, 84, 4)).astype(np.uint8),
            next_state=rng.randint(0, 256, (B, 84, 84, 4)).astype(np.uint8),
            previous_action=rng.randint(0, 4, B).astype(np.int32),
            action=rng.randint(0, 4, B).astype(np.int32),
            reward=rng.choice([0.0, 1.0, -2.0], B).astype(np.float32),
            done=np.arange(B) % 3 == 1)
        is_weight = np.linspace(0.3, 1.0, B).astype(np.float32)
        launches = (kvt.vtrace_cuda.launches, klstm.lstm_fwd_cuda.launches,
                    kattn.flash_fwd_cuda.launches)
        out = {}
        for device in ("cuda", "cpu"):
            agent = ApexAgent(cfg, device=device)
            state = agent.init_state(seed=1)
            for k, v in agent.init_state(seed=2).params.items():
                state.target_params[k].copy_(v)
            td0 = agent.td_error(state, batch).cpu()
            grads, td, loss = agent.grads(state, batch, is_weight)
            host_grads = {k: v.cpu() for k, v in grads.items()}
            _, metrics = agent.apply_grads(state, grads, loss)
            out[device] = (td0, td.cpu(), {k: float(v) for k, v in metrics.items()}, host_grads,
                           {k: v.detach().cpu() for k, v in state.params.items()})
        assert (kvt.vtrace_cuda.launches, klstm.lstm_fwd_cuda.launches,
                kattn.flash_fwd_cuda.launches) == launches
        (td0_g, td_g, m_g, g_g, p_g), (td0_c, td_c, m_c, g_c, p_c) = out["cuda"], out["cpu"]
        torch.testing.assert_close(td0_g, td0_c, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(td_g, td_c, rtol=1e-4, atol=1e-6)
        for k in m_c:
            assert m_g[k] == pytest.approx(m_c[k], rel=1e-4), k
        for k, v in p_c.items():
            torch.testing.assert_close(g_g[k], g_c[k], rtol=1e-4,
                                       atol=1e-5 * float(g_c[k].abs().max()))
            settled = (g_g[k] - g_c[k]).abs() <= 1e-3 * g_c[k].abs()
            torch.testing.assert_close(p_g[k][settled], v[settled], rtol=1e-4, atol=1e-2 * lr)
            assert float((p_g[k] - v).abs().max()) <= 2 * lr * (1 + 1e-5), k
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
