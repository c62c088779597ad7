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

A bfloat16 `xg` (and `keep`, which the JAX package casts to xg's type)
is taken too: the wrappers cast it to float32 before the kernel or the
plain version sees it, where the Pallas kernel adds the bfloat16 `xg` to
its float32 `h @ Wh` (`ops/pallas/lstm.py:91`). Everything else, and
every output, is float32.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

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


def _as_float32(xg, keep) -> tuple[torch.Tensor, torch.Tensor]:
    """The announced cast: a bfloat16 `xg` or `keep` becomes float32."""
    return tuple(t.float() if t.dtype == torch.bfloat16 else t for t in (xg, keep))


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


# The persistent kernels' launch plan (`csrc/lstm.cu`): 256 threads a
# block, each owning 8 batch rows x 4 columns of a product; at most 64
# batch rows staged at a time; the most shared memory a block can opt in
# to on an H100 (227 KB); a staged chunk of at least 64 k-values.
THREADS = 256
WARPS = THREADS // 32
ROW_TILE = 8
COL_TILE = 4
MAX_ROWS = 64
MAX_SMEM = 232_448
MIN_K_CHUNK = 64


@dataclass(frozen=True)
class LSTMPlan:
    """Grid and shared-memory layout of one K2a or K2b launch.

    Block g owns hidden units [g * units, (g + 1) * units) and keeps their
    gate columns of Wh resident; `rows` batch rows are staged at a time
    (the backward's gate recompute over all T * B rows stages `rows_all`
    rows at a time, in two buffers). The three `*_floats` are the regions of the block's dynamic
    shared memory: the resident weights, the gate sums (backward: then a
    chunk's dgates), the staged rows. `part_floats` is the backward's
    global scratch: two steps' partial sums of dh, [2, blocks, blocks,
    Bp, units] with B rounded up to Bp, a multiple of `rows`."""

    blocks: int
    units: int
    rows: int
    rows_all: int
    w_floats: int
    red_floats: int
    stage_floats: int
    part_floats: int

    @property
    def smem_bytes(self) -> int:
        return 4 * (self.w_floats + self.red_floats + self.stage_floats)


def _split_layout(rows: int, cols: int) -> tuple[int, int]:
    """(lanes, warp groups) that split K in a product over rows x cols
    outputs: `split_of` in `csrc/lstm.cu`, whose launch refuses a plan
    that gives a region less than its kernels index (`plan_fits`)."""
    items = (rows // ROW_TILE) * (cols // COL_TILE)
    lanes = 32
    while lanes * items > THREADS:
        lanes //= 2
    return lanes, WARPS // -(-items // (32 // lanes))


def _round_rows(n: int) -> int:
    return min(MAX_ROWS, -(-n // ROW_TILE) * ROW_TILE)


def _plan(T: int, B: int, H: int, sm_count: int, backward: bool) -> LSTMPlan | None:
    units = -(-H // sm_count)
    blocks = -(-H // units)
    C = 4 * units
    w_floats = H * C + H  # k-quads of Wh's columns, 4 floats of padding per quad
    rows = _round_rows(B)
    if not backward:
        # h @ Wh[:, block columns] over `rows` rows, K staged in chunks
        # that fit (at least MIN_K_CHUNK).
        red_floats = _split_layout(rows, C)[1] * rows * C
        free = (MAX_SMEM // 4 - w_floats - red_floats) // 4 * 4
        stage_floats = min(free, rows * (H + 4))
        if stage_floats < rows * (min(H, MIN_K_CHUNK) + 4):
            return None
        return LSTMPlan(blocks, units, rows, rows, w_floats, red_floats, stage_floats, 0)
    # Backward: the gate recompute over rows_all of the T * B rows at a
    # time, double-buffered (two chunks of all H columns in the stage);
    # then each step keeps a chunk's dgates ([rows, C + 4]), sums the
    # chunk's partials of dh from every block, and lays out its own
    # partials for every owner ([rows, units] + 4 floats each) before they
    # go out, as many blocks' (owners') at a time as fit the stage (at
    # least 4). rows_all halves until the two chunks fit (a power of two
    # of row tiles keeps all 256 threads at work).
    first = _round_rows(T * B)
    for rows_all in sorted({first} | {r for r in (32, 16, 8) if r < first}, reverse=True):
        red_floats = max(_split_layout(rows_all, C)[1] * rows_all * C, rows * (C + 4))
        free = (MAX_SMEM // 4 - w_floats - red_floats) // 4 * 4
        seg = rows * units + 4
        stage_floats = min(free, max(2 * rows_all * (H + 4), blocks * seg))
        if stage_floats >= max(2 * rows_all * (H + 4), 4 * seg):
            part_floats = 2 * blocks * blocks * (-(-B // rows) * rows) * units
            return LSTMPlan(blocks, units, rows, rows_all, w_floats, red_floats, stage_floats,
                            part_floats)
    return None


@functools.cache
def max_hidden(sm_count: int) -> int:
    """The largest H (a multiple of 4) up to which both kernels have a
    plan on a card with `sm_count` SMs, at any T and B."""
    H = 4
    while all(_plan(8, MAX_ROWS, H + 4, sm_count, bwd) for bwd in (False, True)):
        H += 4
    return H


def check_hidden_size(H: int, sm_count: int) -> None:
    """Raise unless both kernels take hidden size H on a card with
    `sm_count` SMs (a multiple of 4, at most `max_hidden(sm_count)`)."""
    limit = max_hidden(sm_count)
    if H % 4 or H > limit:
        raise ValueError(
            f"LSTM kernels: hidden size {H} must be a multiple of 4 and at most {limit}: "
            f"the persistent kernels keep Wh split across the {sm_count} SMs' shared memory "
            f"({MAX_SMEM} bytes a block)")


def lstm_plan(T: int, B: int, H: int, sm_count: int, backward: bool = False) -> LSTMPlan:
    """The launch plan of K2a (K2b with `backward`) for T steps, batch B
    and hidden size H on a card with `sm_count` SMs: one block per SM at
    most, so the grid is co-resident and its barrier cannot deadlock.
    Raises where Wh's slices do not fit the SMs' shared memory."""
    check_hidden_size(H, sm_count)
    plan = _plan(T, B, H, sm_count, backward)
    if plan is None:
        raise ValueError(f"LSTM kernels: no launch plan for T={T}, B={B}, H={H} on "
                         f"{sm_count} SMs")
    return plan


def _signature(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    plan = [i] * 6  # units, rows, rows_all, w_floats, red_floats, stage_floats
    lib.drl_lstm_fwd.argtypes = [p] * 9 + [i, i, i] + plan + [i, p]
    lib.drl_lstm_fwd.restype = ctypes.c_int
    lib.drl_lstm_bwd.argtypes = [p] * 12 + [i, i, i] + plan + [i, p]
    lib.drl_lstm_bwd.restype = ctypes.c_int
    lib.drl_lstm_sm_count.argtypes = [i]
    lib.drl_lstm_sm_count.restype = ctypes.c_int


def _load_for(tensors, what: str, backward: bool) -> tuple[ctypes.CDLL, LSTMPlan]:
    """Check that `tensors` are contiguous CUDA tensors of one device; ->
    the loaded library and the launch plan for the tensors' device."""
    if not on_cuda(*tensors):
        raise ValueError(f"{what} takes CUDA tensors")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")
    lib = _build.load("lstm", _signature)
    sm_count = lib.drl_lstm_sm_count(tensors[0].device.index)
    if sm_count < 1:
        raise RuntimeError(f"{what}: cannot read the SM count of {tensors[0].device}")
    T, B = tensors[2].shape
    return lib, lstm_plan(T, B, tensors[3].shape[1], sm_count, backward)


def _plan_args(plan: LSTMPlan) -> tuple[int, ...]:
    return (plan.units, plan.rows, plan.rows_all, plan.w_floats, plan.red_floats,
            plan.stage_floats)


def lstm_fwd_cuda(xg, wh, keep, h0, c0):
    """K2a: one cooperative launch on the current stream of the tensors'
    device -> (h_all, c_all, hT, cT). Takes contiguous float32 CUDA
    tensors only (a bfloat16 `xg` or `keep` is cast to float32 here);
    raises on anything else, on a hidden size past the plan's limit, on a
    failed build and on a refused launch."""
    xg, keep = _as_float32(xg, keep)
    tensors = (xg, wh, keep, h0, c0)
    _check_inputs(*tensors)
    lib, plan = _load_for(tensors, "lstm_fwd_cuda", backward=False)
    T, B, G = xg.shape
    h_all = xg.new_empty((T, B, G // 4))
    c_all = torch.empty_like(h_all)
    hT, cT = torch.empty_like(h0), torch.empty_like(c0)
    device = xg.device
    err = lib.drl_lstm_fwd(
        xg.data_ptr(), wh.data_ptr(), keep.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        h_all.data_ptr(), c_all.data_ptr(), hT.data_ptr(), cT.data_ptr(), T, B, G // 4,
        *_plan_args(plan), device.index, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, err, "LSTM forward kernel launch")
    lstm_fwd_cuda.launches += 1
    return h_all, c_all, hT, cT


lstm_fwd_cuda.launches = 0


def lstm_bwd_cuda(xg, wh, keep, h0, c0, h_all, c_all, dh_all, dhT, dcT):
    """K2b: one cooperative launch on the current stream -> (dxg, dh0,
    dc0). Same contract as `lstm_fwd_cuda`."""
    xg, keep = _as_float32(xg, keep)
    tensors = (xg, wh, keep, h0, c0, h_all, c_all, dh_all, dhT, dcT)
    _check_inputs(*tensors[:5])
    T, B, G = xg.shape
    for name, t, shape in (("h_all", h_all, (T, B, G // 4)), ("c_all", c_all, (T, B, G // 4)),
                           ("dh_all", dh_all, (T, B, G // 4)), ("dhT", dhT, (B, G // 4)),
                           ("dcT", dcT, (B, G // 4))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}, got {t.dtype} {tuple(t.shape)}")
    lib, plan = _load_for(tensors, "lstm_bwd_cuda", backward=True)
    dxg = torch.empty_like(xg)
    # The kernel carries dh and dc in these buffers: dhT, dcT in, dh0, dc0 out.
    dh0, dc0 = dhT.clone(), dcT.clone()
    part = xg.new_empty(plan.part_floats)  # the blocks' partial sums of dh
    device = xg.device
    err = lib.drl_lstm_bwd(
        xg.data_ptr(), wh.data_ptr(), keep.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        h_all.data_ptr(), c_all.data_ptr(), dh_all.data_ptr(), dxg.data_ptr(),
        dh0.data_ptr(), dc0.data_ptr(), part.data_ptr(), T, B, G // 4, *_plan_args(plan),
        device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, err, "LSTM backward kernel launch")
    lstm_bwd_cuda.launches += 1
    return dxg, dh0, dc0


lstm_bwd_cuda.launches = 0


def lstm_fwd(xg, wh, keep, h0, c0):
    """K2a for CUDA tensors, the plain version for CPU tensors."""
    if on_cuda(xg, wh, keep, h0, c0):
        return lstm_fwd_cuda(xg, wh, keep, h0, c0)
    xg, keep = _as_float32(xg, keep)
    _check_inputs(xg, wh, keep, h0, c0)
    return lstm_fwd_plain(xg, wh, keep, h0, c0)


def lstm_bwd(xg, wh, keep, h0, c0, h_all, c_all, dh_all, dhT, dcT):
    """K2b for CUDA tensors, the plain version for CPU tensors."""
    args = (xg, wh, keep, h0, c0, h_all, c_all, dh_all, dhT, dcT)
    if on_cuda(*args):
        return lstm_bwd_cuda(*args)
    xg, keep = _as_float32(xg, keep)
    _check_inputs(xg, wh, keep, h0, c0)
    return lstm_bwd_plain(xg, wh, keep, h0, c0, h_all, c_all, dh_all, dhT, dcT)


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
        h_prev = torch.cat([h0[None], h_all[:-1] * keep[:-1, :, None].float()])
        H = h0.shape[1]
        dwh = h_prev.reshape(-1, H).T @ dxg.reshape(-1, 4 * H)
        dkeep = torch.zeros_like(keep) if ctx.needs_input_grad[2] else None
        return dxg, dwh, dkeep, dh0, dc0
