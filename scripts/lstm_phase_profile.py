"""Phase-by-phase device timing of the LSTM kernels K2a and K2b on one GPU.

    python3 scripts/lstm_phase_profile.py [T,B,H ...]   # default: 10,32,512 10,16,512 20,256,512

Builds `csrc/lstm.cu` with -DDRL_LSTM_PHASES (into `csrc/build/`, which
git ignores): at each phase boundary every block meets at a barrier and
its thread 0 writes the globaltimer (ns) into a buffer (the `MARK`s of
the source). Prints, for each shape and kernel, the time of an
instrumented call (CUDA events) and, per step, the median over blocks of
each phase, the spread of the blocks' arrivals at the grid barrier, and
the step's wall time. The extra barriers make the instrumented kernels a
few percent slower than the real ones; `chip_smoke.py` times those.
T is at most 40 (slots 40 and up hold the backward's head). Needs a CUDA
device and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from distributed_reinforcement_learning_tpu_torch.ops.kernels import _build  # noqa: E402
from distributed_reinforcement_learning_tpu_torch.ops.kernels import lstm as klstm  # noqa: E402

SLOTS = 64  # per block: slots 0..T-1 steps, 40..59 the backward's recompute chunks, 63 the head


def build() -> ctypes.CDLL:
    """`csrc/lstm.cu` built with its phase marks (-DDRL_LSTM_PHASES)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / "lstm_phases.so"
    out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-DDRL_LSTM_PHASES", "-o",
                          str(lib), str(_build.CSRC / "lstm.cu")], capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(out.stdout + out.stderr)
    cdll = ctypes.CDLL(str(lib))
    klstm._signature(cdll)
    cdll.drl_lstm_set_marks.argtypes = [ctypes.c_void_p]
    return cdll


def inputs(T: int, B: int, H: int):
    rng = np.random.RandomState(0)
    arrays = [rng.randn(T, B, 4 * H) * 0.5, rng.randn(H, 4 * H) / np.sqrt(H),
              rng.rand(T, B) > 0.15, rng.randn(B, H) * 0.1, rng.randn(B, H) * 0.1]
    return [torch.from_numpy(np.asarray(a, np.float32)).cuda() for a in arrays]


def phases(steps: list[np.ndarray], names: list[tuple[str, int, int]]) -> str:
    """Each (name, from mark, to mark) interval: the median over blocks,
    averaged over the steps."""
    return ", ".join(f"{name} {np.mean([np.median(m[:, b] - m[:, a]) for m in steps]):.0f}"
                     for name, a, b in names)


def profile(lib: ctypes.CDLL, T: int, B: int, H: int, backward: bool) -> None:
    xg, wh, keep, h0, c0 = inputs(T, B, H)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = klstm.lstm_plan(T, B, H, sms, backward)
    args = (*klstm._plan_args(plan), 0, torch.cuda.current_stream().cuda_stream)
    prof = torch.zeros(plan.blocks * SLOTS * 8, dtype=torch.int64, device="cuda")
    if lib.drl_lstm_set_marks(prof.data_ptr()) != 0:
        raise SystemExit("cannot set the marks buffer")
    h_all, c_all, _, _ = klstm.lstm_fwd_plain(xg, wh, keep, h0, c0)
    if backward:
        dxg, part = torch.empty_like(xg), torch.empty(plan.part_floats, device="cuda")
        dh, dc = torch.empty_like(h0), torch.empty_like(c0)
        ones = torch.ones_like(h_all)

        def call():
            dh.fill_(1.0)
            dc.fill_(1.0)
            return lib.drl_lstm_bwd(
                xg.data_ptr(), wh.data_ptr(), keep.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                h_all.data_ptr(), c_all.data_ptr(), ones.data_ptr(), dxg.data_ptr(),
                dh.data_ptr(), dc.data_ptr(), part.data_ptr(), T, B, H, *args)
        want = klstm.lstm_bwd_plain(xg, wh, keep, h0, c0, h_all, c_all, ones,
                                    torch.ones_like(h0), torch.ones_like(c0))
        got = (dxg, dh, dc)
    else:
        got = (torch.empty_like(h_all), torch.empty_like(c_all), torch.empty_like(h0),
               torch.empty_like(c0))

        def call():
            return lib.drl_lstm_fwd(
                xg.data_ptr(), wh.data_ptr(), keep.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                *(t.data_ptr() for t in got), T, B, H, *args)
        want = klstm.lstm_fwd_plain(xg, wh, keep, h0, c0)
    for _ in range(3):
        if call() != 0:
            raise SystemExit("launch refused")
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        call()
    end.record()
    torch.cuda.synchronize()
    marks = prof.view(plan.blocks, SLOTS, 8).cpu().numpy()
    lib.drl_lstm_set_marks(None)
    tag = "K2b" if backward else "K2a"
    print(f"{tag} T={T} B={B} H={H}: {start.elapsed_time(end) / 20 * 1e3:.1f} us a call "
          f"(instrumented, eager); max |kernel - plain| {err:.2e}; {plan}")
    # Steps away from both ends of the recursion.
    steps = [marks[:, t, :] for t in range(T)][1:-1] or [marks[:, t, :] for t in range(T)]
    if backward:
        names = [("partials summed", 0, 4), ("cell gradients", 4, 5),
                 ("own partials out", 5, 1), ("rest of the chunks", 1, 2), ("grid barrier", 2, 3)]
        head = marks[:, 63, :]
        print(f"  gate recompute (phase 1): {np.median(head[:, 2] - head[:, 0]):.0f} ns")
        chunks = [marks[:, 40 + c, :] for c in range(19)
                  if (marks[:, 40 + c, 2] > marks[:, 40 + c, 0]).all()]
        if chunks:
            per = [("rows landed", 0, 4), ("FMAs", 4, 5), ("sums shared", 5, 1),
                   ("gates parked", 1, 2)]
            print(f"  per recompute chunk ({len(chunks)}), ns: "
                  + ", ".join(f"{n} {np.mean([np.median(m[:, b] - m[:, a]) for m in chunks]):.0f}"
                              for n, a, b in per))
    else:
        names = [("first rows landed", 0, 4), ("FMAs", 4, 5), ("sums shared", 5, 1),
                 ("cell + fetch + later chunks", 1, 2), ("grid barrier", 2, 3)]
    spread = np.mean([m[:, 2].max() - m[:, 2].min() for m in steps])
    wall = np.mean([m[:, 3].max() - m[:, 0].min() for m in steps])
    print(f"  a step, ns: {phases(steps, names)}; arrival spread {spread:.0f}; "
          f"step wall {wall:.0f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("lstm_phase_profile: no CUDA device", file=sys.stderr)
        return 1
    shapes = [tuple(map(int, a.split(","))) for a in sys.argv[1:]] or [
        (10, 32, 512), (10, 16, 512), (20, 256, 512)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi.stdout.strip()}")
    if any(T > 40 for T, _, _ in shapes):
        raise SystemExit("T is at most 40")
    lib = build()
    for T, B, H in shapes:
        for backward in (False, True):
            profile(lib, T, B, H, backward)
    return 0


if __name__ == "__main__":
    sys.exit(main())
