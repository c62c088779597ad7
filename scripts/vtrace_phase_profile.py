"""Where a call of the V-trace kernel K1 spends its time, per block, on one GPU.

    python3 scripts/vtrace_phase_profile.py [--source other.cu]

Builds `csrc/vtrace.cu` (or another version of it that keeps its marks)
with -DDRL_VTRACE_PHASES into `csrc/build/`, which git ignores. Each
block writes the globaltimer (ns) when it starts, when its first item's
(a slab's chunk of rows) copies are issued and when they have landed in
shared memory, when that item's elementwise work (in the 32-column
kernel, where it comes before the recursion) and its columns are done,
and when its last item is done, with the number of items it took.
Prints, at chip_smoke's two timed V-trace shapes, the instrumented
call's time in a CUDA graph, the span from the first block's start to
the last block's end, the spread of the blocks' starts, and the median
(and max) over blocks of each phase. The marks are taken on three eager
calls of one input set, which stays in the 50 MB L2 cache at the large
shape, where the graph's timing rotates four sets through device memory.
`chip_smoke.py` times the real kernel. Needs a CUDA device and nvcc;
imports no JAX.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from distributed_reinforcement_learning_tpu_torch.ops.kernels import _build  # noqa: E402
from distributed_reinforcement_learning_tpu_torch.ops.kernels import vtrace as kvt  # noqa: E402
from attention_compare import using  # noqa: E402  (the sibling script)

PHASES = [("copies issued", 0, 6), ("first item landed", 6, 1),
          ("elementwise (32-column slabs)", 1, 2), ("recursion (32-column slabs)", 2, 3),
          ("its columns computed", 1, 3), ("other items", 3, 4), ("block total", 0, 4)]


def build(source: Path) -> ctypes.CDLL:
    """`source` built with its phase marks."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha1(source.read_bytes()).hexdigest()[:8]
    lib = _build.BUILD_DIR / f"vtrace_phases_{tag}.so"
    out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-DDRL_VTRACE_PHASES",
                          "-o", str(lib), str(source)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(out.stdout + out.stderr)
    cdll = ctypes.CDLL(str(lib))
    kvt._signature(cdll)
    cdll.drl_cuda_error_string.argtypes = [ctypes.c_int]
    cdll.drl_cuda_error_string.restype = ctypes.c_char_p
    cdll.drl_vtrace_set_marks.argtypes = [ctypes.c_void_p]
    return cdll


def profile(lib: ctypes.CDLL, T: int, B: int) -> None:
    sets = [smoke.vtrace_inputs(T, B, seed=i, device="cuda") for i in range(1 if B <= 4096 else 4)]
    fns = [lambda a=a: kvt.vtrace_cuda(*a) for a in sets]
    slabs = -(-B // 32)  # at most one block a slab
    marks = torch.zeros(slabs * 8, dtype=torch.int64, device="cuda")
    with using(lib):
        if lib.drl_vtrace_set_marks(None) != 0:
            raise SystemExit("cannot clear the marks buffer")
        graph_us = smoke.time_graph_ms(fns) * 1e3
        if lib.drl_vtrace_set_marks(marks.data_ptr()) != 0:
            raise SystemExit("cannot set the marks buffer")
        for _ in range(3):
            fns[0]()
        torch.cuda.synchronize()
        lib.drl_vtrace_set_marks(None)
    m = marks.view(slabs, 8).cpu().numpy().astype(np.int64)
    m = m[m[:, 0] > 0]  # the blocks of the grid
    span = m[:, 4].max() - m[:, 0].min()
    spread = m[:, 0].max() - m[:, 0].min()
    phases = ", ".join(f"{name} {np.median(m[:, b] - m[:, a]):.0f} "
                       f"(max {(m[:, b] - m[:, a]).max():.0f})" for name, a, b in PHASES
                       if (m[:, a] > 0).all() and (m[:, b] > 0).all())  # marks the kernel wrote
    print(f"K1 T={T} B={B}: {graph_us:.2f} us a call in a graph (marks off); {len(m)} blocks, "
          f"items a block median {np.median(m[:, 5]):.0f} max {m[:, 5].max()}; span {span} ns, "
          f"starts spread over {spread} ns; ns: {phases}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("vtrace_phase_profile: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    source = Path(args[args.index("--source") + 1]) if "--source" in args else (
        _build.CSRC / "vtrace.cu")
    lib = build(source)
    print(smoke.nvidia_smi_line(), source.name, flush=True)
    for T, B in (smoke.MAIN_SHAPE, smoke.SHAPES[-1]):
        profile(lib, T, B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
