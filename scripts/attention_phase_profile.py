"""Where a call of the flash kernels K3a, K3b and K3c spends its time, per block, on one GPU.

    python3 scripts/attention_phase_profile.py [B,H,T,D ...]   # default: chip_smoke's shapes

Builds `csrc/attention.cu` with -DDRL_FLASH_PHASES (into `csrc/build/`,
which git ignores): each block of K3a, K3b and K3c (one per 16-row tile)
writes the globaltimer (ns) when it starts, when its first tile has
landed in shared memory, before and after the barrier that exchanges
the warps' parts of that tile's S (S and dP in K3b, S^T and dP^T in
K3c), when that tile is computed, when its last tile is computed and
when its outputs are stored, and the number of tiles it computed (warp
0's view). Prints, for each shape and kernel, the
instrumented call's time in a CUDA graph, the span from the first
block's start to the last block's end, the spread of the blocks' starts,
and the median (and max) over blocks of each phase. The marks add a
`__syncwarp` and a store each; `chip_smoke.py` times the real kernels.
Needs a CUDA device and nvcc; imports no JAX.
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

import chip_smoke as smoke  # noqa: E402
from distributed_reinforcement_learning_tpu_torch.ops.kernels import _build  # noqa: E402
from distributed_reinforcement_learning_tpu_torch.ops.kernels import attention as kattn  # noqa: E402
from attention_compare import using  # noqa: E402  (the sibling script)

PHASES = [("first tile landed", 0, 1), ("its parts of S", 1, 6), ("the exchange", 6, 7),
          ("the rest of it", 7, 2), ("other tiles", 2, 3), ("outputs stored", 3, 4),
          ("block total", 0, 4)]


def build() -> ctypes.CDLL:
    """`csrc/attention.cu` built with its phase marks (-DDRL_FLASH_PHASES)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / "attention_phases.so"
    out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-DDRL_FLASH_PHASES", "-o",
                          str(lib), str(_build.CSRC / "attention.cu")],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(out.stdout + out.stderr)
    cdll = ctypes.CDLL(str(lib))
    kattn._signature(cdll)
    cdll.drl_cuda_error_string.argtypes = [ctypes.c_int]
    cdll.drl_cuda_error_string.restype = ctypes.c_char_p
    cdll.drl_flash_set_marks.argtypes = [ctypes.c_void_p]
    return cdll


def profile(lib: ctypes.CDLL, B: int, H: int, T: int, D: int) -> None:
    q, k, v, segs, do = smoke.attention_inputs(B, H, T, D, seed=T + D, device="cuda")
    blk = kattn.flash_blocks(T)
    want_o, lse = kattn.flash_fwd_plain(q, k, v, segs, segs, blk, blk)
    delta = (do * want_o).sum(-1)
    blocks = B * H * -(-T // 16)
    marks = torch.zeros(blocks * 8, dtype=torch.int64, device="cuda")
    with using(lib):
        bwd_args = (q, k, v, segs, segs, do, lse, delta)
        for kind, fn in (("K3a", lambda: kattn.flash_fwd_cuda(q, k, v, segs, segs)),
                         ("K3b", lambda: kattn.flash_dq_cuda(*bwd_args)),
                         ("K3c", lambda: kattn.flash_dkv_cuda(*bwd_args))):
            if lib.drl_flash_set_marks(None) != 0:
                raise SystemExit("cannot clear the marks buffer")
            graph_us = smoke.time_graph_ms([fn], calls=20, replays=5) * 1e3
            if lib.drl_flash_set_marks(marks.data_ptr()) != 0:
                raise SystemExit("cannot set the marks buffer")
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            m = marks.view(blocks, 8).cpu().numpy().astype(np.int64)
            span = m[:, 4].max() - m[:, 0].min()
            spread = m[:, 0].max() - m[:, 0].min()
            phases = ", ".join(f"{name} {np.median(m[:, b] - m[:, a]):.0f} "
                               f"(max {(m[:, b] - m[:, a]).max():.0f})" for name, a, b in PHASES)
            print(f"{kind} B={B} H={H} T={T} D={D}: {graph_us:.2f} us a call in a graph "
                  f"(marks off); {blocks} blocks, tiles a block median {np.median(m[:, 5]):.0f} "
                  f"max {m[:, 5].max()}; span {span} ns, starts spread over {spread} ns; "
                  f"ns: {phases}", flush=True)
    lib.drl_flash_set_marks(None)


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_phase_profile: no CUDA device", file=sys.stderr)
        return 1
    shapes = ([tuple(int(x) for x in a.split(",")) for a in sys.argv[1:]]
              or smoke.ATTN_SHAPES)
    lib = build()
    print(smoke.nvidia_smi_line(), flush=True)
    for shape in shapes:
        profile(lib, *shape)
    return 0


if __name__ == "__main__":
    sys.exit(main())
