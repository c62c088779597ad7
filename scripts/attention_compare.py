"""K3a, K3b and K3c of this tree against other versions of
`csrc/attention.cu`, timed in turns in one process on one card.

    python3 scripts/attention_compare.py runs/pr3/attention.cu [more.cu ...]

Each other version (for example the parent commit's source, unpacked
with `git show <commit>:distributed_reinforcement_learning_tpu_torch/csrc/attention.cu`
into a gitignored directory) must keep the C entry points. It builds with
the package's nvcc flags into `csrc/build/` and runs through the same
Python wrappers, so eager times carry the same host cost. Every version
is first held to the plain versions' bars at chip_smoke's three
attention shapes (dq, dk and dv from the same lse and delta); then, per
shape and kernel, all are timed eager and in
a CUDA graph in the order others, this, this, others reversed. Prints
the card's name and power limit, then one JSON line per (shape, kernel)
with each version's times in microseconds, keyed by file stem ("this"
for this tree). Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from distributed_reinforcement_learning_tpu_torch.ops.kernels import _build  # noqa: E402
from distributed_reinforcement_learning_tpu_torch.ops.kernels import attention as kattn  # noqa: E402


def build_other(src: Path, declare=kattn._signature) -> ctypes.CDLL:
    """Another version of a kernel source, built with the package's nvcc
    flags; `declare` sets its entry points' argtypes."""
    digest = hashlib.sha1(src.read_bytes() + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()
    lib_path = _build.BUILD_DIR / f"{src.stem}_other-{digest[:16]}.so"
    if not lib_path.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                              str(src)], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.drl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.drl_cuda_error_string.restype = ctypes.c_char_p
    declare(lib)
    return lib


@contextlib.contextmanager
def using(lib: ctypes.CDLL | None):
    """The wrappers call `lib` (None: this tree's library) inside the block."""
    if lib is None:
        yield
        return
    load = _build.load
    _build.load = lambda stem, declare: lib
    try:
        yield
    finally:
        _build.load = load


def check(B, H, T, D, q, k, v, segs, do) -> tuple[torch.Tensor, torch.Tensor]:
    """Hold the active version's K3a, K3b and K3c to the plain versions'
    bars."""
    blk = kattn.flash_blocks(T)
    o, lse = kattn.flash_fwd_cuda(q, k, v, segs, segs)
    want_o, want_lse = kattn.flash_fwd_plain(q, k, v, segs, segs, blk, blk)
    torch.testing.assert_close(o, want_o, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0)
    delta = (do * want_o).sum(-1)
    dq = kattn.flash_dq_cuda(q, k, v, segs, segs, do, want_lse, delta)
    dk, dv = kattn.flash_dkv_cuda(q, k, v, segs, segs, do, want_lse, delta)
    want = kattn.flash_bwd_plain(q, k, v, segs, segs, do, want_lse, delta, blk, blk)
    for a, b in zip((dq, dk, dv), want):
        torch.testing.assert_close(a, b, atol=1e-4 * max(1.0, float(b.abs().max())), rtol=0)
    return want_lse, delta


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("attention_compare: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    others = [(Path(p).stem, build_other(Path(p))) for p in sys.argv[1:]]
    order = [*others, ("this", None), ("this", None), *reversed(others)]
    print(smoke.nvidia_smi_line(), flush=True)
    for B, H, T, D in smoke.ATTN_SHAPES:
        q, k, v, segs, do = smoke.attention_inputs(B, H, T, D, seed=T + D, device="cuda")
        for _, lib in order[:len(others) + 1]:
            with using(lib):
                lse, delta = check(B, H, T, D, q, k, v, segs, do)
        big = T >= 1024
        eager = dict(iters=20, warmup=3) if big else dict(iters=500, warmup=20)
        graph = dict(calls=5, replays=3) if big else dict(calls=50, replays=10)
        bwd_args = (q, k, v, segs, segs, do, lse, delta)
        for kind, fn in (("fwd", lambda: kattn.flash_fwd_cuda(q, k, v, segs, segs)),
                         ("dq", lambda: kattn.flash_dq_cuda(*bwd_args)),
                         ("dkv", lambda: kattn.flash_dkv_cuda(*bwd_args))):
            runs = {name: [] for name, _ in order}
            for name, lib in order:
                with using(lib):
                    runs[name].append({"graph_us": smoke.time_graph_ms([fn], **graph) * 1e3,
                                       "eager_us": smoke.time_eager_ms([fn], **eager) * 1e3})
            print(json.dumps({"shape": [B, H, T, D], "kernel": kind, **runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
