"""K1 (V-trace) of this tree against other versions of `csrc/vtrace.cu`,
timed in turns in one process on one card.

    python3 scripts/vtrace_compare.py runs/pr5/vtrace.cu [more.cu ...]

Each other version (for example the parent commit's source, unpacked
with `git show <commit>:distributed_reinforcement_learning_tpu_torch/csrc/vtrace.cu`
into a gitignored directory) must keep the C entry point `drl_vtrace`.
It builds with the package's nvcc flags into `csrc/build/` and runs
through the same Python wrapper, so eager times carry the same host
cost. Every version is first held bit for bit to the plain version on
finite inputs at chip_smoke's V-trace shapes and at T = 70 (more than
one chunk of rows); this tree's version also on NaN and +-inf log-rhos.
Then, at chip_smoke's two timed shapes, all are timed eager and in a
CUDA graph in the order others, this, this, others reversed (the large
shape rotates through 4 input sets, 127 MB, past the 50 MB L2 cache).
Prints the card's name and power limit, then one JSON line per shape
with each version's times in microseconds, keyed by file stem ("this"
for this tree). Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from attention_compare import build_other, using  # noqa: E402  (the sibling script)
from distributed_reinforcement_learning_tpu_torch.ops.kernels import vtrace as kvt  # noqa: E402


def check(T: int, B: int, special: bool) -> None:
    """Hold the active version to the plain version's bits."""
    for clip in (1.0, None):
        make = smoke.vtrace_special_inputs if special else smoke.vtrace_inputs
        args = make(T, B, seed=T + B, device="cuda")
        got = kvt.vtrace_cuda(*args, clip_rho_threshold=clip)
        want = kvt.vtrace_plain(*args, clip_rho_threshold=clip)
        for a, b in zip(got, want):
            if not smoke.bit_equal(a, b):
                raise RuntimeError(f"T={T} B={B} clip_rho={clip} special={special}: "
                                   "kernel and plain version differ")


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("vtrace_compare: no CUDA device available", file=sys.stderr)
        return 1
    others = [(Path(p).stem, build_other(Path(p), kvt._signature)) for p in sys.argv[1:]]
    order = [*others, ("this", None), ("this", None), *reversed(others)]
    print(smoke.nvidia_smi_line(), flush=True)
    for T, B in [*smoke.SHAPES, (70, 1000)]:
        for name, lib in order[:len(others) + 1]:
            with using(lib):
                check(T, B, special=False)
        check(T, B, special=True)
    for T, B in (smoke.MAIN_SHAPE, smoke.SHAPES[-1]):
        sets = [smoke.vtrace_inputs(T, B, seed=i, device="cuda")
                for i in range(1 if B <= 4096 else 4)]
        fns = [lambda a=a: kvt.vtrace_cuda(*a) for a in sets]
        runs = {name: [] for name, _ in order}
        for name, lib in order:
            with using(lib):
                runs[name].append({"graph_us": smoke.time_graph_ms(fns) * 1e3,
                                   "eager_us": smoke.time_eager_ms(fns) * 1e3})
        print(json.dumps({"shape": [T, B], "kernel": "vtrace", **runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
