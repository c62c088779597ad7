"""The host-bound phases of `chip_smoke.py` timed as one block: the
in-process `impala` path (phase 4), the multi-process `impala` learner
with 4 CPU actors (phase 11) and the launcher's phases 31-33.

    python3 scripts/smoke_host_phases.py

Runs from the root of a checkout (the phases build their kernels and
write their logs there, as `chip_smoke.py` does) and prints one line
`BLOCK {json}` with each part's seconds, the learn step's synchronised
ms, phase 11's ms an update and phases 31-33's seconds each. To compare
two commits on one card, unpack each with `git archive <commit>` into a
gitignored directory and run the script from each tree in one machine,
in the order parent, change, change, parent: the host's speed drifts
between runs of the same code. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))

import chip_smoke as smoke  # noqa: E402  (the checkout's own)


def main() -> None:
    out = {}
    t0 = time.perf_counter()
    main_path = smoke.phase_main_path(smoke.phase_memory("impala path"))
    out["phase_4_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    multiproc = smoke.phase_multiprocess_impala()
    out["phase_11_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launcher = smoke.phase_launcher_impala(multiproc)
    r2d2 = smoke.phase_launcher_r2d2_ring()
    respawn = smoke.phase_launcher_respawn()
    out["phases_31_33_s"] = time.perf_counter() - t0
    out.update(learn_ms=main_path["learn_ms"], mp_wall_ms=multiproc["wall_per_update_ms"],
               p31=[launcher[k]["seconds"] for k in ("defaults", "rings")],
               p32=r2d2["seconds"], p33=respawn["seconds"])
    print("BLOCK " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
