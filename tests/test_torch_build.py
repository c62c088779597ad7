"""The kernel build under several processes (`ops/kernels/_build.py`).

A fake compiler stands in for nvcc: it writes its output in two halves
with a pause between them and logs each call. Two processes build the
same sources at once; exactly one compiler call per source may happen,
and neither process may ever see a library under its final name that
is not whole.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_FAKE_NVCC = """#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
src = sys.argv[-1]
with open({calls!r}, "a") as f:
    f.write(os.path.basename(src) + "\\n")
body = open(src, "rb").read() * 2000
with open(out, "wb") as f:
    f.write(body[: len(body) // 2])
    f.flush()
    time.sleep(0.6)
    f.write(body[len(body) // 2:])
"""

_BUILDER = """
import sys, time
from pathlib import Path
from distributed_reinforcement_learning_tpu_torch.ops.kernels import _build
root = Path(sys.argv[1])
_build.CSRC = root / "csrc"
_build.BUILD_DIR = root / "csrc" / "build"
_build.nvcc_path = lambda: str(root / "nvcc")
paths = _build.build_all()
for stem, path in sorted(paths.items()):
    want = (_build.CSRC / (stem + ".cu")).read_bytes() * 2000
    print(stem, path.read_bytes() == want)
"""

_WATCHER = """
import sys, time
from pathlib import Path
build = Path(sys.argv[1]) / "csrc" / "build"
want = {p.stem: p.read_bytes() * 2000 for p in (Path(sys.argv[1]) / "csrc").glob("*.cu")}
bad = 0
end = time.monotonic() + float(sys.argv[2])
while time.monotonic() < end:
    for lib in build.glob("*.so"):
        data = lib.read_bytes()
        stem = lib.name.rsplit("-", 1)[0]
        if data != want[stem]:
            bad += 1
    time.sleep(0.005)
print("partial", bad)
"""


def _run(args):
    """A child in its own process group (killed whole on a timeout)."""
    return subprocess.Popen(args, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)


def _wait(proc, timeout=60):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate(timeout=10)
        raise
    assert proc.returncode == 0, err[-2000:]
    return out


def test_two_processes_build_once_and_never_load_a_partial_library(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for stem in ("alpha", "beta"):
        (csrc / f"{stem}.cu").write_text(f"// {stem} kernel source\n")
    calls = tmp_path / "calls.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, calls=str(calls)))
    nvcc.chmod(0o755)

    watcher = _run([sys.executable, "-c", _WATCHER, str(tmp_path), "4"])
    builders = [_run([sys.executable, "-c", _BUILDER, str(tmp_path)]) for _ in range(2)]
    outs = [_wait(p) for p in builders]
    watched = _wait(watcher)

    for out in outs:
        assert out.split() == ["alpha", "True", "beta", "True"]
    assert sorted(calls.read_text().split()) == ["alpha.cu", "beta.cu"]  # one build each
    assert watched.strip() == "partial 0"
    assert not list((csrc / "build").glob("*.tmp"))


def test_a_second_build_in_one_process_finds_the_libraries(tmp_path, monkeypatch):
    from distributed_reinforcement_learning_tpu_torch.ops.kernels import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "gamma.cu").write_text("// gamma\n")
    calls = tmp_path / "calls.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, calls=str(calls))
                    .replace("time.sleep(0.6)", "pass"))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", csrc / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    first = _build.build_all()
    assert _build.build_all() == first
    assert calls.read_text().split() == ["gamma.cu"]
    _build.build_all(force=True)  # force rebuilds under the same lock
    assert calls.read_text().split() == ["gamma.cu", "gamma.cu"]
    assert first["gamma"].read_text().startswith("// gamma")
