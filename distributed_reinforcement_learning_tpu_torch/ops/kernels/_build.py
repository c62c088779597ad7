"""Build the package's CUDA sources with nvcc and load them with ctypes.

Every `csrc/*.cu` compiles, on first use, into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
All sources compile at once, one nvcc process each. A library's file
name carries a hash of its source and flags, so an edited source builds
anew and a stale library is never loaded.

Several processes may build and load at once (a learner and its tooling,
or the tests): an exclusive `fcntl` lock on `csrc/build/.lock` serialises
builds across processes (and a `threading.Lock` per build directory
across threads, since the file lock belongs to the process). A process
checks for each library only once it holds the lock, so one that waited
behind another's build finds the library there and does not build it
again. nvcc writes a temporary name that is renamed into place, so no
process ever sees a half-written library under its final name. The
kernel releases the lock of a process that dies mid-build.

Nothing here falls back: a missing nvcc, a failed compile or a library
that will not load raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()  # the loaded-library table
_dir_locks: dict[Path, threading.Lock] = {}  # builds within this process, by directory
_dir_locks_guard = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output (with `-Xptxas -v`: registers, shared memory and spills
# per kernel) for each source built in this process.
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else ""
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in the CUDA toolkit "
                           "PyTorch locates; the CUDA kernels cannot be built")
    return path


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _library_path(src: Path) -> Path:
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{digest[:16]}.so"


@contextlib.contextmanager
def build_lock(directory: Path | None = None):
    """This thread holds the build lock of `directory` (default
    `BUILD_DIR`), across processes (`data/native.py` builds the host
    library under the same pattern)."""
    directory = BUILD_DIR if directory is None else directory
    directory.mkdir(parents=True, exist_ok=True)
    with _dir_locks_guard:
        thread_lock = _dir_locks.setdefault(directory.resolve(), threading.Lock())
    with thread_lock, open(directory / ".lock", "a") as f:
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f.fileno(), fcntl.LOCK_UN)


def build_all(force: bool = False) -> dict[str, Path]:
    """Compile every source whose library is missing (every source with
    `force`, so that `build_logs` holds ptxas' report of each), all in
    parallel, under the build lock.

    -> {source stem: library path}. Raises RuntimeError naming each
    source that failed, with nvcc's output."""
    with build_lock():
        return _build_locked(force)


def _build_locked(force: bool) -> dict[str, Path]:
    out = {src.stem: _library_path(src) for src in sources()}
    todo = {stem: lib for stem, lib in out.items() if force or not lib.exists()}
    if not todo:
        return out
    nvcc = nvcc_path()
    procs = {}
    for stem, lib in todo.items():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for stem, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[stem] = log
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[stem])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(stem: str, declare) -> ctypes.CDLL:
    """The loaded library built from `csrc/<stem>.cu` (built on first use).

    `declare(lib)` sets the argtypes and restype of its functions; it runs
    once, when the library is first loaded."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            paths = build_all()
            if stem not in paths:
                raise RuntimeError(f"no CUDA source csrc/{stem}.cu")
            lib = ctypes.CDLL(str(paths[stem]))
            lib.drl_cuda_error_string.argtypes = [ctypes.c_int]
            lib.drl_cuda_error_string.restype = ctypes.c_char_p
            declare(lib)
            _libs[stem] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.drl_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
