"""Build the CUDA kernels under `csrc/` with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` exports plain C entry points and compiles on its own
into `_build/lib<name>-<hash>.so` (the directory is git-ignored; the hash
covers the source and the flags, so an edited source builds anew). Nothing is
built or loaded at import: the first kernel launch builds what it needs, and
`build()` builds several sources at once, one nvcc process each, all started
together. A build writes `-Xptxas -v` output (registers, shared memory,
spills) to `_build/<name>.log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("q4_matmul", "flash_prefill")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dlopen'd libraries by source name; a loaded library lives as long as the
# process, so this table does too
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile the named sources that are not built yet, in parallel.

    Returns {name: seconds} for the sources compiled by this call; raises with
    the compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        started[name] = (proc, tmp, out, log, time.perf_counter())
    times = {}
    failed = []
    for name, (proc, tmp, out, log, t0) in started.items():
        rc = proc.wait()
        log.close()
        times[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)  # a partial output must not linger
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        logs = "\n".join((BUILD_DIR / f"{n}.log").read_text() for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return times


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu`, building it first if needed.

    `signatures` maps each C entry point to its ctypes argtypes; every entry
    returns an int (the cudaError_t of its launch)."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
