"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source has a plain C interface (no PyTorch headers), so one ``nvcc``
call per source takes seconds.  A library is built at first use from the
sources in the checkout into ``build/kernels/`` at the repository root,
under a name that carries the hash of its source and flags: an edited
source builds anew, an unchanged one loads the existing library.
:func:`build` starts one ``nvcc`` per missing library, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
BUILD_DIR = PACKAGE.parent.parent / "build" / "kernels"
SOURCES = {
    "segor": PACKAGE / "kernels" / "segsum" / "csrc" / "segor.cu",
    "segsum": PACKAGE / "kernels" / "segsum" / "csrc" / "segsum.cu",
    "bitmm": PACKAGE / "kernels" / "bitmm" / "csrc" / "bitmm.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is missing."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library of source ``name`` lives once built."""
    h = hashlib.sha256(SOURCES[name].read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, float]:
    """Build every missing library among ``names`` (default: all) in
    parallel; returns the seconds each build took (0.0 when it existed).

    The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside each library as ``<name>-<hash>.log``.
    """
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            seconds[name] = 0.0
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        log = open(so.with_suffix(".log"), "w")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       tmp, so, log, time.perf_counter())
    failed = []
    for name, (proc, tmp, so, log, t0) in procs.items():
        try:
            rc = proc.wait()
        finally:
            log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}, see {so.with_suffix('.log')})")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed: " + ", ".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
