"""Build and load the package's CUDA kernels.

Each source under ``csrc/`` compiles with ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  Builds happen at first use, never at import, into
``build/torch_kernels/`` beside the package (git-ignored), keyed on a hash
of the source text, the shared headers (``csrc/*.cuh``) and the compiler
flags: an edited source or header rebuilds, an unchanged one loads the
library already there.  :func:`build_libraries` starts one ``nvcc`` per
source, all at once; utils/launch.py is the per-call path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"
# sm_90a: Hopper with its arch-specific features (wgmma, setmaxnreg)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# the kernels of this package, by library name -> source file in csrc/
SOURCES = {
    "median": "median.cu",
    "sliding_median": "sliding_median.cu",
    "scan_match": "scan_match.cu",
    "deskew": "deskew.cu",
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# cumulative nvcc runs and library loads by name (utils/guards.py reads
# them: neither may happen in a warmed loop)
compiles: dict[str, int] = {}
loads: dict[str, int] = {}


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the CUDA
    toolkit's default location, else ``nvcc`` on PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels of this package are built from csrc/ at first use"
        )
    return found


def library_path(name: str) -> Path:
    """Where the library of ``name`` lands for the current source text."""
    text = (CSRC_DIR / SOURCES[name]).read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):  # what a source may include
        text += header.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_libraries(names=None) -> dict[str, float]:
    """Compile every library in ``names`` (default: all) that is not
    built yet, one ``nvcc`` process per source started together.
    Returns the seconds each build took (0.0 when already built).
    Raises RuntimeError with the compiler's output when a build fails."""
    import time

    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        compiles[name] = compiles.get(name, 0) + 1
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {SOURCES[name]} (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a library
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``name``, built first when needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_libraries([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
            loads[name] = loads.get(name, 0) + 1
        return lib
