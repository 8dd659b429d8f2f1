"""Build and load the package's CUDA kernels.

Every `csrc/*.cu` is compiled by nvcc for sm_90a into one shared library with
a plain C interface, loaded with ctypes. The library lands in the package's
`build/` directory, named by a hash of the sources and flags, so a changed
source is rebuilt and an unchanged one is loaded as is. Nothing is built at
import: the first call to `library()` builds. A missing nvcc or a failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the build (0.0 when loaded from build/)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; cannot build csrc/*.cu")


def _sources() -> list[Path]:
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return sources


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"libgf_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if the hashed library is absent; return its path."""
    global build_seconds
    so = library_path()
    if so.exists():
        build_seconds = 0.0
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, so)  # atomic: a concurrent build never loads a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.gf_hamming_matrix.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.gf_hamming_matrix.restype = ctypes.c_int
        _lib = lib
    return _lib
