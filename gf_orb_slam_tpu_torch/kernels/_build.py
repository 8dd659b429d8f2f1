"""Build and load the package's CUDA kernels.

Every `csrc/*.cu` is compiled by its own nvcc process for sm_90a, all started
together, and the objects are linked into one shared library with a plain C
interface, loaded with ctypes. The library lands in the package's `build/`
directory, named by a hash of the sources and flags, so a changed source is
rebuilt and an unchanged one is loaded as is. ptxas's report (registers,
shared memory and spills of each kernel) is kept beside it. Nothing is built
at import: the first call to `library()` builds. A missing nvcc or a failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the build (0.0 when loaded from build/)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point → argument types (every pointer and the stream as c_void_p).
SIGNATURES = {
    # q, t, out, nq, nt, bm, bn, grid_x, grid_y, threads, smem_bytes, stream
    "gf_hamming_matrix": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, t, out, nq, nt, stream
    "gf_hamming_matrix_simt": [_P, _P, _P, _I, _I, _P],
}


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
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"libgf_kernels_{h.hexdigest()[:16]}.so"


def ptxas_report_path() -> Path:
    return library_path().with_suffix(".ptxas.txt")


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> Path:
    """Compile the sources if the hashed library is absent; return its path."""
    global build_seconds
    so = library_path()
    if so.exists():
        build_seconds = 0.0
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        procs = [
            (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for cmd in ([nvcc, *COMPILE_FLAGS, "-c", "-o", str(o), str(src)] for src, o in zip(_sources(), objs))
        ]
        report, failed = [], []
        for cmd, p in procs:
            out, _ = p.communicate()
            report.append(out)
            if p.returncode != 0:
                failed.append(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib_tmp = Path(tmp) / so.name
        _run([nvcc, *ARCH, "-shared", "-o", str(lib_tmp), *map(str, objs)])
        ptxas_report_path().write_text("".join(report))
        os.replace(lib_tmp, so)  # atomic: a concurrent build never loads a partial file
    build_seconds = time.perf_counter() - t0
    return so


def ptxas_kernels() -> list[dict]:
    """Per kernel of the built library, from ptxas's report: mangled name,
    registers, shared memory (static bytes), stack frame and spill bytes."""
    kernels: list[dict] = []
    for line in ptxas_report_path().read_text().splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            kernels.append({"kernel": m.group(1)})
        elif kernels and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            kernels[-1].update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                               spill_load_bytes=int(m.group(3)))
        elif kernels and (m := re.search(r"Used (\d+) registers", line)):
            kernels[-1]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            kernels[-1]["static_smem_bytes"] = int(s.group(1)) if s else 0
    return kernels


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
