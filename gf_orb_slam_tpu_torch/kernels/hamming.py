"""Wrappers of the CUDA Hamming-matrix kernels, which replace
gf_orb_slam_tpu/ops/pallas_kernels.py::hamming_matrix_pallas:

- `hamming_matrix_cuda` launches the tensor-core kernel (csrc/hamming.cu), the
  one the main path runs, with the launch that `launch_config` computes;
- `hamming_matrix_simt_cuda` launches the CUDA-core kernel
  (csrc/hamming_simt.cu), kept as the baseline chip_smoke.py times beside it.

The plain PyTorch version is ops/matching.py::hamming_matrix_torch. The
wrappers only launch and raise on anything the kernels cannot take.
"""

from __future__ import annotations

import collections
from functools import lru_cache
from typing import NamedTuple

import torch

from gf_orb_slam_tpu_torch.kernels import _build

LAUNCHES = 0  # launches made by hamming_matrix_cuda in this process
LAUNCHES_BY_SHAPE: collections.Counter = collections.Counter()  # the same launches by (Nq, Nt)

SMS = 132          # streaming multiprocessors of an H100 SXM
# The layout of csrc/hamming.cu, which checks the launch against its own.
BM, BN = 64, 32    # query rows and target columns per block; one warp per 16 rows
STAGE_WORDS = 12   # shared words per staged descriptor row (kStride)
STRIP_PAD = 8      # int32 pad per row of a warp's 16-row result strip (kPad)
SMEM_BYTES = 4 * ((BM + BN) * STAGE_WORDS + (BM + BN) + BM * (BN + STRIP_PAD))
MAX_GRID_Y = 65535
_MAX_SIMT_ROWS = 65535 * 32  # the SIMT kernel's grid.y limit × queries per block


class LaunchConfig(NamedTuple):
    bm: int          # query rows per block
    bn: int          # target columns per block
    grid_x: int      # blocks along Nt
    grid_y: int      # blocks along Nq
    threads: int
    smem_bytes: int  # dynamic shared memory per block

    @property
    def blocks(self) -> int:
        return self.grid_x * self.grid_y


@lru_cache(maxsize=256)
def launch_config(nq: int, nt: int) -> LaunchConfig:
    """The launch at (nq, nt): block (x, y) computes rows [y BM, y BM + BM)
    and columns [x BN, x BN + BN), clipped to (nq, nt). Its dynamic shared
    memory holds both staged descriptor tiles, their row popcounts and each
    warp's 16-row result strip."""
    cfg = LaunchConfig(BM, BN, -(-nt // BN), -(-nq // BM), 2 * BM, SMEM_BYTES)
    if cfg.grid_y > MAX_GRID_Y or nt >= 2**31:
        raise ValueError(f"hamming kernel: ({nq}, {nt}) exceeds the launch grid")
    return cfg


def _checked(q: torch.Tensor, t: torch.Tensor, out: torch.Tensor | None, fn: str) -> torch.Tensor:
    """Check the inputs and `out` (or allocate it); returns the output. The
    devices are checked last, so every other fault reports the same way on
    any device."""
    for name, x in (("q", q), ("t", t)):
        if x.dtype != torch.int32:
            raise TypeError(f"{fn}: {name} has dtype {x.dtype}, expected torch.int32")
        if x.dim() != 2 or x.shape[1] != 8:
            raise ValueError(f"{fn}: {name} has shape {tuple(x.shape)}, expected (N, 8)")
        if not x.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
    shape = (q.shape[0], t.shape[0])
    if out is not None:
        if out.dtype != torch.int32:
            raise TypeError(f"{fn}: out has dtype {out.dtype}, expected torch.int32")
        if tuple(out.shape) != shape:
            raise ValueError(f"{fn}: out has shape {tuple(out.shape)}, expected {shape}")
        if not out.is_contiguous():
            raise ValueError(f"{fn}: out is not contiguous")
    for name, x in (("t", t), ("out", out)):
        if x is not None and x.device != q.device:
            raise ValueError(f"{fn}: {name} is on {x.device}, q on {q.device}")
    if not q.is_cuda:
        raise ValueError(f"{fn}: the inputs are on {q.device}, not a CUDA device")
    return torch.empty(shape, dtype=torch.int32, device=q.device) if out is None else out


def hamming_matrix_cuda(q: torch.Tensor, t: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """(Nq, 8) × (Nt, 8) int32 CUDA tensors → (Nq, Nt) int32 Hamming
    distances on the tensor cores, written into `out` if given, launched on
    the current stream without synchronising."""
    global LAUNCHES
    out = _checked(q, t, out, "hamming_matrix_cuda")
    nq, nt = out.shape
    cfg = launch_config(nq, nt)
    if nq == 0 or nt == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.gf_hamming_matrix(q.data_ptr(), t.data_ptr(), out.data_ptr(), nq, nt, cfg.bm, cfg.bn,
                                    cfg.grid_x, cfg.grid_y, cfg.threads, cfg.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"hamming kernel launch failed: cudaError {err} ({cfg})")
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[(nq, nt)] += 1
    return out


def hamming_matrix_simt_cuda(q: torch.Tensor, t: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """The same function on the CUDA cores (the baseline design)."""
    out = _checked(q, t, out, "hamming_matrix_simt_cuda")
    nq, nt = out.shape
    if nq > _MAX_SIMT_ROWS or nt >= 2**31:
        raise ValueError(f"hamming_matrix_simt_cuda: ({nq}, {nt}) exceeds the launch grid")
    if nq == 0 or nt == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.gf_hamming_matrix_simt(q.data_ptr(), t.data_ptr(), out.data_ptr(), nq, nt, stream)
    if err != 0:
        raise RuntimeError(f"hamming SIMT kernel launch failed: cudaError {err}")
    return out
