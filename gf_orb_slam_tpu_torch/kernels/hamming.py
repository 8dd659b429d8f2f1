"""Wrapper of the CUDA Hamming-matrix kernel (csrc/hamming.cu), which
replaces gf_orb_slam_tpu/ops/pallas_kernels.py::hamming_matrix_pallas.

The plain PyTorch version is ops/matching.py::hamming_matrix_torch; this
wrapper only launches the kernel and raises on anything it cannot take.
"""

from __future__ import annotations

import torch

from gf_orb_slam_tpu_torch.kernels import _build

LAUNCHES = 0  # kernel launches made by hamming_matrix_cuda in this process

_MAX_ROWS = 65535 * 32  # grid.y limit × queries per block


def hamming_matrix_cuda(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(Nq, 8) × (Nt, 8) int32 CUDA tensors → (Nq, Nt) int32 Hamming
    distances, launched on the current stream without synchronising."""
    global LAUNCHES
    for name, x in (("q", q), ("t", t)):
        if x.dtype != torch.int32:
            raise TypeError(f"hamming_matrix_cuda: {name} has dtype {x.dtype}, expected torch.int32")
        if x.dim() != 2 or x.shape[1] != 8:
            raise ValueError(f"hamming_matrix_cuda: {name} has shape {tuple(x.shape)}, expected (N, 8)")
        if not x.is_contiguous():
            raise ValueError(f"hamming_matrix_cuda: {name} is not contiguous")
        if not x.is_cuda:
            raise ValueError(f"hamming_matrix_cuda: {name} is on {x.device}, not a CUDA device")
    if q.device != t.device:
        raise ValueError(f"hamming_matrix_cuda: q on {q.device}, t on {t.device}")
    nq, nt = q.shape[0], t.shape[0]
    if nq > _MAX_ROWS or nt >= 2**31:
        raise ValueError(f"hamming_matrix_cuda: ({nq}, {nt}) exceeds the launch grid")
    out = torch.empty((nq, nt), dtype=torch.int32, device=q.device)
    if nq == 0 or nt == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.gf_hamming_matrix(q.data_ptr(), t.data_ptr(), out.data_ptr(), nq, nt, stream)
    if err != 0:
        raise RuntimeError(f"hamming kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
