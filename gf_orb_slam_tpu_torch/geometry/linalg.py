"""Small-matrix batched linear algebra (port of
gf_orb_slam_tpu/geometry/linalg.py). The `_ex` factorizations never raise and
never synchronise with the device."""

from __future__ import annotations

import torch


def logdet_psd(M: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """log|M| for symmetric PSD (..., n, n) via Cholesky; non-PD inputs give
    the -1e30 sentinel. JAX marks a failed factorization with NaN, torch's
    cholesky_ex with info > 0 and a finite partial factor, so the sentinel
    keys on info."""
    if jitter:
        M = M + jitter * torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    L, info = torch.linalg.cholesky_ex(M)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    ld = 2.0 * torch.sum(torch.log(torch.clamp(diag, min=1e-30)), dim=-1)
    return torch.where((info != 0) | torch.isnan(ld), -1e30, ld)


def solve_psd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for symmetric PD A (..., n, n), b (..., n) via Cholesky."""
    L, _ = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return x[..., 0]
