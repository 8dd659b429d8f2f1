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


def inv3(M: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Closed-form batched 3×3 inverse (adjugate over determinant, the
    determinant pushed away from 0 by eps with its sign kept): no LU, no
    error check, no host sync."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(torch.abs(det) < eps, torch.where(det < 0, -eps, eps), det)
    inv = torch.stack(
        [torch.stack([A, B, C], dim=-1), torch.stack([D, E, F], dim=-1), torch.stack([G, H, I], dim=-1)],
        dim=-2,
    )
    return inv / det[..., None, None]


def normalize_points_2d(pts: torch.Tensor, mask: torch.Tensor):
    """Hartley normalization of masked 2D point sets (the two-view
    initializer's DLT conditioning). Returns (normalized points, 3×3
    similarity T with x_norm = T @ x)."""
    w = mask.to(pts.dtype)
    n = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    mean = torch.sum(pts * w[..., None], dim=-2, keepdim=True) / n[..., None]
    centered = (pts - mean) * w[..., None]
    mean_dev = torch.sum(torch.abs(centered), dim=-2) / n
    s = 1.0 / torch.clamp(mean_dev, min=1e-8)  # (..., 2)
    normed = centered * s[..., None, :]
    sx, sy = s[..., 0], s[..., 1]
    mx, my = mean[..., 0, 0], mean[..., 0, 1]
    zero = torch.zeros_like(sx)
    one = torch.ones_like(sx)
    T = torch.stack(
        [
            torch.stack([sx, zero, -mx * sx], dim=-1),
            torch.stack([zero, sy, -my * sy], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )
    return normed, T


def smallest_eigvec_sym(M: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of small symmetric matrices
    (..., n, n) → (..., n). Its sign is whatever the backend returns, which
    differs between XLA, torch on the CPU and cuSOLVER; callers use it only
    in sign-free ways. `eigh` checks its result on the host: bootstrap only."""
    _, vecs = torch.linalg.eigh(M)
    return vecs[..., :, 0]
