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


def slogdet_general(M: torch.Tensor) -> torch.Tensor:
    """log|det M| where det M > 0, else the −1e30 sentinel (for symmetric
    but indefinite inputs)."""
    sign, ld = torch.linalg.slogdet(M)
    return torch.where(sign > 0, ld, -1e30)


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


def _dominant_eigvec_psd(A: torch.Tensor, squarings: int) -> torch.Tensor:
    """Unit eigenvector of the largest eigenvalue of PSD (..., n, n) by
    repeated squaring (A^(2^squarings), rescaled each step), read off the
    largest column. Sign arbitrary."""
    for _ in range(squarings):
        A = A / torch.clamp(torch.amax(torch.abs(A), dim=(-2, -1), keepdim=True), min=1e-30)
        A = A @ A
    norms = torch.linalg.vector_norm(A, dim=-2)                       # (..., n) column norms
    col = torch.argmax(norms, dim=-1, keepdim=True)                   # (..., 1)
    v = torch.gather(A, -1, col[..., None, :].expand(A.shape[:-1] + (1,)))[..., 0]
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)


def largest_eigvec_sym(M: torch.Tensor, squarings: int = 12) -> torch.Tensor:
    """Eigenvector of the largest eigenvalue of small symmetric (..., n, n),
    without a host synchronisation: M + ‖M‖_F·I is PSD with the same
    eigenvectors, and its dominant one is found by repeated squaring."""
    c = torch.linalg.matrix_norm(M)[..., None, None]
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return _dominant_eigvec_psd(M + c * eye, squarings)


def smallest_eigvec_psd(M: torch.Tensor, squarings: int = 8, rel_shift: float = 1e-12) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of small PSD (..., n, n),
    without a host synchronisation: the dominant eigenvector of
    (M + δI)⁻¹ (δ = rel_shift·trace, `inv_ex`, no error check), in float64,
    where the inverse of an ill-conditioned M keeps its small directions."""
    A = M.to(torch.float64)
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    inv, _ = torch.linalg.inv_ex(A + (rel_shift * tr + 1e-300) * eye)
    return _dominant_eigvec_psd(0.5 * (inv + inv.mT), squarings).to(M.dtype)


def eigh_sym3(M: torch.Tensor):
    """Eigen-decomposition of symmetric (..., 3, 3) in closed form, without
    a host synchronisation: eigenvalues ascending by the trigonometric
    formula, eigenvectors (columns, signs arbitrary) from cross products of
    rows of M − λI, the middle one completing the frame."""
    a00, a01, a02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    a11, a12, a22 = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    p_safe = torch.clamp(p, min=1e-30)
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    B = (M - q[..., None, None] * eye) / p_safe[..., None, None]
    r = torch.clamp(_det3(B) / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    lam_hi = q + 2.0 * p * torch.cos(phi)
    lam_lo = q + 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)
    lam_mid = 3.0 * q - lam_hi - lam_lo

    def vec(lam):
        R = M - lam[..., None, None] * eye
        c = torch.stack([torch.linalg.cross(R[..., 0, :], R[..., 1, :], dim=-1),
                         torch.linalg.cross(R[..., 0, :], R[..., 2, :], dim=-1),
                         torch.linalg.cross(R[..., 1, :], R[..., 2, :], dim=-1)], dim=-2)
        n = torch.linalg.vector_norm(c, dim=-1)
        best = torch.argmax(n, dim=-1, keepdim=True)
        v = torch.gather(c, -2, best[..., None].expand(c.shape[:-2] + (1, 3)))[..., 0, :]
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)

    v_lo, v_hi = vec(lam_lo), vec(lam_hi)
    v_mid = torch.linalg.cross(v_hi, v_lo, dim=-1)
    return torch.stack([lam_lo, lam_mid, lam_hi], dim=-1), torch.stack([v_lo, v_mid, v_hi], dim=-1)


def _det3(M: torch.Tensor) -> torch.Tensor:
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def smallest_eigvec_sym(M: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of small symmetric matrices
    (..., n, n) → (..., n). Its sign is whatever the backend returns, which
    differs between XLA, torch on the CPU and cuSOLVER; callers use it only
    in sign-free ways. `eigh` checks its result on the host: bootstrap only."""
    _, vecs = torch.linalg.eigh(M)
    return vecs[..., :, 0]
