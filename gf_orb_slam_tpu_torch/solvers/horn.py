"""Closed-form weighted 3D-3D alignment, batched (port of
gf_orb_slam_tpu/solvers/horn.py): dst ≈ s·R·src + t.

The reference takes R from an SVD of the weighted cross-covariance with the
reflection fix. `torch.linalg.svd` checks its result on the host (a device
synchronisation per call), so the port takes the same optimum, the best
proper rotation, by Horn's quaternion method: the unit quaternion is the
dominant eigenvector of the 4×4 symmetric matrix N built from the
covariance (`linalg.largest_eigvec_sym`, repeated squaring). The scale is
the reference's Σ D·S = tr(Rᵀ·cov) over the source variance.
"""

from __future__ import annotations

import torch

from gf_orb_slam_tpu_torch.geometry import linalg, quat


def horn_align(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, with_scale: bool = False):
    """src, dst (..., N, 3); w (..., N) non-negative weights.
    Returns (q (..., 4) with w ≥ 0, t (..., 3), s (...,))."""
    wn = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    mu_s = torch.sum(src * wn[..., None], dim=-2, keepdim=True)
    mu_d = torch.sum(dst * wn[..., None], dim=-2, keepdim=True)
    xs = src - mu_s
    xd = dst - mu_d
    cov = torch.einsum("...ni,...n,...nj->...ij", xd, wn, xs)          # Σ w·xd·xsᵀ
    Sm = cov.mT                                                          # S_ab = Σ w·xs_a·xd_b
    sxx, sxy, sxz = Sm[..., 0, 0], Sm[..., 0, 1], Sm[..., 0, 2]
    syx, syy, syz = Sm[..., 1, 0], Sm[..., 1, 1], Sm[..., 1, 2]
    szx, szy, szz = Sm[..., 2, 0], Sm[..., 2, 1], Sm[..., 2, 2]
    # A degenerate (zero) covariance gives the identity rotation, as the
    # reference's SVD of a zero matrix does: a bias far below float32
    # resolution on the identity quaternion's entry.
    bias = 1e-12 * (1.0 + torch.linalg.matrix_norm(cov))
    N = torch.stack([
        torch.stack([sxx + syy + szz + bias, syz - szy, szx - sxz, sxy - syx], dim=-1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], dim=-1),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], dim=-1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], dim=-1),
    ], dim=-2)
    q = linalg.largest_eigvec_sym(N)
    R = quat.q2r(quat.qnormalize(q))
    if with_scale:
        var_s = torch.sum(torch.einsum("...ni,...ni->...n", xs, xs) * wn, dim=-1)
        s = torch.sum(R * cov, dim=(-2, -1)) / torch.clamp(var_s, min=1e-12)
    else:
        s = torch.ones(cov.shape[:-2], dtype=cov.dtype, device=cov.device)
    t = mu_d[..., 0, :] - s[..., None] * torch.einsum("...ij,...j->...i", R, mu_s[..., 0, :])
    return quat.r2q(R), t, s
