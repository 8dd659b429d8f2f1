"""Two-view monocular bootstrap (port of gf_orb_slam_tpu/solvers/initializer.py):
batched H/F RANSAC scoring of all hypotheses at once, model selection by
RH = SH / (SH + SF), motion recovery (the 4 essential and 8 Faugeras
homography motions) with triangulation, cheirality and parallax gates.

The reference draws its 8-point samples inside `initialize_two_view` from a
JAX key; the port draws them apart (`sample_hypotheses`, a Gumbel top-k from
a torch.Generator), so tests can inject the reference's samples. The
eigen and singular vectors' signs differ between backends; every use here is
sign-free (H is normalised by H[2,2], the scores are quadratic, ±t and the
Faugeras sign pairs are enumerated). `eigh`, `svd` and `det` check their
results on the host: the bootstrap runs once and may synchronise.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from gf_orb_slam_tpu_torch.geometry import linalg, quat, se3
from gf_orb_slam_tpu_torch.geometry.camera import CameraModel
from gf_orb_slam_tpu_torch.ops.fast import top_k_stable

SIGMA = 1.0          # reprojection sigma (px)
TH_H = 5.991         # chi2(2 dof): homography transfer gate
TH_F = 3.841         # chi2(1 dof): epipolar distance gate
SCORE_CLIP_H = 5.991
SCORE_CLIP_F = 5.991


class TwoViewResult(NamedTuple):
    success: torch.Tensor          # () bool
    pose21: torch.Tensor           # (7,) T_21: frame-1 camera → frame-2 camera
    points3d: torch.Tensor         # (N, 3) triangulated points in frame-1 camera coords
    is_triangulated: torch.Tensor  # (N,) bool
    used_homography: torch.Tensor  # () bool
    n_good: torch.Tensor           # () int32


@lru_cache(maxsize=None)
def camera_K(cam: CameraModel, device: torch.device) -> torch.Tensor:
    """The 3×3 intrinsics on `device` (cached: a host→device copy
    synchronises the stream)."""
    K = torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]], dtype=torch.float32)
    return K.to(device)


@lru_cache(maxsize=None)
def camera_K_inv(cam: CameraModel, device: torch.device) -> torch.Tensor:
    """inv(K) by float32 LU on the host, as the reference computes it."""
    K = torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]], dtype=torch.float32)
    return torch.linalg.inv(K).to(device)


def _mat3(rows) -> torch.Tensor:
    """3×3 (batched) matrix from nested lists of equal-shaped tensors."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


# ---------------------------------------------------------------------------
# Sampling and model estimation (DLT), batched over hypotheses
# ---------------------------------------------------------------------------


def sample_hypotheses(matched: torch.Tensor, n_hypotheses: int, generator: torch.Generator) -> torch.Tensor:
    """(S, 8) int64 sample sets among the matched slots: the Gumbel top-k
    trick of the reference (initializer.py:351-357), drawn from `generator`
    on matched's device. Equal keys rank lowest index first."""
    N = matched.shape[0]
    u = torch.rand((n_hypotheses, N), generator=generator, device=matched.device)
    g = -torch.log(-torch.log(u)) + torch.where(matched, 0.0, -1e9)
    return top_k_stable(g, 8)[1]


def _dlt_homography(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """DLT for H with x2 ≈ H x1, batched over leading dims; optional row
    weights for refitting. → (..., 3, 3)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    rows_a = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    rows_b = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    if w is not None:
        rows_a = rows_a * w[..., None]
        rows_b = rows_b * w[..., None]
    A = torch.cat([rows_a, rows_b], dim=-2)  # (..., 2M, 9)
    h = linalg.smallest_eigvec_sym(A.mT @ A)
    return h.reshape(h.shape[:-1] + (3, 3))


def _dlt_fundamental(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """DLT for F with x2ᵀ F x1 = 0, rank 2 enforced by SVD. → (..., 3, 3)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    o = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o], dim=-1)  # (..., M, 9)
    if w is not None:
        A = A * w[..., None]
    f = linalg.smallest_eigvec_sym(A.mT @ A)
    F = f.reshape(f.shape[:-1] + (3, 3))
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return (U * S[..., None, :]) @ Vt


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _score_homography(H, uv1, uv2, mask):
    """Symmetric transfer error score (CheckHomography), batched over H's
    leading dims. Returns (score (...,), inlier mask (..., N))."""
    Hinv = torch.linalg.inv_ex(H)[0]

    def transfer(M, src, dst):
        p = _homog(src) @ M.mT
        w = torch.where(torch.abs(p[..., 2:3]) < 1e-8, 1e-8, p[..., 2:3])
        return torch.sum((dst - p[..., :2] / w) ** 2, dim=-1)

    inv_s2 = 1.0 / (SIGMA * SIGMA)
    d12 = transfer(H, uv1, uv2) * inv_s2
    d21 = transfer(Hinv, uv2, uv1) * inv_s2
    ok = (d12 < TH_H) & (d21 < TH_H) & mask
    score = torch.where(d12 < TH_H, SCORE_CLIP_H - d12, 0.0) + torch.where(d21 < TH_H, SCORE_CLIP_H - d21, 0.0)
    return torch.sum(torch.where(mask, score, 0.0), dim=-1), ok


def _score_fundamental(F, uv1, uv2, mask):
    """Symmetric epipolar distance score (CheckFundamental)."""
    x1 = _homog(uv1)
    x2 = _homog(uv2)
    l2 = x1 @ F.mT  # lines in image 2
    l1 = x2 @ F     # lines in image 1
    inv_s2 = 1.0 / (SIGMA * SIGMA)
    d2 = (torch.sum(l2 * x2, dim=-1) ** 2) / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12) * inv_s2
    d1 = (torch.sum(l1 * x1, dim=-1) ** 2) / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12) * inv_s2
    ok = (d1 < TH_F) & (d2 < TH_F) & mask
    score = torch.where(d1 < TH_F, SCORE_CLIP_F - d1, 0.0) + torch.where(d2 < TH_F, SCORE_CLIP_F - d2, 0.0)
    return torch.sum(torch.where(mask, score, 0.0), dim=-1), ok


# ---------------------------------------------------------------------------
# Triangulation + hypothesis checking
# ---------------------------------------------------------------------------


def _dlt_rows(P1, P2, uv1, uv2):
    """(..., N, 4, 4) homogeneous DLT constraint rows per correspondence;
    P1/P2 (..., 3, 4) broadcast against each other."""
    P1, P2 = torch.broadcast_tensors(P1, P2)
    rows = [
        uv1[:, 0, None] * P1[..., None, 2, :] - P1[..., None, 0, :],
        uv1[:, 1, None] * P1[..., None, 2, :] - P1[..., None, 1, :],
        uv2[..., 0, None] * P2[..., None, 2, :] - P2[..., None, 0, :],
        uv2[..., 1, None] * P2[..., None, 2, :] - P2[..., None, 1, :],
    ]
    return torch.stack(torch.broadcast_tensors(*rows), dim=-2)


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """Inhomogeneous linear triangulation (w = 1, 3×3 normal equations by
    linalg.inv3), batched over points (and over leading dims of P1/P2).
    P: (..., 3, 4); uv: (N, 2) pixels → (..., N, 3)."""
    A = _dlt_rows(P1, P2, uv1, uv2)                      # (..., N, 4, 4)
    B, a4 = A[..., :3], A[..., 3]
    BtB = torch.einsum("...nij,...nik->...njk", B, B)     # (..., N, 3, 3)
    rhs = -torch.einsum("...nij,...ni->...nj", B, a4)     # (..., N, 3)
    return torch.einsum("...njk,...nk->...nj", linalg.inv3(BtB), rhs)


def triangulate_dlt_homogeneous(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """Nullspace DLT: the exact homogeneous solution (the smallest
    eigenvector of AᵀA per point, sign-free after the division by w)."""
    A = _dlt_rows(P1, P2, uv1, uv2)
    M = torch.einsum("...nij,...nik->...njk", A, A)
    x = linalg.smallest_eigvec_sym(M)
    w = torch.where(torch.abs(x[..., 3]) < 1e-10, 1e-10, x[..., 3])
    return x[..., :3] / w[..., None]


def _check_rt(R, t, K, uv1, uv2, mask, sigma2_reproj=4.0):
    """Good triangulations of motion hypotheses (R, t), batched over their
    leading dims (CheckRT). Returns (n_good, good mask, parallax at the
    50th-smallest good cosine in degrees, points in camera-1 coords)."""
    dev = K.device
    P1 = K @ torch.cat([torch.eye(3, device=dev), torch.zeros((3, 1), device=dev)], dim=1)
    P2 = K @ torch.cat([R, t[..., None]], dim=-1)
    X = triangulate_dlt(P1, P2, uv1, uv2)  # (..., N, 3), camera-1 frame

    finite = torch.all(torch.isfinite(X), dim=-1)
    z1 = X[..., 2]
    X2 = torch.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
    z2 = X2[..., 2]

    O2 = -(R.mT @ t[..., None])[..., 0]
    n1 = X
    n2 = X - O2[..., None, :]
    cosp = torch.sum(n1 * n2, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(n1, dim=-1) * torch.linalg.vector_norm(n2, dim=-1), min=1e-12
    )

    def reproj_err(P, Xh, uv):
        p = _homog(Xh) @ P.mT
        w = torch.where(torch.abs(p[..., 2:3]) < 1e-8, 1e-8, p[..., 2:3])
        return torch.sum((uv - p[..., :2] / w) ** 2, dim=-1)

    e1 = reproj_err(P1, X, uv1)
    e2 = reproj_err(P2, X, uv2)
    th2 = sigma2_reproj * SIGMA * SIGMA
    good = mask & finite & (z1 > 0) & (z2 > 0) & (cosp < 0.99998) & (e1 < th2) & (e2 < th2)
    n_good = good.sum(dim=-1, dtype=torch.int32)
    cos_sorted = torch.sort(torch.where(good, cosp, 1.0), dim=-1).values
    pick = torch.clamp(n_good - 1, min=0, max=50).long()
    c = torch.gather(cos_sorted, -1, pick[..., None])[..., 0]
    parallax_deg = torch.rad2deg(torch.arccos(torch.clamp(c, -1.0, 1.0)))
    return n_good, good, parallax_deg, X


def _motions_from_F(F, K):
    """Essential decomposition → 4 (R, t) hypotheses (ReconstructF)."""
    E = K.T @ F @ K
    U, _, Vt = torch.linalg.svd(E)
    W = torch.zeros((3, 3), dtype=F.dtype, device=F.device)
    W[0, 1], W[1, 0], W[2, 2] = -1.0, 1.0, 1.0
    R1 = U @ W @ Vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = U @ W.T @ Vt
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _motions_from_H(H, K, K_inv):
    """Faugeras SVD decomposition → 8 (R, t) hypotheses (ReconstructH)."""
    A = K_inv @ H @ K
    U, w, Vt = torch.linalg.svd(A)
    V = Vt.T
    s = torch.linalg.det(U) * torch.linalg.det(V)
    d1, d2, d3 = w[0], w[1], w[2]

    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / torch.clamp(d1 * d1 - d3 * d3, min=1e-12), min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / torch.clamp(d1 * d1 - d3 * d3, min=1e-12), min=0.0))
    x1s = [aux1, aux1, -aux1, -aux1]
    x3s = [aux3, -aux3, aux3, -aux3]
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    # Case d' > 0.
    aux_stheta = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0)) / torch.clamp(
        (d1 + d3) * d2, min=1e-12
    )
    ctheta = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    stheta = [aux_stheta, -aux_stheta, -aux_stheta, aux_stheta]
    # Case d' < 0.
    aux_sphi = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0)) / torch.clamp(
        (d1 - d3) * d2, min=1e-12
    )
    cphi = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    sphi = [aux_sphi, -aux_sphi, -aux_sphi, aux_sphi]

    Rs, ts = [], []
    for i in range(4):
        Rp = _mat3([[ctheta, zero, -stheta[i]], [zero, one, zero], [stheta[i], zero, ctheta]])
        t = U @ (torch.stack([x1s[i], zero, -x3s[i]]) * (d1 - d3))
        Rs.append(s * U @ Rp @ Vt)
        ts.append(t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12))
    for i in range(4):
        Rp = _mat3([[cphi, zero, sphi[i]], [zero, -one, zero], [sphi[i], zero, -cphi]])
        t = U @ (torch.stack([x1s[i], zero, x3s[i]]) * (d1 + d3))
        Rs.append(s * U @ Rp @ Vt)
        ts.append(t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12))
    return torch.stack(Rs), torch.stack(ts)


# ---------------------------------------------------------------------------
# Full initialization
# ---------------------------------------------------------------------------


def _normalised_H(T1_inv2, Hn, T1):
    H = T1_inv2 @ Hn @ T1
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(torch.abs(h22) < 1e-10, 1e-10, h22)


def initialize_with_prior(
    cam: CameraModel,
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    matched: torch.Tensor,
    pose21: torch.Tensor,
    min_triangulated: int = 50,
) -> TwoViewResult:
    """Structure-only bootstrap from an external motion (odometry, IMU): R, t
    of `pose21` are given, only the points are triangulated and gated
    (Initializer::Initialize_withRT). No host read."""
    R = quat.q2r(quat.qnormalize(se3.pose_q(pose21)))
    n_good, good, _, X = _check_rt(R, se3.pose_t(pose21), camera_K(cam, uv1.device), uv1, uv2, matched)
    return TwoViewResult(
        success=n_good >= min_triangulated,
        pose21=pose21,
        points3d=X,
        is_triangulated=good,
        used_homography=torch.zeros((), dtype=torch.bool, device=uv1.device),
        n_good=n_good,
    )


def initialize_two_view(
    cam: CameraModel,
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    matched: torch.Tensor,
    samples: torch.Tensor,
    min_triangulated: int = 50,
) -> TwoViewResult:
    """Two-view bootstrap on matched undistorted pixel pairs: uv1/uv2 (N, 2)
    slot-aligned, matched (N,), samples (S, 8) slot indices (from
    `sample_hypotheses`). Mirrors Initializer::Initialize."""
    dev = uv1.device
    K, K_inv = camera_K(cam, dev), camera_K_inv(cam, dev)
    samples = samples.long()

    # Hartley-normalized coordinates for conditioning.
    n1, T1 = linalg.normalize_points_2d(uv1, matched)
    n2, T2 = linalg.normalize_points_2d(uv2, matched)
    T2_inv = torch.linalg.inv_ex(T2)[0]

    Hs = _normalised_H(T2_inv, _dlt_homography(n1[samples], n2[samples]), T1)   # (S, 3, 3)
    sH, okH = _score_homography(Hs, uv1, uv2, matched)
    Fs = T2.T @ _dlt_fundamental(n1[samples], n2[samples]) @ T1
    sF, okF = _score_fundamental(Fs, uv1, uv2, matched)

    iH = torch.argmax(sH)
    iF = torch.argmax(sF)
    H_best, F_best = Hs[iH], Fs[iF]
    inH, inF = okH[iH], okF[iF]
    SH, SF = sH[iH], sF[iF]

    # All-inlier refit (2 rounds), as the reference does for float32.
    for _ in range(2):
        H_ref = _normalised_H(T2_inv, _dlt_homography(n1, n2, inH.to(n1.dtype)), T1)
        sH_ref, inH_ref = _score_homography(H_ref, uv1, uv2, matched)
        better_h = sH_ref > SH
        H_best = torch.where(better_h, H_ref, H_best)
        inH = torch.where(better_h, inH_ref, inH)
        SH = torch.maximum(sH_ref, SH)

        F_ref = T2.T @ _dlt_fundamental(n1, n2, inF.to(n1.dtype)) @ T1
        sF_ref, inF_ref = _score_fundamental(F_ref, uv1, uv2, matched)
        better_f = sF_ref > SF
        F_best = torch.where(better_f, F_ref, F_best)
        inF = torch.where(better_f, inF_ref, inF)
        SF = torch.maximum(sF_ref, SF)

    RH = SH / torch.clamp(SH + SF, min=1e-12)
    use_H = RH > 0.40

    # Motion hypotheses from both models, evaluated together.
    Rs_F, ts_F = _motions_from_F(F_best, K)              # (4, 3, 3), (4, 3)
    Rs_H, ts_H = _motions_from_H(H_best, K, K_inv)       # (8, 3, 3), (8, 3)
    Rs = torch.cat([Rs_F, Rs_H])                         # (12, 3, 3)
    ts = torch.cat([ts_F, ts_H])
    is_h = torch.arange(12, device=dev) >= 4
    model_mask = torch.where(use_H, is_h, ~is_h)
    inlier_mask = torch.where(use_H, inH, inF)

    n_goods, goods, parallaxes, Xs = _check_rt(Rs, ts, K, uv1, uv2, inlier_mask)
    n_goods = torch.where(model_mask, n_goods, -1)

    best = torch.argmax(n_goods)
    n_best = n_goods[best]
    n_second = torch.where(torch.arange(12, device=dev) == best, -1, n_goods).amax()
    n_inliers = inlier_mask.sum(dtype=torch.int32)
    n_min_good = torch.clamp(0.9 * n_inliers.to(torch.float32), min=float(min_triangulated))
    success = (
        (n_best.to(torch.float32) >= n_min_good)
        & (n_second.to(torch.float32) < 0.75 * n_best.to(torch.float32))
        & (parallaxes[best] > 1.0)
    )
    pose21 = se3.make_pose(quat.r2q(Rs[best]), ts[best])
    return TwoViewResult(
        success=success,
        pose21=pose21,
        points3d=Xs[best],
        is_triangulated=goods[best],
        used_homography=use_H,
        n_good=n_best,
    )

