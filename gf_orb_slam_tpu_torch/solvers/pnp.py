"""PnP RANSAC for relocalization (port of gf_orb_slam_tpu/solvers/pnp.py):
6-point EPnP minimal solves for every hypothesis at once, dense inlier
scoring, and the winner refined by the staged pose LM.

The reference draws its samples inside `pnp_ransac` from a JAX key; the
port draws them apart (`sample_pnp`, a Gumbel top-k from a
torch.Generator), so tests can inject the reference's samples. The
reference's `eigh` calls (control points, the M-matrix null vector) check
their results on the host in torch; the port takes the 3×3 decomposition
in closed form and the null vector by inverse iteration
(`linalg.eigh_sym3`, `linalg.smallest_eigvec_psd`), so nothing here
synchronises. Eigenvector signs differ between backends: the control
points then differ, the EPnP pose in exact arithmetic does not.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam_tpu_torch.geometry import linalg, se3
from gf_orb_slam_tpu_torch.geometry.camera import CameraModel, project
from gf_orb_slam_tpu_torch.ops.fast import top_k_stable
from gf_orb_slam_tpu_torch.solvers import pose_opt
from gf_orb_slam_tpu_torch.solvers.horn import horn_align

MIN_SET = 6


class PnPResult(NamedTuple):
    pose: torch.Tensor       # (7,) T_cw
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int32
    ok: torch.Tensor         # () bool


def sample_pnp(valid: torch.Tensor, n_hypotheses: int, generator: torch.Generator) -> torch.Tensor:
    """(..., S, 6) int64 minimal sets among the valid slots of (..., N)
    masks: the reference's Gumbel top-k (pnp.py:110-116), drawn from
    `generator` on valid's device."""
    N = valid.shape[-1]
    u = torch.rand(valid.shape[:-1] + (n_hypotheses, N), generator=generator, device=valid.device)
    g = -torch.log(-torch.log(u)) + torch.where(valid, 0.0, -1e9)[..., None, :]
    return top_k_stable(g, MIN_SET)[1]


def _control_points(pts: torch.Tensor) -> torch.Tensor:
    """(..., M, 3) → (..., 4, 3): the centroid and centroid + √λᵢ·vᵢ along
    the principal axes (EPnP choose_control_points)."""
    c0 = pts.mean(dim=-2)
    centered = pts - c0[..., None, :]
    cov = centered.mT @ centered / pts.shape[-2]
    evals, evecs = linalg.eigh_sym3(cov)
    scale = torch.sqrt(torch.clamp(evals, min=1e-8))
    cps = c0[..., None, :] + (evecs * scale[..., None, :]).mT
    return torch.cat([c0[..., None, :], cps], dim=-2)


def _barycentric(pts: torch.Tensor, cps: torch.Tensor) -> torch.Tensor:
    """(..., M, 4) alphas with pts = Σ αᵢ cpᵢ, Σ α = 1."""
    ones_c = torch.ones(cps.shape[:-2] + (1, 4), dtype=pts.dtype, device=pts.device)
    ones_p = torch.ones(pts.shape[:-2] + (1, pts.shape[-2]), dtype=pts.dtype, device=pts.device)
    M = torch.cat([cps.mT, ones_c], dim=-2)                       # (..., 4, 4)
    rhs = torch.cat([pts.mT, ones_p], dim=-2)                     # (..., 4, M)
    return torch.linalg.solve_ex(M, rhs, check_errors=False)[0].mT


def epnp_minimal(cam: CameraModel, pts_w: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """EPnP (N=1) on minimal sets, batched: pts_w (..., M, 3), uv (..., M, 2)
    → (..., 7) T_cw."""
    cps = _control_points(pts_w)
    alpha = _barycentric(pts_w, cps)                               # (..., M, 4)
    u, v = uv[..., 0], uv[..., 1]
    z = torch.zeros_like(u)
    row_u = torch.cat([torch.stack([a * cam.fx, z, a * (cam.cx - u)], dim=-1) for a in alpha.unbind(-1)], dim=-1)
    row_v = torch.cat([torch.stack([z, a * cam.fy, a * (cam.cy - v)], dim=-1) for a in alpha.unbind(-1)], dim=-1)
    Mm = torch.cat([row_u, row_v], dim=-2)                         # (..., 2M, 12)
    vec = linalg.smallest_eigvec_psd(Mm.mT @ Mm)                   # (..., 12)
    cc = vec.reshape(vec.shape[:-1] + (4, 3))                      # camera-frame control points

    def pdists(x):
        d = x[..., :, None, :] - x[..., None, :, :]
        return torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1), min=1e-12))

    iu = torch.triu_indices(4, 4, 1, device=pts_w.device)
    dw = pdists(cps)[..., iu[0], iu[1]]
    dc = pdists(cc)[..., iu[0], iu[1]]
    beta = torch.sum(dw * dc, dim=-1) / torch.clamp(torch.sum(dc * dc, dim=-1), min=1e-12)
    cc = cc * beta[..., None, None]
    # Sign: the points must lie in front of the camera.
    xc = alpha @ cc
    flip = torch.sum(xc[..., 2], dim=-1) < 0
    cc = torch.where(flip[..., None, None], -cc, cc)
    q, t, _ = horn_align(cps, cc, torch.ones(cps.shape[:-1], dtype=cps.dtype, device=cps.device))
    return se3.make_pose(q, t)


def pnp_ransac(
    cam: CameraModel,
    points_w: torch.Tensor,   # (N, 3) candidate 3D points
    uv: torch.Tensor,         # (N, 2) their 2D matches in the lost frame
    sigma2: torch.Tensor,     # (N,) per-observation noise (octave)
    valid: torch.Tensor,      # (N,) match mask
    samples: torch.Tensor,    # (S, 6) minimal sets (sample_pnp)
    min_inliers: int = 15,
    chi2_th: float = 5.991,
) -> PnPResult:
    """Every hypothesis's EPnP pose scored densely; the best refined by the
    staged robust pose LM on its inliers (PnPsolver::iterate + the
    Relocalisation PoseOptimization loop)."""
    poses = epnp_minimal(cam, points_w[samples], uv[samples])      # (S, 7)
    uv_hat, _, front = project(cam, se3.transform_point(poses[:, None, :], points_w[None]))
    chi2 = torch.sum((uv_hat - uv[None]) ** 2, dim=-1) / sigma2[None]
    inl = (chi2 < chi2_th) & front & valid[None]
    counts = inl.sum(dim=1, dtype=torch.int32)
    best = torch.argmax(counts, dim=0, keepdim=True)               # (1,): first of the maxima
    res = pose_opt.optimize_pose(cam, poses.index_select(0, best)[0], points_w, uv, 1.0 / sigma2,
                                 inl.index_select(0, best)[0])
    return PnPResult(pose=res.pose, inliers=res.inliers, n_inliers=res.n_inliers, ok=res.n_inliers >= min_inliers)
