"""Motion-only pose optimization: batched-residual Levenberg–Marquardt (port
of gf_orb_slam_tpu/solvers/pose_opt.py).

One SE3 pose against fixed points, Huber kernel δ² = 5.991, four stages of
(10, 10, 7, 5) LM iterations with χ² outlier gates 9.21/7.378/5.991/5.991
between them. The reference's lax.scan loops are Python loops; the 6×6
solve is solve_ex without error checking, so no iteration synchronises with
the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam_tpu_torch.geometry import se3
from gf_orb_slam_tpu_torch.geometry.camera import CameraModel, project, projection_jacobian

CHI2_STAGES = (9.21, 7.378, 5.991, 5.991)
ITERS_PER_STAGE = (10, 10, 7, 5)
HUBER_DELTA2 = 5.991


class PoseOptResult(NamedTuple):
    pose: torch.Tensor       # (7,) refined T_cw
    inliers: torch.Tensor    # (N,) bool — final chi2 gate
    n_inliers: torch.Tensor  # () int32
    chi2: torch.Tensor       # (N,) final per-observation chi2


def _residuals(cam, pose, points_w, uv_obs):
    """r (N,2) = observed − projected, camera-frame points, in-front mask."""
    xc = se3.transform_point(pose, points_w)
    uv_hat, _, pos_depth = project(cam, xc)
    return uv_obs - uv_hat, xc, pos_depth


def _residuals_jacobians(cam, pose, points_w, uv_obs):
    """r (N,2) and J (N,2,6) wrt a left se3 perturbation. Eager torch runs
    what it is given, so the cost evaluations call _residuals alone (XLA
    drops the unused Jacobian of the reference's shared helper itself)."""
    r, xc, pos_depth = _residuals(cam, pose, points_w, uv_obs)
    Jproj = projection_jacobian(cam, xc)  # (N,2,3)
    J = torch.cat([-Jproj, Jproj @ se3.hat(xc)], dim=-1)  # (N,2,6)
    return r, J, pos_depth


def _huber_rho(chi2: torch.Tensor) -> torch.Tensor:
    return torch.where(
        chi2 <= HUBER_DELTA2,
        chi2,
        2.0 * torch.sqrt(HUBER_DELTA2 * torch.clamp(chi2, min=1e-12)) - HUBER_DELTA2,
    )


def _robust_weights(chi2, inv_sigma2):
    """Huber IRLS weight on the whitened residual norm."""
    w = torch.where(
        chi2 > HUBER_DELTA2, torch.sqrt(HUBER_DELTA2 / torch.clamp(chi2, min=1e-12)), 1.0
    )
    return w * inv_sigma2


def _cost(cam, pose, points_w, uv_obs, inv_sigma2, active):
    r, _, pos = _residuals(cam, pose, points_w, uv_obs)
    chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
    return torch.sum(torch.where(active & pos, _huber_rho(chi2), 0.0)), chi2, pos


def optimize_pose(
    cam: CameraModel,
    pose0: torch.Tensor,
    points_w: torch.Tensor,
    uv_obs: torch.Tensor,
    inv_sigma2: torch.Tensor,
    valid: torch.Tensor,
    stages: tuple = CHI2_STAGES,
    iters: tuple = ITERS_PER_STAGE,
) -> PoseOptResult:
    """Staged robust LM on a single pose against fixed points. `valid` masks
    the observations (unmatched / GF-unselected slots are False)."""
    eye6 = torch.eye(6, dtype=pose0.dtype, device=pose0.device)

    def lm_iter(pose, lam, active):
        r, J, pos = _residuals_jacobians(cam, pose, points_w, uv_obs)
        m = active & pos
        chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
        w = torch.where(m, _robust_weights(chi2, inv_sigma2), 0.0)
        H = torch.einsum("nri,n,nrj->ij", J, w, J)
        b = torch.einsum("nri,n,nr->i", J, w, r)
        Hd = H + lam * (eye6 * torch.diagonal(H)[None, :] + 1e-8 * eye6)
        delta = torch.linalg.solve_ex(Hd, -b, check_errors=False)[0]
        new_pose = se3.apply_left_update(delta, pose)
        # The current pose's cost from the residuals above (same pose, same
        # front-of-camera mask): saves one residual pass per iteration.
        old_cost = torch.sum(torch.where(m, _huber_rho(chi2), 0.0))
        new_cost, _, _ = _cost(cam, new_pose, points_w, uv_obs, inv_sigma2, active)
        accept = new_cost < old_cost
        pose = torch.where(accept, new_pose, pose)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9), torch.clamp(lam * 4.0, max=1e6))
        return pose, lam

    pose = pose0
    active = valid
    chi2_final = torch.zeros(points_w.shape[0], dtype=pose0.dtype, device=pose0.device)
    for chi2_th, n_it in zip(stages, iters):
        lam = torch.full((), 1e-3, dtype=pose0.dtype, device=pose0.device)  # a fill, not a copy
        for _ in range(n_it):
            pose, lam = lm_iter(pose, lam, active)
        _, chi2_now, pos = _cost(cam, pose, points_w, uv_obs, inv_sigma2, active)
        # Re-admit observations that pass the gate again.
        active = valid & pos & (chi2_now < chi2_th)
        chi2_final = chi2_now
    return PoseOptResult(
        pose=pose,
        inliers=active,
        n_inliers=active.sum(dtype=torch.int32),
        chi2=chi2_final,
    )
