"""Bundle adjustment by Levenberg–Marquardt with the points marginalised by
Schur complement (port of gf_orb_slam_tpu/solvers/local_ba.py).

Problem layout (fixed shapes, mask-gated):
  poses      (C, 7)  — T_cw camera poses; `fixed` (C,) bool freezes cameras
  points     (P, 3)  — world points
  obs_uv     (C, N, 2), obs_point (C, N) local point ids (−1 = none),
  obs_w      (C, N)  — per-observation information weight (1/σ²; 0 disables)
Normally one observation per (camera, point) pair; a keyframe that holds
one point more than once (after a fuse merge, as in the reference) adds
each edge.

Two stages: iters_stage1 LM iterations → χ² outlier pruning (5.991) →
iters_stage2 more. The reference's `lax.scan` is a Python loop here; the LM
accept/reject stays a device `where`, and the reduced camera system is
solved by `solve_ex` without an error check, so no iteration reads anything
back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam_tpu_torch.geometry import linalg, se3
from gf_orb_slam_tpu_torch.geometry.camera import CameraModel, project, projection_jacobian
from gf_orb_slam_tpu_torch.geometry.quat import q2r, qnormalize
from gf_orb_slam_tpu_torch.ops import scatter

HUBER2 = 5.991


class BAProblem(NamedTuple):
    poses: torch.Tensor        # (C, 7)
    points: torch.Tensor       # (P, 3)
    fixed: torch.Tensor        # (C,) bool
    point_valid: torch.Tensor  # (P,) bool
    obs_uv: torch.Tensor       # (C, N, 2)
    obs_point: torch.Tensor    # (C, N) int32 local point id or −1
    obs_w: torch.Tensor        # (C, N) information weight (0 = inactive)


class BAResult(NamedTuple):
    poses: torch.Tensor
    points: torch.Tensor
    obs_active: torch.Tensor  # (C, N) surviving observations
    cost: torch.Tensor


def _edge_terms(cam: CameraModel, poses, points, obs_uv, obs_point, active):
    """Residuals and Jacobians of every (c, n) edge."""
    lp = torch.clamp(obs_point, min=0).long()
    Xw = points[lp]                                        # (C, N, 3)
    xc = se3.transform_point(poses[:, None, :], Xw)        # (C, N, 3)
    uv_hat, _, front = project(cam, xc)
    r = obs_uv - uv_hat                                    # (C, N, 2)
    Jp = projection_jacobian(cam, xc)                      # (C, N, 2, 3)
    Jpose = torch.cat([Jp, -Jp @ se3.hat(xc)], dim=-1)     # (C, N, 2, 6) = dh/dξ
    R_cw = q2r(qnormalize(poses[:, :4]))                   # (C, 3, 3)
    Jpt = torch.einsum("cnij,cjk->cnik", Jp, R_cw)         # (C, N, 2, 3) = dh/dXw
    ok = active & front & (obs_point >= 0)
    return r, Jpose, Jpt, ok


def _robust_w(r, obs_w, ok):
    """Per-edge Huber weight and χ² of residuals r (…, 2)."""
    chi2 = torch.sum(r * r, dim=-1) * obs_w
    hub = torch.where(chi2 > HUBER2, torch.sqrt(HUBER2 / torch.clamp(chi2, min=1e-12)), 1.0)
    return torch.where(ok, obs_w * hub, 0.0), chi2


def _rho(chi2):
    return torch.where(chi2 <= HUBER2, chi2, 2.0 * torch.sqrt(HUBER2 * torch.clamp(chi2, min=1e-12)) - HUBER2)


def _cost_from_residuals(r, obs_w, ok):
    chi2 = torch.sum(r * r, dim=-1) * obs_w
    return torch.sum(torch.where(ok, _rho(chi2), 0.0))


def _cost(cam, poses, points, obs_uv, obs_point, obs_w, active):
    """Huber cost; builds no Jacobian."""
    lp = torch.clamp(obs_point, min=0).long()
    xc = se3.transform_point(poses[:, None, :], points[lp])
    uv_hat, _, front = project(cam, xc)
    ok = active & front & (obs_point >= 0)
    return _cost_from_residuals(obs_uv - uv_hat, obs_w, ok)


def _edge_plan(obs_point, P: int) -> scatter.SumPlan:
    """The plan of `_lm_step`'s scatter-add of every edge onto row p·C + c
    of its (point, camera) table, fixed for a solve; slots without a point
    are dropped."""
    C = obs_point.shape[0]
    c_iota = torch.arange(C, device=obs_point.device)[:, None]
    return scatter.sum_plan(torch.where(obs_point >= 0, obs_point.long() * C + c_iota, P * C).reshape(-1), P * C)


def _lm_step(cam: CameraModel, prob: BAProblem, active, lam, plan: scatter.SumPlan | None = None):
    """One damped Schur-reduced Gauss–Newton step (`plan`: `_edge_plan` of
    the problem, made here when not given). Returns (dξ (C, 6), dX (P, 3),
    Huber cost at the current state)."""
    C, N = prob.obs_point.shape
    P = prob.points.shape[0]
    dev, dt = prob.points.device, prob.points.dtype
    r, Jpose, Jpt, ok = _edge_terms(cam, prob.poses, prob.points, prob.obs_uv, prob.obs_point, active)
    w, chi2 = _robust_w(r, prob.obs_w, ok)  # fixed cameras keep weight: they still constrain points
    cost_here = torch.sum(torch.where(ok, _rho(chi2), 0.0))

    # Camera blocks U (C, 6, 6) and gradient g_c (C, 6).
    U = torch.einsum("cnri,cn,cnrj->cij", Jpose, w, Jpose)
    g_c = torch.einsum("cnri,cn,cnr->ci", Jpose, w, r)

    # Per-edge point blocks, reduced onto points below.
    Vscat = torch.einsum("cnri,cn,cnrj->cnij", Jpt, w, Jpt)
    gp_scat = torch.einsum("cnri,cn,cnr->cni", Jpt, w, r)
    W_edge = torch.einsum("cnri,cn,cnrj->cnij", Jpose, w, Jpt)   # (C, N, 6, 3)
    W_edge = torch.where(prob.fixed[:, None, None, None], 0.0, W_edge)

    # One flat scatter-add of each edge's 30 floats [V (9) | g_p (3) | W (18)]
    # into row p·C + c of a (P·C, 30) table. A row takes one edge, or more
    # where a keyframe holds one point more than once (the reference's
    # duplicate BA edges: three or more on real maps), summed in a fixed
    # order (ops/scatter.py); an edge that is not ok adds 0.
    payload = torch.cat([Vscat.reshape(C, N, 9), gp_scat, W_edge.reshape(C, N, 18)], dim=-1)
    payload = torch.where(ok[..., None], payload, 0.0)
    plan = _edge_plan(prob.obs_point, P) if plan is None else plan
    M = scatter.planned_sum(plan, payload.reshape(-1, 30)).reshape(P, C, 30)
    V = M[:, :, :9].sum(dim=1).reshape(P, 3, 3)
    g_p = M[:, :, 9:12].sum(dim=1)
    T = M[:, :, 12:30].reshape(P, C, 6, 3)

    # Levenberg damping (scaled diagonals).
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    U_d = U + lam * eye6[None] * torch.clamp(torch.diagonal(U, dim1=-2, dim2=-1), min=1e-6)[:, :, None] * eye6[None]
    V_d = V + lam * eye3[None] * torch.clamp(torch.diagonal(V, dim1=-2, dim2=-1), min=1e-6)[:, :, None] * eye3[None]
    V_d = V_d + 1e-8 * eye3[None]
    Vinv = linalg.inv3(V_d)
    Vinv = torch.where(prob.point_valid[:, None, None], Vinv, 0.0)

    # Schur complement S = U − Σ_p Y_p W_pᵀ with Y = T·V⁻¹.
    Y = torch.einsum("pcij,pjk->pcik", T, Vinv)
    S = -torch.einsum("pcij,pdkj->cidk", Y, T)  # (C, 6, C, 6)
    diag = torch.arange(C, device=dev)
    S[diag, :, diag, :] += U_d
    b = g_c - torch.einsum("pcij,pj->ci", Y, g_p)

    # Freeze fixed cameras: identity rows/cols, zero rhs.
    free_f = (~prob.fixed).to(dt)
    S = S * free_f[:, None, None, None] * free_f[None, None, :, None]
    S[diag, :, diag, :] += eye6[None] * prob.fixed.to(dt)[:, None, None]
    b = b * free_f[:, None]

    Sd = S.reshape(C * 6, C * 6) + 1e-8 * torch.eye(C * 6, dtype=dt, device=dev)
    delta_c = torch.linalg.solve_ex(Sd, b.reshape(-1, 1))[0].reshape(C, 6)

    # Back-substitute points: δX = V⁻¹ (g_p − Σ_c W_pᵀ δξ_c).
    delta_p = torch.einsum("pij,pj->pi", Vinv, g_p - torch.einsum("pcij,ci->pj", T, delta_c))
    delta_p = torch.where(prob.point_valid[:, None], delta_p, 0.0)
    return delta_c, delta_p, cost_here


def _apply(prob: BAProblem, delta_c, delta_p):
    new_poses = se3.apply_left_update(delta_c, prob.poses)
    new_poses = torch.where(prob.fixed[:, None], prob.poses, new_poses)
    return new_poses, prob.points + delta_p


def bundle_adjust(
    cam: CameraModel,
    prob: BAProblem,
    iters_stage1: int = 5,
    iters_stage2: int = 10,
    chi2_prune: float = HUBER2,
) -> BAResult:
    """Two-stage robust BA (LocalBundleAdjustment's 5-then-10 schedule with
    outlier pruning between the stages)."""

    plan = _edge_plan(prob.obs_point, prob.points.shape[0])

    def run(poses, points, active, iters):
        lam = torch.full((), 1e-4, dtype=prob.poses.dtype, device=prob.poses.device)
        for _ in range(iters):
            p = prob._replace(poses=poses, points=points)
            dc, dp, c_old = _lm_step(cam, p, active, lam, plan)
            new_poses, new_points = _apply(p, dc, dp)
            c_new = _cost(cam, new_poses, new_points, prob.obs_uv, prob.obs_point, prob.obs_w, active)
            good = c_new < c_old
            poses = torch.where(good, new_poses, poses)
            points = torch.where(good, new_points, points)
            lam = torch.where(good, torch.clamp(lam * 0.4, min=1e-9), torch.clamp(lam * 5.0, max=1e5))
        return poses, points

    def inliers(poses, points, active):
        r, _, _, ok = _edge_terms(cam, poses, points, prob.obs_uv, prob.obs_point, active)
        chi2 = torch.sum(r * r, dim=-1) * prob.obs_w
        return active & ok & (chi2 <= chi2_prune)

    active0 = (prob.obs_point >= 0) & (prob.obs_w > 0)
    poses, points = run(prob.poses, prob.points, active0, iters_stage1)
    active1 = inliers(poses, points, active0)
    poses, points = run(poses, points, active1, iters_stage2)
    final_active = inliers(poses, points, active1)
    cost = _cost(cam, poses, points, prob.obs_uv, prob.obs_point, prob.obs_w, final_active)
    return BAResult(poses=poses, points=points, obs_active=final_active, cost=cost)
