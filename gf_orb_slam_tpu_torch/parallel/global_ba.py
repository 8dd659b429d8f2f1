"""Distributed global bundle adjustment on torch.distributed (port of
gf_orb_slam_tpu/parallel/global_ba.py): keyframe-sharded Levenberg–Marquardt
with a matrix-free PCG solve of the Schur-reduced camera system.

* Keyframe rows (poses and their observation rows) are split over the
  ranks of the process group; point positions are replicated on every
  rank, but the O(P) point work is split: the per-point normal-equation
  blocks V_p, g_p are formed from each rank's edges and combined with one
  `reduce_scatter_tensor` over the point dimension, so each rank owns,
  inverts (batched 3×3) and applies only its P/d slice.
* The reduced camera system S = U − Σ_p W V⁻¹ Wᵀ is never formed: PCG
  applies it as S·v = U·v − Σ_p W_p V_p⁻¹ (Σ_d W_pdᵀ v_d), the inner sum a
  rank-local scatter-add followed by a `reduce_scatter_tensor` of (P, 3),
  and V⁻¹ applied on the local slice and re-replicated by
  `all_gather_into_tensor`. Dot products and costs are `all_reduce` sums.
* Block-Jacobi preconditioner (damped U⁻¹, rank-local).

The LM accept/reject and the damping λ stay tensors on the device
(`torch.where` on the all-reduced cost, so every rank takes the same
branch), and the PCG runs a fixed number of iterations: the solve reads
nothing back to the host. The reference's `psum_scatter(tiled)`,
`all_gather(tiled)` and `psum` map onto `reduce_scatter_tensor`,
`all_gather_into_tensor` and `all_reduce`; NCCL needs equal chunks, so both
the camera and the point dimensions are padded to a multiple of the world
size (padded keyframe rows are fixed and observe nothing, padded points are
invalid and observed by no edge).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gf_orb_slam_tpu_torch.geometry import linalg, se3
from gf_orb_slam_tpu_torch.geometry.camera import CameraModel
from gf_orb_slam_tpu_torch.ops import scatter
from gf_orb_slam_tpu_torch.solvers.local_ba import (HUBER2, BAProblem, BAResult, _cost, _cost_from_residuals,
                                                    _edge_terms, _robust_w)


def _local_blocks(cam, poses, points, obs_uv, obs_point, obs_w, fixed, active):
    """Rank-local residuals, Jacobians and per-edge weights; fixed cameras
    weigh in on the points (w) but not on the pose rows (w_pose)."""
    r, Jpose, Jpt, ok = _edge_terms(cam, poses, points, obs_uv, obs_point, active)
    w, _ = _robust_w(r, obs_w, ok)
    w_pose = torch.where(fixed[:, None], 0.0, w)
    return r, Jpose, Jpt, w, w_pose, ok


def _point_plan(obs_point, active, P_cap: int) -> scatter.SumPlan:
    """The plan of summing per-edge values onto their points (a point takes
    one edge per keyframe that sees it), fixed for a solve: edges that are
    not active or observe no point are dropped."""
    ok = active & (obs_point >= 0)
    return scatter.sum_plan(torch.where(ok, obs_point.long(), P_cap).reshape(-1), P_cap)


def _scatter_point(vals, plan):
    """Per-edge (C, N, ...) values summed onto (P_cap, ...) by `plan`
    (`_point_plan`), each point's edges in a fixed order."""
    return scatter.planned_sum(plan, vals.reshape((-1,) + vals.shape[2:]))


def _reduce_scatter(x, group, world: int):
    """Sum of x (P, ...) over the ranks; this rank's (P/world, ...) slice."""
    out = torch.empty((x.shape[0] // world,) + x.shape[1:], dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM, group=group)
    return out


def _all_gather(x, group, world: int):
    """Every rank's (P/world, ...) slice, concatenated in rank order."""
    out = torch.empty((x.shape[0] * world,) + x.shape[1:], dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _all_sum(x, group):
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _lm_step(cam: CameraModel, poses, points, fixed, point_valid, obs_uv, obs_point, obs_w, active, plan, lam,
             n_pcg_iters: int, lam_pt: float, group, world: int, rank: int):
    """One LM iteration on this rank's keyframe rows: (poses, points, λ,
    accepted cost), every one but the poses replicated."""
    P_cap = points.shape[0]
    P_loc = P_cap // world
    dev, dt = points.device, points.dtype
    lp = torch.clamp(obs_point, min=0).long()
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    r, Jpose, Jpt, w, w_pose, okk = _local_blocks(cam, poses, points, obs_uv, obs_point, obs_w, fixed, active)
    ok = active & (obs_point >= 0)

    # Camera blocks (rank-local).
    U = torch.einsum("cnri,cn,cnrj->cij", Jpose, w_pose, Jpose)
    g_c = torch.einsum("cnri,cn,cnr->ci", Jpose, w_pose, r)

    # Point blocks: each rank owns, and inverts, its P/d slice of the sums.
    V_loc = torch.einsum("cnri,cn,cnrj->cnij", Jpt, w, Jpt)
    gp_loc = torch.einsum("cnri,cn,cnr->cni", Jpt, w, r)
    V_s = _reduce_scatter(_scatter_point(V_loc, plan), group, world)      # (P/d, 3, 3)
    gp_s = _reduce_scatter(_scatter_point(gp_loc, plan), group, world)    # (P/d, 3)
    pv_s = point_valid[rank * P_loc : (rank + 1) * P_loc]

    V_d = (V_s + (lam * torch.clamp(torch.diagonal(V_s, dim1=-2, dim2=-1), min=1e-6))[:, :, None] * eye3
           + lam_pt * eye3)
    Vinv_s = torch.where(pv_s[:, None, None], linalg.inv3(V_d), 0.0)

    def vinv_apply_gather(a_s):
        """V⁻¹ on the local point slice, re-replicated as (P, 3)."""
        return _all_gather(torch.einsum("pij,pj->pi", Vinv_s, a_s), group, world)

    W_edge = torch.einsum("cnri,cn,cnrj->cnij", Jpose, w_pose, Jpt)                 # (C, N, 6, 3)

    # Damped U and its inverse, the block-Jacobi preconditioner. inv_ex
    # leaves its error flag on the device (no host read).
    U_d = (U + (lam * torch.clamp(torch.diagonal(U, dim1=-2, dim2=-1), min=1e-6))[:, :, None] * eye6
           + 1e-7 * eye6)
    M_inv = torch.where(fixed[:, None, None], eye6, torch.linalg.inv_ex(U_d)[0])

    def point_accum_scatter(v):
        """a_p = Σ_d W_pdᵀ v_d: scatter, then this rank's slice of the sum."""
        contrib = torch.einsum("cnij,ci->cnj", W_edge, v)
        return _reduce_scatter(_scatter_point(contrib, plan), group, world)

    okf = ok[..., None].to(dt)

    def S_apply(v):
        """S v on this rank's rows (identity on fixed rows)."""
        Va = vinv_apply_gather(point_accum_scatter(v))
        back = torch.einsum("cnij,cnj->ci", W_edge, Va[lp] * okf)
        Sv = torch.einsum("cij,cj->ci", U_d, v) - back
        return torch.where(fixed[:, None], v, Sv)

    def dot(x, y):
        return _all_sum(torch.sum(x * y), group)

    # RHS b = g_c − Y g_p (rank-local rows).
    Vg = vinv_apply_gather(gp_s)
    b = g_c - torch.einsum("cnij,cnj->ci", W_edge, Vg[lp] * okf)
    b = torch.where(fixed[:, None], 0.0, b)

    # Preconditioned CG on S δ = b, a fixed number of iterations.
    x = torch.zeros_like(b)
    rr = b
    z = torch.einsum("cij,cj->ci", M_inv, rr)
    p = z
    rz = dot(rr, z)
    for _ in range(n_pcg_iters):
        Sp = S_apply(p)
        alpha = rz / torch.clamp(dot(p, Sp), min=1e-20)
        x = x + alpha * p
        rr = rr - alpha * Sp
        z = torch.einsum("cij,cj->ci", M_inv, rr)
        rz_new = dot(rr, z)
        beta = rz_new / torch.clamp(rz, min=1e-20)
        p = z + beta * p
        rz = rz_new
    delta_c = torch.where(fixed[:, None], 0.0, x)

    # Back-substitute the points: δX = V⁻¹ (g_p − Σ_c W_pcᵀ δξ_c) on the
    # local slice, re-replicated.
    delta_p = vinv_apply_gather(gp_s - point_accum_scatter(delta_c))
    delta_p = torch.where(point_valid[:, None], delta_p, 0.0)

    # Apply, then accept or reject on the all-reduced Huber cost. A proposal
    # that is not finite costs +inf on its rank, so every rank rejects it:
    # the Huber cost drops the edges of a NaN camera (they fail the front
    # test) and would read lower. The reference accepts such a proposal
    # (ROADMAP C); on a real map PCG meets negative curvature by round-off
    # once λ is small.
    new_poses = torch.where(fixed[:, None], poses, se3.apply_left_update(delta_c, poses))
    new_points = points + delta_p
    c_old = _all_sum(_cost_from_residuals(r, obs_w, okk), group)
    c_new = _cost(cam, new_poses, new_points, obs_uv, obs_point, obs_w, active)
    finite = torch.isfinite(new_poses).all() & torch.isfinite(new_points).all()
    c_new = _all_sum(torch.where(finite, c_new, torch.inf), group)
    good = c_new < c_old
    poses = torch.where(good, new_poses, poses)
    points = torch.where(good, new_points, points)   # the same decision on every rank
    lam = torch.where(good, torch.clamp(lam * 0.4, min=1e-9), torch.clamp(lam * 5.0, max=1e5))
    # The accepted objective: a rejected proposal must not pose as the result.
    return poses, points, lam, torch.where(good, c_new, c_old)


def _pad_rows(x, n: int, value):
    return x if n == 0 else torch.cat([x, torch.full((n,) + x.shape[1:], value, dtype=x.dtype, device=x.device)])


def distributed_bundle_adjust(
    cam: CameraModel,
    prob: BAProblem,
    group=None,
    n_lm_iters: int = 10,
    n_pcg_iters: int = 25,
    lam_pt: float = 1e-6,
) -> BAResult:
    """Keyframe-sharded global BA over the ranks of `group` (the default
    process group when None).

    Every rank passes the whole problem (solvers/local_ba.BAProblem layout)
    on its device; rank i keeps keyframe rows [i·C/d, (i+1)·C/d) of the
    problem padded to C a multiple of the world size d. Returns this rank's
    rows (poses (C/d, 7), obs_active (C/d, N)), the replicated points (P, 3)
    and the replicated final cost; `gather_result` puts the rows together.
    """
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    C, P = prob.poses.shape[0], prob.points.shape[0]
    pad_c, pad_p = (-C) % world, (-P) % world
    C_loc = (C + pad_c) // world
    rows = slice(rank * C_loc, (rank + 1) * C_loc)
    poses = _pad_rows(prob.poses, pad_c, 0.0)
    if pad_c:
        poses[C:, 0] = 1.0  # identity quaternions
    poses = poses[rows]
    fixed = _pad_rows(prob.fixed, pad_c, True)[rows]
    obs_uv = _pad_rows(prob.obs_uv, pad_c, 0.0)[rows]
    obs_point = _pad_rows(prob.obs_point, pad_c, -1)[rows]
    obs_w = _pad_rows(prob.obs_w, pad_c, 0.0)[rows]
    points = _pad_rows(prob.points, pad_p, 0.0)
    point_valid = _pad_rows(prob.point_valid, pad_p, False)

    active = (obs_point >= 0) & (obs_w > 0)
    plan = _point_plan(obs_point, active, points.shape[0])
    lam = torch.full((), 1e-4, dtype=poses.dtype, device=poses.device)
    cost = torch.zeros((), dtype=poses.dtype, device=poses.device)
    for _ in range(n_lm_iters):
        poses, points, lam, cost = _lm_step(cam, poses, points, fixed, point_valid, obs_uv, obs_point, obs_w,
                                            active, plan, lam, n_pcg_iters, lam_pt, group, world, rank)
    # The final χ² classification (rank-local rows).
    r, _, _, ok = _edge_terms(cam, poses, points, obs_uv, obs_point, active)
    chi2 = torch.sum(r * r, dim=-1) * obs_w
    final_active = active & ok & (chi2 <= HUBER2)
    return BAResult(poses=poses, points=points[:P], obs_active=final_active, cost=cost)


def gather_result(res: BAResult, n_cams: int, group=None) -> BAResult:
    """The whole result on every rank (rank 0 is the one that usually
    wants it): every rank's keyframe rows gathered in rank order, the
    padding rows dropped."""
    world = dist.get_world_size(group)
    return res._replace(poses=_all_gather(res.poses, group, world)[:n_cams],
                        obs_active=_all_gather(res.obs_active.to(torch.uint8), group, world)[:n_cams].bool())
