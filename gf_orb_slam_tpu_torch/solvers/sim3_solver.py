"""Sim(3) RANSAC between two keyframes' matched map points and the Sim(3)
LM refinement (port of gf_orb_slam_tpu/solvers/sim3_solver.py).

The reference draws its 3-point samples inside `solve_sim3_ransac`; the
port draws them apart (`sample_sim3`) so tests can inject the reference's.
OptimizeSim3's Jacobian is forward-mode autodiff of the exact residual
(`torch.func.jacfwd`, the reference's `jax.jacfwd`); its `lax.scan` is a
Python loop, its 7×7 solve `solve_ex` without error checks, and each step
is accepted or rejected on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam_tpu_torch.geometry import sim3 as s3
from gf_orb_slam_tpu_torch.geometry.camera import CameraModel
from gf_orb_slam_tpu_torch.ops.fast import top_k_stable
from gf_orb_slam_tpu_torch.solvers.horn import horn_align


class Sim3Result(NamedTuple):
    S12: torch.Tensor        # (8,) Sim3: KF2-camera coords → KF1-camera coords
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int32
    ok: torch.Tensor         # () bool


def _project(cam: CameraModel, xc):
    z = torch.where(torch.abs(xc[..., 2]) < 1e-6, 1e-6, xc[..., 2])
    return torch.stack([cam.fx * xc[..., 0] / z + cam.cx, cam.fy * xc[..., 1] / z + cam.cy], dim=-1)


def sample_sim3(valid: torch.Tensor, n_hypotheses: int, generator: torch.Generator) -> torch.Tensor:
    """(S, 3) int64 minimal sets among the valid slots: the reference's
    Gumbel top-k (sim3_solver.py:120-126), drawn from `generator`."""
    u = torch.rand((n_hypotheses, valid.shape[0]), generator=generator, device=valid.device)
    g = -torch.log(-torch.log(u)) + torch.where(valid, 0.0, -1e9)
    return top_k_stable(g, 3)[1]


def optimize_sim3(
    cam: CameraModel,
    S12_0: torch.Tensor,
    x1: torch.Tensor,
    x2: torch.Tensor,
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    sigma2_1: torch.Tensor,
    sigma2_2: torch.Tensor,
    valid: torch.Tensor,
    n_iters: int = 10,
    fix_scale: bool = False,
    chi2_th: float = 9.21,
):
    """Sim3 LM on two-way reprojection residuals (Optimizer::OptimizeSim3):
    Jacobians over the 7-dof tangent, inlier gating, fixed iterations.
    Returns (S12, inliers)."""
    dev = x1.device
    sel = torch.ones(7, dtype=x1.dtype, device=dev)
    if fix_scale:
        sel = sel.index_fill(0, torch.full((1,), 6, device=dev), 0.0)
    zero = torch.zeros(7, dtype=x1.dtype, device=dev)
    eye7 = torch.eye(7, dtype=x1.dtype, device=dev)
    sig1, sig2 = torch.sqrt(sigma2_1)[:, None], torch.sqrt(sigma2_2)[:, None]

    def residuals(xi, S_base):
        S = s3.compose(s3.exp(xi), S_base)
        r1 = uv1 - _project(cam, s3.transform_point(S[None], x2))
        r2 = uv2 - _project(cam, s3.transform_point(s3.inverse(S)[None], x1))
        return r1, r2

    def whitened_cost(S, w_mask):
        r1, r2 = residuals(zero, S)
        c1 = torch.sum(r1 * r1, dim=-1) / sigma2_1
        c2 = torch.sum(r2 * r2, dim=-1) / sigma2_2
        return torch.sum(torch.where(w_mask, c1 + c2, 0.0)), c1, c2

    S = S12_0
    lam = torch.full((), 1e-3, dtype=x1.dtype, device=dev)
    for _ in range(n_iters):
        _, c1, c2 = whitened_cost(S, valid)
        w_mask = (valid & (c1 < chi2_th) & (c2 < chi2_th))[:, None]

        def flat_res(xi, S=S, w_mask=w_mask):
            r1, r2 = residuals(xi * sel, S)
            return torch.cat([(r1 / sig1 * w_mask).reshape(-1), (r2 / sig2 * w_mask).reshape(-1)])

        r = flat_res(zero)
        J = torch.func.jacfwd(flat_res)(zero)
        H = J.T @ J + lam * eye7
        delta = -torch.linalg.solve_ex(H, J.T @ r, check_errors=False)[0] * sel
        S_new = s3.compose(s3.exp(delta), S)
        c_old, _, _ = whitened_cost(S, w_mask[:, 0])
        c_new, _, _ = whitened_cost(S_new, w_mask[:, 0])
        good = c_new < c_old
        S = torch.where(good, S_new, S)
        lam = torch.where(good, torch.clamp(lam * 0.3, min=1e-8), torch.clamp(lam * 5.0, max=1e5))
    _, c1, c2 = whitened_cost(S, valid)
    return S, valid & (c1 < chi2_th) & (c2 < chi2_th)


def solve_sim3_ransac(
    cam: CameraModel,
    x1: torch.Tensor,        # (N, 3) matched map points in KF1 camera frame
    x2: torch.Tensor,        # (N, 3) the same points in KF2 camera frame
    uv1: torch.Tensor,       # (N, 2) their keypoint pixels in KF1
    uv2: torch.Tensor,       # (N, 2) their keypoint pixels in KF2
    sigma2_1: torch.Tensor,  # (N,) octave noise in KF1
    sigma2_2: torch.Tensor,  # (N,) octave noise in KF2
    valid: torch.Tensor,     # (N,) match mask
    samples: torch.Tensor,   # (S, 3) minimal sets (sample_sim3)
    min_inliers: int = 20,
    fix_scale: bool = False,
    chi2_th: float = 9.21,
) -> Sim3Result:
    """Every hypothesis's Horn fit and two-way reprojection inliers at once,
    the best refitted on its inliers (kept if it holds as many)."""
    q, t, s = horn_align(x2[samples], x1[samples], torch.ones(samples.shape, dtype=x1.dtype, device=x1.device),
                         with_scale=not fix_scale)
    S12 = s3.make_sim3(q, t, s)                                        # (S, 8)
    S21 = s3.inverse(S12)
    e1 = torch.sum((_project(cam, s3.transform_point(S12[:, None, :], x2[None])) - uv1[None]) ** 2, dim=-1) / sigma2_1[None]
    e2 = torch.sum((_project(cam, s3.transform_point(S21[:, None, :], x1[None])) - uv2[None]) ** 2, dim=-1) / sigma2_2[None]
    inl = (e1 < chi2_th) & (e2 < chi2_th) & valid[None, :]
    counts = inl.sum(dim=1, dtype=torch.int32)
    best = torch.argmax(counts, dim=0, keepdim=True)                   # (1,): first of the maxima
    inliers = inl.index_select(0, best)[0]

    # Refit on all inliers of the best hypothesis.
    q_r, t_r, s_r = horn_align(x2, x1, inliers.to(x1.dtype), with_scale=not fix_scale)
    S_refit = s3.make_sim3(q_r, t_r, s_r)
    e1r = torch.sum((_project(cam, s3.transform_point(S_refit[None], x2)) - uv1) ** 2, dim=-1) / sigma2_1
    e2r = torch.sum((_project(cam, s3.transform_point(s3.inverse(S_refit)[None], x1)) - uv2) ** 2, dim=-1) / sigma2_2
    inl_r = (e1r < chi2_th) & (e2r < chi2_th) & valid
    use_refit = inl_r.sum(dtype=torch.int32) >= counts.index_select(0, best)[0]
    S_final = torch.where(use_refit, S_refit, S12.index_select(0, best)[0])
    inl_final = torch.where(use_refit, inl_r, inliers)
    n_in = inl_final.sum(dtype=torch.int32)
    return Sim3Result(S12=S_final, inliers=inl_final, n_inliers=n_in, ok=n_in >= min_inliers)
