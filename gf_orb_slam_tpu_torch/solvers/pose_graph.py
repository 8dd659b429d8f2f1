"""Sim(3) pose-graph (essential graph) optimization (port of
gf_orb_slam_tpu/solvers/pose_graph.py).

Vertices are keyframe Sim3 poses S_cw (K, 8); edges (spanning tree, strong
covisibility, the loop) carry relative Sim3 measurements; the residual is
e_ij = log(S_ji_meas ∘ S_iw ∘ S_wj) ∈ R⁷. Jacobians come from forward-mode
autodiff of the exact residual batched over the edges
(`torch.func.vmap(torch.func.jacfwd(...))`, the reference's
`vmap(jacfwd(...))`), and the dense (7K, 7K) normal equations are assembled
by flat scatter-adds (`index_add_`, whose float sums on CUDA run in no fixed
order) and solved by `solve_ex`. Steps are accepted on the device: nothing
here reads back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam_tpu_torch.geometry import sim3 as s3


class PoseGraphProblem(NamedTuple):
    poses: torch.Tensor        # (K, 8) initial S_cw
    fixed: torch.Tensor        # (K,) bool
    vertex_valid: torch.Tensor  # (K,) bool
    edge_i: torch.Tensor       # (E,) int
    edge_j: torch.Tensor       # (E,) int
    edge_meas: torch.Tensor    # (E, 8) S_ji measurement (i-cam coords → j-cam)
    edge_valid: torch.Tensor   # (E,) bool
    edge_weight: torch.Tensor  # (E,) information scale


def relative_sim3(poses: torch.Tensor, i, j) -> torch.Tensor:
    """S_ji = S_jw ∘ S_wi from absolute S_cw poses."""
    return s3.compose(poses[j], s3.inverse(poses[i]))


def _edge_residual(xi_i, xi_j, S_iw, S_jw, S_ji_meas):
    """Residual with left-multiplicative updates applied to both vertices
    (batched over any leading dims)."""
    Si = s3.compose(s3.exp(xi_i), S_iw)
    Sj = s3.compose(s3.exp(xi_j), S_jw)
    return s3.log(s3.compose(S_ji_meas, s3.compose(Si, s3.inverse(Sj))))


_edge_jacobians = torch.func.vmap(torch.func.jacfwd(_edge_residual, argnums=(0, 1)))


def _block_index(a: torch.Tensor, b: torch.Tensor, K: int) -> torch.Tensor:
    """(E, 7, 7) flat indices of the 7×7 blocks (a, b) of a (7K, 7K) matrix."""
    r = torch.arange(7, device=a.device)
    rows = 7 * a.long()[:, None, None] + r[None, :, None]
    cols = 7 * b.long()[:, None, None] + r[None, None, :]
    return rows * (7 * K) + cols


def optimize_pose_graph(prob: PoseGraphProblem, n_iters: int = 20) -> torch.Tensor:
    """Gauss-Newton with LM damping on the Sim3 pose graph. Returns (K, 8)."""
    K = prob.poses.shape[0]
    E = prob.edge_i.shape[0]
    dev = prob.poses.device
    ei, ej = prob.edge_i.long(), prob.edge_j.long()
    zeros = torch.zeros((E, 7), dtype=prob.poses.dtype, device=dev)
    idx_ii, idx_jj = _block_index(ei, ei, K).reshape(-1), _block_index(ej, ej, K).reshape(-1)
    idx_ij, idx_ji = _block_index(ei, ej, K).reshape(-1), _block_index(ej, ei, K).reshape(-1)
    w = torch.where(prob.edge_valid, prob.edge_weight, 0.0)
    free = prob.vertex_valid & ~prob.fixed
    f7 = free.to(prob.poses.dtype).repeat_interleave(7)
    eye = torch.eye(7 * K, dtype=prob.poses.dtype, device=dev)

    def total_cost(poses):
        r = _edge_residual(zeros, zeros, poses[ei], poses[ej], prob.edge_meas)
        return torch.sum(torch.where(prob.edge_valid, prob.edge_weight * torch.sum(r * r, -1), 0.0))

    poses = prob.poses
    lam = torch.full((), 1e-4, dtype=poses.dtype, device=dev)
    for _ in range(n_iters):
        Si, Sj = poses[ei], poses[ej]
        r = _edge_residual(zeros, zeros, Si, Sj, prob.edge_meas)             # (E, 7)
        Ji, Jj = _edge_jacobians(zeros, zeros, Si, Sj, prob.edge_meas)        # (E, 7, 7) each

        Hii = torch.einsum("eri,e,erj->eij", Ji, w, Ji)
        Hjj = torch.einsum("eri,e,erj->eij", Jj, w, Jj)
        Hij = torch.einsum("eri,e,erj->eij", Ji, w, Jj)
        gi = torch.einsum("eri,e,er->ei", Ji, w, r)
        gj = torch.einsum("eri,e,er->ei", Jj, w, r)
        H = torch.zeros(7 * K * 7 * K, dtype=poses.dtype, device=dev)
        H.index_add_(0, idx_ii, Hii.reshape(-1)).index_add_(0, idx_jj, Hjj.reshape(-1))
        H.index_add_(0, idx_ij, Hij.reshape(-1)).index_add_(0, idx_ji, Hij.mT.reshape(-1))
        g = torch.zeros((K, 7), dtype=poses.dtype, device=dev).index_add_(0, ei, gi).index_add_(0, ej, gj)

        # Freeze fixed and invalid vertices: their rows and columns vanish
        # and their diagonal is 1; free vertices get the LM damping.
        H = H.reshape(7 * K, 7 * K) * f7[:, None] * f7[None, :]
        damp = torch.where(free, lam, 1.0).repeat_interleave(7)
        Hd = H + torch.diag(damp) + 1e-8 * eye
        g = g * free[:, None]
        delta = torch.linalg.solve_ex(Hd, -g.reshape(-1), check_errors=False)[0].reshape(K, 7)
        delta = torch.where(free[:, None], delta, 0.0)

        new_poses = torch.where(free[:, None], s3.compose(s3.exp(delta), poses), poses)
        good = total_cost(new_poses) < total_cost(poses)
        poses = torch.where(good, new_poses, poses)
        lam = torch.where(good, torch.clamp(lam * 0.3, min=1e-8), torch.clamp(lam * 6.0, max=1e6))
    return poses


def build_essential_edges(
    covis: torch.Tensor,      # (K, K) int32 covisibility weights
    parent: torch.Tensor,     # (K,) spanning-tree parent (−1 root)
    kf_valid: torch.Tensor,   # (K,)
    loop_i: torch.Tensor,     # (Lmax,) loop edge endpoints
    loop_j: torch.Tensor,
    loop_valid: torch.Tensor,
    poses: torch.Tensor,      # (K, 8) current S_cw (measurements from the current estimate)
    corrected: torch.Tensor | None = None,
    covis_min: int = 100,
):
    """The essential graph's edges (Optimizer.cc:1814-1907): spanning tree +
    covisibility ≥ covis_min (upper triangle) + loop edges, measured from
    the pre-correction relative poses. Returns (edge_i, edge_j, meas,
    edge_valid, weight)."""
    K = covis.shape[0]
    dev = covis.device
    meas_src = poses if corrected is None else corrected
    tree_i = torch.arange(K, dtype=torch.int32, device=dev)
    tree_j = torch.where(parent >= 0, parent, 0).to(torch.int32)
    tree_valid = (parent >= 0) & kf_valid
    iu, ju = torch.triu_indices(K, K, 1, device=dev)
    strong = (covis[iu, ju] >= covis_min) & kf_valid[iu] & kf_valid[ju]
    edge_i = torch.cat([tree_i, iu.to(torch.int32), loop_i.to(torch.int32)])
    edge_j = torch.cat([tree_j, ju.to(torch.int32), loop_j.to(torch.int32)])
    edge_valid = torch.cat([tree_valid, strong, loop_valid])
    weight = torch.cat([
        torch.ones(K + iu.shape[0], dtype=poses.dtype, device=dev),
        torch.full((loop_i.shape[0],), 5.0, dtype=poses.dtype, device=dev),  # loop edges count more
    ])
    meas = relative_sim3(meas_src, edge_i.long(), edge_j.long())
    return edge_i, edge_j, meas, edge_valid, weight
