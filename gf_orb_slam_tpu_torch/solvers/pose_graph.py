"""Sim(3) pose-graph (essential graph) optimization (port of
gf_orb_slam_tpu/solvers/pose_graph.py).

Vertices are keyframe Sim3 poses S_cw (K, 8); edges (spanning tree, strong
covisibility, the loop) carry relative Sim3 measurements; the residual is
e_ij = log(S_ji_meas ∘ S_iw ∘ S_wj) ∈ R⁷. Jacobians come from forward-mode
autodiff of the exact residual batched over the edges
(`torch.func.vmap(torch.func.jacfwd(...))`, the reference's
`vmap(jacfwd(...))`), and the dense (7K, 7K) normal equations are assembled
by flat scatter-adds whose sums run in a fixed order (`ops/scatter.py`;
a keyframe's rows take every edge that touches it) and solved by
`solve_ex`. Steps are accepted on the device; the one
host read is whether the reference would reject every step (below).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam_tpu_torch.geometry import sim3 as s3
from gf_orb_slam_tpu_torch.ops import scatter


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


def _edge_error(xi_i, xi_j, S_iw, S_jw, S_ji_meas):
    """The Sim3 whose log is the residual, with left-multiplicative updates
    applied to both vertices (batched over any leading dims)."""
    Si = s3.compose(s3.exp(xi_i), S_iw)
    Sj = s3.compose(s3.exp(xi_j), S_jw)
    return s3.compose(S_ji_meas, s3.compose(Si, s3.inverse(Sj)))


def _edge_residual(xi_i, xi_j, S_iw, S_jw, S_ji_meas):
    return s3.log(_edge_error(xi_i, xi_j, S_iw, S_jw, S_ji_meas))


_FLT_MIN = torch.finfo(torch.float32).tiny
_EPS = 1e-7


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).to(torch.float64)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a·b + c rounded once, as XLA's CPU code contracts it (the
    product of two float32 is exact in float64)."""
    return _f32(a * b + c)


def _qprod_xla(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """quat.qprod as XLA compiles it for the CPU: each row fma(p₀, q_k,
    ±p₁·q) and then fused into the last two products."""
    a, b, c, d = p.unbind(-1)
    w, x, y, z = q.unbind(-1)

    def row(t0, t1, t2, t3):
        acc = _fma(a, t0, _f32(t1[0] * t1[1]))
        return _fma(t3[0], t3[1], _fma(t2[0], t2[1], acc))

    return torch.stack([row(w, (-b, x), (-c, y), (-d, z)), row(x, (b, w), (c, z), (-d, y)),
                        row(y, (-b, z), (c, w), (d, x)), row(z, (b, y), (-c, x), (d, w))], dim=-1)


def _sumsq_xla(v: torch.Tensor) -> torch.Tensor:
    """Σ v² over the last axis as one fused chain, first element first."""
    acc = _f32(v[..., 0] * v[..., 0])
    for k in range(1, v.shape[-1]):
        acc = _fma(v[..., k], v[..., k], acc)
    return acc


def _qnormalize_xla(q: torch.Tensor) -> torch.Tensor:
    return _f32(q / _f32(torch.sqrt(_sumsq_xla(q)))[..., None])


def log_tangent_overflows(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(...,) bool: where the reference's forward-mode tangents of
    `sim3.log` are not finite at a Sim3 with quaternion q and scale s (as
    float32 values held in float64; gf_orb_slam_tpu/geometry/sim3.py:76-160).

    Its `log` calls `exp` at φ = q2v(q), σ = log(s), and `exp` divides by
    θ³ (C of the σ → 0 limit, :121-123), σ³ (C of the θ → 0 limit,
    :128-132) and θ·(σ² + θ²) (B of the general case, :114) wherever the
    branch's own threshold (θ, |σ| ≥ 1e-7) lets it. JAX's tangent of x / y
    is −ẋ·x·y⁻², and y² flushes to zero in XLA's CPU arithmetic once it is
    below the least normal float32: the tangent is then ±inf, or NaN where
    x vanished by round-off. torch's tangent, (ẋ − ẏ·x/y)/y, stays finite
    there. φ and θ are rounded as the reference's compiled code rounds
    them, because their float32 noise is what falls in that range."""
    q = _qnormalize_xla(q)
    q = torch.where(q[..., :1] < 0.0, -q, q)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    vn2 = _sumsq_xla(q[..., 1:])
    small = vn2 < _EPS * _EPS
    vn = _f32(torch.sqrt(torch.where(small, 1.0, vn2)))
    angle = _f32(2.0 * _f32(torch.atan2(vn, w)))
    series = _f32(_f32(2.0 / torch.clamp(w, min=_EPS))
                  * _f32(1.0 - _f32(vn2 / _f32(3.0 * torch.clamp(_f32(w * w), min=_EPS)))))
    phi = _f32(q[..., 1:] * torch.where(small, series, _f32(angle / vn))[..., None])
    sig = _f32(torch.log(s))
    theta2_raw = _sumsq_xla(phi)
    tiny = theta2_raw < _EPS * _EPS
    th = torch.where(tiny, 0.0, _f32(torch.sqrt(torch.where(tiny, 1.0, theta2_raw))))
    small_th, small_sig = th < _EPS, torch.abs(sig) < _EPS

    def flushed(y):
        return _f32(y * y) < _FLT_MIN

    c_sig0 = flushed(_f32(_f32(th * th) * th))
    c_th0 = flushed(_f32(_f32(sig * sig) * sig))
    b_gen = flushed(_f32(th * _fma(sig, sig, _f32(th * th))))
    over = torch.where(small_th, ~small_sig & c_th0, torch.where(small_sig, c_sig0, b_gen))
    return over | ~(torch.isfinite(q).all(dim=-1) & torch.isfinite(s))


def reference_tangent_overflow(poses: torch.Tensor, edge_i: torch.Tensor, edge_j: torch.Tensor,
                               edge_meas: torch.Tensor) -> torch.Tensor:
    """(E,) bool: edges, valid or masked, whose reference Jacobian at
    `poses` is not finite (`log_tangent_overflows` of the residual's Sim3
    S_ji ∘ (exp(0) ∘ S_iw) ∘ (exp(0) ∘ S_jw)⁻¹ at ξ = 0, its quaternion
    composed as the reference's compiled code composes it; exp(0) is
    exactly the identity)."""
    P = poses.double()
    qi = _qnormalize_xla(P[edge_i.long(), :4])
    qj = _qnormalize_xla(P[edge_j.long(), :4])
    qj = torch.cat([qj[:, :1], -qj[:, 1:]], dim=-1)  # the inverse's conjugate, exact
    M = edge_meas.double()
    q = _qnormalize_xla(_qprod_xla(M[:, :4], _qnormalize_xla(_qprod_xla(qi, qj))))
    s = _f32(M[:, 7] * _f32(P[edge_i.long(), 7] * _f32(1.0 / P[edge_j.long(), 7])))
    return log_tangent_overflows(q, s)


_edge_jacobians = torch.func.vmap(torch.func.jacfwd(_edge_residual, argnums=(0, 1)))


def _block_index(a: torch.Tensor, b: torch.Tensor, K: int) -> torch.Tensor:
    """(E, 7, 7) flat indices of the 7×7 blocks (a, b) of a (7K, 7K) matrix."""
    r = torch.arange(7, device=a.device)
    rows = 7 * a.long()[:, None, None] + r[None, :, None]
    cols = 7 * b.long()[:, None, None] + r[None, None, :]
    return rows * (7 * K) + cols


def optimize_pose_graph(prob: PoseGraphProblem, n_iters: int = 20) -> torch.Tensor:
    """Gauss-Newton with LM damping on the Sim3 pose graph. Returns (K, 8).

    A step is rejected, as the reference rejects it, wherever the
    reference's normal equations are not finite: where any edge of the
    padded table, valid or masked (its weight 0 times a NaN tangent still
    poisons H), has a residual at which the reference's tangents overflow
    (`reference_tangent_overflow`). A rejected step keeps the poses, so
    where that holds at the input every step is rejected and the input is
    returned after one host read."""
    K = prob.poses.shape[0]
    E = prob.edge_i.shape[0]
    dev = prob.poses.device
    ei, ej = prob.edge_i.long(), prob.edge_j.long()
    zeros = torch.zeros((E, 7), dtype=prob.poses.dtype, device=dev)
    # H's four blocks of every edge and g's two rows, each one flat
    # fixed-order scatter-add planned once for the solve.
    plan_h = scatter.sum_plan(torch.cat([_block_index(ei, ei, K), _block_index(ej, ej, K), _block_index(ei, ej, K),
                                         _block_index(ej, ei, K)]).reshape(-1), 49 * K * K)
    plan_g = scatter.sum_plan(torch.cat([ei, ej]), K)
    w = torch.where(prob.edge_valid, prob.edge_weight, 0.0)
    free = prob.vertex_valid & ~prob.fixed
    f7 = free.to(prob.poses.dtype).repeat_interleave(7)
    eye = torch.eye(7 * K, dtype=prob.poses.dtype, device=dev)

    def total_cost(poses):
        r = _edge_residual(zeros, zeros, poses[ei], poses[ej], prob.edge_meas)
        return torch.sum(torch.where(prob.edge_valid, prob.edge_weight * torch.sum(r * r, -1), 0.0))

    def overflow(poses):
        return reference_tangent_overflow(poses, ei, ej, prob.edge_meas).any()

    if bool(overflow(prob.poses)):
        return prob.poses
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
        H = scatter.planned_sum(plan_h, torch.cat([Hii, Hjj, Hij, Hij.mT]).reshape(-1))
        g = scatter.planned_sum(plan_g, torch.cat([gi, gj]))

        # Freeze fixed and invalid vertices: their rows and columns vanish
        # and their diagonal is 1; free vertices get the LM damping.
        H = H.reshape(7 * K, 7 * K) * f7[:, None] * f7[None, :]
        damp = torch.where(free, lam, 1.0).repeat_interleave(7)
        Hd = H + torch.diag(damp) + 1e-8 * eye
        g = g * free[:, None]
        delta = torch.linalg.solve_ex(Hd, -g.reshape(-1), check_errors=False)[0].reshape(K, 7)
        delta = torch.where(free[:, None], delta, 0.0)

        new_poses = torch.where(free[:, None], s3.compose(s3.exp(delta), poses), poses)
        good = (total_cost(new_poses) < total_cost(poses)) & ~overflow(poses)
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
