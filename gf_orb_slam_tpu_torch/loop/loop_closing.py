"""Loop closing (port of gf_orb_slam_tpu/loop/loop_closing.py):
DetectLoop's temporal consistency on the host, then per consistent
candidate ComputeSim3 (`verify_candidate`) and CorrectLoop with
SearchAndFuse (`correct_loop`).

Keyframe ids are device tensors; neither function reads back to the host
(the system reads `LoopMatch.ok`). The Sim3 RANSAC samples come from
`sim3_solver.sample_sim3` with the caller's torch.Generator.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam_tpu_torch.geometry import se3
from gf_orb_slam_tpu_torch.geometry import sim3 as s3
from gf_orb_slam_tpu_torch.geometry.camera import CameraModel
from gf_orb_slam_tpu_torch.mapping import keyframe_ops
from gf_orb_slam_tpu_torch.mapping import map_state as ms
from gf_orb_slam_tpu_torch.ops import matching
from gf_orb_slam_tpu_torch.ops.fast import top_k_stable
from gf_orb_slam_tpu_torch.ops.pyramid import level_consts
from gf_orb_slam_tpu_torch.retrieval import keyframe_db as kdb
from gf_orb_slam_tpu_torch.solvers import pose_graph, sim3_solver


class LoopMatch(NamedTuple):
    ok: torch.Tensor          # () bool
    S12: torch.Tensor         # (8,) Sim3: candidate-KF camera → query-KF camera
    n_inliers: torch.Tensor   # OptimizeSim3 post-refine inliers
    n_bow: torch.Tensor       # BoW-gated 3D-3D matches fed to Sim3 RANSAC
    n_ransac: torch.Tensor    # best-hypothesis RANSAC inliers
    n_guided: torch.Tensor    # matches after the Sim3-guided rematch union


def verify_candidate(
    cam: CameraModel,
    m: ms.MapState,
    db: kdb.BowDatabase,
    query_kf,
    cand_kf,
    generator: torch.Generator,
    scale: float = 1.2,
    n_levels: int = 8,
    ransac_floor: int = 20,
    accept_ransac: int = 20,
    accept_refine: int = 20,
    n_hypotheses: int = 128,
    rematch_radius: float = 7.5,
) -> LoopMatch:
    """ComputeSim3 for one candidate: BoW-gated matching of the two
    keyframes' map points, Sim3 RANSAC, a Sim3-guided re-match
    (SearchBySim3), OptimizeSim3; accepted at ≥ 20 RANSAC and ≥ 20 refined
    inliers (LoopClosing.cc:398)."""
    dev = m.kf_pose.device
    q1, c1 = ms.kf_index(query_kf, dev), ms.kf_index(cand_kf, dev)

    def row(x, k1):
        return x.index_select(0, k1)[0]

    obs_q, obs_c = row(m.kf_obs_point, q1), row(m.kf_obs_point, c1)
    has1 = row(m.kf_kp_valid, q1) & (obs_q >= 0)
    has2 = row(m.kf_kp_valid, c1) & (obs_c >= 0)
    desc_q, desc_c = row(m.kf_kp_desc, q1), row(m.kf_kp_desc, c1)
    mask = kdb.bow_match_mask(row(db.mid_nodes, q1), row(db.mid_nodes, c1), has1, has2)
    res = matching.match(desc_q, desc_c, mask, max_dist=matching.TH_LOW, ratio=0.75,
                         angle_q=row(m.kf_kp_angle, q1), angle_t=row(m.kf_kp_angle, c1), mutual=True)
    idx = res.idx.long()
    matched = res.matched & has1

    # Both sides' 3D points in their own camera frames.
    pose_q, pose_c = row(m.kf_pose, q1), row(m.kf_pose, c1)
    p1_ids = torch.clamp(obs_q, min=0).long()
    p2_all = torch.clamp(obs_c, min=0).long()
    p2_ids = p2_all[idx]
    good = matched & m.pt_valid[p1_ids] & m.pt_valid[p2_ids]
    x1 = se3.transform_point(pose_q, m.pt_pos[p1_ids])
    x2 = se3.transform_point(pose_c, m.pt_pos[p2_ids])
    uv1 = row(m.kf_kp_uv, q1)
    uv2_all = row(m.kf_kp_uv, c1)
    sigma2 = level_consts(scale, n_levels, dev).sigma2
    s1 = sigma2[row(m.kf_kp_octave, q1).long()]
    s2_all = sigma2[row(m.kf_kp_octave, c1).long()]

    samples = sim3_solver.sample_sim3(good, n_hypotheses, generator)
    sres = sim3_solver.solve_sim3_ransac(cam, x1, x2, uv1, uv2_all[idx], s1, s2_all[idx], good, samples,
                                         min_inliers=ransac_floor)

    # Sim3-guided re-match (ORBmatcher::SearchBySim3): each side's points
    # projected into the other keyframe, both projections within the window.
    S12, S21 = sres.S12, s3.inverse(sres.S12)
    x2_all = se3.transform_point(pose_c, m.pt_pos[p2_all])
    p_q = sim3_solver._project(cam, s3.transform_point(S12[None], x2_all))   # cand points in the query image
    p_c = sim3_solver._project(cam, s3.transform_point(S21[None], x1))       # query points in the cand image
    sig1, sig2 = torch.sqrt(s1), torch.sqrt(s2_all)
    d_a = torch.sum((uv1[:, None, :] - p_q[None, :, :]) ** 2, dim=-1)
    d_b = torch.sum((p_c[:, None, :] - uv2_all[None, :, :]) ** 2, dim=-1)
    guided = ((d_a < (rematch_radius * sig2[None, :]) ** 2) & (d_b < (rematch_radius * sig1[:, None]) ** 2)
              & has1[:, None] & has2[None, :])
    res_g = matching.match(desc_q, desc_c, guided, max_dist=matching.TH_HIGH, mutual=True)
    # Union: the RANSAC inliers, plus guided matches on free slots.
    add = res_g.matched & has1 & ~sres.inliers
    idx_u = torch.where(add, res_g.idx.long(), idx)
    p2_u = p2_all[idx_u]
    valid_u = (sres.inliers | add) & m.pt_valid[p2_u] & m.pt_valid[p1_ids]
    x2_u = se3.transform_point(pose_c, m.pt_pos[p2_u])

    S_ref, inl_ref = sim3_solver.optimize_sim3(cam, S12, x1, x2_u, uv1, uv2_all[idx_u], s1, s2_all[idx_u],
                                               valid_u, n_iters=10)
    n_ref = inl_ref.sum(dtype=torch.int32)
    ok = (sres.n_inliers >= accept_ransac) & (n_ref >= accept_refine)
    return LoopMatch(ok=ok, S12=torch.where(ok, S_ref, S12), n_inliers=n_ref,
                     n_bow=good.sum(dtype=torch.int32), n_ransac=sres.n_inliers,
                     n_guided=valid_u.sum(dtype=torch.int32))


def correct_loop(
    m: ms.MapState,
    query_kf,
    loop_kf,
    S_query_loop: torch.Tensor,   # Sim3: loop-KF camera coords → query-KF camera coords
    covis: torch.Tensor,
    n_iters: int = 20,
    cam: CameraModel | None = None,
    n_fuse_targets: int = 4,
    n_fuse_sources: int = 2,
    scale: float = 1.2,
    n_levels: int = 8,
) -> ms.MapState:
    """CorrectLoop (LoopClosing.cc:412-571): the query's corrected Sim3, the
    essential-graph optimization with the loop edge, map points re-anchored
    through their first observer; then SearchAndFuse (cc:572-618): the loop
    side's points fused into the query's covisible group (skipped when
    `cam` is None)."""
    K = m.kf_capacity
    dev = m.kf_pose.device
    q1, l1 = ms.kf_index(query_kf, dev), ms.kf_index(loop_kf, dev)
    S_cw = s3.from_se3(m.kf_pose)                                         # (K, 8)
    S_qw_corr = s3.compose(S_query_loop, S_cw.index_select(0, l1)[0])
    poses0 = S_cw.index_copy(0, q1, S_qw_corr[None])

    parent = ms.spanning_tree_parent(m, covis)
    edge_i, edge_j, meas, edge_valid, weight = pose_graph.build_essential_edges(
        covis, parent, m.kf_valid, l1, q1, torch.ones(1, dtype=torch.bool, device=dev), S_cw)
    # The loop edge measures the verified relative Sim3, not the drifted estimate.
    meas = meas.index_copy(0, torch.full((1,), edge_i.shape[0] - 1, device=dev), S_query_loop[None])
    prob = pose_graph.PoseGraphProblem(
        poses=poses0, fixed=torch.zeros(K, dtype=torch.bool, device=dev).index_fill(0, l1, True),
        vertex_valid=m.kf_valid, edge_i=edge_i, edge_j=edge_j, edge_meas=meas,
        edge_valid=edge_valid, edge_weight=weight,
    )
    S_opt = pose_graph.optimize_pose_graph(prob, n_iters=n_iters)

    # Each point moves with its first observer: X' = S_opt_wc(S_old_cw(X)).
    A = ms.incidence(m)
    first_kf = torch.argmax(A.to(torch.uint8), dim=0)                      # first observer (first of the maxima)
    has_obs = A.any(dim=0)
    x_cam = s3.transform_point(S_cw[first_kf], m.pt_pos)
    x_new = s3.transform_point(s3.inverse(S_opt)[first_kf], x_cam)
    new_pos = torch.where((has_obs & m.pt_valid)[:, None], x_new, m.pt_pos)
    new_kf_pose = torch.where(m.kf_valid[:, None], s3.to_se3(S_opt), m.kf_pose)
    m = m._replace(kf_pose=new_kf_pose, pt_pos=new_pos)
    if cam is None:
        return m

    # SearchAndFuse: the loop keyframe's and its top covisible neighbours'
    # points projected into the query and its top covisible neighbours.
    N = m.kp_capacity
    src_w, src_ids = top_k_stable(covis.index_select(0, l1)[0], n_fuse_sources)
    src_ids = torch.cat([l1, src_ids])
    src_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), src_w >= 15])
    cand = m.kf_obs_point[src_ids].reshape(-1)
    cand_use = (cand >= 0) & src_ok.repeat_interleave(N)
    tgt_w, tgt_ids = top_k_stable(covis.index_select(0, q1)[0], n_fuse_targets)
    tgt_ids = torch.cat([q1, tgt_ids])
    tgt_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), tgt_w >= 15])
    for i in range(n_fuse_targets + 1):
        m = keyframe_ops.fuse_into_keyframe(cam, m, tgt_ids[i : i + 1], torch.clamp(cand, min=0),
                                            cand_use & tgt_ok[i], scale=scale, n_levels=n_levels)
    return ms.refresh_point_stats(m, scale=scale, n_levels=n_levels, update_desc=False)


class LoopDetector:
    """Host-side temporal consistency (DetectLoop's mvConsistentGroups,
    LoopClosing.cc:160-238)."""

    def __init__(self, consistency_threshold: int = 3):
        self.consistency_threshold = consistency_threshold
        self.prev_groups: list[tuple[set, int]] = []  # (covisible group, streak)

    def update_streaks(self, cand_ids, cand_ok, covis_row_of) -> list[tuple[int, int]]:
        """Advance the consistency state; returns (candidate, streak length)
        for every eligible candidate of this round (streak 1 = first
        sighting)."""
        pairs = []
        new_groups: list[tuple[set, int]] = []
        for c, ok in zip(cand_ids, cand_ok):
            if not ok:
                continue
            group = set(covis_row_of(int(c))) | {int(c)}
            streak = 0
            for prev_set, prev_streak in self.prev_groups:
                if group & prev_set:
                    streak = max(streak, prev_streak + 1)
            new_groups.append((group, streak))
            pairs.append((int(c), streak + 1))
        self.prev_groups = new_groups
        return pairs

    def update(self, cand_ids, cand_ok, covis_row_of) -> list[int]:
        """Candidates whose group has been consistent for ≥ threshold
        consecutive detections."""
        return [c for c, s in self.update_streaks(cand_ids, cand_ok, covis_row_of)
                if s >= self.consistency_threshold]

    def reset(self):
        self.prev_groups = []
