"""Keyframe-rate map maintenance (port of
gf_orb_slam_tpu/mapping/keyframe_ops.py): new-point triangulation between a
new keyframe and a neighbour, map-point culling, duplicate fusion in both
directions, and keyframe redundancy.

Keyframe ids are device tensors (`map_state.kf_index`), so none of these
functions reads anything back to the host. Where the reference relies on a
scatter with duplicate indices resolving last-wins (XLA on the CPU applies
updates in order; CUDA gives no order), the winners are chosen explicitly
(`map_state.last_wins`) and only they are written.
"""

from __future__ import annotations

import torch

from gf_orb_slam_tpu_torch.geometry import quat, se3
from gf_orb_slam_tpu_torch.geometry.camera import CameraModel, project
from gf_orb_slam_tpu_torch.mapping import map_state as ms
from gf_orb_slam_tpu_torch.ops import matching
from gf_orb_slam_tpu_torch.ops.pyramid import level_consts, predict_octave
from gf_orb_slam_tpu_torch.solvers.initializer import camera_K, camera_K_inv, triangulate_dlt


def _row(x: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    """x[k] for a (1,) index tensor, without a host read."""
    return x.index_select(0, k1)[0]


# ---------------------------------------------------------------------------
# Triangulating new map points (LocalMapping::CreateNewMapPoints)
# ---------------------------------------------------------------------------


def fundamental_from_poses(cam: CameraModel, pose1: torch.Tensor, pose2: torch.Tensor) -> torch.Tensor:
    """F12 with x2ᵀ F12 x1 = 0 from two T_cw poses (ComputeF12)."""
    rel = se3.compose(pose2, se3.inverse(pose1))  # T_21
    R = quat.q2r(se3.pose_q(rel))
    E = se3.hat(se3.pose_t(rel)) @ R
    Kinv = camera_K_inv(cam, pose1.device)
    return Kinv.T @ E @ Kinv


def _projection_matrix(K: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    T = se3.pose_matrix(pose)
    return K @ torch.cat([T[:3, :3], T[:3, 3:4]], dim=1)


def triangulate_between(
    cam: CameraModel,
    m: ms.MapState,
    kf1,
    kf2,
    frame_id,
    min_parallax_cos: float = 0.9998,
    scale: float = 1.2,
    n_levels: int = 8,
) -> ms.MapState:
    """Epipolar search + DLT triangulation of the unmatched keypoints of
    keyframes kf1 (new) and kf2 (neighbour); inserts the accepted points and
    wires their observations in both keyframes."""
    dev = m.kf_pose.device
    k1, k2 = ms.kf_index(kf1, dev), ms.kf_index(kf2, dev)
    pose1, pose2 = _row(m.kf_pose, k1), _row(m.kf_pose, k2)
    uv1, uv2 = _row(m.kf_kp_uv, k1), _row(m.kf_kp_uv, k2)
    oct1, oct2 = _row(m.kf_kp_octave, k1).long(), _row(m.kf_kp_octave, k2).long()
    obs1_row, obs2_row = _row(m.kf_obs_point, k1), _row(m.kf_obs_point, k2)
    desc1 = _row(m.kf_kp_desc, k1)
    N = uv1.shape[0]

    # Only keypoints without an existing map point participate.
    free1 = _row(m.kf_kp_valid, k1) & (obs1_row == ms.NO_POINT)
    free2 = _row(m.kf_kp_valid, k2) & (obs2_row == ms.NO_POINT)

    sigma2_lvl = level_consts(scale, n_levels, dev).sigma2
    F12 = fundamental_from_poses(cam, pose1, pose2)
    emask = matching.epipolar_mask(uv1, uv2, F12, sigma2_lvl[oct2], free1, free2)
    res = matching.match(
        desc1, _row(m.kf_kp_desc, k2), emask, max_dist=matching.TH_LOW, ratio=1.0,
        angle_q=_row(m.kf_kp_angle, k1), angle_t=_row(m.kf_kp_angle, k2), mutual=True,
    )
    idx = res.idx.long()

    # Triangulate every tentative pair; gate afterwards.
    K = camera_K(cam, dev)
    uv2_m = uv2[idx]
    X = triangulate_dlt(_projection_matrix(K, pose1), _projection_matrix(K, pose2), uv1, uv2_m)

    # Cheirality, reprojection, parallax and scale-consistency gates.
    uvp1, _, ok1 = project(cam, se3.transform_point(pose1, X))
    uvp2, _, ok2 = project(cam, se3.transform_point(pose2, X))
    e1 = torch.sum((uvp1 - uv1) ** 2, dim=-1)
    e2 = torch.sum((uvp2 - uv2_m) ** 2, dim=-1)
    s2_1 = sigma2_lvl[oct1]
    s2_2 = sigma2_lvl[oct2][idx]

    r1 = X - se3.pose_t(se3.inverse(pose1))[None, :]
    r2 = X - se3.pose_t(se3.inverse(pose2))[None, :]
    dist1 = torch.linalg.vector_norm(r1, dim=-1)
    dist2 = torch.linalg.vector_norm(r2, dim=-1)
    cosp = torch.sum(r1 * r2, dim=-1) / torch.clamp(dist1 * dist2, min=1e-9)
    ratio_dist = dist1 / torch.clamp(dist2, min=1e-9)
    ratio_oct = (s2_1 / torch.clamp(s2_2, min=1e-9)) ** 0.5  # scale^Δoctave
    ratio_factor = 1.5 * scale

    good = (
        res.matched & ok1 & ok2
        & torch.all(torch.isfinite(X), dim=-1)
        & (e1 < 5.991 * s2_1)
        & (e2 < 5.991 * s2_2)
        & (cosp < min_parallax_cos)
        & (ratio_dist * ratio_factor > ratio_oct)
        & (ratio_dist < ratio_oct * ratio_factor)
    )

    # Insert points and wire the observations in both keyframes.
    slots = ms.free_point_slots(m, N)
    normal = r1 / torch.clamp(torch.linalg.vector_norm(r1, dim=-1, keepdim=True), min=1e-9)
    max_d = dist1 * torch.pow(torch.full_like(dist1, scale), oct1.to(torch.float32))
    min_d = max_d / (scale ** (n_levels - 1))
    m2 = ms.add_points(m, slots, X, desc1, normal, min_d, max_d, first_kf=k1, first_frame=frame_id, use=good)
    obs1 = torch.where(good, slots, obs1_row)
    # Mutual matching makes the kf2 slots of the good pairs unique.
    obs2 = ms.set_drop(obs2_row, torch.where(good, idx, N), torch.where(good, slots, 0))
    obs = m2.kf_obs_point.index_copy(0, k1, obs1[None]).index_copy(0, k2, obs2[None])
    return m2._replace(kf_obs_point=obs)


# ---------------------------------------------------------------------------
# Map point culling (LocalMapping::MapPointCulling)
# ---------------------------------------------------------------------------


def cull_points(
    m: ms.MapState,
    current_kf,
    min_found_ratio: float = 0.25,
    n_obs: torch.Tensor | None = None,
) -> ms.MapState:
    """Remove low-quality recent points: found/visible < 0.25, or ≥ 2
    keyframes old with ≤ 2 observations; points ≥ 3 keyframes old with ≥ 3
    observations are permanent. n_obs may be shared with other stages."""
    if n_obs is None:
        n_obs = ms.point_observation_count(m)
    age = ms.kf_index(current_kf, m.pt_first_kf.device) - m.pt_first_kf
    found_ratio = m.pt_found.to(torch.float32) / torch.clamp(m.pt_visible.to(torch.float32), min=1.0)
    bad = m.pt_valid & ((found_ratio < min_found_ratio) | ((age >= 2) & (n_obs <= 2)))
    bad = bad & ~((age >= 3) & (n_obs >= 3))
    return ms.erase_points(m, bad)


# ---------------------------------------------------------------------------
# Duplicate fusion (LocalMapping::SearchInNeighbors + ORBmatcher::Fuse)
# ---------------------------------------------------------------------------


def fuse_into_keyframe(
    cam: CameraModel,
    m: ms.MapState,
    target_kf,
    cand_points: torch.Tensor,  # (M,) point ids to project
    cand_use: torch.Tensor,     # (M,) bool
    radius: float = 3.0,
    scale: float = 1.2,
    n_levels: int = 8,
) -> ms.MapState:
    """ORBmatcher::Fuse into one keyframe (the loop's SearchAndFuse): where a
    projected candidate matches a keypoint, claim the free keypoint (case A)
    or merge with its point, the better-observed one surviving (case B).
    Merges rewire one level, as the reference's (a→b→c leaves references to
    a killed id until a later fuse); conflicting writes resolve last-wins."""
    dev = m.kf_pose.device
    P = m.pt_capacity
    t1 = ms.kf_index(target_kf, dev)
    lc = level_consts(scale, n_levels, dev)
    cand = cand_points.long()
    pose = _row(m.kf_pose, t1)
    pts = m.pt_pos[cand]
    ok = cand_use & m.pt_valid[cand]

    # Candidates the target already observes are skipped (IsInKeyFrame).
    obs_t = _row(m.kf_obs_point, t1)
    in_target = ms.mark(P, torch.where(obs_t >= 0, obs_t, P), dev)
    ok = ok & ~in_target[cand]

    uvp, _, front = project(cam, se3.transform_point(pose, pts))
    view = pts - se3.pose_t(se3.inverse(pose))[None, :]
    dist = torch.linalg.vector_norm(view, dim=-1)
    cos_view = torch.sum(view * m.pt_normal[cand], dim=-1) / torch.clamp(dist, min=1e-9)
    in_range = (dist >= m.pt_min_dist[cand] * 0.8) & (dist <= m.pt_max_dist[cand] * 1.2)
    ok = ok & front & in_range & (cos_view > 0.5)
    pred_oct = predict_octave(dist, m.pt_max_dist[cand], scale, n_levels)
    rad = radius * lc.sf[pred_oct.long()]

    pmask = matching.projection_mask(uvp, ok, _row(m.kf_kp_uv, t1), _row(m.kf_kp_octave, t1),
                                     _row(m.kf_kp_valid, t1), rad, pred_oct)
    res = matching.match(m.pt_desc[cand], _row(m.kf_kp_desc, t1), pmask, max_dist=matching.TH_LOW)
    hit = res.matched & ok
    idx = res.idx.long()
    kp_point = obs_t[idx]
    n_obs = ms.point_observation_count(m)

    # Case A: a free keypoint slot is claimed, the last claim of a slot winning.
    N = obs_t.shape[0]
    claim = hit & (kp_point == ms.NO_POINT)
    win = ms.last_wins(idx, claim, N)
    obs_row = ms.set_drop(obs_t, torch.where(win, idx, N), cand)
    m = m._replace(kf_obs_point=m.kf_obs_point.index_copy(0, t1, obs_row[None]))

    # Case B: occupied by a different point → keep the better-observed one,
    # through a one-level remap table (the last write of an id winning).
    dup = hit & (kp_point != ms.NO_POINT) & (kp_point != cand)
    keep_existing = n_obs[torch.clamp(kp_point, min=0).long()] >= n_obs[torch.clamp(cand, min=0)]
    old_id = torch.where(keep_existing, cand, kp_point.long())
    new_id = torch.where(keep_existing, kp_point.long(), cand)
    ar = torch.arange(P, dtype=torch.int32, device=dev)
    remap = ms.set_drop(ar, torch.where(ms.last_wins(old_id, dup, P), old_id, P), new_id)
    obs = m.kf_obs_point
    obs = torch.where(obs >= 0, remap[torch.clamp(obs, min=0).long()], obs)
    killed = m.pt_valid & (remap != ar)
    # Each dead point donates its counters once, to its survivor remap[p].
    surv = torch.where(killed, remap, P).long()
    add_vis = torch.zeros(P + 1, dtype=torch.int32, device=dev).index_add_(
        0, surv, torch.where(killed, m.pt_visible, 0))[:P]
    add_fnd = torch.zeros(P + 1, dtype=torch.int32, device=dev).index_add_(
        0, surv, torch.where(killed, m.pt_found, 0))[:P]
    return m._replace(
        kf_obs_point=obs,
        pt_valid=m.pt_valid & ~killed,
        pt_visible=m.pt_visible + add_vis,
        pt_found=m.pt_found + add_fnd,
    )


def fuse_points_into_keyframes(
    cam: CameraModel,
    m: ms.MapState,
    target_kfs: torch.Tensor,   # (F,) keyframe ids
    target_ok: torch.Tensor,    # (F,) bool — padded/ineligible targets off
    cand_points: torch.Tensor,  # (F, M) point ids to project per target
    cand_use: torch.Tensor,     # (F, M) bool
    radius: float = 3.0,
    scale: float = 1.2,
    n_levels: int = 8,
    n_obs: torch.Tensor | None = None,
) -> ms.MapState:
    """Both directions of the neighbour fuse over F targets: each target
    matches its candidate list as of the call's start, then one update
    claims free keypoint slots (case A) and merges duplicated points into
    the better-observed one (case B). Conflicting writes resolve last-wins,
    as in the reference (keyframe_ops.py:381-409)."""
    if n_obs is None:
        n_obs = ms.point_observation_count(m)
    dev = m.kf_pose.device
    P = m.pt_capacity
    K, Nk = m.kf_obs_point.shape
    lc = level_consts(scale, n_levels, dev)
    tkfs = target_kfs.long()
    cand = cand_points.long()
    F, M = cand.shape

    # Candidates the target already observes are skipped (IsInKeyFrame).
    obs_t = m.kf_obs_point[tkfs]                                        # (F, Nk)
    f_idx = torch.arange(F, device=dev)[:, None]
    in_target = ms.mark(F * P, torch.where(obs_t >= 0, f_idx * P + obs_t, F * P), dev)
    in_target = in_target[f_idx * P + cand]                             # (F, M)
    ok = cand_use & m.pt_valid[cand] & target_ok[:, None] & ~in_target

    pts = m.pt_pos[cand]                                                # (F, M, 3)
    pose = m.kf_pose[tkfs]                                              # (F, 7)
    uvp, _, front = project(cam, se3.transform_point(pose[:, None, :], pts))
    view = pts - se3.pose_t(se3.inverse(pose))[:, None, :]
    dist = torch.linalg.vector_norm(view, dim=-1)
    cos_view = torch.sum(view * m.pt_normal[cand], dim=-1) / torch.clamp(dist, min=1e-9)
    in_range = (dist >= m.pt_min_dist[cand] * 0.8) & (dist <= m.pt_max_dist[cand] * 1.2)
    ok = ok & front & in_range & (cos_view > 0.5)
    pred_oct = predict_octave(dist, m.pt_max_dist[cand], scale, n_levels)
    rad = radius * lc.sf[pred_oct.long()]

    hits, idxs = [], []
    for f in range(F):  # one Hamming matrix per target
        t1 = tkfs[f : f + 1]
        pmask = matching.projection_mask(
            uvp[f], ok[f], _row(m.kf_kp_uv, t1), _row(m.kf_kp_octave, t1), _row(m.kf_kp_valid, t1),
            rad[f], pred_oct[f],
        )
        res = matching.match(m.pt_desc[cand[f]], _row(m.kf_kp_desc, t1), pmask, max_dist=matching.TH_LOW)
        hits.append(res.matched & ok[f])
        idxs.append(res.idx.long())
    hit = torch.stack(hits)                                             # (F, M)
    idx = torch.stack(idxs)
    kp_point = torch.gather(obs_t, 1, idx)

    # Case A: free keypoint slot → claim it. Flat (k·Nk + slot) scatter, the
    # last claim of a slot winning.
    claim = hit & (kp_point == ms.NO_POINT)
    flat_idx = tkfs[:, None] * Nk + idx
    win = ms.last_wins(flat_idx, claim, K * Nk)
    obs_all = ms.set_drop(
        m.kf_obs_point.reshape(-1), torch.where(win, flat_idx, K * Nk), cand
    ).reshape(K, Nk)
    m = m._replace(kf_obs_point=obs_all)

    # Case B: occupied by a different point → keep the better-observed one.
    dup = hit & (kp_point != ms.NO_POINT) & (kp_point != cand)
    keep_existing = n_obs[torch.clamp(kp_point, min=0).long()] >= n_obs[torch.clamp(cand, min=0)]
    old_id = torch.where(keep_existing, cand, kp_point.long())
    new_id = torch.where(keep_existing, kp_point.long(), cand)
    ar = torch.arange(P, dtype=torch.int32, device=dev)
    win_b = ms.last_wins(old_id, dup, P)
    remap = ms.set_drop(ar, torch.where(win_b, old_id, P).reshape(-1), new_id.reshape(-1))
    # Survivors map to themselves (every such write has index == value).
    remap = ms.set_drop(remap, torch.where(dup, new_id, P).reshape(-1), new_id.reshape(-1))
    obs = m.kf_obs_point
    obs = torch.where(obs >= 0, remap[torch.clamp(obs, min=0).long()], obs)
    killed = m.pt_valid & (remap != ar)
    # Each dead point donates its counters once, to its survivor remap[p].
    surv = torch.where(killed, remap, P).long()
    add_vis = torch.zeros(P + 1, dtype=torch.int32, device=dev).index_add_(
        0, surv, torch.where(killed, m.pt_visible, 0))[:P]
    add_fnd = torch.zeros(P + 1, dtype=torch.int32, device=dev).index_add_(
        0, surv, torch.where(killed, m.pt_found, 0))[:P]
    return m._replace(
        kf_obs_point=obs,
        pt_valid=m.pt_valid & ~killed,
        pt_visible=m.pt_visible + add_vis,
        pt_found=m.pt_found + add_fnd,
    )


# ---------------------------------------------------------------------------
# Keyframe culling (LocalMapping::KeyFrameCulling)
# ---------------------------------------------------------------------------


def keyframe_redundancy(
    m: ms.MapState, n_levels: int = 8, rows: torch.Tensor | None = None
) -> torch.Tensor:
    """Fraction of each keyframe's tracked points seen by ≥ 3 other
    keyframes at the same or a finer scale (observer octave ≤ own + 1). One
    flat scatter-add builds the per-point octave histogram; a cumulative sum
    answers every query by gather. rows=None → (K,); rows (Kc,) → (Kc,)."""
    P = m.pt_capacity
    dev = m.kf_pose.device
    obs_all = m.kf_obs_point
    ok_all = (obs_all >= 0) & m.kf_valid[:, None] & m.pt_valid[torch.clamp(obs_all, min=0).long()]
    oct_all = torch.clamp(m.kf_kp_octave, 0, n_levels - 1)
    flat = torch.where(ok_all, obs_all * n_levels + oct_all, P * n_levels).reshape(-1).long()
    cnt = torch.zeros(P * n_levels + 1, dtype=torch.int32, device=dev).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))[: P * n_levels]
    cum = torch.cumsum(cnt.reshape(P, n_levels), dim=1)   # observers at octave ≤ o
    if rows is None:
        obs, ok, oct_, kfv = obs_all, ok_all, oct_all, m.kf_valid
    else:
        r = rows.long()
        obs, ok, oct_, kfv = obs_all[r], ok_all[r], oct_all[r], m.kf_valid[r]
    oct_p1 = torch.clamp(oct_ + 1, max=n_levels - 1)
    # Subtract self: this keyframe's own observation is at octave ≤ octave+1.
    n_other = cum[torch.clamp(obs, min=0).long(), oct_p1.long()] - 1
    red = ok & (n_other >= 3)
    n_has = ok.sum(dim=1)
    return torch.where(kfv & (n_has > 0), red.sum(dim=1) / torch.clamp(n_has, min=1), 0.0)
