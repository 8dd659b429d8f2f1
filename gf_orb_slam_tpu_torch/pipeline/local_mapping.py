"""The per-keyframe local-mapping sequence as one function of the map (port
of gf_orb_slam_tpu/pipeline/local_mapping.py): keyframe insertion,
covisibility-neighbour triangulation, point culling, two-way duplicate
fusion, the windowed Schur BA, window-local distinctive descriptors, the
point-statistics refresh, keyframe culling, and the tracking view around the
new keyframe.

The reference compiles this into one XLA program; here it is a sequence of
eager torch ops with no host read: the keyframe id is a device tensor used
through (1,) index tensors, the data-dependent choices (which neighbours
triangulate, whether a keyframe is culled) are device `where` selects over
the map as in the reference, and no scatter relies on an order among
duplicate indices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gf_orb_slam_tpu_torch.geometry import se3
from gf_orb_slam_tpu_torch.geometry.camera import CameraModel
from gf_orb_slam_tpu_torch.mapping import keyframe_ops
from gf_orb_slam_tpu_torch.mapping import map_state as ms
from gf_orb_slam_tpu_torch.ops.fast import top_k_stable
from gf_orb_slam_tpu_torch.ops.matching import _popcount32
from gf_orb_slam_tpu_torch.ops.pyramid import level_consts
from gf_orb_slam_tpu_torch.pipeline import track_view as tv
from gf_orb_slam_tpu_torch.solvers import local_ba

_FOREVER = 1 << 30


class InsertResult(NamedTuple):
    m: ms.MapState
    kf_id: torch.Tensor      # () int32
    culled_kf: torch.Tensor  # () int32 — keyframe tombstoned this round (−1 none)
    view: tv.TrackView       # tracking view around the new keyframe
    n_ref: torch.Tensor      # () int32 — tracked observations of the new keyframe


def select_map(do: torch.Tensor, new: ms.MapState, old: ms.MapState) -> ms.MapState:
    """where(do, new, old) field by field (do: () bool on the device); fields
    the update left as the same tensor are passed through."""
    return ms.MapState(*(a if a is b else torch.where(do, a, b) for a, b in zip(new, old)))


def insert_keyframe_fused(
    cam: CameraModel,
    m: ms.MapState,
    pose: torch.Tensor,
    frame_id,
    timestamp,
    kp_uv: torch.Tensor,
    kp_octave: torch.Tensor,
    kp_angle: torch.Tensor,
    kp_desc: torch.Tensor,
    kp_valid: torch.Tensor,
    obs_point: torch.Tensor,
    scale: float = 1.2,
    n_levels: int = 8,
    ba_window: int = 8,
    ba_fixed: int = 2,
    n_tri_neighbors: int = 3,
    ba_points: int = 2048,
    ba_iters: tuple = (5, 10),
    n_fuse_neighbors: int = 4,
    view_size: int = 4096,
) -> InsertResult:
    """Insert a keyframe and run the whole local-mapping sequence; kp_*
    arrays must already be padded to the map's keypoint capacity."""
    dev = m.kf_pose.device
    m, kf_id = ms.add_keyframe(m, pose, frame_id, timestamp, kp_uv, kp_octave, kp_angle, kp_desc,
                               kp_valid, obs_point)
    k1 = ms.kf_index(kf_id, dev)
    K, N, P = m.kf_capacity, m.kp_capacity, m.pt_capacity
    sigma2_lvl = level_consts(scale, n_levels, dev).sigma2

    # Triangulation neighbours: top covisibility (≥ 10 shared points) among
    # keyframes with a baseline above 2% of the new keyframe's mean depth.
    w_row = ms.covisibility_row(m, k1)
    centers = se3.pose_t(se3.inverse(m.kf_pose))            # (K, 3)
    c_new = centers.index_select(0, k1)                     # (1, 3)
    baseline = torch.linalg.vector_norm(centers - c_new, dim=-1)
    obs_new = m.kf_obs_point.index_select(0, k1)[0]
    has_new = obs_new >= 0
    depth = torch.linalg.vector_norm(m.pt_pos[torch.clamp(obs_new, min=0).long()] - c_new, dim=-1)
    depth_ref = torch.where(has_new, depth, 0.0).sum() / torch.clamp(has_new.sum(), min=1)
    w_eff = torch.where(baseline > 0.02 * depth_ref, w_row, 0)
    top_w, top_ids = top_k_stable(w_eff, n_tri_neighbors)
    for i in range(n_tri_neighbors):
        m_tri = keyframe_ops.triangulate_between(
            cam, m, k1, top_ids[i : i + 1], frame_id, scale=scale, n_levels=n_levels
        )
        # Every neighbour is triangulated and the result selected on the
        # device, as the reference does (local_mapping.py:100-110).
        m = select_map(top_w[i] >= 10, m_tri, m)

    # One observation-count scatter shared by culling and fusion.
    cnt_raw = ms.point_observation_count_raw(m)
    m = keyframe_ops.cull_points(m, k1, n_obs=cnt_raw * m.pt_valid.to(torch.int32))

    # Fusion in both directions: target 0 is the new keyframe receiving the
    # union of its top covisible neighbours' points; targets 1..F are those
    # neighbours receiving the new keyframe's points. Neighbours below the
    # covisibility floor take part with an all-False mask.
    if n_fuse_neighbors > 0:
        fw, fuse_ids = top_k_stable(w_row, n_fuse_neighbors)
        fuse_ok = fw >= 10
        obs_nb = m.kf_obs_point[fuse_ids]                   # (F, N)
        nb_ok = (obs_nb >= 0) & fuse_ok[:, None]
        member = ms.mark(P, torch.where(nb_ok, obs_nb, P), dev)
        order = torch.where(member, torch.arange(P, dtype=torch.int32, device=dev), P)
        Mf = min(max(ba_points, N), P)
        cand1 = torch.sort(order).values[:Mf]               # the Mf smallest member ids
        use1 = cand1 < P
        cand2 = m.kf_obs_point.index_select(0, k1)[0][:Mf]
        c2 = torch.cat([cand2, cand2.new_full((Mf - cand2.shape[0],), ms.NO_POINT)])
        targets = torch.cat([k1, fuse_ids])
        t_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), fuse_ok])
        cands = torch.cat([
            torch.clamp(cand1, max=P - 1)[None],
            torch.clamp(c2, min=0)[None].expand(n_fuse_neighbors, Mf),
        ])
        uses = torch.cat([use1[None], (c2 >= 0)[None].expand(n_fuse_neighbors, Mf)])
        m = keyframe_ops.fuse_points_into_keyframes(
            cam, m, targets, t_ok, cands, uses, scale=scale, n_levels=n_levels,
            n_obs=cnt_raw * m.pt_valid.to(torch.int32),
        )

    # Local BA over the top covisibility window, ordered by keyframe id so
    # the fixed boundary is the earliest keyframes.
    w_row2 = w_row.index_fill(0, k1, _FOREVER)  # self always in the window
    top_w2, win_ids = top_k_stable(w_row2, ba_window)
    active = top_w2 > 0
    order = torch.argsort(torch.where(active, win_ids, _FOREVER), stable=True)
    win_ids = win_ids[order]
    active = active[order]

    obs_local = torch.where(active[:, None], m.kf_obs_point[win_ids], ms.NO_POINT)   # (C, N)
    local_pts = ms.mark(P, torch.where(obs_local >= 0, obs_local, P), dev) & m.pt_valid
    sigma2 = sigma2_lvl[m.kf_kp_octave[win_ids].long()]
    act_i = active.to(torch.int32)
    rank = torch.cumsum(act_i, 0) - 1  # position among active
    fixed = (~active) | (rank < torch.clamp(act_i.sum() - 1, min=1).clamp(max=ba_fixed))

    # Compact the BA to ba_points local slots (set bits of local_pts, lowest
    # id first); points beyond the cap sit this BA out.
    L = ba_points
    local_idx = top_k_stable(local_pts.to(torch.int32), L)[1]
    l_valid = local_pts[local_idx]
    inv = torch.full((P,), L, dtype=torch.int64, device=dev).scatter(
        0, local_idx, torch.arange(L, device=dev))
    obs_lidx = inv[torch.clamp(obs_local, min=0).long()]
    in_ba = (obs_local >= 0) & (obs_lidx < L)
    obs_l = torch.where(in_ba, obs_lidx, ms.NO_POINT)

    prob = local_ba.BAProblem(
        poses=m.kf_pose[win_ids],
        points=m.pt_pos[local_idx],
        fixed=fixed,
        point_valid=l_valid,
        obs_uv=m.kf_kp_uv[win_ids],
        obs_point=obs_l,
        obs_w=torch.where(obs_l >= 0, 1.0 / sigma2, 0.0),
    )
    res = local_ba.bundle_adjust(cam, prob, iters_stage1=ba_iters[0], iters_stage2=ba_iters[1])
    safe_ids = torch.where(active, win_ids, K)
    # Observations outside the compacted BA keep their status; only
    # BA-classified outliers are dropped.
    keep_obs = torch.where(in_ba, res.obs_active, obs_local >= 0)
    m = m._replace(
        kf_pose=ms.set_drop(m.kf_pose, safe_ids, res.poses),
        pt_pos=ms.set_drop(m.pt_pos, torch.where(l_valid, local_idx, P), res.points),
        kf_obs_point=ms.set_drop(m.kf_obs_point, safe_ids, torch.where(keep_obs, obs_local, ms.NO_POINT)),
    )

    # Distinctive descriptors, window-local: scatter the window's post-BA
    # inlier observations into an (L, C, 8) table and keep each point's
    # medoid descriptor (least summed Hamming distance to the others).
    C = ba_window
    desc_w = m.kf_kp_desc[win_ids]                           # (C, N, 8)
    obs_keep = torch.where(keep_obs, obs_l, ms.NO_POINT)
    slot = torch.where(obs_keep >= 0, obs_keep, L)           # (C, N) local ids
    c_idx = torch.arange(C, device=dev)[:, None].expand(C, N)
    flat = slot * C + c_idx                                  # row L·C.. = the discard row
    # A keyframe may hold one point in two slots after a merge; the later
    # slot wins, as XLA's in-order scatter does.
    win = ms.last_wins(flat, obs_keep >= 0, (L + 1) * C)
    Dw = ms.set_drop(
        torch.zeros(((L + 1) * C, 8), dtype=torch.int32, device=dev),
        torch.where(win, flat, (L + 1) * C), desc_w,
    ).reshape(L + 1, C, 8)
    Hw = ms.mark((L + 1) * C, torch.where(obs_keep >= 0, flat, (L + 1) * C), dev).reshape(L + 1, C)
    dmat = _popcount32(torch.bitwise_xor(Dw[:, :, None, :], Dw[:, None, :, :])).sum(dim=-1)
    dmat = torch.where(Hw[:, :, None] & Hw[:, None, :], dmat, 0)
    sums = torch.where(Hw, dmat.sum(dim=2), _FOREVER)
    best = torch.argmin(sums, dim=1)
    new_desc = Dw[torch.arange(L + 1, device=dev), best]    # (L + 1, 8)
    upd = Hw.any(dim=1)[:L] & l_valid
    m = m._replace(pt_desc=ms.set_drop(m.pt_desc, torch.where(upd, local_idx, P), new_desc[:L]))
    # update_desc=False: the medoid above must not be overwritten.
    m = ms.refresh_point_stats(m, scale=scale, n_levels=n_levels, update_desc=False)

    # Keyframe culling: the most redundant of the new keyframe's top
    # covisible neighbours, if over 90% redundant. The first two and the
    # three newest keyframes are protected.
    cull_rows = top_k_stable(w_row, min(32, K))[1]
    red = keyframe_ops.keyframe_redundancy(m, n_levels=n_levels, rows=cull_rows)
    protect = (cull_rows <= 1) | (cull_rows >= kf_id - 2) | (w_row[cull_rows] <= 0)
    red = torch.where(protect, 0.0, red)
    # (1,) index tensors: indexing with a 0-d tensor reads it on the host.
    j = torch.argmax(red).reshape(1)
    worst = cull_rows.index_select(0, j)[0]
    do_cull = red.index_select(0, j)[0] > 0.9
    m = select_map(do_cull, ms.erase_keyframe(m, worst), m)
    culled = torch.where(do_cull, worst, -1).to(torch.int32)

    # Tracking view around the new keyframe from the same covisibility row.
    w_view = w_row.index_fill(0, k1, _FOREVER)
    _, view_kfs = top_k_stable(w_view, 12)
    obs_v = m.kf_obs_point[view_kfs]
    ok_v = (obs_v >= 0) & (m.kf_valid[view_kfs] & (w_view[view_kfs] > 0))[:, None]
    member = ms.mark(P, torch.where(ok_v, obs_v, P), dev) & m.pt_valid
    view = tv.view_from_members(m, member, view_size)

    return InsertResult(
        m=m, kf_id=kf_id, culled_kf=culled, view=view,
        n_ref=(obs_point >= 0).sum(dtype=torch.int32),
    )
