"""Per-frame tracking (port of gf_orb_slam_tpu/pipeline/tracking.py):
motion-model tracking, local-map tracking with optional Good-Feature
selection in any of the reference's modes, the fused WORKING-state step, and
the fused relocalization of a LOST frame.

The reference's `mode="drop"` scatters (index N or P = drop) become writes
into an N+1 (P+1) buffer whose last slot is cut off; every gather index is
clamped as the reference clamps it (torch raises on out-of-range reads).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from gf_orb_slam_tpu_torch.geometry import pwls, se3
from gf_orb_slam_tpu_torch.geometry.camera import CameraModel, project
from gf_orb_slam_tpu_torch.gf import active_matching, observability, selection
from gf_orb_slam_tpu_torch.mapping import map_state as ms
from gf_orb_slam_tpu_torch.mapping.frame import FrameData, make_frame
from gf_orb_slam_tpu_torch.ops import matching
from gf_orb_slam_tpu_torch.ops.fast import top_k_stable
from gf_orb_slam_tpu_torch.ops.pyramid import level_consts, predict_octave
from gf_orb_slam_tpu_torch.pipeline import track_view as tv
from gf_orb_slam_tpu_torch.pipeline.track_view import TrackView
from gf_orb_slam_tpu_torch.retrieval import keyframe_db as kdb
from gf_orb_slam_tpu_torch.solvers import pnp, pose_opt

NO_POINT = ms.NO_POINT

# Good-Feature selection modes (the reference's SlamConfig.gf_mode):
#   subset    exact greedy Max-logDet over the 2×7 factors, seeded with the
#             current matches' information (determinant lemma);
#   hybrid    the same over 13-dim two-segment PWLS factors [H; H·F];
#   lazier    lazier-than-lazy greedy over random candidate subsets;
#   auto      lazier greedy whose budget stops at a marginal-gain floor;
#   active    select-then-match by marginal logdet gain;
#   random    a budget-size random subset (ablation baseline);
#   longlive  the budget's oldest points by first keyframe (baseline).
GF_MODES = ("subset", "hybrid", "lazier", "auto", "active", "random", "longlive")


def check_gf_mode(gf_mode: str) -> None:
    if gf_mode not in GF_MODES:
        raise ValueError(f"unknown gf_mode {gf_mode!r}; one of {', '.join(GF_MODES)}")


def gf_noise_shape(gf_mode: str, V: int, gf_budget: int, gf_batch: int) -> tuple | None:
    """Shape of the noise a mode's selection takes over a V-point view, or
    None for the modes that draw none."""
    if gf_mode == "random":
        return (V,)
    if gf_mode == "lazier":
        return (selection.lazier_sizes(V, gf_budget, batch=gf_batch)[1], V)
    if gf_mode == "auto":
        return (gf_budget, V)
    return None


def sample_gf_noise(gf_mode: str, V: int, gf_budget: int, gf_batch: int,
                    generator: torch.Generator) -> torch.Tensor | None:
    """The noise `track_local_map` takes in `gf_mode`, drawn from `generator`
    on its device: (V,) uniform for random, (⌈budget/batch⌉, V) Gumbel for
    lazier, (budget, V) Gumbel for auto; None otherwise."""
    shape = gf_noise_shape(gf_mode, V, gf_budget, gf_batch)
    if shape is None:
        return None
    if gf_mode == "random":
        return torch.rand(shape, generator=generator, device=generator.device)
    return selection.sample_gumbel(*shape, generator)


class TrackResult(NamedTuple):
    pose: torch.Tensor       # (7,) refined T_cw
    obs_point: torch.Tensor  # (N,) map-point id per keypoint (post-opt inliers)
    n_matches: torch.Tensor  # () int32 — tentative matches fed to the optimizer
    n_inliers: torch.Tensor  # () int32
    ok: torch.Tensor         # () bool


def _scatter_ids(n: int, hit: torch.Tensor, slot: torch.Tensor, ids: torch.Tensor,
                 base: torch.Tensor | None = None) -> torch.Tensor:
    """(n,) int32: `base` (or NO_POINT) with ids[j] written at slot[j] where hit[j]."""
    if base is None:
        base = torch.full((n,), NO_POINT, dtype=torch.int32, device=slot.device)
    return ms.set_drop(base, torch.where(hit, slot.long(), n), torch.where(hit, ids, 0))


def _scatter_mask(n: int, hit: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """(n,) bool, True at slot[j] where hit[j]."""
    return ms.mark(n, torch.where(hit, slot.long(), n), slot.device)


def track_with_motion_model(
    cam: CameraModel,
    m: ms.MapState,
    frame: FrameData,
    pose_pred: torch.Tensor,
    last_obs_point: torch.Tensor,   # (N,) point ids matched in the previous frame
    last_uv: torch.Tensor,          # (N, 2) their pixel locations last frame
    scale: float = 1.2,
    n_levels: int = 8,
    radius: float = 15.0,
    min_inliers: int = 10,
) -> TrackResult:
    """Project last frame's map points through the predicted pose, search
    ±radius (octave-scaled), pose-optimize, drop outliers."""
    N = frame.capacity
    lc = level_consts(scale, n_levels, pose_pred.device)
    lp = torch.clamp(last_obs_point, min=0).long()
    has_pt = (last_obs_point >= 0) & m.pt_valid[lp]
    pts = m.pt_pos[lp]

    xc = se3.transform_point(pose_pred, pts)
    uv_proj, _, front = project(cam, xc)
    proj_ok = has_pt & front

    center = se3.pose_t(se3.inverse(pose_pred))
    pred_oct = predict_octave(
        torch.linalg.vector_norm(pts - center[None, :], dim=-1), m.pt_max_dist[lp], scale, n_levels
    )
    rad = radius * lc.sf[pred_oct.long()]

    pmask = matching.projection_mask(uv_proj, proj_ok, frame.uv, frame.octave, frame.valid, rad, pred_oct)
    res = matching.match(m.pt_desc[lp], frame.desc, pmask, max_dist=matching.TH_HIGH, ratio=0.9, mutual=True)
    hit = res.matched & proj_ok

    obs = _scatter_ids(N, hit, res.idx, last_obs_point)
    n_matches = (obs >= 0).sum(dtype=torch.int32)

    op = torch.clamp(obs, min=0).long()
    sigma2 = lc.sigma2[frame.octave.long()]
    result = pose_opt.optimize_pose(cam, pose_pred, m.pt_pos[op], frame.uv, 1.0 / sigma2, obs >= 0)
    obs_final = torch.where(result.inliers, obs, NO_POINT)
    ok = (n_matches >= 20) & (result.n_inliers >= min_inliers)
    return TrackResult(
        pose=result.pose, obs_point=obs_final, n_matches=n_matches,
        n_inliers=result.n_inliers, ok=ok,
    )


class LocalMapTrackResult(NamedTuple):
    pose: torch.Tensor
    obs_point: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor
    local_points: torch.Tensor    # (P,) bool — the local map used
    gf_selected: torch.Tensor     # (P,) bool — GF-selected subset (all False if off)
    visible_points: torch.Tensor  # (P,) bool — frustum-visible this frame
    found_points: torch.Tensor    # (P,) bool — matched this frame
    n_total: torch.Tensor         # () int32 — inliers + deferred matches


def track_local_map(
    cam: CameraModel,
    m: ms.MapState,
    view: TrackView,
    frame: FrameData,
    pose: torch.Tensor,
    obs_point: torch.Tensor,   # (N,) current matches from initial tracking (global ids)
    Xv: torch.Tensor,          # (13,) PWLS state for GF Jacobians
    gf_noise: torch.Tensor | None = None,
    scale: float = 1.2,
    n_levels: int = 8,
    radius: float = 3.0,
    min_inliers: int = 15,
    gf_budget: int = 100,
    use_gf: bool = False,
    gf_mode: str = "subset",
    gf_batch: int = 1,
    dt=0.05,
) -> LocalMapTrackResult:
    """Frustum-filter the view's candidates, optionally restrict them by GF
    selection in `gf_mode` (GF_MODES), match all visible candidates by
    projection, optimize the pose over the matches of selected candidates,
    then merge the deferred (unselected) matches that pass the χ² gate at
    the refined pose. `gf_noise` is the random modes' noise
    (`sample_gf_noise`); `dt` (a float or a device tensor) is the PWLS
    segment of the hybrid mode's F matrix."""
    if use_gf:
        check_gf_mode(gf_mode)
        want = gf_noise_shape(gf_mode, view.capacity, gf_budget, gf_batch)
        got = None if gf_noise is None else tuple(gf_noise.shape)
        if want is not None and got != want:
            raise ValueError(f"gf_mode {gf_mode!r} takes gf_noise of shape {want} (sample_gf_noise), got {got}")
    N = frame.capacity
    P = m.pt_capacity
    lc = level_consts(scale, n_levels, pose.device)
    safe_ids = torch.clamp(view.ids, max=P - 1).long()

    pos_v = m.pt_pos[safe_ids]
    valid_v = view.valid & m.pt_valid[safe_ids]

    # Exclude candidates already matched by the initial tracking stage.
    cur_mask = _scatter_mask(P, obs_point >= 0, obs_point)
    search_v = valid_v & ~cur_mask[safe_ids]

    # --- frustum check over the view ---
    xc = se3.transform_point(pose, pos_v)
    uv_proj, _, front = project(cam, xc)
    center = se3.pose_t(se3.inverse(pose))
    vec = pos_v - center[None, :]
    dist = torch.linalg.vector_norm(vec, dim=-1)
    cos_view = torch.sum(vec * view.normal, dim=-1) / torch.clamp(dist, min=1e-9)
    in_img = (
        (uv_proj[:, 0] >= 0) & (uv_proj[:, 0] < cam.width)
        & (uv_proj[:, 1] >= 0) & (uv_proj[:, 1] < cam.height)
    )
    in_range = (dist >= view.min_dist) & (dist <= view.max_dist)
    visible = search_v & front & in_img & in_range & (cos_view > 0.5)

    pred_oct = predict_octave(dist, view.max_dist, scale, n_levels)
    lvl_sigma2 = lc.sigma2

    # --- budgeted GF selection over the visible candidates ---
    match_v = visible
    gf_sel_v = torch.zeros_like(visible)
    if use_gf and gf_mode in ("subset", "hybrid", "lazier", "auto", "active"):
        jac = observability.measurement_jacobians(cam, Xv, pos_v)
        H_w = observability.whiten(jac.H, lvl_sigma2[pred_oct.long()])
        vis_j = jac.visible & valid_v
        if gf_mode == "hybrid":
            factors = observability.hybrid_factors(H_w, pwls.f_matrix(Xv, dt), vis_j)
        else:
            factors = torch.where(vis_j[:, None, None], H_w, 0.0)
        if gf_mode in ("lazier", "auto", "active"):
            blocks = torch.einsum("nri,nrj->nij", factors, factors)
        cand = visible & jac.visible
    if use_gf and gf_mode in ("subset", "hybrid", "active"):
        # Info prior from the initial-tracking matches, whitened at their
        # keypoints' octaves.
        op0 = torch.clamp(obs_point, min=0).long()
        jac_cur = observability.measurement_jacobians(cam, Xv, m.pt_pos[op0])
        Hc = observability.whiten(jac_cur.H, lvl_sigma2[frame.octave.long()])
        Hc = torch.where((jac_cur.visible & (obs_point >= 0))[:, None, None], Hc, 0.0)
        info_prior7 = torch.einsum("nri,nrj->ij", Hc, Hc)
    if use_gf and gf_mode in ("subset", "hybrid"):
        prior = F.pad(info_prior7, (0, 6, 0, 6)) if gf_mode == "hybrid" else info_prior7
        sel = selection.greedy_maxlogdet_lowrank(factors, cand, k=gf_budget, batch=gf_batch, info_prior=prior)
        match_v = gf_sel_v = sel.selected
    elif use_gf and gf_mode == "lazier":
        sel = selection.lazier_greedy_maxlogdet(blocks, cand, k=gf_budget, gumbel=gf_noise, batch=gf_batch)
        match_v = gf_sel_v = sel.selected
    elif use_gf and gf_mode == "auto":
        sel = selection.auto_maxlogdet(blocks, cand, k_max=gf_budget, gumbel=gf_noise)
        match_v = gf_sel_v = sel.selected
    elif use_gf and gf_mode in ("random", "longlive"):
        if gf_mode == "random":
            pri = gf_noise
        else:
            # Older points first (smaller first keyframe); ids break ties.
            pri = -(m.pt_first_kf[safe_ids].to(torch.float32) + safe_ids.to(torch.float32) / float(P))
        pri = torch.where(visible, pri, -torch.inf)
        kth = top_k_stable(pri, min(gf_budget, pri.shape[0]))[0][-1]
        # Ties at the k-th value all pass, as in the reference.
        match_v = gf_sel_v = visible & (pri >= kth) & torch.isfinite(pri)

    # --- projection matching of all visible candidates into the frame ---
    rad = radius * lc.sf[pred_oct.long()]
    rad = torch.where(cos_view < 0.998, rad * (5.0 / 3.0), rad)
    free_kp = frame.valid & (obs_point == NO_POINT)
    pmask = matching.projection_mask(uv_proj, visible, frame.uv, frame.octave, free_kp, rad, pred_oct)
    res = matching.match(view.desc, frame.desc, pmask, max_dist=matching.TH_HIGH, ratio=0.8, mutual=True)
    hit_all = res.matched & visible
    hit = hit_all & match_v
    if use_gf and gf_mode == "active":
        # Select-then-match by marginal logdet gain over the candidates'
        # precomputed match outcomes, seeded with the same info prior.
        act = active_matching.active_match(blocks, cand, hit, res.idx, info_prior7, budget=gf_budget)
        hit = gf_sel_v = act.matched

    obs = _scatter_ids(N, hit, res.idx, view.ids, base=obs_point)

    # --- pose optimization over the (budgeted) matches ---
    op = torch.clamp(obs, min=0).long()
    sigma2 = lvl_sigma2[frame.octave.long()]
    result = pose_opt.optimize_pose(cam, pose, m.pt_pos[op], frame.uv, 1.0 / sigma2, obs >= 0)
    obs_final = torch.where(result.inliers, obs, NO_POINT)

    # --- deferred matches: matched but outside the GF budget, χ²-gated at
    # the refined pose (mutual matching keeps their slots disjoint) ---
    hit_def = hit_all & ~hit
    obs_def = _scatter_ids(N, hit_def, res.idx, view.ids)
    dp = torch.clamp(obs_def, min=0).long()
    uv_hat_d, _, front_d = project(cam, se3.transform_point(result.pose, m.pt_pos[dp]))
    r_d = frame.uv - uv_hat_d
    chi2_d = torch.sum(r_d * r_d, dim=-1) / sigma2
    keep_d = (obs_def >= 0) & front_d & (chi2_d < pose_opt.HUBER_DELTA2)
    obs_final = torch.where((obs_final == NO_POINT) & keep_d, obs_def, obs_final)

    found = _scatter_mask(P, obs_final >= 0, obs_final)
    return LocalMapTrackResult(
        pose=result.pose,
        obs_point=obs_final,
        n_inliers=result.n_inliers,
        ok=result.n_inliers >= min_inliers,
        local_points=_scatter_mask(P, valid_v, view.ids),
        gf_selected=_scatter_mask(P, gf_sel_v, view.ids),
        visible_points=_scatter_mask(P, visible, view.ids),
        found_points=found,
        n_total=(obs_final >= 0).sum(dtype=torch.int32),
    )


class FusedTrackResult(NamedTuple):
    """Everything the host needs from one WORKING-state frame."""

    pose: torch.Tensor            # (7,)
    obs_point: torch.Tensor       # (N,)
    frame_uv: torch.Tensor        # (N, 2) undistorted keypoints (for next frame)
    frame_octave: torch.Tensor    # (N,)
    frame_angle: torch.Tensor     # (N,)
    frame_desc: torch.Tensor      # (N, 8)
    frame_valid: torch.Tensor     # (N,)
    n_inliers: torch.Tensor       # () int32
    ok: torch.Tensor              # () bool — both stages passed
    velocity: torch.Tensor        # (7,) updated T_cur_last
    pt_visible_add: torch.Tensor  # (P,) bool — this frame's visibility
    pt_found_add: torch.Tensor    # (P,) bool
    pt_visible: torch.Tensor      # (P,) int32 — already-incremented counters
    pt_found: torch.Tensor        # (P,) int32
    n_total: torch.Tensor         # () int32 — LM inliers + deferred matches
    next_key: torch.Tensor        # (2,) per-frame key for the next frame


def track_frame_fused(
    cam: CameraModel,
    orb_cfg,
    m: ms.MapState,
    view: TrackView,
    img: torch.Tensor,
    last_pose: torch.Tensor,
    last_obs: torch.Tensor,
    last_uv: torch.Tensor,
    velocity: torch.Tensor,
    dt,
    key: torch.Tensor,
    scale: float = 1.2,
    n_levels: int = 8,
    gf_budget: int = 100,
    use_gf: bool = False,
    gf_mode: str = "subset",
    gf_batch: int = 1,
    gf_noise: torch.Tensor | None = None,
) -> FusedTrackResult:
    """The per-frame WORKING path: ORB extraction → motion-model tracking
    (with the wide-radius retry) → local-map tracking (+ GF selection, with
    the random modes' `gf_noise`) → velocity update → counter deltas. Runs on
    the device of `img`."""
    return track_frame(
        cam, m, view, make_frame(img, cam, orb_cfg), last_pose, last_obs, last_uv, velocity, dt, key,
        scale=scale, n_levels=n_levels, gf_budget=gf_budget, use_gf=use_gf, gf_mode=gf_mode, gf_batch=gf_batch,
        gf_noise=gf_noise,
    )


def track_frame(
    cam: CameraModel,
    m: ms.MapState,
    view: TrackView,
    frame: FrameData,
    last_pose: torch.Tensor,
    last_obs: torch.Tensor,
    last_uv: torch.Tensor,
    velocity: torch.Tensor,
    dt,
    key: torch.Tensor,
    scale: float = 1.2,
    n_levels: int = 8,
    gf_budget: int = 100,
    use_gf: bool = False,
    gf_mode: str = "subset",
    gf_batch: int = 1,
    gf_noise: torch.Tensor | None = None,
) -> FusedTrackResult:
    """`track_frame_fused` after its ORB extraction: the step on a frame's
    extracted keypoints."""
    pose_pred = se3.compose(velocity, last_pose)

    r = track_with_motion_model(
        cam, m, frame, pose_pred, last_obs, last_uv, scale=scale, n_levels=n_levels, radius=15.0,
    )
    # Widened search from the last pose when the motion model fails. This
    # host branch on r.ok is the step's one device synchronisation; running
    # both branches and selecting (for CUDA-graph capture) is later work.
    if not bool(r.ok):
        r = track_with_motion_model(
            cam, m, frame, last_pose, last_obs, last_uv, scale=scale, n_levels=n_levels, radius=40.0,
        )
    pose1, obs1, ok1 = r.pose, r.obs_point, r.ok

    t0 = torch.zeros((), dtype=pose1.dtype, device=pose1.device)
    dt = torch.as_tensor(dt, dtype=pose1.dtype, device=pose1.device)
    Xv = pwls.state_from_pose_pair(t0, last_pose, t0 + dt, pose1)
    r2 = track_local_map(
        cam, m, view, frame, pose1, obs1, Xv, gf_noise, scale=scale, n_levels=n_levels,
        gf_budget=gf_budget, use_gf=use_gf, gf_mode=gf_mode, gf_batch=gf_batch, dt=dt,
    )
    return FusedTrackResult(
        pose=r2.pose,
        obs_point=r2.obs_point,
        frame_uv=frame.uv,
        frame_octave=frame.octave,
        frame_angle=frame.angle,
        frame_desc=frame.desc,
        frame_valid=frame.valid,
        n_inliers=r2.n_inliers,
        ok=ok1 & r2.ok,
        velocity=se3.compose(r2.pose, se3.inverse(last_pose)),
        pt_visible_add=r2.visible_points,
        pt_found_add=r2.found_points,
        pt_visible=m.pt_visible + r2.visible_points.to(torch.int32),
        pt_found=m.pt_found + r2.found_points.to(torch.int32),
        n_total=r2.n_total,
        next_key=key + torch.arange(2, dtype=key.dtype, device=key.device),  # + [0, 1]
    )


class RelocResult(NamedTuple):
    ok: torch.Tensor          # () bool — relocalized
    pose: torch.Tensor        # (7,)
    obs_point: torch.Tensor   # (N,)
    n_inliers: torch.Tensor   # () int32
    best_kf: torch.Tensor     # (1,) int32 — winning candidate keyframe


def relocalize_fused(
    cam: CameraModel,
    m: ms.MapState,
    db_words: torch.Tensor,   # (K, N) BoW word ids per keyframe keypoint
    frame: FrameData,
    words_f: torch.Tensor,    # (N,) frame word ids
    cand: torch.Tensor,       # (C,) candidate keyframe ids
    cand_ok: torch.Tensor,    # (C,) bool
    generator: torch.Generator,
    scale: float = 1.2,
    n_levels: int = 8,
    view_size: int = 4096,
    n_hypotheses: int = 128,
):
    """Tracking::Relocalisation without a host read: every BoW candidate's
    gated matching and EPnP RANSAC (a loop over the C candidates, where the
    reference vmaps), the best candidate by refined inliers, then local-map
    tracking (GF off) on its covisibility view. Each candidate's PnP samples
    come from `pnp.sample_pnp` with `generator`. Returns (RelocResult,
    TrackView of the winner)."""
    dev = frame.uv.device
    sigma2 = level_consts(scale, n_levels, dev).sigma2[frame.octave.long()]
    oks, poses, n_inl, obs0s = [], [], [], []
    for c in range(cand.shape[0]):
        c1 = cand[c : c + 1].long()
        obs_c = m.kf_obs_point.index_select(0, c1)[0]
        has_pt = m.kf_kp_valid.index_select(0, c1)[0] & (obs_c >= 0)
        mask = kdb.bow_match_mask(words_f, db_words.index_select(0, c1)[0], frame.valid, has_pt)
        res = matching.match(frame.desc, m.kf_kp_desc.index_select(0, c1)[0], mask,
                             max_dist=matching.TH_LOW, ratio=0.75, mutual=True)
        obs_m = obs_c[res.idx.long()]
        pt_ids = torch.clamp(obs_m, min=0).long()
        good = res.matched & (obs_m >= 0) & m.pt_valid[pt_ids] & cand_ok[c]
        good = good & (good.sum() >= 15)
        samples = pnp.sample_pnp(good, n_hypotheses, generator)
        pr = pnp.pnp_ransac(cam, m.pt_pos[pt_ids], frame.uv, sigma2, good, samples)
        oks.append(pr.ok & cand_ok[c])
        poses.append(pr.pose)
        n_inl.append(pr.n_inliers)
        obs0s.append(torch.where(pr.inliers & good, obs_m, NO_POINT))
    oks, n_inl = torch.stack(oks), torch.stack(n_inl)
    j = torch.argmax(torch.where(oks, n_inl, -1), dim=0, keepdim=True)   # (1,): first of the maxima
    best_kf = cand.index_select(0, j)

    view = tv.compute_track_view(m, best_kf, view_size=view_size)
    Xv = torch.zeros(13, dtype=frame.uv.dtype, device=dev).index_fill_(0, torch.full((1,), 3, device=dev), 1.0)
    r2 = track_local_map(cam, m, view, frame, torch.stack(poses).index_select(0, j)[0],
                         torch.stack(obs0s).index_select(0, j)[0], Xv, None,
                         scale=scale, n_levels=n_levels, min_inliers=25, use_gf=False)
    return (
        RelocResult(ok=oks.index_select(0, j)[0] & r2.ok, pose=r2.pose, obs_point=r2.obs_point,
                    n_inliers=r2.n_inliers, best_kf=best_kf.to(torch.int32)),
        view,
    )


def update_point_counters(m: ms.MapState, visible: torch.Tensor, found: torch.Tensor) -> ms.MapState:
    """MapPoint::IncreaseVisible / IncreaseFound bookkeeping."""
    return m._replace(pt_visible=m.pt_visible + visible.to(torch.int32),
                      pt_found=m.pt_found + found.to(torch.int32))


def need_new_keyframe(
    n_inliers: int,
    n_ref_tracked: int,
    frames_since_kf: int,
    frames_since_reloc: int,
    max_frames: int,
) -> bool:
    """Tracking::NeedNewKeyFrame on host scalars: insert when the map is
    getting stale or tracking weakens against the reference keyframe. (The
    reference's `min_frames` gap serves its pipelined system only; the
    synchronous system uses its default, 0.)"""
    if frames_since_reloc < max_frames:
        return False
    c1 = frames_since_kf >= max_frames
    c2 = n_inliers < 0.9 * n_ref_tracked
    return (c1 or c2) and n_inliers >= 15
