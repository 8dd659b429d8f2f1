#!/usr/bin/env python
"""Write the room fixture that the PyTorch port's room path is held against
stage by stage: one run of the JAX reference's synchronous `SlamSystem` on
the CPU over the reference CLI's room circuit (`run_slam.py --synthetic 420
--scene room --gf-budget 100`: the radtan-distorted EuRoC camera, keyframe
cadence 6, GF subset mode at budget 100, scene seed 0, PRNG key 0, frames
rounded to uint8) with the packaged 1M-word vocabulary preset. It takes
about 10 minutes on the CPU.

    python tools/make_torch_room_fixture.py [--out PATH]

Output: gf_orb_slam_tpu_torch/data/room_fixture.npz (under 10 MB; maps are
stored as row deltas, io_utils/map_delta.py), holding

* (d) the reference's final map in the snapshot schema (`map_*` keys, read
  by `snapshot.load_map`), its valid keyframes' ids, frames and
  ground-truth camera centres (`final_kf_*`), and the keyframe ATE of the
  map and of the reference's Schur global BA (5 + 40 LM) of it;
* (a) the first insertion at or after frame INSERT_FRAME (200): the map before it
  (`ins_in`), the arguments `insert_keyframe_fused` received (`ins_arg_*`,
  already padded to the map's keypoint capacity) and the reference's map
  after it (`ins_out`, with `ins_kf_id`, `ins_culled_kf`, `ins_view_ids`);
  and the same insertion replayed piece by piece with the reference's own
  functions, each piece's input and output: the new keyframe added
  (`ins_add`), each triangulation (`ins_tri{i}_out`, `ins_tri_ids`,
  `ins_tri_w`), point culling (`ins_cull_out`, `ins_n_obs`), the two-way
  fuse (`ins_fuse_*`), the window BA (`ins_ba_*`: the problem and the
  result), the map before keyframe culling (`ins_pre_cull`) and the
  redundancy of the culling candidates (`ins_red_rows`, `ins_red`);
* (b) the tracking step on the TRACK_FRAMES (3) frames after (a), then on
  frame GF_STOP_FRAME (236), where the reference's GF selection picks no
  point (its info prior is indefinite within float32 round-off and its
  Cholesky returns NaN): per step j the map and view in (`trk{j}_map`,
  `trk{j}_view_*`), the state in, the frame as the reference extracted it
  (uv, octave, angle, descriptors, validity; no pixels), the pose,
  `obs_point`, `n_inliers`, `n_total` and `ok` out, and the reference's
  GF pick count (`trk{j}_gf_picks`, from the step traced again with a
  counting selection, which must reproduce the recorded pose);
* (c) the first loop correction: the map before `correct_loop`
  (`loop_in`), `loop_query_kf`, `loop_loop_kf`, the verified
  `loop_S12`, `loop_covis`, the reference's optimized essential graph
  (`loop_S_opt`) and its map after the correction (`loop_out`).

`meta` is a JSON string with the configuration, the run's summary and the
git commit. Each map's keyframe keypoint rows never change after insertion
(no compaction in 420 frames), which the tool checks.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gf_orb_slam_tpu.geometry import se3  # noqa: E402
from gf_orb_slam_tpu.geometry.camera import EUROC_CAM  # noqa: E402
from gf_orb_slam_tpu.gf import selection  # noqa: E402
from gf_orb_slam_tpu.io_utils import evaluation, snapshot, synthetic  # noqa: E402
from gf_orb_slam_tpu.loop import loop_closing  # noqa: E402
from gf_orb_slam_tpu.mapping import keyframe_ops  # noqa: E402
from gf_orb_slam_tpu.mapping import map_state as ms  # noqa: E402
from gf_orb_slam_tpu.pipeline import local_mapping, tracking  # noqa: E402
from gf_orb_slam_tpu.pipeline import system as system_mod  # noqa: E402
from gf_orb_slam_tpu.retrieval import vocabulary as voc_mod  # noqa: E402
from gf_orb_slam_tpu.solvers import local_ba, pose_graph  # noqa: E402
from gf_orb_slam_tpu_torch.io_utils import map_delta  # noqa: E402

OUT = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "room_fixture.npz")
FPS = 20.0
N_FRAMES = 420
INSERT_FRAME = 200
TRACK_FRAMES = 3
GF_STOP_FRAME = 236
MAX_BYTES = 10 * 1024 * 1024
KP_FIELDS = ("kf_kp_uv", "kf_kp_octave", "kf_kp_angle", "kf_kp_desc", "kf_kp_valid")


def _commit() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def host(tree) -> dict:
    """A NamedTuple of device arrays as field → numpy copy (copies: the
    insertion donates its map)."""
    return {k: np.array(v, copy=True) for k, v in tree._asdict().items()}


def to_map(d: dict) -> ms.MapState:
    return ms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def select(do, new: ms.MapState, old: ms.MapState) -> ms.MapState:
    return jax.tree.map(lambda a, b: jnp.where(do, a, b), new, old)


def replay_insertion(cam, m, pose, frame_id, timestamp, kp_uv, kp_octave, kp_angle, kp_desc, kp_valid,
                     obs_point, scale, n_levels, ba_window, ba_fixed, n_tri_neighbors, ba_points, ba_iters,
                     n_fuse_neighbors=4, view_size=4096):
    """local_mapping.insert_keyframe_fused (reference local_mapping.py:41-337)
    step by step with the reference's own functions, returning every
    piece's input and output as numpy."""
    rec = {}
    m, kf_id = ms.add_keyframe(m, pose, frame_id, timestamp, kp_uv, kp_octave, kp_angle, kp_desc, kp_valid,
                               obs_point)
    rec["add"] = host(m)
    rec["kf_id"] = int(kf_id)
    w_row = ms.covisibility_row(m, kf_id)
    centers = se3.pose_t(se3.inverse(m.kf_pose))
    baseline = jnp.linalg.norm(centers - centers[kf_id], axis=-1)
    obs_new = m.kf_obs_point[kf_id]
    has_new = obs_new >= 0
    depth_ref = jnp.sum(jnp.where(has_new, jnp.linalg.norm(m.pt_pos[jnp.maximum(obs_new, 0)] - centers[kf_id],
                                                             axis=-1), 0.0)) / jnp.maximum(jnp.sum(has_new), 1)
    w_eff = jnp.where(baseline > 0.02 * depth_ref, w_row, 0)
    top_w, top_ids = jax.lax.top_k(w_eff, n_tri_neighbors)
    rec["tri_ids"], rec["tri_w"] = np.asarray(top_ids), np.asarray(top_w)
    for i in range(n_tri_neighbors):
        rec[f"tri{i}_in"] = host(m)
        m_tri = keyframe_ops.triangulate_between(cam, m, kf_id, top_ids[i], frame_id, scale=scale,
                                                 n_levels=n_levels)
        rec[f"tri{i}_out"] = host(m_tri)
        m = select(top_w[i] >= 10, m_tri, m)
    cnt_raw = ms.point_observation_count_raw(m)
    rec["cull_in"] = host(m)
    rec["n_obs"] = np.asarray(cnt_raw * m.pt_valid.astype(jnp.int32))
    m = keyframe_ops.cull_points(m, kf_id, n_obs=cnt_raw * m.pt_valid.astype(jnp.int32))
    rec["cull_out"] = host(m)

    N, P = m.kp_capacity, m.pt_capacity
    fw, fuse_ids = jax.lax.top_k(w_row, n_fuse_neighbors)
    fuse_ok = fw >= 10
    obs_nb = m.kf_obs_point[fuse_ids]
    nb_ok = (obs_nb >= 0) & fuse_ok[:, None]
    member = jnp.zeros((P,), bool).at[jnp.where(nb_ok, obs_nb, P).reshape(-1)].set(True, mode="drop")
    order = jnp.where(member, jnp.arange(P, dtype=jnp.int32), P)
    Mf = min(max(ba_points, N), P)
    cand1 = -jax.lax.top_k(-order, Mf)[0]
    use1 = cand1 < P
    cand2 = m.kf_obs_point[kf_id]
    c2 = jnp.full((Mf,), ms.NO_POINT, jnp.int32).at[: min(cand2.shape[0], Mf)].set(cand2[:Mf])
    targets = jnp.concatenate([kf_id[None], fuse_ids])
    t_ok = jnp.concatenate([jnp.ones(1, bool), fuse_ok])
    cands = jnp.concatenate([jnp.minimum(cand1, P - 1)[None],
                             jnp.broadcast_to(jnp.maximum(c2, 0)[None], (n_fuse_neighbors, Mf))])
    uses = jnp.concatenate([use1[None], jnp.broadcast_to((c2 >= 0)[None], (n_fuse_neighbors, Mf))])
    n_obs_fuse = cnt_raw * m.pt_valid.astype(jnp.int32)
    rec.update(fuse_targets=np.asarray(targets), fuse_t_ok=np.asarray(t_ok), fuse_cands=np.asarray(cands),
               fuse_uses=np.asarray(uses), fuse_n_obs=np.asarray(n_obs_fuse))
    m = keyframe_ops.fuse_points_into_keyframes(cam, m, targets, t_ok, cands, uses, scale=scale,
                                                n_levels=n_levels, n_obs=n_obs_fuse)
    rec["fuse_out"] = host(m)

    w_row2 = w_row.at[kf_id].set(jnp.int32(1 << 30))
    top_w2, win_ids = jax.lax.top_k(w_row2, ba_window)
    active = top_w2 > 0
    order = jnp.argsort(jnp.where(active, win_ids, jnp.int32(1 << 30)))
    win_ids, active = win_ids[order], active[order]
    obs_local = jnp.where(active[:, None], m.kf_obs_point[win_ids], ms.NO_POINT)
    local_pts = jnp.zeros(P, bool).at[jnp.maximum(obs_local.reshape(-1), 0)].max(obs_local.reshape(-1) >= 0)
    local_pts = local_pts & m.pt_valid
    sigma2 = jnp.asarray([scale ** (2 * i) for i in range(n_levels)])[m.kf_kp_octave[win_ids]]
    n_active = jnp.sum(active.astype(jnp.int32))
    rank = jnp.cumsum(active.astype(jnp.int32)) - 1
    fixed = (~active) | (rank < jnp.minimum(ba_fixed, jnp.maximum(n_active - 1, 1)))
    L = ba_points
    local_idx = jax.lax.top_k(local_pts.astype(jnp.int32), L)[1].astype(jnp.int32)
    l_valid = local_pts[local_idx]
    inv = jnp.full((P,), L, jnp.int32).at[local_idx].set(jnp.arange(L, dtype=jnp.int32))
    obs_lidx = inv[jnp.maximum(obs_local, 0)]
    in_ba = (obs_local >= 0) & (obs_lidx < L)
    obs_l = jnp.where(in_ba, obs_lidx, ms.NO_POINT)
    prob = local_ba.BAProblem(poses=m.kf_pose[win_ids], points=m.pt_pos[local_idx], fixed=fixed,
                              point_valid=l_valid, obs_uv=m.kf_kp_uv[win_ids], obs_point=obs_l,
                              obs_w=jnp.where(obs_l >= 0, 1.0 / sigma2, 0.0))
    res = local_ba.bundle_adjust(cam, prob, iters_stage1=ba_iters[0], iters_stage2=ba_iters[1])
    rec.update({f"ba_{k}": np.asarray(v) for k, v in prob._asdict().items()})
    rec.update(ba_win_ids=np.asarray(win_ids), ba_local_idx=np.asarray(local_idx), ba_out_poses=np.asarray(res.poses),
               ba_out_points=np.asarray(res.points), ba_out_obs_active=np.asarray(res.obs_active),
               ba_out_cost=np.asarray(res.cost))
    safe_ids = jnp.where(active, win_ids, m.kf_capacity)
    keep_obs = jnp.where(in_ba, res.obs_active, obs_local >= 0)
    m = m._replace(
        kf_pose=m.kf_pose.at[safe_ids].set(res.poses, mode="drop"),
        pt_pos=m.pt_pos.at[jnp.where(l_valid, local_idx, P)].set(res.points, mode="drop"),
        kf_obs_point=m.kf_obs_point.at[safe_ids].set(jnp.where(keep_obs, obs_local, ms.NO_POINT), mode="drop"),
    )
    C = ba_window
    desc_w = m.kf_kp_desc[win_ids]
    obs_keep = jnp.where(keep_obs, obs_l, ms.NO_POINT)
    slot = jnp.where(obs_keep >= 0, obs_keep, L)
    c_idx = jax.lax.broadcasted_iota(jnp.int32, slot.shape, 0)
    Dw = jnp.zeros((L + 1, C, 8), jnp.uint32).at[slot, c_idx].set(desc_w, mode="drop")
    Hw = jnp.zeros((L + 1, C), bool).at[slot, c_idx].set(True, mode="drop")
    dmat = jnp.sum(jax.lax.population_count(jnp.bitwise_xor(Dw[:, :, None, :], Dw[:, None, :, :])),
                   axis=-1).astype(jnp.int32)
    dmat = jnp.where(Hw[:, :, None] & Hw[:, None, :], dmat, 0)
    sums = jnp.where(Hw, jnp.sum(dmat, axis=2), jnp.int32(1 << 30))
    best = jnp.argmin(sums, axis=1)
    new_desc = jnp.take_along_axis(Dw, best[:, None, None], axis=1)[:, 0]
    upd = Hw.any(axis=1)[:L] & l_valid
    m = m._replace(pt_desc=m.pt_desc.at[jnp.where(upd, local_idx, P)].set(new_desc[:L], mode="drop"))
    m = ms.refresh_point_stats(m, scale=scale, n_levels=n_levels, update_desc=False)
    rec["pre_cull"] = host(m)

    cull_rows = jax.lax.top_k(w_row, min(32, m.kf_capacity))[1]
    red = keyframe_ops.keyframe_redundancy(m, n_levels=n_levels, rows=cull_rows)
    rec["red_rows"], rec["red"] = np.asarray(cull_rows), np.asarray(red)
    protect = (cull_rows <= 1) | (cull_rows >= kf_id - 2) | (w_row[cull_rows] <= 0)
    red = jnp.where(protect, 0.0, red)
    j = jnp.argmax(red)
    m = select(red[j] > 0.9, ms.erase_keyframe(m, cull_rows[j].astype(jnp.int32)), m)
    rec["out"] = host(m)
    return rec


def reference_gf_picks(track, r: dict) -> int:
    """The reference's GF pick count on a recorded step: the step traced
    again with a selection that reports its count, on the recorded inputs.
    Raises unless the traced-again step reproduces the recorded pose and
    inlier count."""
    counts: list[int] = []
    select = selection.greedy_maxlogdet_lowrank

    def counted(*a, **kw):
        res = select(*a, **kw)
        jax.debug.callback(lambda c: counts.append(int(c)), res.n_selected)
        return res

    selection.greedy_maxlogdet_lowrank = counted
    jax.clear_caches()  # the step's inner jitted functions hold traces of the selection
    try:
        step = jax.jit(track.__wrapped__, static_argnames=tuple(r["kw"]) + ("cam", "orb_cfg"))
        res = step(r["cam"], r["orb_cfg"], to_map(r["map"]), r["view_type"](**r["view"]), jnp.asarray(r["img"]),
                   *(jnp.asarray(x) for x in r["state"]), **r["kw"])
        jax.effects_barrier()
    finally:
        selection.greedy_maxlogdet_lowrank = select
    if (len(counts) != 1 or not np.array_equal(np.asarray(res.pose), r["out"]["pose"])
            or int(res.n_inliers) != int(r["out"]["n_inliers"])):
        raise SystemExit(f"frame {r['frame']}: the step traced again does not reproduce the recorded one "
                         f"(selection calls {len(counts)}, n_inliers {int(res.n_inliers)})")
    return counts[0]


def keyframe_ate(poses: np.ndarray, gt_centers: np.ndarray) -> float:
    centers = np.stack([np.asarray(se3.pose_t(se3.inverse(jnp.asarray(p)))) for p in poses])
    s, R, t = evaluation.umeyama_alignment(centers.astype(np.float64), gt_centers.astype(np.float64))
    err = np.linalg.norm((s * (R @ centers.T)).T + t - gt_centers, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    n = N_FRAMES
    cam = EUROC_CAM
    cfg = system_mod.SlamConfig(max_frames_between_kf=6, use_gf=True, gf_budget=100, gf_mode="subset",
                                pipelined=False)
    scene = synthetic.make_room_scene(seed=0)
    ts, poses_gt = synthetic.circuit_trajectory(n, fps=FPS, radius=4.0, revs=min(1.1, n / 270.0))
    gt_centers = np.stack([np.asarray(se3.pose_t(se3.inverse(jnp.asarray(p)))) for p in poses_gt])
    system = system_mod.SlamSystem(cam, cfg)
    system.set_vocabulary(voc_mod.load_default_vocabulary())
    out: dict = {}
    ins: dict = {}
    trk: list = []
    loop: dict = {}

    insert = local_mapping.insert_keyframe_fused

    def recording_insert(cam_, m, *a, **kw):
        frame_id = int(a[1])
        if ins or frame_id < INSERT_FRAME:
            return insert(cam_, m, *a, **kw)
        ins.update(frame=frame_id, kw=kw, m_in=host(m),
                   args=[np.array(x, copy=True) for x in a])
        res = insert(cam_, to_map(ins["m_in"]), *a, **kw)
        ins.update(out=host(res.m), kf_id=int(res.kf_id), culled=int(res.culled_kf),
                   view_ids=np.asarray(res.view.ids))
        return res

    track = tracking.track_frame_fused

    def recording_track(cam_, orb_cfg, m, view, img, *a, **kw):
        frame_id = system.frame_id
        record = (ins and len(trk) < TRACK_FRAMES and frame_id > ins["frame"]) or frame_id == GF_STOP_FRAME
        if record:
            r = {"frame": frame_id, "map": host(m), "view": host(view), "view_type": type(view),
                 "img": np.array(img, copy=True), "state": [np.array(x, copy=True) for x in a], "kw": kw,
                 "cam": cam_, "orb_cfg": orb_cfg}
        res = track(cam_, orb_cfg, m, view, img, *a, **kw)
        if record:
            r["out"] = {k: np.asarray(getattr(res, k)) for k in (
                "pose", "obs_point", "n_inliers", "n_total", "ok", "frame_uv", "frame_octave", "frame_angle",
                "frame_desc", "frame_valid")}
            trk.append(r)
        return res

    correct = loop_closing.correct_loop

    def recording_correct(m, query_kf, loop_kf, S12, covis, **kw):
        first = not loop
        if first:
            loop.update(frame=system.frame_id, m_in=host(m), query_kf=int(query_kf), loop_kf=int(loop_kf),
                        S12=np.asarray(S12), covis=np.asarray(covis))
        res = correct(m, query_kf, loop_kf, S12, covis, **kw)
        if first:
            loop["out"] = host(res)
            # The optimized graph, from the same function unjitted (the graph
            # is jitted on its own), and that run's map against the jitted one.
            optimize = pose_graph.optimize_pose_graph
            graphs = []

            def recording_graph(prob, n_iters=20):
                graphs.append(optimize(prob, n_iters=n_iters))
                return graphs[-1]

            pose_graph.optimize_pose_graph = recording_graph
            try:
                replay = correct.__wrapped__(to_map(loop["m_in"]), query_kf, loop_kf, S12, covis, **kw)
            finally:
                pose_graph.optimize_pose_graph = optimize
            loop["S_opt"] = np.asarray(graphs[0])
            loop["replay_agreement"] = map_delta.agreement(host(replay), loop["out"])
        return res

    local_mapping.insert_keyframe_fused = recording_insert
    tracking.track_frame_fused = recording_track
    loop_closing.correct_loop = recording_correct
    t0 = time.perf_counter()
    try:
        for i in range(n):
            img = np.clip(np.round(np.asarray(synthetic.render_general(scene, cam, jnp.asarray(poses_gt[i])))), 0, 255)
            log = system.process(jnp.asarray(img.astype(np.uint8), jnp.float32), float(ts[i]))
            if i % 20 == 0:
                print(f"frame {i}: {log.state} n_inliers={log.n_inliers} n_kf={system.n_kf} "
                      f"loops={system.n_loops_closed} {time.perf_counter() - t0:.0f}s", flush=True)
        system.flush()
    finally:
        local_mapping.insert_keyframe_fused = insert
        tracking.track_frame_fused = track
        loop_closing.correct_loop = correct
    seconds = time.perf_counter() - t0
    if not ins or len(trk) != TRACK_FRAMES + 1 or trk[-1]["frame"] != GF_STOP_FRAME:
        raise SystemExit(f"no insertion at or after frame {INSERT_FRAME}, too few tracked frames after it, or frame "
                         f"{GF_STOP_FRAME} not tracked")
    for r in trk:
        r["gf_picks"] = reference_gf_picks(track, r)
    if trk[-1]["gf_picks"] != 0:
        raise SystemExit(f"frame {GF_STOP_FRAME}: the reference picked {trk[-1]['gf_picks']} points, not none")

    # (d) the final map, whole, in the snapshot schema.
    fm = system.map
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.npz")
        snapshot.save_map(path, fm)
        with np.load(path) as z:
            out.update({k: z[k] for k in z.files})
    final = map_delta.whole(out)
    kf_ids = np.flatnonzero(final["kf_valid"])
    kf_frames = np.abs(np.asarray(ts)[None, :] - final["kf_timestamp"][kf_ids][:, None]).argmin(axis=1)
    gt = gt_centers[kf_frames]
    # The reference's Schur global BA of the final map (every valid
    # keyframe, the first fixed, observations weighted 1/σ²).
    idj = jnp.asarray(kf_ids, jnp.int32)
    obs = fm.kf_obs_point[idj]
    pts = jnp.zeros(fm.pt_capacity, bool).at[jnp.maximum(obs.reshape(-1), 0)].max(obs.reshape(-1) >= 0)
    sigma2 = jnp.asarray([1.2 ** (2 * i) for i in range(8)])[fm.kf_kp_octave[idj]]
    prob = local_ba.BAProblem(poses=fm.kf_pose[idj], points=fm.pt_pos, fixed=jnp.arange(len(kf_ids)) == 0,
                              point_valid=pts & fm.pt_valid, obs_uv=fm.kf_kp_uv[idj], obs_point=obs,
                              obs_w=jnp.where(obs >= 0, 1.0 / sigma2, 0.0))
    ba = local_ba.bundle_adjust(cam, prob, iters_stage1=5, iters_stage2=40)
    out.update(final_kf_ids=kf_ids.astype(np.int32), final_kf_frames=kf_frames.astype(np.int32),
               final_kf_gt_centers=gt.astype(np.float32), final_schur_5_40_kf_pose=np.asarray(ba.poses),
               final_keyframe_ate_m=np.float64(keyframe_ate(np.asarray(fm.kf_pose)[kf_ids], gt)),
               final_schur_5_40_keyframe_ate_m=np.float64(keyframe_ate(np.asarray(ba.poses), gt)))

    def check_kp(name, d):
        for f in KP_FIELDS:
            rows = d["n_kf"]
            if not np.array_equal(d[f][:rows], final[f][:rows]):
                raise SystemExit(f"{name}.{f}: keyframe keypoint rows changed after insertion")

    def put(name, d, base, base_name):
        check_kp(name, d)
        out.update(map_delta.encode(name, d, base, base_name))

    # (a) the insertion and its pieces.
    a = ins["args"]
    put("ins_in", ins["m_in"], final, "map")
    out.update({f"ins_arg_{k}": v for k, v in zip(
        ("pose", "frame_id", "timestamp", "kp_uv", "kp_octave", "kp_angle", "kp_desc", "kp_valid", "obs_point"), a)})
    put("ins_out", ins["out"], ins["m_in"], "ins_in")
    out.update(ins_kf_id=np.int32(ins["kf_id"]), ins_culled_kf=np.int32(ins["culled"]), ins_view_ids=ins["view_ids"])
    rec = replay_insertion(cam, to_map(ins["m_in"]), *(jnp.asarray(x) for x in a), **ins["kw"])
    put("ins_add", rec["add"], ins["m_in"], "ins_in")
    prev, prev_name = rec["add"], "ins_add"
    for i in range(len(rec["tri_ids"])):
        # tri{i}_in is tri{i-1}_out where that neighbour triangulated, else its input.
        assert all(np.array_equal(rec[f"tri{i}_in"][k], prev[k]) for k in prev)
        put(f"ins_tri{i}_out", rec[f"tri{i}_out"], prev, prev_name)
        if rec["tri_w"][i] >= 10:
            prev, prev_name = rec[f"tri{i}_out"], f"ins_tri{i}_out"
    assert all(np.array_equal(rec["cull_in"][k], prev[k]) for k in prev)
    out["ins_cull_in"] = np.asarray(prev_name)
    put("ins_cull_out", rec["cull_out"], prev, prev_name)
    put("ins_fuse_out", rec["fuse_out"], rec["cull_out"], "ins_cull_out")
    put("ins_pre_cull", rec["pre_cull"], rec["fuse_out"], "ins_fuse_out")
    put("ins_replay_out", rec["out"], rec["pre_cull"], "ins_pre_cull")
    for k in ("tri_ids", "tri_w", "n_obs", "fuse_targets", "fuse_t_ok", "fuse_cands", "fuse_uses", "fuse_n_obs",
              "ba_poses", "ba_points", "ba_fixed", "ba_point_valid", "ba_obs_uv", "ba_obs_point", "ba_obs_w",
              "ba_win_ids", "ba_local_idx", "ba_out_poses", "ba_out_points", "ba_out_obs_active", "ba_out_cost",
              "red_rows", "red"):
        out[f"ins_{k}"] = rec[k]
    replay_vs_fused = map_delta.agreement(rec["out"], ins["out"])

    # (b) the tracked frames after it.
    prev, prev_name = ins["out"], "ins_out"
    for j, r in enumerate(trk):
        put(f"trk{j}_map", r["map"], prev, prev_name)
        prev, prev_name = r["map"], f"trk{j}_map"
        out.update({f"trk{j}_view_{k}": v for k, v in r["view"].items()})
        out.update({f"trk{j}_{k}": v for k, v in zip(("last_pose", "last_obs", "last_uv", "velocity", "dt", "key"),
                                                     r["state"])})
        out.update({f"trk{j}_out_{k}": v for k, v in r["out"].items()})
        out[f"trk{j}_frame"] = np.int32(r["frame"])
        out[f"trk{j}_gf_picks"] = np.int32(r["gf_picks"])

    # (c) the loop correction.
    if loop:
        put("loop_in", loop["m_in"], final, "map")
        put("loop_out", loop["out"], loop["m_in"], "loop_in")
        out.update(loop_query_kf=np.int32(loop["query_kf"]), loop_loop_kf=np.int32(loop["loop_kf"]),
                   loop_S12=loop["S12"], loop_covis=loop["covis"], loop_S_opt=loop["S_opt"],
                   loop_frame=np.int32(loop["frame"]))

    meta = {
        "camera": cam._asdict(),
        "slam_config": {k: v for k, v in cfg.__dict__.items() if isinstance(v, (int, float, bool, str, tuple))},
        "orb_config": system.orb_cfg._asdict(),
        "insert_kw": {k: list(v) if isinstance(v, tuple) else v for k, v in ins["kw"].items()},
        "track_kw": {k: v for k, v in trk[0]["kw"].items()},
        "scene_seed": 0, "frames": n, "fps": FPS, "seconds": seconds,
        "insert_frame": ins["frame"], "track_frames": [r["frame"] for r in trk],
        "track_gf_picks": [r["gf_picks"] for r in trk],
        "loop_frame": loop.get("frame"), "loops_closed": system.n_loops_closed,
        "keyframes_valid": int(len(kf_ids)), "points_valid": int(final["pt_valid"].sum()),
        "final_keyframe_ate_m": float(out["final_keyframe_ate_m"]),
        "final_schur_5_40_keyframe_ate_m": float(out["final_schur_5_40_keyframe_ate_m"]),
        "insertion_replay_vs_fused": replay_vs_fused,
        "loop_replay_vs_jit": loop.get("replay_agreement"),
        "commit": _commit(),
    }
    out["meta"] = np.asarray(json.dumps(meta))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **out)
    size = os.path.getsize(args.out)
    print(json.dumps({"out": args.out, "bytes": size, **{k: v for k, v in meta.items() if k not in (
        "camera", "slam_config", "orb_config")}}))
    if size > MAX_BYTES:
        raise SystemExit(f"{args.out} is {size} bytes, over {MAX_BYTES}")


if __name__ == "__main__":
    main()
