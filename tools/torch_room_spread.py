#!/usr/bin/env python3
"""The room circuit's spread over seeds on the CPU, the port's and the
reference's, and the studies that located its outliers.

    python tools/torch_room_spread.py all [--seeds 0 1 2 3 4] [--frames 420] [--jobs 6] \
        [--out results/room_spread]
    python tools/torch_room_spread.py ref --seed 0 [--samples PATH] [--save-map PATH] --out F.json
    python tools/torch_room_spread.py port --seed 0 [--inject PATH] [--ref-frames] [--threads 6] \
        [--graph-no-op] [--save-map PATH] [--dump-correct PATH] --out F.json
    python tools/torch_room_spread.py ref-ba --map PATH --out F.json
    python tools/torch_room_spread.py correct-study --map DUMP --out F.json
    python tools/torch_room_spread.py verify-study --map DUMP [--draws 64] --out F.json
    python tools/torch_room_spread.py c4-table --out DIR

Each run is the 420-frame room circuit (radtan EuRoC camera, scene seed 0,
keyframe cadence 6, GF subset at budget 100, the packaged 1M-word
vocabulary, frames rendered on the CPU and rounded to uint8) in a process of
its own with one intra-op thread. `ref` runs the JAX reference
(`SlamSystem._key = PRNGKey(seed)` as its CLI's `--seed` sets it), `port`
the PyTorch port on the CPU (`SlamSystem(seed=)`; `--threads` intra-op
threads). Each writes one JSON object:

* frame ATE and keyframe ATE (the map's valid keyframes at their
  timestamps, Sim(3)-aligned), each keyframe's aligned error;
* the loop closures (frame, query keyframe, loop keyframe) and, for each,
  how many valid keyframes the correction moved and by how much;
* the first frame where the pose leaves the reference's recorded run
  (`place_fixture.npz` `room_pose`) by more than 1e-3 in any component, and
  where the state, the insertions or the frames' pixel sums first differ.

`ref --samples PATH` also saves the reference's initializer samples (as
tools/make_torch_system_fixture.py does for the bench); `port --inject
PATH` feeds them to the port's initializer and `--ref-frames` the
reference's own renders, so that the run shares the reference's start and
input. `--graph-no-op` keeps the essential graph's input poses, as the
reference's rejected steps keep them. `--save-map PATH` saves the final map
(io_utils/snapshot.py, the reference's schema); `ref-ba` solves a saved
map's global BA with the reference's solvers (Schur `local_ba.bundle_adjust`
5 + 10, 40 and 80 LM; the distributed solver 5 × 25 to 40 × 100 on a mesh of
one) and reports each solve's keyframe ATE and cost against the map's own,
or that it went non-finite; `tools/torch_room_ba_study.py study MAP --device
cpu` solves the same map with the port's solvers. `--graph-no-op`,
`--dump-correct`, `correct-study` and `verify-study` reproduce PERF.md's C5
rows (a reference behaviour since). `port --dump-correct
PATH` saves the first loop correction's map, BoW database, Sim3 and result;
`correct-study` replays it (as run, float32, float64, the graph's poses
kept) against the ground truth, and `verify-study` replays its loop
verification with fresh RANSAC draws on both sides (also on the closures
`tools/torch_endurance.py --dump-closures` saves; C6).

`all` runs the reference and the port at every seed, each saving its map
(seed 0 of the reference also its samples), and the port once injected,
--jobs at a time; then solves every saved map with both sides' solvers
(`ref-ba`; `tools/torch_room_ba_study.py study MAP --device cpu`) and holds
its edges against the ground truth (`torch_room_ba_study.py edges`), and
writes `<out>/*.json`, `<out>/summary.json` and `<out>/c4_table.json`. A
reference run takes 7-11 minutes and a port run 18-24 (one thread each,
six at once); `all` about 45 minutes. `c4-table --out DIR` rebuilds the
table from a directory `all` wrote: per map its keyframe ATE, the
converged keyframe ATE of each solver and its ratio to the map's, its
keyframes, points and edges, and its bad-edge share.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLACE_FIXTURE = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "place_fixture.npz")
FPS = 20.0
DEPART = 1e-3
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
              "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1",
              "JAX_PLATFORMS": "cpu"}


def recorded_room(n: int) -> dict:
    import numpy as np

    with np.load(PLACE_FIXTURE) as z:
        return {"pose": z["room_pose"][:n], "state": z["room_state"][:n],
                "insert_frames": z["room_insert_frames"].tolist(), "loops": z["room_loops"].tolist()}


def first_departures(poses, states, inserts, sums, ref_sums, n: int) -> dict:
    """First frames where this run leaves the recorded reference run."""
    import numpy as np

    rec = recorded_room(n)
    out = {"first_pose_departure": None, "first_state_departure": None, "first_insert_departure": None,
           "first_frame_pixels_differ": None}
    for i in range(n):
        a, b = poses[i], rec["pose"][i]
        if np.isfinite(a[0]) != np.isfinite(b[0]) or (np.isfinite(a[0]) and np.abs(a - b).max() > DEPART):
            out["first_pose_departure"] = i
            break
    diff = np.flatnonzero(np.asarray(states) != rec["state"])
    out["first_state_departure"] = int(diff[0]) if diff.size else None
    ri = [f for f in rec["insert_frames"] if f < n]
    for k, (x, y) in enumerate(zip(inserts, ri)):
        if x != y:
            out["first_insert_departure"] = int(min(x, y))
            break
    else:
        if len(inserts) != len(ri):
            out["first_insert_departure"] = int(min(inserts[len(ri):] + ri[len(inserts):]))
    if ref_sums is not None:
        d = np.flatnonzero(np.asarray(sums) != np.asarray(ref_sums)[:n])
        out["first_frame_pixels_differ"] = int(d[0]) if d.size else None
    return out


def keyframe_errors(centers, kf_frames, gt_centers) -> tuple[float, list]:
    """Keyframe ATE (Sim(3)-aligned) and each keyframe's (frame, error m)."""
    import numpy as np

    from gf_orb_slam_tpu_torch.io_utils import evaluation

    gt = gt_centers[kf_frames]
    s, R, t = evaluation.umeyama_alignment(centers, gt)
    err = np.linalg.norm((s * (R @ centers.T)).T + t - gt, axis=1)
    order = np.argsort(kf_frames)
    return float(np.sqrt((err ** 2).mean())), [[int(kf_frames[j]), round(float(err[j]), 5)] for j in order]


def moved(before, after, valid) -> dict:
    """Valid keyframes a loop correction moved (camera centre or rotation,
    T_cw rows (w, x, y, z, t)), and the largest moves."""
    import numpy as np

    b, a = np.asarray(before, np.float64)[valid], np.asarray(after, np.float64)[valid]
    centre = lambda p: -quat_rotate_inv(p[:, :4], p[:, 4:])  # noqa: E731
    dc = np.linalg.norm(centre(a) - centre(b), axis=1)
    dq = 2 * np.arccos(np.clip(np.abs((a[:, :4] * b[:, :4]).sum(1)) / np.linalg.norm(a[:, :4], axis=1)
                               / np.linalg.norm(b[:, :4], axis=1), 0, 1))
    return {"valid": int(len(dc)), "moved_over_1e-4": int(((dc > 1e-4) | (dq > 1e-4)).sum()),
            "max_centre_move": float(dc.max(initial=0)), "max_rotation_move_rad": float(dq.max(initial=0))}


def quat_rotate_inv(q, t):
    """R(q)ᵀ t for unit quaternions (w, x, y, z), row by row."""
    import numpy as np

    w, v = q[:, :1], -q[:, 1:]
    uv = np.cross(v, t)
    return t + 2 * (w * uv + np.cross(v, uv))


# --------------------------------------------------------------------- reference
def ref(seed: int, n: int, samples_out: str | None, map_out: str | None) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_torch_system_fixture import reference_samples

    from gf_orb_slam_tpu.geometry import se3
    from gf_orb_slam_tpu.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu.io_utils import evaluation, synthetic
    from gf_orb_slam_tpu.loop import loop_closing
    from gf_orb_slam_tpu.pipeline import system as system_mod
    from gf_orb_slam_tpu.retrieval import vocabulary as voc_mod
    from gf_orb_slam_tpu.solvers import initializer

    cam = EUROC_CAM
    cfg = system_mod.SlamConfig(max_frames_between_kf=6, use_gf=True, gf_budget=100, gf_mode="subset",
                                pipelined=False)
    scene = synthetic.make_room_scene(seed=0)
    ts, poses_gt = synthetic.circuit_trajectory(n, fps=FPS, radius=4.0, revs=min(1.1, n / 270.0))
    system = system_mod.SlamSystem(cam, cfg)
    if seed:
        system._seed = seed
        system._key = jax.random.PRNGKey(seed)
    system.set_vocabulary(voc_mod.load_default_vocabulary())

    inserts: list[int] = []
    insert = system._insert_keyframe

    def recording_insert(*a, frame_id=None, **kw):
        inserts.append(int(frame_id))
        return insert(*a, frame_id=frame_id, **kw)

    loops, moves, attempts = [], [], []
    correct = loop_closing.correct_loop

    def recording_correct(m, query_kf, loop_kf, *a, **kw):
        out = correct(m, query_kf, loop_kf, *a, **kw)
        loops.append([system.frame_id, int(query_kf), int(loop_kf)])
        moves.append(moved(np.asarray(m.kf_pose), np.asarray(out.kf_pose), np.asarray(m.kf_valid, bool)))
        return out

    two_view = initializer.initialize_two_view

    def recording_two_view(cam_, uv1, uv2, matched, key, **kw):
        attempts.append((key, np.asarray(matched)))
        return two_view(cam_, uv1, uv2, matched, key, **kw)

    system._insert_keyframe = recording_insert
    loop_closing.correct_loop = recording_correct
    initializer.initialize_two_view = recording_two_view
    states, sums = [], []
    t0 = time.perf_counter()
    try:
        for i in range(n):
            img = np.clip(np.round(np.asarray(synthetic.render_general(scene, cam, jnp.asarray(poses_gt[i])))), 0, 255)
            sums.append(int(img.astype(np.int64).sum()))
            log = system.process(jnp.asarray(img.astype(np.uint8), jnp.float32), float(ts[i]))
            states.append(system_mod.State[log.state].value)
        system.flush()
    finally:
        loop_closing.correct_loop = correct
        initializer.initialize_two_view = two_view
    seconds = time.perf_counter() - t0
    working = [i for i, s in enumerate(states) if s == system_mod.State.WORKING.value]
    if working:
        inserts = [working[0]] + inserts
    poses = np.full((n, 7), np.nan, np.float32)
    for t, p in system.trajectory:
        poses[int(round(t * FPS))] = np.asarray(p)
    gt_centers = np.stack([np.asarray(se3.pose_t(se3.inverse(jnp.asarray(p)))) for p in poses_gt])
    est_ts, est_poses = system.get_trajectory()
    idx = np.rint(np.asarray(est_ts) * FPS).astype(int)
    centers = np.stack([np.asarray(se3.pose_t(se3.inverse(jnp.asarray(p)))) for p in est_poses])
    m = system.map
    valid = np.asarray(m.kf_valid)
    kf_frames = np.abs(np.asarray(ts)[None, :] - np.asarray(m.kf_timestamp)[valid][:, None]).argmin(axis=1)
    kf_centers = np.stack([np.asarray(se3.pose_t(se3.inverse(p))) for p in np.asarray(m.kf_pose)[valid]])
    kf_ate, kf_err = keyframe_errors(kf_centers, kf_frames, gt_centers)
    rec = {"side": "reference", "seed": seed, "frames": n, "seconds": seconds,
           "ate_rmse_m": evaluation.ate_rmse(centers, gt_centers[idx]), "keyframe_ate_m": kf_ate,
           "tracked": len(est_poses), "keyframes_valid": int(valid.sum()), "keyframes_inserted": len(inserts) + 1,
           "loops": loops, "loop_moves": moves, "keyframe_errors": kf_err,
           **first_departures(poses, states, inserts, sums, None, n), "frame_sums": sums}
    if samples_out:
        np.savez_compressed(samples_out, init_samples=np.stack(
            [reference_samples(k, jnp.asarray(mt)) for k, mt in attempts]))
        rec["init_attempts"] = len(attempts)
    if map_out:
        from gf_orb_slam_tpu.io_utils import snapshot

        snapshot.save_map(map_out, system.map, system.voc, system.bow_db)
    return rec


def ref_global_ba(map_path: str, n: int) -> dict:
    """The reference's own global BA of a saved room map (every valid
    keyframe, the first fixed, observations weighted 1/σ², as
    SlamSystem._run_local_ba builds its problem), short and to convergence,
    with each solve's keyframe ATE against the map's own."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, REPO)
    from gf_orb_slam_tpu.geometry import se3
    from gf_orb_slam_tpu.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu.io_utils import snapshot, synthetic
    from gf_orb_slam_tpu.parallel import global_ba
    from gf_orb_slam_tpu.solvers import local_ba

    m, _, _ = snapshot.load_map(map_path)
    ts, poses_gt = synthetic.circuit_trajectory(n, fps=FPS, radius=4.0, revs=min(1.1, n / 270.0))
    gt_centers = np.stack([np.asarray(se3.pose_t(se3.inverse(jnp.asarray(p)))) for p in poses_gt])
    ids = np.flatnonzero(np.asarray(m.kf_valid))
    kf_frames = np.abs(np.asarray(ts)[None, :] - np.asarray(m.kf_timestamp)[ids][:, None]).argmin(axis=1)
    idj = jnp.asarray(ids, jnp.int32)
    obs_point = m.kf_obs_point[idj]
    pts = jnp.zeros(m.pt_capacity, bool).at[jnp.maximum(obs_point.reshape(-1), 0)].max(obs_point.reshape(-1) >= 0)
    sigma2 = jnp.asarray([1.2 ** (2 * i) for i in range(8)])[m.kf_kp_octave[idj]]
    prob = local_ba.BAProblem(
        poses=m.kf_pose[idj], points=m.pt_pos, fixed=jnp.asarray([k == ids[0] for k in ids]),
        point_valid=pts & m.pt_valid, obs_uv=m.kf_kp_uv[idj], obs_point=obs_point,
        obs_w=jnp.where(obs_point >= 0, 1.0 / sigma2, 0.0))
    active0 = (prob.obs_point >= 0) & (prob.obs_w > 0)

    def report(poses, points) -> dict:
        poses = np.asarray(poses)
        finite = bool(np.isfinite(poses).all() and np.isfinite(np.asarray(points)).all())
        out = {"finite": finite, "keyframe_ate_m": None, "cost": None,
               "non_finite_keyframes": int((~np.isfinite(poses).all(axis=1)).sum())}
        if finite:
            c = np.stack([np.asarray(se3.pose_t(se3.inverse(jnp.asarray(p)))) for p in poses])
            out["keyframe_ate_m"] = keyframe_errors(c, kf_frames, gt_centers)[0]
            out["cost"] = float(local_ba._cost(EUROC_CAM, jnp.asarray(poses), points, prob.obs_uv, prob.obs_point,
                                               prob.obs_w, active0))
        return out

    out = {"keyframes": len(ids), "points": int(prob.point_valid.sum()), "edges": int(active0.sum()),
           "map": report(prob.poses, prob.points)}
    for s1, s2 in ((5, 10), (5, 40), (5, 80)):
        res = local_ba.bundle_adjust(EUROC_CAM, prob, iters_stage1=s1, iters_stage2=s2)
        out[f"schur_{s1}_{s2}"] = report(res.poses, res.points)
    mesh = global_ba.make_mesh(1)
    for lm, pcg in ((5, 25), (10, 25), (20, 100), (40, 100)):
        res = global_ba.distributed_bundle_adjust(EUROC_CAM, prob, mesh, lm, pcg)
        out[f"dist_{lm}x{pcg}"] = report(res.poses[: len(ids)], res.points)
    return out


def correct_study(dump: str) -> dict:
    """One saved loop correction (`port --dump-correct`) against the ground
    truth: the keyframe ATE of the map before it, as it happened, recomputed
    in float32 and in float64, and with the essential graph's poses kept (the
    reference's rejected steps); the verified Sim3's rotation against the
    ground truth's relative rotation; the pose graph's cost at its start and
    end in both precisions."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.geometry import quat
    from gf_orb_slam_tpu_torch.geometry import sim3 as s3
    from gf_orb_slam_tpu_torch.io_utils import snapshot
    from gf_orb_slam_tpu_torch.loop import loop_closing
    from gf_orb_slam_tpu_torch.mapping import map_state as ms
    from gf_orb_slam_tpu_torch.solvers import pose_graph

    z = np.load(dump)
    m, _, _ = snapshot.load_map(dump, "cpu")
    q, lk = int(z["query_kf"]), int(z["loop_kf"])
    S12, covis, ts, poses_gt = torch.from_numpy(z["S12"]), torch.from_numpy(z["covis"]), z["ts"], z["poses_gt"]
    valid = m.kf_valid.numpy()
    frames = np.abs(np.asarray(ts)[None, :] - m.kf_timestamp.numpy()[:, None]).argmin(axis=1)
    gt_c = run_slam.camera_centers(poses_gt)

    def kf_ate(poses) -> float:
        return keyframe_errors(run_slam.camera_centers(np.asarray(poses, np.float32)[valid]), frames[valid], gt_c)[0]

    costs = {}
    optimize = pose_graph.optimize_pose_graph

    def traced(prob, n_iters=20):
        out = optimize(prob, n_iters)
        i, j = prob.edge_i.long(), prob.edge_j.long()
        zeros = torch.zeros((i.shape[0], 7), dtype=prob.poses.dtype)

        def cost(P):
            r = pose_graph._edge_residual(zeros, zeros, P[i], P[j], prob.edge_meas)
            return float(torch.sum(torch.where(prob.edge_valid, prob.edge_weight * torch.sum(r * r, -1), 0.0)))

        costs[str(prob.poses.dtype)] = {"start": cost(prob.poses), "end": cost(out),
                                        "edges": int(prob.edge_valid.sum())}
        return out

    pose_graph.optimize_pose_graph = traced
    try:
        f32 = loop_closing.correct_loop(m, q, lk, S12, covis).kf_pose
        m64 = ms.MapState(*(t.double() if t.is_floating_point() else t for t in m))
        f64 = loop_closing.correct_loop(m64, q, lk, S12.double(), covis).kf_pose
        pose_graph.optimize_pose_graph = lambda prob, n_iters=20: prob.poses
        kept = loop_closing.correct_loop(m, q, lk, S12, covis).kf_pose
    finally:
        pose_graph.optimize_pose_graph = optimize
    # The verified Sim3 (loop camera → query camera) against the ground truth's relative rotation.
    q_gt = quat.qprod(torch.from_numpy(poses_gt[frames[q]][:4]), quat.qconj(torch.from_numpy(poses_gt[frames[lk]][:4])))
    q_s = s3.q_of(S12) / torch.linalg.norm(s3.q_of(S12))
    rot_err = float(2 * torch.arccos(torch.clamp(torch.abs(torch.sum(q_gt * q_s)), 0, 1)))
    return {"query_kf": q, "loop_kf": lk, "query_frame": int(frames[q]), "loop_frame": int(frames[lk]),
            "keyframe_ate_m": {"before": kf_ate(m.kf_pose.numpy()), "as_run": kf_ate(z["out_kf_pose"]),
                               "float32": kf_ate(f32.numpy()), "float64": kf_ate(f64.numpy()),
                               "graph_kept": kf_ate(kept.numpy())},
            "sim3_rotation_error_rad": rot_err, "sim3_scale": float(s3.s_of(S12)), "pose_graph_cost": costs}


def verify_study(dump: str, draws: int) -> dict:
    """The saved correction's loop verification replayed `draws` times with
    fresh RANSAC draws, by the port (torch generators 0..draws−1) and by the
    reference (PRNG keys 0..draws−1), on the same map and BoW database:
    accepted share, and the accepted Sim3s' rotation error against the
    ground truth's relative rotation and their scale over the ground truth's
    ratio of the map's scales at the two keyframes
    (`io_utils/loop_eval.sim3_against_ground_truth`); how many accepted Sim3s are ≥ 5° off
    in rotation or ≥ 10% off in scale. The reference's verification is held
    to the same numbers as the port's. Takes `port --dump-correct` files and
    `tools/torch_endurance.py --dump-closures` files alike."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from gf_orb_slam_tpu.io_utils import snapshot as jsnap
    from gf_orb_slam_tpu.loop import loop_closing as jlc
    from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu_torch.io_utils import loop_eval, snapshot
    from gf_orb_slam_tpu_torch.loop import loop_closing

    from gf_orb_slam_tpu.geometry.camera import EUROC_CAM as JCAM

    z = np.load(dump)
    q, lk, poses_gt = int(z["query_kf"]), int(z["loop_kf"]), z["poses_gt"]
    m, _, db = snapshot.load_map(dump, "cpu")
    jm, _, jdb = jsnap.load_map(dump)
    kf = (m.kf_pose.numpy(), m.kf_frame_id.numpy(), m.kf_valid.numpy(), poses_gt)

    def against_gt(S) -> dict:
        return loop_eval.sim3_against_ground_truth(np.asarray(S, np.float64), q, lk, *kf)

    out = {}
    for side in ("port", "reference"):
        rows = []
        for k in range(draws):
            if side == "port":
                lm = loop_closing.verify_candidate(EUROC_CAM, m, db, q, lk, torch.Generator().manual_seed(k))
                ok, S, n_r, n_o = bool(lm.ok), lm.S12.numpy(), int(lm.n_ransac), int(lm.n_inliers)
            else:
                lm = jlc.verify_candidate(JCAM, jm, jdb, jnp.asarray(q), jnp.asarray(lk), jax.random.PRNGKey(k))
                ok, S, n_r, n_o = bool(lm.ok), np.asarray(lm.S12), int(lm.n_ransac), int(lm.n_inliers)
            g = against_gt(S)
            rows.append({"ok": ok, "rot_err_rad": float(np.deg2rad(g["rotation_error_deg"])), "n_ransac": n_r,
                         "n_opt": n_o, "scale_error": g["scale_error"]})
        acc = [r for r in rows if r["ok"]]
        over_rot = [r["rot_err_rad"] > float(np.deg2rad(5)) for r in acc]
        over_scale = [abs(r["scale_error"] - 1) >= 0.1 for r in acc]
        out[side] = {"draws": draws, "accepted": len(acc),
                     "accepted_rot_err_rad": sorted(round(r["rot_err_rad"], 4) for r in acc),
                     "accepted_scale_error": sorted(round(r["scale_error"], 4) for r in acc),
                     "accepted_over_5deg": sum(over_rot), "accepted_scale_off_10pct": sum(over_scale),
                     "accepted_wrong": sum(a or b for a, b in zip(over_rot, over_scale)),
                     "n_ransac": [r["n_ransac"] for r in rows], "n_opt": [r["n_opt"] for r in rows]}
    fid = kf[1]
    return {"dump": os.path.basename(dump), "query_kf": q, "loop_kf": lk, "query_frame": int(fid[q]),
            "loop_frame": int(fid[lk]), "gt_scale_ratio": loop_eval.map_scale_ratio(q, lk, *kf), **out}


# --------------------------------------------------------------------- port
def reference_frames(n: int):
    """The room circuit's frames as the reference renders them (JAX on the
    CPU), rounded to uint8 values, as a float32 tensor."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from gf_orb_slam_tpu.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu.io_utils import synthetic

    scene = synthetic.make_room_scene(seed=0)
    _, poses_gt = synthetic.circuit_trajectory(n, fps=FPS, radius=4.0, revs=min(1.1, n / 270.0))
    return torch.from_numpy(np.stack([np.clip(np.round(np.asarray(synthetic.render_general(
        scene, EUROC_CAM, jnp.asarray(poses_gt[i])))), 0, 255) for i in range(n)]).astype(np.float32))


def port(seed: int, n: int, inject: str | None, ref_json: str | None, ref_frames: bool = False,
         threads: int = 1, map_out: str | None = None, graph_no_op: bool = False,
         dump_correct: str | None = None) -> dict:
    import numpy as np
    import torch

    torch.set_num_threads(threads)
    sys.path.insert(0, REPO)
    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu_torch.loop import loop_closing
    from gf_orb_slam_tpu_torch.pipeline import system as system_mod
    from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod
    from gf_orb_slam_tpu_torch.solvers import initializer

    ts, poses_gt, frames = run_slam.render_sequence(EUROC_CAM, n, 0, "cpu", scene="room")
    if ref_frames:
        frames = reference_frames(n)
    sums = frames.to(torch.int64).flatten(1).sum(1).tolist()
    voc = voc_mod.load_default_vocabulary("cpu")
    loops, moves = [], []
    correct = loop_closing.correct_loop
    holder: dict = {}

    def recording_correct(m, query_kf, loop_kf, *a, **kw):
        out = correct(m, query_kf, loop_kf, *a, **kw)
        if dump_correct and not loops:  # the first correction's inputs and output
            from gf_orb_slam_tpu_torch.io_utils import snapshot

            snapshot.save_map(dump_correct, m, holder["system"].voc, holder["system"].bow_db)
            with np.load(dump_correct) as z:
                arrays = dict(z)
            np.savez_compressed(dump_correct, **arrays, query_kf=int(query_kf), loop_kf=int(loop_kf),
                                S12=a[0].numpy(), covis=a[1].numpy(), out_kf_pose=out.kf_pose.numpy(),
                                out_pt_pos=out.pt_pos.numpy(), ts=ts, poses_gt=poses_gt)
        loops.append([holder["system"].frame_id, int(query_kf), int(loop_kf)])
        moves.append(moved(m.kf_pose.numpy(), out.kf_pose.numpy(), m.kf_valid.numpy()))
        return out

    sample = initializer.sample_hypotheses
    calls = []
    if inject:
        recorded = [torch.from_numpy(s).long() for s in np.load(inject)["init_samples"]]

        def injected(matched, n_hypotheses, generator):
            calls.append(n_hypotheses)
            return recorded[len(calls) - 1]

        initializer.sample_hypotheses = injected
    loop_closing.correct_loop = recording_correct
    from gf_orb_slam_tpu_torch.solvers import pose_graph

    optimize = pose_graph.optimize_pose_graph
    if graph_no_op:  # the reference's essential graph, whose steps are all rejected (ROADMAP)
        pose_graph.optimize_pose_graph = lambda prob, n_iters=20: prob.poses
    system = system_mod.SlamSystem(EUROC_CAM, run_slam.room_config(), device="cpu", seed=seed)
    holder["system"] = system
    system.set_vocabulary(voc)
    states, inserts = [], []
    t0 = time.perf_counter()
    try:
        for i in range(n):
            log = system.process(frames[i], float(ts[i]))
            states.append(system_mod.State[log.state].value)
            if "keyframe_insert" in log.timing_ms:
                inserts.append(i)
        system.flush()
    finally:
        loop_closing.correct_loop = correct
        initializer.sample_hypotheses = sample
        pose_graph.optimize_pose_graph = optimize
    if map_out:
        from gf_orb_slam_tpu_torch.io_utils import snapshot

        snapshot.save_map(map_out, system.map, system.voc, system.bow_db)
    seconds = time.perf_counter() - t0
    working = [i for i, s in enumerate(states) if s == system_mod.State.WORKING.value]
    if working:
        inserts = [working[0]] + inserts
    poses = np.full((n, 7), np.nan, np.float32)
    for t, p in system.trajectory:
        poses[int(round(t * FPS))] = np.asarray(p)
    gt_centers = run_slam.camera_centers(poses_gt)
    est_ts, est_poses = system.get_trajectory()
    idx = np.rint(np.asarray(est_ts) * FPS).astype(int)
    from gf_orb_slam_tpu_torch.io_utils import evaluation

    m = system.map
    valid = m.kf_valid.numpy()
    kf_frames = np.abs(np.asarray(ts)[None, :] - m.kf_timestamp.numpy()[valid][:, None]).argmin(axis=1)
    kf_ate, kf_err = keyframe_errors(run_slam.camera_centers(m.kf_pose.numpy()[valid]), kf_frames, gt_centers)
    ref_sums = None
    if ref_json and os.path.exists(ref_json):
        with open(ref_json) as f:
            ref_sums = json.load(f).get("frame_sums")
    return {"side": "port", "seed": seed, "injected": bool(inject), "injected_draws": len(calls),
            "reference_frames": ref_frames, "threads": threads, "graph_no_op": graph_no_op, "frames": n,
            "seconds": seconds, "ate_rmse_m": evaluation.ate_rmse(run_slam.camera_centers(est_poses), gt_centers[idx]),
            "keyframe_ate_m": kf_ate, "tracked": len(est_poses), "keyframes_valid": int(valid.sum()),
            "keyframes_inserted": len(inserts) + 1, "loops": loops, "loop_moves": moves, "keyframe_errors": kf_err,
            **first_departures(poses, states, inserts, sums, ref_sums, n)}


# --------------------------------------------------------------------- all runs
def run_child(argv: list[str], log: str, script: str = os.path.abspath(__file__)) -> int:
    env = dict(os.environ, **ONE_THREAD)
    with open(log, "w") as f:
        return subprocess.run([sys.executable, script, *argv], env=env, stdout=f,
                              stderr=subprocess.STDOUT, cwd=REPO).returncode


def run_all(seeds: list[int], n: int, jobs: int, out: str) -> None:
    os.makedirs(out, exist_ok=True)
    samples = os.path.join(out, "ref_init_samples.npz")
    p = lambda name: os.path.join(out, name)  # noqa: E731
    ref_jobs = [["ref", "--seed", str(s), "--frames", str(n), "--save-map", p(f"ref_map_{s}.npz"),
                 "--out", p(f"ref_{s}.json")] + (["--samples", samples] if s == 0 else []) for s in seeds]
    port_jobs = [["port", "--seed", str(s), "--frames", str(n), "--ref-json", p("ref_0.json"),
                  "--save-map", p(f"port_map_{s}.npz"), "--out", p(f"port_{s}.json")] for s in seeds]
    inject_job = ["port", "--seed", "0", "--frames", str(n), "--inject", samples, "--ref-frames",
                  "--ref-json", p("ref_0.json"), "--out", p("port_injected.json")]
    study = os.path.join(REPO, "tools", "torch_room_ba_study.py")
    maps = [(side, s) for side in ("ref", "port") for s in seeds]
    with ThreadPoolExecutor(jobs) as ex:
        first = ex.submit(run_child, ref_jobs[0], p("ref_0.log"))
        rest = [ex.submit(run_child, j, p(j[-1].rsplit("/", 1)[-1].replace(".json", ".log")))
                for j in ref_jobs[1:] + port_jobs]
        first.result()
        rest.append(ex.submit(run_child, inject_job, p("port_injected.log")))
        codes = [f.result() for f in rest]
        solves = [ex.submit(run_child, ["ref-ba", "--map", p(f"{side}_map_{s}.npz"), "--frames", str(n),
                                        "--out", p(f"refba_{side}_{s}.json")], p(f"refba_{side}_{s}.log"))
                  for side, s in maps]
        solves += [ex.submit(run_child, ["study", p(f"{side}_map_{s}.npz"), "--device", "cpu"],
                             p(f"study_{side}_{s}.log"), script=study) for side, s in maps]
        codes += [f.result() for f in solves]
    codes.append(run_child(["edges", *[p(f"{side}_map_{s}.npz") for side, s in maps], "--out", p("edges.json")],
                           p("edges.log"), script=study))
    summary = []
    for name in sorted(os.listdir(out)):
        if name.endswith(".json") and name.startswith(("ref_", "port_")):
            with open(p(name)) as f:
                r = json.load(f)
            summary.append({k: r.get(k) for k in ("side", "seed", "injected", "ate_rmse_m", "keyframe_ate_m",
                                                   "loops", "first_pose_departure", "first_state_departure",
                                                   "first_insert_departure", "first_frame_pixels_differ",
                                                   "tracked", "keyframes_valid", "seconds")})
            print(json.dumps(summary[-1]), flush=True)
    with open(p("summary.json"), "w") as f:
        json.dump({"runs": summary, "exit_codes": codes}, f, indent=1)
    c4_table(out)


def c4_table(out: str) -> list:
    """Per saved map of `all`: its keyframe ATE, each converged solve's
    (the reference's Schur 5 + 40 and distributed 5 × 25, the port's Schur
    5 + 40 and distributed 40 × 100) with its ratio to the map's, its size
    and its bad-edge share against the ground truth; then each side's
    ratios and their ranges. Each row also names the map's keyframe family:
    whether a valid keyframe lies at frames 101-104 (`kf_at_101_104`), and
    the valid keyframes' frames either side of frame 100 (`kf_around_100`).
    Writes <out>/c4_table.json."""
    import numpy as np

    p = lambda name: os.path.join(out, name)  # noqa: E731
    edges = {}
    if os.path.exists(p("edges.json")):
        with open(p("edges.json")) as f:
            edges = {e["map"]: e for e in json.load(f)}
    rows = []
    for side in ("ref", "port"):
        for name in sorted(os.listdir(out)):
            if not (name.startswith(f"refba_{side}_") and name.endswith(".json")):
                continue
            seed = int(name[len(f"refba_{side}_"):-5])
            with open(p(name)) as f:
                rb = json.load(f)
            with open(p(f"study_{side}_{seed}.log")) as f:
                st = next(json.loads(line) for line in f if line.startswith('{"run"'))
            m = rb["map"]["keyframe_ate_m"]

            def cell(v):
                return None if v is None else {"keyframe_ate_m": v, "ratio": v / m}

            e = edges.get(f"{side}_map_{seed}.npz", {})
            with np.load(p(f"{side}_map_{seed}.npz")) as z:
                frames = np.sort(z["map_kf_frame_id"][z["map_kf_valid"]])
            around = np.searchsorted(frames, 100, side="right")
            rows.append({"side": side, "seed": seed, "keyframes": rb["keyframes"], "points": rb["points"],
                         "edges": rb["edges"], "map_keyframe_ate_m": m,
                         "kf_at_101_104": bool(((frames >= 101) & (frames <= 104)).any()),
                         "kf_around_100": [int(x) for x in frames[max(around - 1, 0):around + 1]],
                         "ref_schur_5_40": cell(rb["schur_5_40"]["keyframe_ate_m"]),
                         "ref_dist_5x25": cell(rb["dist_5x25"]["keyframe_ate_m"]),
                         "port_schur_5_40": cell(st["schur_5_40"]["keyframe_ate_m"]),
                         "port_dist_40x100": cell(st["dist_40x100"]["keyframe_ate_m"]),
                         "bad_edge_share": e.get("all", {}).get("bad_share")})
    spread = {}
    for side in ("ref", "port"):
        ratios = [r[k]["ratio"] for r in rows if r["side"] == side
                  for k in ("ref_schur_5_40", "port_schur_5_40", "port_dist_40x100") if r[k]]
        spread[side] = {"ratios": len(ratios), "lowered": sum(x < 1 for x in ratios),
                        "range": [min(ratios), max(ratios)] if ratios else None,
                        "maps": sum(r["side"] == side for r in rows),
                        "maps_without_kf_at_101_104": sum(r["side"] == side and not r["kf_at_101_104"]
                                                          for r in rows)}
    with open(p("c4_table.json"), "w") as f:
        json.dump({"rows": rows, "spread": spread}, f, indent=1)
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps(spread), flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["all", "ref", "port", "ref-ba", "correct-study", "verify-study", "c4-table"])
    ap.add_argument("--draws", type=int, default=32, help="verify-study: RANSAC draws per side")
    ap.add_argument("--map", help="ref-ba: a map snapshot")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--frames", type=int, default=420)
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--samples")
    ap.add_argument("--save-map")
    ap.add_argument("--inject")
    ap.add_argument("--ref-json")
    ap.add_argument("--ref-frames", action="store_true", help="port: run on the reference's renders")
    ap.add_argument("--threads", type=int, default=1, help="port: intra-op threads")
    ap.add_argument("--dump-correct", help="port: save the first loop correction's inputs and output here")
    ap.add_argument("--graph-no-op", action="store_true",
                    help="port: keep the essential graph's poses, as the reference's rejected steps do")
    ap.add_argument("--out", default=os.path.join(REPO, "results", "room_spread"))
    args = ap.parse_args()
    if args.mode == "all":
        run_all(args.seeds, args.frames, args.jobs, args.out)
        return
    if args.mode == "c4-table":
        c4_table(args.out)
        return
    if args.mode == "ref-ba":
        rec = ref_global_ba(args.map, args.frames)
    elif args.mode == "correct-study":
        rec = correct_study(args.map)
    elif args.mode == "verify-study":
        rec = verify_study(args.map, args.draws)
    elif args.mode == "ref":
        rec = ref(args.seed, args.frames, args.samples, args.save_map)
    else:
        rec = port(args.seed, args.frames, args.inject, args.ref_json, args.ref_frames, args.threads, args.save_map,
                   args.graph_no_op, args.dump_correct)
    with open(args.out, "w") as f:
        json.dump(rec, f)
    print(json.dumps({k: v for k, v in rec.items() if k not in ("frame_sums", "keyframe_errors")}))


if __name__ == "__main__":
    main()
