#!/usr/bin/env python3
"""Global BA on the room circuit's loop-corrected maps, against the ground truth.

    python tools/torch_room_ba_study.py record [--runs 2] [--out chiprun_out/room_maps.npz]
    python tools/torch_room_ba_study.py study PATH [--device cpu]
    python tools/torch_room_ba_study.py edges PATH [PATH ...] [--out F.json]
    python tools/torch_room_ba_study.py ablate PATH [PATH ...]

`record` runs the 420-frame room circuit (`run_slam.room_config()`, the
packaged 1M-word vocabulary, scene seed 0) --runs times on the first CUDA
card with its default (non-deterministic) kernels, as `chip_smoke.py` phase 7
does, and saves each run's global-BA problem (every valid keyframe, the first
fixed; `SlamSystem.ba_problem`) with the ground-truth camera centres of its
keyframes to --out; then it runs `study` on the card.

PATH is a file `record` wrote, or a saved map of the 420-frame room circuit
(io_utils/snapshot.py's schema, which the port and the reference share;
`tools/torch_room_spread.py --save-map` writes one from either side), whose
problem `study` builds as `record` does. `study` solves each saved problem
with the distributed solver on an in-process group of one (10 LM × 25 PCG,
as phase 11, and 40 × 100) and with the Schur solver (5 + 10 LM, as phase
11, and 5 + 40); then the two on one problem, the Schur 5 + 40 with no
pruning and the distributed 40 × 100 over the edges the Schur keeps after
its first 5 LM, with the converged keyframe-ATE ratios of each pairing
(`converged_ate_ratio`); and prints for each solve the Huber cost, the keyframe
ATE (Sim(3)-aligned), each keyframe's aligned error, and the edges whose χ²
exceeds the Huber threshold. One JSON line per map. Two suspects of a
biased optimum are checked beside them: `pyramid_exact` re-solves (Schur
5 + 40) with each observation mapped from its level to level 0 through the
pyramid's centre-aligned resizes, in place of the reference's
`xy · 1.2^level`; `undistort_roundtrip_px` is the largest
pixel error of the camera's undistortion, distorted back, over the image.

`edges` holds each map's observations against the ground truth: every
point with >= 2 observing keyframes is re-triangulated (multi-view DLT)
from its observations under the ground-truth poses of its observers, and an
edge counts as bad where its reprojection error there exceeds 5.991·σ² of
its octave. It reports the map's keyframe ATE and the bad share of its
edges, split by the point's observation count, by octave, by whether the
point's observers span the loop (first and last observer >= 10 keyframes
apart, SlamConfig.loop_min_kf_gap) and by duplicate edges (one keyframe
holding one point in two slots). PATH is anything `study` reads, or the
room fixture (gf_orb_slam_tpu_torch/data/room_fixture.npz: its final map).
One JSON line per map; --out also writes them as one JSON list.

`ablate` asks whether a class of edges moves the converged optimum: per map
the Schur solve (5 + 40 LM) with all edges, and without each class in turn
(the edges `edges` calls bad, the duplicate slots of a (keyframe, point)
but its finest octave, the loop-spanning edges, octaves >= 3, the two
initial keyframes' rows), each as its keyframe ATE over the map's; and the
same solve started from the ground truth (its poses in the map's gauge, the
points solved with the poses held), with the Huber cost there and at the
solve's end. CPU, one JSON line per map.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FIELDS = ("poses", "points", "fixed", "point_valid", "obs_uv", "obs_point", "obs_w")
ROOM_FRAMES = 420


def problem_arrays(system, m, ts, poses_gt, r: int) -> dict:
    """Run r's global-BA problem of map m (every valid keyframe, the first
    fixed) with its keyframes' frames and ground-truth camera centres."""
    import numpy as np
    import torch

    from gf_orb_slam_tpu_torch import run_slam

    ids = torch.nonzero(m.kf_valid).flatten().tolist()
    prob, _, _, _ = system.ba_problem(m, ids, fixed_ids=ids[:1])
    frame = np.abs(np.asarray(ts)[None, :] - m.kf_timestamp.cpu().numpy()[ids][:, None]).argmin(axis=1)
    arrays = {f"run{r}_{f}": getattr(prob, f).cpu().numpy() for f in FIELDS}
    arrays[f"run{r}_gt_centers"] = run_slam.camera_centers(poses_gt)[frame]
    arrays[f"run{r}_kf_frame"] = frame
    arrays[f"run{r}_kf_ids"] = np.asarray(ids)
    return arrays


def snapshot_problem(path: str) -> dict:
    """A saved room map as the arrays `record` writes for one run."""
    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu_torch.io_utils import snapshot, synthetic
    from gf_orb_slam_tpu_torch.pipeline.system import SlamSystem

    m, _, _ = snapshot.load_map(path, "cpu")
    ts, poses_gt = synthetic.circuit_trajectory(ROOM_FRAMES, fps=EUROC_CAM.fps, radius=4.0,
                                                revs=run_slam.circuit_revs(ROOM_FRAMES))
    system = SlamSystem(EUROC_CAM, run_slam.room_config(), device="cpu")
    return {"runs": 1, **problem_arrays(system, m, ts, poses_gt, 0)}


def record(runs: int, out: str) -> None:
    import numpy as np
    import torch

    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

    dev = torch.device("cuda")
    ts, poses_gt, frames = run_slam.render_sequence(EUROC_CAM, ROOM_FRAMES, 0, dev, scene="room")
    voc = voc_mod.load_default_vocabulary(dev)
    arrays = {}
    for r in range(runs):
        t0 = time.perf_counter()
        system, result = run_slam.run_sequence(EUROC_CAM, run_slam.room_config(), ts, poses_gt, frames, dev,
                                               vocabulary=voc)
        arrays.update(problem_arrays(system, system.map, ts, poses_gt, r))
        print(json.dumps({"run": r, "seconds": time.perf_counter() - t0,
                          "keyframes": len(arrays[f"run{r}_kf_frame"]), "ate_rmse_m": result.get("ate_rmse_m"),
                          "loops_closed": result.get("loops_closed"),
                          "keyframe_frames": arrays[f"run{r}_kf_frame"].tolist()}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, runs=runs, **arrays)
    study(out, "cuda")


def study(path: str, device: str) -> None:
    import numpy as np
    import torch

    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu_torch.io_utils import evaluation
    from gf_orb_slam_tpu_torch.parallel import global_ba, launch
    from gf_orb_slam_tpu_torch.solvers import local_ba
    from gf_orb_slam_tpu_torch.solvers.local_ba import HUBER2

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    cam = EUROC_CAM
    z = map_problem_arrays(path)
    group = launch.nccl_group() if dev.type == "cuda" else launch.gloo_group()
    with group as g:
        for r in range(int(z["runs"])):
            prob = local_ba.BAProblem(**{f: torch.from_numpy(z[f"run{r}_{f}"]).to(dev) for f in FIELDS})
            gt = z[f"run{r}_gt_centers"]
            active0 = (prob.obs_point >= 0) & (prob.obs_w > 0)

            def report(poses, points):
                centers = run_slam.camera_centers(poses.cpu().numpy().astype(np.float64))
                s, R, t = evaluation.umeyama_alignment(centers, gt)
                err = np.linalg.norm((s * (R @ centers.T)).T + t - gt, axis=1)
                res, _, _, ok = local_ba._edge_terms(cam, poses, points, prob.obs_uv, prob.obs_point, active0)
                chi2 = torch.sum(res * res, dim=-1) * prob.obs_w
                return {"cost": float(local_ba._cost(cam, poses, points, prob.obs_uv, prob.obs_point, prob.obs_w,
                                                     active0)),
                        "keyframe_ate_m": float(np.sqrt((err ** 2).mean())), "scale": s,
                        "kf_err_cm": [round(float(e) * 100, 3) for e in err],
                        "edges_over_huber": int((active0 & ok & (chi2 > HUBER2)).sum()),
                        "edges_behind": int((active0 & ~ok).sum())}

            rec = {"run": r, "keyframes": int(prob.poses.shape[0]), "points": int(prob.point_valid.sum()),
                   "edges": int(active0.sum()),
                   "edges_per_keyframe": active0.sum(1).tolist(),
                   "initial": report(prob.poses, prob.points)}
            for name, (lm, pcg) in {"dist_10x25": (10, 25), "dist_40x100": (40, 100)}.items():
                res = global_ba.gather_result(global_ba.distributed_bundle_adjust(cam, prob, g, lm, pcg),
                                              prob.poses.shape[0], g)
                rec[name] = report(res.poses, res.points)
            for name, (s1, s2) in {"schur_5_10": (5, 10), "schur_5_40": (5, 40)}.items():
                res = local_ba.bundle_adjust(cam, prob, iters_stage1=s1, iters_stage2=s2)
                rec[name] = report(res.poses, res.points)
            # The two solvers on one problem: the Schur solve unpruned, and
            # the distributed solve over the edges the Schur keeps after its
            # first stage.
            res = local_ba.bundle_adjust(cam, prob, iters_stage1=5, iters_stage2=40, chi2_prune=float("inf"))
            rec["schur_5_40_unpruned"] = report(res.poses, res.points)
            kept = local_ba.bundle_adjust(cam, prob, iters_stage1=5, iters_stage2=0).obs_active
            pruned = prob._replace(obs_w=torch.where(kept, prob.obs_w, torch.zeros_like(prob.obs_w)))
            res = global_ba.gather_result(global_ba.distributed_bundle_adjust(cam, pruned, g, 40, 100),
                                          prob.poses.shape[0], g)
            rec["dist_40x100_pruned"] = report(res.poses, res.points) | {"edges_pruned": int((active0 & ~kept).sum())}
            rec["converged_ate_ratio"] = {
                k: rec[a]["keyframe_ate_m"] / rec[b]["keyframe_ate_m"]
                for k, (a, b) in {"dist_over_schur": ("dist_40x100", "schur_5_40"),
                                  "dist_over_schur_unpruned": ("dist_40x100", "schur_5_40_unpruned"),
                                  "dist_pruned_over_schur": ("dist_40x100_pruned", "schur_5_40")}.items()}
            exact = prob._replace(obs_uv=pyramid_exact_uv(cam, prob.obs_uv, prob.obs_w))
            res = local_ba.bundle_adjust(cam, exact, iters_stage1=5, iters_stage2=40)
            rec["pyramid_exact"] = report(res.poses, res.points) | {
                "cost_on_its_observations": float(local_ba._cost(cam, res.poses, res.points, exact.obs_uv,
                                                                 prob.obs_point, prob.obs_w, active0)),
                "max_shift_px": float((exact.obs_uv - prob.obs_uv)[active0].abs().max())}
            print(json.dumps(rec), flush=True)
    print(json.dumps({"undistort_roundtrip_px": undistort_roundtrip_px(cam)}), flush=True)


def map_problem_arrays(path: str) -> dict:
    """The `record` arrays of PATH (a `record` file or a saved map)."""
    import numpy as np

    z = np.load(path)
    return {k: z[k] for k in z.files} if "runs" in z else snapshot_problem(path)


def edge_classes(arrays: dict, r: int, cam, loop_gap: int = 10, bad_mask: bool = False):
    """Run r's edges held against the ground truth (see the module
    docstring): the share of edges over 5.991·σ² at the point re-triangulated
    under the ground-truth poses, in total and by class."""
    import numpy as np
    import torch

    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.geometry import se3
    from gf_orb_slam_tpu_torch.io_utils import evaluation, synthetic

    poses = arrays[f"run{r}_poses"]
    obs_point, obs_uv, obs_w = arrays[f"run{r}_obs_point"], arrays[f"run{r}_obs_uv"], arrays[f"run{r}_obs_w"]
    gt_c = arrays[f"run{r}_gt_centers"]
    frames = arrays[f"run{r}_kf_frame"]
    _, poses_gt = synthetic.circuit_trajectory(ROOM_FRAMES, fps=cam.fps, radius=4.0,
                                               revs=run_slam.circuit_revs(ROOM_FRAMES))
    C = poses.shape[0]
    centers = run_slam.camera_centers(poses).astype(np.float64)
    s, R, t = evaluation.umeyama_alignment(centers, gt_c.astype(np.float64))
    kf_ate = float(np.sqrt((np.linalg.norm((s * (R @ centers.T)).T + t - gt_c, axis=1) ** 2).mean()))
    # Ground-truth projection matrices K [R | t] of the keyframes.
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]])
    Pm = K @ se3.pose_matrix(torch.from_numpy(poses_gt[frames].astype(np.float64))).numpy()[:, :3]  # (C, 3, 4)
    c_idx, n_idx = np.nonzero((obs_point >= 0) & arrays[f"run{r}_point_valid"][np.maximum(obs_point, 0)])
    pid = obs_point[c_idx, n_idx]
    uv = obs_uv[c_idx, n_idx].astype(np.float64)
    sigma2 = 1.0 / obs_w[c_idx, n_idx].astype(np.float64)
    octave = np.rint(np.log(sigma2) / np.log(1.2 ** 2)).astype(int)
    pts, inv = np.unique(pid, return_inverse=True)
    n_obs = np.bincount(inv)
    first = np.full(pts.size, C, int)
    last = np.full(pts.size, -1, int)
    np.minimum.at(first, inv, c_idx)
    np.maximum.at(last, inv, c_idx)
    kf_id = arrays.get(f"run{r}_kf_ids", np.arange(C))
    span = (kf_id[last] - kf_id[first]) >= loop_gap
    dup_pair = np.zeros(c_idx.size, bool)
    key = c_idx.astype(np.int64) * (pid.max() + 1) + pid
    u, cnt = np.unique(key, return_counts=True)
    dup_pair[np.isin(key, u[cnt > 1])] = True
    # Multi-view DLT per point, rows padded with zeros to the largest count.
    order = np.argsort(inv, kind="stable")
    slot = np.arange(order.size) - np.repeat(np.cumsum(n_obs) - n_obs, n_obs)
    A = np.zeros((pts.size, 2 * n_obs.max(), 4))
    P_e = Pm[c_idx[order]]
    A[inv[order], 2 * slot] = uv[order, :1] * P_e[:, 2] - P_e[:, 0]
    A[inv[order], 2 * slot + 1] = uv[order, 1:] * P_e[:, 2] - P_e[:, 1]
    X = np.linalg.svd(A)[2][:, -1]                                                 # (points, 4)
    X = X / np.where(np.abs(X[:, 3:]) < 1e-12, 1e-12, X[:, 3:])                   # the null vector's sign is free
    Xh = X[inv]
    proj = np.einsum("eij,ej->ei", Pm[c_idx], Xh)
    z = proj[:, 2]
    err2 = np.sum((proj[:, :2] / np.where(np.abs(z) < 1e-12, 1e-12, z)[:, None] - uv) ** 2, axis=1)
    multi = n_obs[inv] >= 2
    bad = ((err2 > 5.991 * sigma2) | (z <= 0)) & multi
    if bad_mask:  # the bad edges as (keyframe row, slot) indices
        return c_idx[bad], n_idx[bad]

    def share(mask) -> dict:
        m = mask & multi
        return {"edges": int(m.sum()), "bad": int((bad & m).sum()),
                "bad_share": round(float((bad & m).sum() / max(m.sum(), 1)), 5)}

    n_e = n_obs[inv]
    by_count = {"2": n_e == 2, "3": n_e == 3, "4-5": (n_e >= 4) & (n_e <= 5), "6-9": (n_e >= 6) & (n_e <= 9),
                ">=10": n_e >= 10}
    return {"run": r, "keyframes": C, "points_multi": int((n_obs >= 2).sum()), "keyframe_ate_m": kf_ate,
            "all": share(np.ones_like(bad)),
            "by_obs_count": {k: share(v) for k, v in by_count.items()},
            "by_octave": {str(o): share(octave == o) for o in range(8)},
            "loop_span": {"spans": share(span[inv]), "within": share(~span[inv])},
            "duplicate": {"duplicate": share(dup_pair), "single": share(~dup_pair)}}


def ablate(path: str, cam) -> dict:
    """See the module docstring: `ablate` on one map (run 0)."""
    import numpy as np
    import torch

    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.geometry import quat, se3
    from gf_orb_slam_tpu_torch.io_utils import evaluation, synthetic
    from gf_orb_slam_tpu_torch.solvers import local_ba

    a = map_problem_arrays(path)
    prob = local_ba.BAProblem(**{f: torch.from_numpy(a[f"run0_{f}"]) for f in FIELDS})
    obs, w, ids = a["run0_obs_point"], a["run0_obs_w"], a.get("run0_kf_ids", np.arange(len(a["run0_poses"])))
    gt = a["run0_gt_centers"].astype(np.float64)

    def ate(poses) -> float:
        c = run_slam.camera_centers(poses).astype(np.float64)
        s, R, t = evaluation.umeyama_alignment(c, gt)
        return float(np.sqrt((np.linalg.norm((s * (R @ c.T)).T + t - gt, axis=1) ** 2).mean()))

    def solve(p):
        return local_ba.bundle_adjust(cam, p, iters_stage1=5, iters_stage2=40)

    def without(drop):
        o = np.where(drop, -1, obs).astype(np.int32)
        return round(ate(solve(prob._replace(obs_point=torch.from_numpy(o), obs_w=torch.from_numpy(
            np.where(o >= 0, w, 0).astype(np.float32)))).poses.numpy()) / m, 4)

    m = ate(prob.poses.numpy())
    valid = (obs >= 0) & a["run0_point_valid"][np.maximum(obs, 0)]
    octave = np.rint(np.log(1 / np.where(valid, w, 1)) / np.log(1.44)).astype(int)
    dup = np.zeros_like(valid)
    for c in range(obs.shape[0]):  # every slot of a (keyframe, point) but its finest octave
        order = np.argsort(np.where(valid[c], octave[c], 99), kind="stable")
        _, first = np.unique(obs[c, order], return_index=True)
        keep = np.zeros(obs.shape[1], bool)
        keep[order[first]] = True
        dup[c] = valid[c] & ~keep
    cc, nn = np.nonzero(valid)
    pid = obs[cc, nn]
    lo = np.full(pid.max() + 1, 1 << 30)
    hi = np.full(pid.max() + 1, -1)
    np.minimum.at(lo, pid, ids[cc])
    np.maximum.at(hi, pid, ids[cc])
    span = np.zeros_like(valid)
    span[cc, nn] = (hi - lo)[pid] >= 10
    bad = np.zeros_like(valid)
    bad[edge_classes(a, 0, cam, bad_mask=True)] = True
    rec = {"map": os.path.basename(path), "keyframe_ate_m": m, "all": without(np.zeros_like(valid)),
           "without_bad": without(bad), "without_duplicates": without(dup), "without_loop_span": without(span),
           "without_octave_ge3": without(valid & (octave >= 3)),
           "without_initial_keyframes": without(np.arange(obs.shape[0])[:, None] < 2)}
    # The ground truth in the map's gauge: x_gt = s R x_map + t, so T_cw_map = T_cw_gt ∘ (s R, t) / s.
    _, poses_gt = synthetic.circuit_trajectory(ROOM_FRAMES, fps=cam.fps, radius=4.0,
                                               revs=run_slam.circuit_revs(ROOM_FRAMES))
    s_, R_, t_ = evaluation.umeyama_alignment(run_slam.camera_centers(prob.poses.numpy()).astype(np.float64), gt)
    T = se3.pose_matrix(torch.from_numpy(poses_gt[a["run0_kf_frame"]].astype(np.float64))).numpy()
    P_gt = torch.cat([quat.r2q(torch.from_numpy(T[:, :3, :3] @ R_).float()),
                      torch.from_numpy((T[:, :3, :3] @ t_ + T[:, :3, 3]) / s_).float()], 1)
    pts = local_ba.bundle_adjust(cam, prob._replace(poses=P_gt, fixed=torch.ones_like(prob.fixed)),
                                 iters_stage1=5, iters_stage2=20).points
    active0 = (prob.obs_point >= 0) & (prob.obs_w > 0)

    def cost(p, x):
        return float(local_ba._cost(cam, p, x, prob.obs_uv, prob.obs_point, prob.obs_w, active0))

    from_map, from_gt = solve(prob), solve(prob._replace(poses=P_gt, points=pts))
    rec.update(cost_at_ground_truth=cost(P_gt, pts), cost_solved=cost(from_map.poses, from_map.points),
               cost_solved_from_ground_truth=cost(from_gt.poses, from_gt.points),
               from_ground_truth=round(ate(from_gt.poses.numpy()) / m, 4))
    return rec


def edges(paths: list[str], out: str | None) -> None:
    from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM

    rows = []
    for path in paths:
        arrays = map_problem_arrays(path)
        for r in range(int(arrays["runs"])):
            rows.append({"map": os.path.basename(path), **edge_classes(arrays, r, EUROC_CAM)})
            print(json.dumps(rows[-1]), flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(rows, f, indent=1)


def pyramid_exact_uv(cam, obs_uv, obs_w, n_levels: int = 8, scale: float = 1.2):
    """Observations mapped from their level (σ² = scale^(2·level) = 1/w) to
    level 0 through the chain of centre-aligned resizes between the
    pyramid's rounded level sizes."""
    import torch

    from gf_orb_slam_tpu_torch.ops import pyramid as pyr

    shapes = pyr.pyramid_shapes(cam.height, cam.width, n_levels, scale)
    level = torch.round(-0.5 * torch.log(obs_w.clamp(min=1e-12)) / torch.log(torch.tensor(scale))).long()
    out = obs_uv.clone()
    for lv in range(1, n_levels):
        m = level == lv
        xy = obs_uv[m] / scale**lv
        for axis, col in ((1, 0), (0, 1)):  # shapes are (H, W): u runs along W
            c = xy[:, col]
            for step in range(lv, 0, -1):
                c = (c + 0.5) * (shapes[step - 1][axis] / shapes[step][axis]) - 0.5
            xy[:, col] = c
        out[m] = xy
    return out


def undistort_roundtrip_px(cam) -> float:
    import torch

    from gf_orb_slam_tpu_torch.geometry import camera

    u, v = torch.meshgrid(torch.arange(0.0, cam.width, 4.0), torch.arange(0.0, cam.height, 4.0), indexing="xy")
    uv = torch.stack([u, v], -1).reshape(-1, 2)
    back = camera.normalized_to_pixel(cam, camera.distort_normalized(
        cam, camera.undistort_normalized(cam, camera.pixel_to_normalized(cam, uv))))
    return float((back - uv).norm(dim=-1).max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("record")
    a.add_argument("--runs", type=int, default=2)
    a.add_argument("--out", default=os.path.join("chiprun_out", "room_maps.npz"))
    b = sub.add_parser("study")
    b.add_argument("path")
    b.add_argument("--device", default="cuda")
    c = sub.add_parser("edges")
    c.add_argument("paths", nargs="+")
    c.add_argument("--out")
    d = sub.add_parser("ablate")
    d.add_argument("paths", nargs="+")
    args = ap.parse_args(argv)
    if args.cmd == "record":
        record(args.runs, args.out)
    elif args.cmd == "edges":
        edges(args.paths, args.out)
    elif args.cmd == "ablate":
        from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM

        for path in args.paths:
            print(json.dumps(ablate(path, EUROC_CAM)), flush=True)
    else:
        study(args.path, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
