#!/usr/bin/env python3
"""Global BA on the room circuit's loop-corrected maps, against the ground truth.

    python tools/torch_room_ba_study.py record [--runs 2] [--out chiprun_out/room_maps.npz]
    python tools/torch_room_ba_study.py study PATH [--device cpu]

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
11, and 5 + 40), and prints for each solve the Huber cost, the keyframe
ATE (Sim(3)-aligned), each keyframe's aligned error, and the edges whose χ²
exceeds the Huber threshold. One JSON line per map. Two suspects of a
biased optimum are checked beside them: `pyramid_exact` re-solves (Schur
5 + 40) with each observation mapped from its level to level 0 through the
pyramid's centre-aligned resizes, in place of the reference's
`xy · 1.2^level`; `undistort_roundtrip_px` is the largest
pixel error of the camera's undistortion, distorted back, over the image.
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
    z = np.load(path)
    if "runs" not in z:
        z = snapshot_problem(path)
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
            exact = prob._replace(obs_uv=pyramid_exact_uv(cam, prob.obs_uv, prob.obs_w))
            res = local_ba.bundle_adjust(cam, exact, iters_stage1=5, iters_stage2=40)
            rec["pyramid_exact"] = report(res.poses, res.points) | {
                "cost_on_its_observations": float(local_ba._cost(cam, res.poses, res.points, exact.obs_uv,
                                                                 prob.obs_point, prob.obs_w, active0)),
                "max_shift_px": float((exact.obs_uv - prob.obs_uv)[active0].abs().max())}
            print(json.dumps(rec), flush=True)
    print(json.dumps({"undistort_roundtrip_px": undistort_roundtrip_px(cam)}), flush=True)


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
    args = ap.parse_args(argv)
    if args.cmd == "record":
        record(args.runs, args.out)
    else:
        study(args.path, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
