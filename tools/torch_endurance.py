#!/usr/bin/env python3
"""Endurance of the PyTorch port at shipped capacities (tools/endurance.py on the port).

    python tools/torch_endurance.py [--frames 3600] [--scene room] [--segment 600] \
        [--device cuda] [--out results/torch_endurance.json] [--dump-closures DIR]

A multi-revolution room circuit (the EuRoC camera, scene seed 0, radius 4.0,
--deg-per-frame of yaw: 3600 frames at 0.99°/frame are 9.9 revolutions) or
the long planes sweep, keyframe cadence 6 (room) or 12 (planes), GF at
--gf-budget, the packaged 1M-word vocabulary, `max_keyframes` 256 and
`max_points` 16384, synchronously (the reference's tool pipelines at depth 6;
the port has no pipelined mode). Each frame is rendered on the CPU, rounded
to uint8 and moved to the device as it is needed. Per --segment frames:
live keyframes and map points, the keyframe counter, loops, compactions and
their frames, the state, the median host ms per stage (`local_map_track`,
`keyframe_insert`, `pipeline_wait`, `total`) and the frame rate so far; then
the segment ATEs (each segment Sim(3)-aligned alone), each loop closure
(its frame, the query and loop keyframes' frames, and the verified Sim3
against the ground truth, `io_utils/loop_eval.sim3_against_ground_truth`:
its rotation error to the ground truth's relative rotation of those two
frames, its scale beside the map's scale ratio at the two keyframes, and
the ratio of the two), the whole run's ATE
and the reference tool's gates (tracked ≥ 97%, ATE ≤ --ate-gate-m, live
keyframes and points within capacity, the last segment's tracking median ≤
2× the second's). Exits 1 when a gate fails. Runs on the first CUDA card
unless --device cpu.

--dump-closures DIR saves each closure's verification and correction
inputs as DIR/closure_<frame>.npz: the map and the BoW database in the
snapshot schema (io_utils/snapshot.py, no vocabulary), `query_kf`,
`loop_kf`, the verified `S12`, `covis`, the corrected map's `out_kf_pose`
and `out_pt_pos`, and the ground truth (`ts`, `poses_gt`), the format of
`tools/torch_room_spread.py port --dump-correct`, which `verify-study` and
`correct-study` replay on both sides.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=3600)
    ap.add_argument("--scene", choices=["room", "planes"], default="room")
    ap.add_argument("--gf-budget", type=int, default=100)
    ap.add_argument("--segment", type=int, default=600)
    ap.add_argument("--deg-per-frame", type=float, default=0.99)
    ap.add_argument("--ate-gate-m", type=float, default=0.12)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(REPO, "results", "torch_endurance.json"))
    ap.add_argument("--dump-closures", default="", help="save each closure's inputs in this directory")
    args = ap.parse_args()

    import numpy as np
    import torch

    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu_torch.io_utils import evaluation, loop_eval, snapshot, synthetic
    from gf_orb_slam_tpu_torch.loop import loop_closing
    from gf_orb_slam_tpu_torch.pipeline.system import SlamConfig, SlamSystem, resolve_device
    from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

    dev = resolve_device(args.device)
    header = {"torch": torch.__version__, "device": str(dev)}
    if dev.type == "cuda":
        header["nvidia_smi"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                              capture_output=True, text=True).stdout.strip()
    print(json.dumps(header), flush=True)
    n = args.frames
    if args.scene == "room":
        cam = EUROC_CAM
        scene = synthetic.make_room_scene(seed=0)
        revs = n * args.deg_per_frame / 360.0
        ts, poses_gt = synthetic.circuit_trajectory(n, fps=cam.fps, radius=4.0, revs=revs)
        render = synthetic.render_general
    else:
        cam = run_slam.BENCH_CAMERA
        scene = synthetic.make_scene(seed=0)
        revs = 0.0
        ts, poses_gt = synthetic.trajectory(n, fps=cam.fps)
        render = synthetic.render
    cfg = SlamConfig(max_frames_between_kf=6 if args.scene == "room" else 12, use_gf=args.gf_budget > 0,
                     gf_budget=max(args.gf_budget, 1))
    system = SlamSystem(cam, cfg, device=dev)
    system.set_vocabulary(voc_mod.load_default_vocabulary(dev))

    closures = []
    correct = loop_closing.correct_loop

    def recording_correct(m, query_kf, loop_kf, S12, *a, **kw):
        q, lk = int(query_kf), int(loop_kf)
        fid = m.kf_frame_id.cpu().numpy()
        row = loop_eval.sim3_against_ground_truth(S12.cpu().numpy(), q, lk, m.kf_pose.cpu().numpy(), fid,
                                                  m.kf_valid.cpu().numpy(), poses_gt)
        closures.append({"frame": i, "query_frame": int(fid[q]), "loop_frame": int(fid[lk]),
                         **{k: round(v, 4) for k, v in row.items()}})
        out = correct(m, query_kf, loop_kf, S12, *a, **kw)
        if args.dump_closures:
            os.makedirs(args.dump_closures, exist_ok=True)
            path = os.path.join(args.dump_closures, f"closure_{i}.npz")
            snapshot.save_map(path, m, None, system.bow_db)
            with np.load(path) as z:
                arrays = dict(z)
            np.savez_compressed(path, **arrays, query_kf=q, loop_kf=lk, S12=S12.cpu().numpy(),
                                covis=a[0].cpu().numpy(), out_kf_pose=out.kf_pose.cpu().numpy(),
                                out_pt_pos=out.pt_pos.cpu().numpy(), ts=np.asarray(ts), poses_gt=poses_gt)
        return out

    loop_closing.correct_loop = recording_correct
    seg_rows = []
    t_start = time.perf_counter()
    for i in range(n):
        img = torch.clamp(torch.round(render(scene, cam, torch.from_numpy(poses_gt[i]))), 0, 255).to(dev)
        system.process(img, float(ts[i]))
        if (i + 1) % args.segment == 0:
            system.flush()
            frames = system.time_log.frames[-args.segment:]

            def med(stage):
                vals = [f.stages_ms[stage] for f in frames if stage in f.stages_ms]
                return round(statistics.median(vals), 2) if vals else None

            seg_rows.append({
                "frame": i + 1, "live_keyframes": int(system.map.kf_valid.sum()),
                "live_points": int(system.map.pt_valid.sum()), "n_kf_counter": system.n_kf,
                "loops_closed": system.n_loops_closed, "compactions": system.n_compactions,
                "compaction_frames": [f for f, _ in system.compactions], "state": system.state.name,
                "median_track_ms": med("local_map_track"), "median_insert_ms": med("keyframe_insert"),
                "median_wait_ms": med("pipeline_wait"), "median_frame_ms": med("total"),
                "wall_fps": round((i + 1) / (time.perf_counter() - t_start), 2),
            })
            print(json.dumps(seg_rows[-1]), flush=True)
    system.flush()
    wall_s = time.perf_counter() - t_start
    loop_closing.correct_loop = correct

    est_ts, est_poses = system.get_trajectory()
    gt_by_t = {round(float(t), 6): c for t, c in zip(ts, run_slam.camera_centers(poses_gt))}
    est_pos = run_slam.camera_centers(est_poses)
    gt_pos = np.stack([gt_by_t[round(float(t), 6)] for t in est_ts])
    full_ate = evaluation.ate_rmse(est_pos, gt_pos)
    tarr = np.asarray(est_ts)
    seg_ate = []
    for s0 in range(0, n, args.segment):
        m = (tarr >= ts[s0]) & (tarr < ts[min(s0 + args.segment, n - 1)])
        seg_ate.append(round(evaluation.ate_rmse(est_pos[m], gt_pos[m]), 4) if m.sum() > 30 else None)
    tracked_frac = len(est_poses) / n
    result = {**header, "scene": args.scene, "frames": n, "revolutions": round(revs, 2), "gf_budget": args.gf_budget,
              "pipeline": 1, "capacities": {"max_keyframes": cfg.max_keyframes, "max_points": cfg.max_points},
              "tracked": len(est_poses), "tracked_frac": round(tracked_frac, 4), "ate_rmse_m": full_ate,
              "segment_ate_m": seg_ate, "loops_closed": system.n_loops_closed, "closures": closures,
              "compactions": system.n_compactions,
              "compaction_frames": [list(c) for c in system.compactions], "final_state": system.state.name,
              "wall_s": round(wall_s, 1), "wall_fps": round(n / wall_s, 2), "segments": seg_rows}
    print(json.dumps({k: v for k, v in result.items() if k != "segments"}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)

    fails = []
    if tracked_frac < 0.97:
        fails.append(f"tracked_frac {tracked_frac:.3f} < 0.97")
    if full_ate > args.ate_gate_m:
        fails.append(f"ate {full_ate:.3f} > {args.ate_gate_m}")
    if seg_rows and max(r["live_keyframes"] for r in seg_rows) > cfg.max_keyframes:
        fails.append("keyframes exceeded capacity")
    if seg_rows and max(r["live_points"] for r in seg_rows) > cfg.max_points:
        fails.append("points exceeded capacity")
    track = [r["median_track_ms"] for r in seg_rows if r["median_track_ms"] is not None]
    if len(track) >= 4 and track[-1] > 2.0 * max(track[1], 1.0):
        fails.append(f"tracking median grew {track[1]} -> {track[-1]} ms")
    if fails:
        print("ENDURANCE GATES FAILED: " + "; ".join(fails), file=sys.stderr)
        return 1
    print("ENDURANCE GATES PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
