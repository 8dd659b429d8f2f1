#!/usr/bin/env python
"""Where the time of the port's per-frame tracking step and of its keyframe
insertion goes, on a CUDA GPU.

    python tools/profile_torch_step.py [--out profile_out] [--frames 6] [--insertions 5]

Loads the tracking fixture (gf_orb_slam_tpu_torch/data/track_fixture.npz)
onto the card, warms up, then

1. times the step's three stages (ORB extraction, motion-model tracking,
   local-map tracking with GF selection) by synchronising between them;
2. traces whole steps with torch.profiler and prints the operators that take
   the most host time and the most device time, with the device's busy share
   of the traced window, kernel launches and stream synchronisations per
   frame;
3. inserts frame 0 (tracked on the fixture's map) as a keyframe with
   `insert_keyframe_fused`: its wall time as the system runs it (no sync
   inside), then its stages — setup, triangulation, point culling, fusion,
   BA, descriptors (window medoid + statistics refresh), keyframe culling
   and the new view — each timed by synchronising at its boundaries (the
   stage functions are wrapped; the insertion's code is unchanged), and one
   insertion traced with torch.profiler for its kernel launches.

Prints one JSON line per part and writes the profiler tables under --out.
Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "profile_out"))
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--insertions", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step.py needs a CUDA GPU")

    from gf_orb_slam_tpu_torch.geometry import pwls, se3
    from gf_orb_slam_tpu_torch.geometry.camera import CameraModel
    from gf_orb_slam_tpu_torch.io_utils import snapshot
    from gf_orb_slam_tpu_torch.mapping.frame import make_frame
    from gf_orb_slam_tpu_torch.ops.orb import OrbConfig
    from gf_orb_slam_tpu_torch.pipeline import track_view as tv
    from gf_orb_slam_tpu_torch.pipeline import tracking

    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda", 0)
    fixture = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "track_fixture.npz")
    with np.load(fixture) as zf:
        z = {k: zf[k] for k in zf.files}
    meta = json.loads(str(z["meta"]))
    cam = CameraModel(**meta["camera"])
    cfg = OrbConfig(**meta["orb_config"])
    gf = meta["gf"]
    m, _, _ = snapshot.load_map(fixture, dev)
    view = tv.compute_track_view(m, int(z["center_kf"]), view_size=meta["view_size"])
    frames = snapshot.to_tensor(z["frames"], dev).to(torch.float32)
    state = [snapshot.to_tensor(z[k], dev) for k in ("last_pose", "last_obs", "last_uv", "velocity")]
    key = torch.tensor([0, 1], dtype=torch.int64, device=dev)
    dt = torch.tensor(meta["dt"], dtype=torch.float32, device=dev)
    kw = dict(scale=cfg.scale, n_levels=cfg.n_levels)
    gkw = dict(gf_budget=gf["gf_budget"], use_gf=gf["use_gf"], gf_mode=gf["gf_mode"], gf_batch=gf["gf_batch"])

    def step(i):
        return tracking.track_frame_fused(cam, cfg, m, view, frames[i], *state, dt, key, **kw, **gkw)

    for i in range(2):
        step(i)
    torch.cuda.synchronize()

    # 1. stage times, synchronised between stages.
    stages = {"extract": [], "motion_model": [], "local_map": [], "step": []}
    for i in range(args.frames):
        img = frames[i % frames.shape[0]]
        last_pose, last_obs, last_uv, vel = state
        t0 = time.perf_counter()
        frame = make_frame(img, cam, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r1 = tracking.track_with_motion_model(
            cam, m, frame, se3.compose(vel, last_pose), last_obs, last_uv, radius=15.0, **kw)
        ok1 = bool(r1.ok)
        t2 = time.perf_counter()
        zero = torch.zeros((), device=dev)
        Xv = pwls.state_from_pose_pair(zero, last_pose, zero + dt, r1.pose)
        r2 = tracking.track_local_map(cam, m, view, frame, r1.pose, r1.obs_point, Xv, None, **kw, **gkw, dt=dt)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        step(i % frames.shape[0])
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[k].append(v * 1e3)
        assert ok1 and bool(r2.ok)
    print(json.dumps({"part": "stages_ms_median", **{k: statistics.median(v) for k, v in stages.items()},
                      "device": torch.cuda.get_device_name(0)}), flush=True)

    # 2. profiler trace of whole steps.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.frames):
            step(i % frames.shape[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    # Kernel-side events only (the aten rows repeat their kernels' time).
    dev_us = sum(e.self_device_time_total for e in ka
                 if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation)
    by_cpu = ka.table(sort_by="self_cpu_time_total", row_limit=30)
    by_dev = ka.table(sort_by="self_device_time_total", row_limit=30)
    with open(os.path.join(args.out, "profile_step_tables.txt"), "w") as f:
        f.write(by_cpu + "\n\n" + by_dev + "\n")
    top_cpu = sorted(ka, key=lambda e: -e.self_cpu_time_total)[:15]
    top_dev = sorted((e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)[:10]
    print(json.dumps({
        "part": "profile", "frames": args.frames, "wall_ms_per_frame": wall * 1e3 / args.frames,
        "device_busy_ms_per_frame": dev_us / 1e3 / args.frames,
        "device_busy_share": dev_us / 1e6 / wall,
        "top_self_cpu_ms_per_frame": {e.key: e.self_cpu_time_total / 1e3 / args.frames for e in top_cpu},
        "top_calls_per_frame": {e.key: e.count / args.frames for e in top_cpu},
        "kernel_launches_per_frame": sum(e.count for e in ka if e.key == "cudaLaunchKernel") / args.frames,
        "stream_syncs_per_frame": sum(e.count for e in ka if e.key == "cudaStreamSynchronize") / args.frames,
        "top_self_device_ms_per_frame": {e.key: e.self_device_time_total / 1e3 / args.frames for e in top_dev},
    }), flush=True)

    # 3. the keyframe insertion.
    r = step(0)
    profile_insertion(torch, cam, m, r, args.insertions, args.out)


def profile_insertion(torch, cam, m, r, reps: int, out_dir: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    from gf_orb_slam_tpu_torch.kernels import hamming
    from gf_orb_slam_tpu_torch.mapping import keyframe_ops
    from gf_orb_slam_tpu_torch.mapping import map_state as ms
    from gf_orb_slam_tpu_torch.pipeline import local_mapping
    from gf_orb_slam_tpu_torch.solvers import local_ba

    pad = m.kp_capacity - r.frame_uv.shape[0]

    def pz(a, fill=0):
        return torch.cat([a, a.new_full((pad,) + a.shape[1:], fill)])

    args = (cam, m._replace(pt_visible=r.pt_visible, pt_found=r.pt_found), r.pose, 132, 6.6,
            pz(r.frame_uv), pz(r.frame_octave), pz(r.frame_angle), pz(r.frame_desc), pz(r.frame_valid, False),
            pz(r.obs_point, -1))

    def insert():
        return local_mapping.insert_keyframe_fused(*args)

    insert()
    torch.cuda.synchronize()
    walls, launches = [], []
    for _ in range(reps):
        before = hamming.LAUNCHES
        t0 = time.perf_counter()
        insert()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        launches.append(hamming.LAUNCHES - before)

    # Stage split: synchronise at every stage function's entry and exit.
    marks: list[tuple[str, float]] = []
    wrapped = [(keyframe_ops, "triangulate_between"), (keyframe_ops, "cull_points"),
               (keyframe_ops, "fuse_points_into_keyframes"), (local_ba, "bundle_adjust"),
               (ms, "refresh_point_stats"), (keyframe_ops, "keyframe_redundancy")]
    originals = {(mod, name): getattr(mod, name) for mod, name in wrapped}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            marks.append((name + ":start", time.perf_counter()))
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            marks.append((name + ":end", time.perf_counter()))
            return out
        return run

    splits = []
    for mod, name in wrapped:
        setattr(mod, name, timed(name, originals[(mod, name)]))
    try:
        for _ in range(reps):
            marks.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            insert()
            torch.cuda.synchronize()
            t_end = time.perf_counter()
            at = {}
            for k, v in marks:
                at.setdefault(k, []).append(v)
            tri = at["triangulate_between:start"], at["triangulate_between:end"]
            splits.append({
                "setup": tri[0][0] - t0,
                "triangulation": tri[1][-1] - tri[0][0],
                "point_culling": at["cull_points:end"][0] - tri[1][-1],
                "fusion": at["fuse_points_into_keyframes:end"][0] - at["cull_points:end"][0],
                "ba": at["bundle_adjust:end"][0] - at["fuse_points_into_keyframes:end"][0],
                "descriptors": at["refresh_point_stats:end"][0] - at["bundle_adjust:end"][0],
                "keyframe_culling_and_view": t_end - at["refresh_point_stats:end"][0],
            })
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        insert()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    with open(os.path.join(out_dir, "profile_insertion_tables.txt"), "w") as f:
        f.write(ka.table(sort_by="self_cpu_time_total", row_limit=30) + "\n\n"
                + ka.table(sort_by="self_device_time_total", row_limit=30) + "\n")
    dev_us = sum(e.self_device_time_total for e in ka
                 if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation)
    print(json.dumps({
        "part": "insertion", "reps": reps, "wall_ms_median": statistics.median(walls), "wall_ms": walls,
        "hamming_launches_per_insertion": launches[0],
        "stages_ms_median_synchronised": {k: statistics.median(s[k] for s in splits) * 1e3 for k in splits[0]},
        "kernel_launches": sum(e.count for e in ka if e.key == "cudaLaunchKernel"),
        "stream_syncs": sum(e.count for e in ka if e.key == "cudaStreamSynchronize"),
        "device_busy_ms": dev_us / 1e3,
        "device": torch.cuda.get_device_name(0),
    }), flush=True)


if __name__ == "__main__":
    main()
