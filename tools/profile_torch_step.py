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
   insertion traced with torch.profiler for its kernel launches;
4. the stages of the reference's tools/profile_stages.py that parts 1-3 do
   not split out, each timed alone between synchronisations (median of
   --frames calls after a warm-up): the pyramid, pyramid + FAST detection,
   pyramid + moment integrals, pyramid + Gaussian blur, the whole
   extraction, the patch-matmul extraction (`OrbConfig.patch_desc`), and
   the whole step with GF subset at batch 1, 5 and 10 and at budgets 60 and
   200 (batch 5). Its bfloat16 variants have no counterpart: the port's
   matmuls run in float32;
5. the insertion variants of the reference's tools/profile_insertion.py
   (window BA at 4+6, 1+1 and 0+0 LM, window 6, 1,024 points, triangulation
   with 2 or no neighbours, fusion with 2 or no neighbours), each timed as
   the median of --insertions calls between synchronisations.

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

    # 4. the reference's stage list (tools/profile_stages.py).
    from gf_orb_slam_tpu_torch.ops import fast as fast_ops
    from gf_orb_slam_tpu_torch.ops import orb
    from gf_orb_slam_tpu_torch.ops import pyramid as pyr

    img0 = frames[0]
    quotas = pyr.features_per_level(cfg.n_features, cfg.n_levels, cfg.scale)

    def s_fast():
        for lvl, q in zip(pyr.build_pyramid(img0, cfg.n_levels, cfg.scale), quotas):
            if q > 0:
                fast_ops.detect_keypoints(lvl, n_keep=q, threshold=cfg.fast_threshold,
                                          min_threshold=cfg.fast_min_threshold, grid=cfg.grid)

    def s_step(batch, budget=gf["gf_budget"]):
        return lambda: tracking.track_frame_fused(cam, cfg, m, view, img0, *state, dt, key, **kw,
                                                  **dict(gkw, gf_batch=batch, gf_budget=budget))

    reference_stages = {
        "pyramid": lambda: pyr.build_pyramid(img0, cfg.n_levels, cfg.scale),
        "pyr+fast": s_fast,
        "pyr+integrals": lambda: [orb.level_moment_integrals(lvl)
                                  for lvl in pyr.build_pyramid(img0, cfg.n_levels, cfg.scale)],
        "pyr+blur": lambda: [pyr.gaussian_blur(lvl) for lvl in pyr.build_pyramid(img0, cfg.n_levels, cfg.scale)],
        "extract_full": lambda: orb.extract_orb(img0, cfg),
        "extract_patchmm": lambda: orb.extract_orb(img0, cfg._replace(patch_desc=True)),
        "fused_track_gf_b1": s_step(1),
        "fused_gf_b5": s_step(5),
        "fused_gf_b10": s_step(10),
        "fused_gf_b5_k60": s_step(5, 60),
        "fused_gf_b5_k200": s_step(5, 200),
    }
    print(json.dumps({"part": "reference_stages_ms_median",
                      **{k: synced_ms(torch, fn, args.frames) for k, fn in reference_stages.items()},
                      "device": torch.cuda.get_device_name(0)}), flush=True)

    # 5. the reference's insertion variants (tools/profile_insertion.py).
    insertion_variants(torch, cam, m, r, args.insertions)


def synced_ms(torch, fn, reps: int) -> float:
    """Median wall ms of fn() between synchronisations, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def insertion_args(torch, cam, m, r) -> tuple:
    """`insert_keyframe_fused`'s arguments for the tracked frame r, padded
    to the map's keypoint capacity."""
    pad = m.kp_capacity - r.frame_uv.shape[0]

    def pz(a, fill=0):
        return torch.cat([a, a.new_full((pad,) + a.shape[1:], fill)])

    return (cam, m._replace(pt_visible=r.pt_visible, pt_found=r.pt_found), r.pose, 132, 6.6,
            pz(r.frame_uv), pz(r.frame_octave), pz(r.frame_angle), pz(r.frame_desc), pz(r.frame_valid, False),
            pz(r.obs_point, -1))


def insertion_variants(torch, cam, m, r, reps: int) -> None:
    from gf_orb_slam_tpu_torch.pipeline import local_mapping

    args = insertion_args(torch, cam, m, r)
    variants = {
        "full (tri3, fuse4, ba 5+10)": {},
        "ba 4+6": dict(ba_iters=(4, 6)),
        "ba 4+6 window 6": dict(ba_iters=(4, 6), ba_window=6),
        "ba 4+6 pts 1024": dict(ba_iters=(4, 6), ba_points=1024),
        "ba 1+1": dict(ba_iters=(1, 1)),
        "ba 0+0": dict(ba_iters=(0, 0)),
        "no triangulation": dict(n_tri_neighbors=0),
        "no fusion": dict(n_fuse_neighbors=0),
        "fusion 2 neighbors": dict(n_fuse_neighbors=2),
        "tri 2 neighbors": dict(n_tri_neighbors=2),
        "window 6": dict(ba_window=6),
    }
    print(json.dumps({"part": "insertion_variants_ms_median",
                      **{k: synced_ms(torch, lambda kw=kw: local_mapping.insert_keyframe_fused(*args, **kw), reps)
                         for k, kw in variants.items()},
                      "device": torch.cuda.get_device_name(0)}), flush=True)


def profile_insertion(torch, cam, m, r, reps: int, out_dir: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    from gf_orb_slam_tpu_torch.kernels import hamming
    from gf_orb_slam_tpu_torch.mapping import keyframe_ops
    from gf_orb_slam_tpu_torch.mapping import map_state as ms
    from gf_orb_slam_tpu_torch.pipeline import local_mapping
    from gf_orb_slam_tpu_torch.solvers import local_ba

    args = insertion_args(torch, cam, m, r)

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
