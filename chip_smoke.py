#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. device  — requires CUDA; torch/CUDA versions, the card, and nvidia-smi's
             name and power limit (also printed as a raw line);
2. build   — builds csrc/*.cu with nvcc for sm_90a (or loads the build);
3. kernel  — the Hamming kernel against its plain PyTorch version on the card
             at the shapes of the tracking path (4096×800, 800×800, and
             1600×800 on the first frame after initialization, whose last
             observations are the 1600-wide second keyframe's), the
             initialization and triangulation matches (1600×1600) and the
             fusion matches (2048×1600), and edge cases, bit for bit; the
             median CUDA-event time of each at the five path shapes.
             Phases 4 and 5 record the shapes they launch the kernel at,
             and the run fails if one of them was not checked here;
4. main    — the per-frame tracking step (`track_frame_fused`, GF subset mode,
             budget 100, batch 10) chained over the fixture's frames on the
             reference's map, each frame checked against the reference's
             recorded outputs; per-frame times after one warm-up frame; the
             step's host synchronisations counted (exactly one expected);
5. system  — the whole SLAM loop from the first frame: the bench's 240
             frames rendered on the card and rounded to uint8, run through
             `SlamSystem.process` (bench configuration, seed 0: two-view
             initialization, tracking, keyframe insertion with triangulation,
             fusion, windowed BA and culling), held against the reference's
             recorded run (first WORKING frame, tracked and LOST frames,
             keyframes inserted, ATE); per-frame times, Hamming launches per
             insertion, host syncs per frame, and one insertion re-run under
             PyTorch's sync debug mode (no sync allowed).

Then the kernel table line and, last, {"ok": true, "device": {...}}. The
fixtures (gf_orb_slam_tpu_torch/data/track_fixture.npz and
system_fixture.npz) are written from the JAX reference by
tools/make_torch_fixture.py and tools/make_torch_system_fixture.py.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "track_fixture.npz")
SYSTEM_FIXTURE = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "system_fixture.npz")
TIMED_SHAPES = [(4096, 800), (800, 800), (1600, 800), (1600, 1600), (2048, 1600)]
KERNEL_SHAPES = TIMED_SHAPES + [(1000, 777), (1, 1), (0, 8)]
# Slice tolerances against the reference's recorded outputs.
ROT_TOL_RAD = 1e-3
TRANS_TOL = 1e-3        # map units (the map is median-depth normalised at init)
OBS_AGREE_MIN = 0.95
# System-phase gates against the reference's recorded run.
WORKING_SLACK = 2          # first WORKING frame ≤ the reference's + 2
TRACKED_SHARE = 0.98       # tracked frames ≥ the reference's less 2%
KF_SHARE = 0.25            # keyframes inserted within ±25% of the reference's
ATE_FACTOR = 2.0           # ATE ≤ 2× the reference's
MIN_INSERT_LAUNCHES = 4    # Hamming launches inside every insertion


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def median_ms(fn, reps: int = 11, inner: int = 20) -> float:
    """Median over `reps` samples of CUDA-event time per call, each sample
    averaging `inner` back-to-back calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


def count_host_syncs(fn) -> int:
    """Calls of fn that synchronise the host with the device, as PyTorch's
    sync debug mode reports them (one warning per synchronising operation)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def rot_err(q1, q2) -> float:
    """Angle (rad) between two unit quaternions."""
    import numpy as np

    d = abs(float(np.dot(q1 / np.linalg.norm(q1), q2 / np.linalg.norm(q2))))
    return float(2.0 * np.arccos(min(1.0, d)))


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a non-empty list."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, int(-(-q * len(xs) // 100)) - 1))]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this smoke run needs a CUDA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np

    from gf_orb_slam_tpu_torch.geometry.camera import CameraModel
    from gf_orb_slam_tpu_torch.io_utils import snapshot
    from gf_orb_slam_tpu_torch.kernels import _build, hamming
    from gf_orb_slam_tpu_torch.ops import matching
    from gf_orb_slam_tpu_torch.ops.orb import OrbConfig
    from gf_orb_slam_tpu_torch.pipeline import track_view as tv
    from gf_orb_slam_tpu_torch.pipeline import tracking

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # --- 1. device ---
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": kind, "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "python": sys.version.split()[0]})

    # --- 2. build ---
    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "library": os.path.relpath(_build.library_path(), REPO),
          "nvcc_seconds": _build.build_seconds, "seconds": time.perf_counter() - t0})

    # --- 3. kernel against its plain version ---
    rng = np.random.default_rng(0)
    max_err = 0
    for nq, nt in KERNEL_SHAPES:
        qn = rng.integers(0, 2**32, size=(nq, 8), dtype=np.uint32)
        tn = rng.integers(0, 2**32, size=(nt, 8), dtype=np.uint32)
        q = snapshot.to_tensor(qn, dev)
        t = snapshot.to_tensor(tn, dev)
        got = hamming.hamming_matrix_cuda(q, t)
        torch.cuda.synchronize()
        want = matching.hamming_matrix_torch(q, t)
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if got.numel() else 0
        if got.shape != (nq, nt) or not torch.equal(got, want):
            raise AssertionError(f"hamming kernel differs from the plain version at ({nq},{nt}): max err {err}")
        max_err = max(max_err, err)
    times = {}
    for nq, nt in TIMED_SHAPES:
        q = snapshot.to_tensor(rng.integers(0, 2**32, size=(nq, 8), dtype=np.uint32), dev)
        t = snapshot.to_tensor(rng.integers(0, 2**32, size=(nt, 8), dtype=np.uint32), dev)
        # Turns: plain, kernel, kernel, plain.
        p1 = median_ms(lambda: matching.hamming_matrix_torch(q, t))
        k1 = median_ms(lambda: hamming.hamming_matrix_cuda(q, t))
        k2 = median_ms(lambda: hamming.hamming_matrix_cuda(q, t))
        p2 = median_ms(lambda: matching.hamming_matrix_torch(q, t))
        times[f"{nq}x{nt}"] = {"kernel_ms": min(k1, k2), "plain_ms": min(p1, p2),
                               "kernel_ms_runs": [k1, k2], "plain_ms_runs": [p1, p2]}
    emit({"phase": "kernel", "name": "hamming_matrix", "shapes": KERNEL_SHAPES,
          "bit_identical": True, "max_abs_err": max_err, "times": times})

    # --- 4. main path ---
    with np.load(FIXTURE) as zf:
        z = {k: zf[k] for k in zf.files}
    meta = json.loads(str(z["meta"]))
    cam = CameraModel(**meta["camera"])
    orb_cfg = OrbConfig(**meta["orb_config"])
    gf = meta["gf"]
    m = snapshot.load_map(FIXTURE, dev)
    view = tv.compute_track_view(m, int(z["center_kf"]), view_size=meta["view_size"])
    ref_view = snapshot.track_view_from_numpy(z, dev, prefix="track_view_")
    if not (torch.equal(view.ids, ref_view.ids) and torch.equal(view.valid, ref_view.valid)):
        raise AssertionError("the port's compute_track_view ids/valid differ from the reference's")
    frames = snapshot.to_tensor(z["frames"], dev).to(torch.float32)
    F = frames.shape[0]
    state0 = [snapshot.to_tensor(z[k], dev) for k in ("last_pose", "last_obs", "last_uv", "velocity")]
    key0 = torch.tensor([0, 1], dtype=torch.int64, device=dev)
    dt = torch.tensor(meta["dt"], dtype=torch.float32, device=dev)

    def step(img, pose, obs, uv, vel, key):
        return tracking.track_frame_fused(
            cam, orb_cfg, m, view, img, pose, obs, uv, vel, dt, key,
            scale=orb_cfg.scale, n_levels=orb_cfg.n_levels, gf_budget=gf["gf_budget"],
            use_gf=gf["use_gf"], gf_mode=gf["gf_mode"], gf_batch=gf["gf_batch"],
        )

    # Record every shape the path launches the kernel at (phases 4 and 5).
    path_shapes = set()
    kernel = hamming.hamming_matrix_cuda

    def recording_kernel(q, t):
        if q.shape[0] and t.shape[0]:
            path_shapes.add((q.shape[0], t.shape[0]))
        return kernel(q, t)

    hamming.hamming_matrix_cuda = recording_kernel

    step(frames[0], *state0, key0)  # warm-up: first-call allocations, library load, cached constants
    torch.cuda.synchronize()
    # The step's one intended host sync is the wide-radius retry branch.
    host_syncs = count_host_syncs(lambda: step(frames[0], *state0, key0))
    if host_syncs != 1:
        raise AssertionError(f"the tracking step synchronised with the host {host_syncs} times (expected 1)")

    hamming.LAUNCHES = 0
    pose, obs, uv, vel = state0
    key = key0
    per_frame = []
    for i in range(F):
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        w0 = time.perf_counter()
        ev0.record()
        r = step(frames[i], pose, obs, uv, vel, key)
        ev1.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1e3
        pose, obs, uv, vel, key = r.pose, r.obs_point, r.frame_uv, r.velocity, r.next_key

        p = r.pose.cpu().numpy()
        o = r.obs_point.cpu().numpy()
        ro = z["ref_obs_point"][i]
        either = (o >= 0) | (ro >= 0)
        n_inl, ref_inl = int(r.n_inliers), int(z["ref_n_inliers"][i])
        n_tot, ref_tot = int(r.n_total), int(z["ref_n_total"][i])
        rec = {
            "frame": i, "ms_cuda_events": ev0.elapsed_time(ev1), "ms_wall": wall_ms,
            "rot_err_rad": rot_err(p[:4], z["ref_pose"][i][:4]),
            "trans_err": float(np.linalg.norm(p[4:] - z["ref_pose"][i][4:])),
            "n_inliers": n_inl, "ref_n_inliers": ref_inl, "n_total": n_tot, "ref_n_total": ref_tot,
            "ok": bool(r.ok), "ref_ok": bool(z["ref_ok"][i]),
            "obs_agree": float((o == ro)[either].mean()) if either.any() else 1.0,
        }
        per_frame.append(rec)
        bad = []
        if not (np.isfinite(p).all() and p.shape == (7,) and o.shape == ro.shape):
            bad.append("pose not finite or wrong shape")
        if rec["rot_err_rad"] > ROT_TOL_RAD or rec["trans_err"] > TRANS_TOL:
            bad.append("pose")
        if abs(n_inl - ref_inl) > max(3, 0.02 * ref_inl) or abs(n_tot - ref_tot) > max(3, 0.02 * ref_tot):
            bad.append("inlier counts")
        if rec["ok"] != rec["ref_ok"]:
            bad.append("ok")
        if rec["obs_agree"] < OBS_AGREE_MIN:
            bad.append("obs_point agreement")
        if bad:
            raise AssertionError(f"frame {i} outside the slice tolerances ({', '.join(bad)}): {rec}")
    launches = hamming.LAUNCHES
    if launches < 2 * F:
        raise AssertionError(f"hamming kernel launched {launches} times over {F} frames (< 2 per frame)")
    ms_wall = [rec["ms_wall"] for rec in per_frame]
    emit({"phase": "main", "entry": "pipeline.tracking.track_frame_fused", "frames": F,
          "view_valid": int(view.valid.sum()), "map_points": int(m.pt_valid.sum()),
          "hamming_launches": launches, "host_syncs_per_frame": host_syncs, "per_frame": per_frame,
          "median_ms_wall": statistics.median(ms_wall),
          "median_ms_cuda_events": statistics.median(rec["ms_cuda_events"] for rec in per_frame),
          "fps": F / (sum(ms_wall) / 1e3), "device": kind, "nvidia_smi": smi})

    # --- 5. the whole SLAM loop from the first frame ---
    launches_main = launches
    system_rec = run_system_phase(dev)
    system_rec.update(device=kind, nvidia_smi=smi)
    emit(system_rec)
    hamming.hamming_matrix_cuda = kernel
    unchecked = path_shapes - set(KERNEL_SHAPES)
    emit({"phase": "kernel_shapes", "path_shapes": sorted(path_shapes), "unchecked": sorted(unchecked)})
    if unchecked:
        raise AssertionError(f"the path launched the hamming kernel at shapes phase 3 did not check: {sorted(unchecked)}")

    t48 = times["4096x800"]
    emit({"kernels": [{
        "name": "hamming_matrix", "route": "cuda",
        "source": "gf_orb_slam_tpu_torch/csrc/hamming.cu",
        "replaces": "gf_orb_slam_tpu/ops/pallas_kernels.py:41",
        "launches": launches_main + system_rec["hamming_launches"], "max_abs_err": max_err,
        "ms": t48["kernel_ms"], "plain_ms": t48["plain_ms"],
    }]})
    # The run used one card, whatever the machine holds.
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}})
    return 0


def run_system_phase(dev) -> dict:
    """Phase 5: SlamSystem.process over the bench sequence on the card, held
    against the reference's recorded run. Raises on any gate."""
    import warnings

    import numpy as np
    import torch

    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.kernels import hamming
    from gf_orb_slam_tpu_torch.pipeline import local_mapping

    with np.load(SYSTEM_FIXTURE) as zf:
        z = {k: zf[k] for k in zf.files}
    meta = json.loads(str(z["meta"]))
    ref = meta["summary"]
    cam = run_slam.BENCH_CAMERA._replace(**{k: meta["camera"][k] for k in ("fx", "fy", "cx", "cy", "width", "height", "fps")})
    cfg = run_slam.bench_config()
    F = meta["frames"]
    t0 = time.perf_counter()
    ts, poses_gt, frames = run_slam.render_sequence(cam, meta["trajectory_frames"], meta["scene_seed"], dev)
    frames = frames[:F]
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0

    # Count the Hamming launches of every insertion, and keep the last
    # insertion's arguments for the sync check below.
    insert = local_mapping.insert_keyframe_fused
    inserts: list[dict] = []

    def counting_insert(*a, **kw):
        before = hamming.LAUNCHES
        out = insert(*a, **kw)
        inserts.append({"launches": hamming.LAUNCHES - before, "args": a, "kw": kw})
        return out

    per_frame_ms, syncs, states = [], [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def on_frame(i, log):
            per_frame_ms.append(log.timing_ms["total"])
            n_sync = sum("synchronizing CUDA operation" in str(w.message) for w in caught)
            caught.clear()
            syncs.append(n_sync)
            states.append((log.state, "keyframe_insert" in log.timing_ms, log.pose_cw is not None))

        local_mapping.insert_keyframe_fused = counting_insert
        hamming.LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            system, result = run_slam.run_sequence(
                cam, cfg, ts[:F], poses_gt[:F], frames, dev, seed=meta["seed"], on_frame=on_frame)
            run_s = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
            local_mapping.insert_keyframe_fused = insert
    launches = hamming.LAUNCHES
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    # One insertion again, on the map it was given, with every sync counted.
    last = inserts[-1]
    insert_syncs = count_host_syncs(lambda: insert(*last["args"], **last["kw"]))

    working = [i for i, (st, _, _) in enumerate(states) if st == "WORKING"]
    first_working = working[0] if working else -1
    insert_frames = [i for i, (_, ins, _) in enumerate(states) if ins]
    n_inserted = len(insert_frames) + (2 if first_working >= 0 else 0)
    tracked_ms = [per_frame_ms[i] for i, (st, ins, has) in enumerate(states) if has and not ins]
    insert_ms = [per_frame_ms[i] for i in insert_frames]
    tracked_syncs = [syncs[i] for i, (st, ins, has) in enumerate(states) if has and not ins]
    est_ts, est_poses = system.get_trajectory()
    # The fixture lists the initialization frame first, then each insertion.
    ref_insert_frames = [int(f) for f in z["insert_frames"][1:]]
    rec = {
        "phase": "system", "entry": "pipeline.system.SlamSystem.process", "frames": F,
        "render_seconds": render_s, "run_seconds": run_s,
        "first_working": first_working, "ref_first_working": ref["first_working"],
        "tracked": result["tracked"], "ref_tracked": ref["tracked"],
        "lost": sum(st == "LOST" for st, _, _ in states),
        "keyframes_inserted": n_inserted, "ref_keyframes_inserted": ref["keyframes_inserted"],
        "keyframes_valid": result["keyframes_valid"], "map_points": result["map_points"],
        "insert_frames": insert_frames,
        # Reported, not gated: the gates hold the run statistically.
        "insert_frames_match_reference": insert_frames == ref_insert_frames,
        "insert_frames_not_in_reference": sorted(set(insert_frames) - set(ref_insert_frames)),
        "reference_insert_frames_missed": sorted(set(ref_insert_frames) - set(insert_frames)),
        "ate_rmse_m": result.get("ate_rmse_m"), "ref_ate_rmse_m": ref["ate_rmse_m"],
        "init_frame_ms": per_frame_ms[first_working] if first_working >= 0 else None,
        "tracked_ms_median": statistics.median(tracked_ms) if tracked_ms else None,
        "tracked_ms_p90": percentile(tracked_ms, 90) if tracked_ms else None,
        "insert_frame_ms_median": statistics.median(insert_ms) if insert_ms else None,
        "hamming_launches": launches,
        "hamming_launches_per_insertion": [r["launches"] for r in inserts],
        "host_syncs_per_tracked_frame": sorted(set(tracked_syncs)),
        "host_syncs_per_insert_frame": sorted({syncs[i] for i in insert_frames}),
        "host_syncs_in_insert_keyframe_fused": insert_syncs,
        "peak_device_memory_mib": peak_mb,
        "per_frame_ms": [round(v, 1) for v in per_frame_ms],
    }

    bad = []
    if not all(np.isfinite(p).all() and p.shape == (7,) for p in est_poses):
        bad.append("a pose is not finite or not a 7-vector")
    if first_working < 0 or first_working > ref["first_working"] + WORKING_SLACK:
        bad.append(f"first WORKING frame {first_working} (reference {ref['first_working']})")
    if rec["lost"]:
        bad.append(f"{rec['lost']} LOST frames")
    if any(r["launches"] < MIN_INSERT_LAUNCHES for r in inserts):
        bad.append(f"an insertion launched the Hamming kernel fewer than {MIN_INSERT_LAUNCHES} times")
    if insert_syncs:
        bad.append(f"insert_keyframe_fused synchronised with the host {insert_syncs} times")
    if result["tracked"] < TRACKED_SHARE * ref["tracked"]:
        bad.append(f"tracked {result['tracked']} of {F} (reference {ref['tracked']})")
    if abs(n_inserted - ref["keyframes_inserted"]) > KF_SHARE * ref["keyframes_inserted"]:
        bad.append(f"{n_inserted} keyframes inserted (reference {ref['keyframes_inserted']})")
    if rec["ate_rmse_m"] is None or rec["ate_rmse_m"] > ATE_FACTOR * ref["ate_rmse_m"]:
        bad.append(f"ATE {rec['ate_rmse_m']} m (reference {ref['ate_rmse_m']} m)")
    if bad:
        raise AssertionError("system phase outside its gates: " + "; ".join(bad) + f" — {rec}")
    return rec


if __name__ == "__main__":
    sys.exit(main())
