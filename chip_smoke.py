#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. device  — requires CUDA; torch/CUDA versions, the card, and nvidia-smi's
             name and power limit (also printed as a raw line);
2. build   — builds csrc/*.cu with nvcc for sm_90a (or loads the build);
3. kernel  — the Hamming kernel against its plain PyTorch version on the card
             at the tracking path's shapes and edge cases, bit for bit, and
             the median CUDA-event time of each at 4096×800 and 800×800;
4. main    — the per-frame tracking step (`track_frame_fused`, GF subset mode,
             budget 100, batch 10) chained over the fixture's frames on the
             reference's map, each frame checked against the reference's
             recorded outputs; per-frame times after one warm-up frame; the
             step's host synchronisations counted (exactly one expected).

Then the kernel table line and, last, {"ok": true, "device": {...}}. The
fixture (gf_orb_slam_tpu_torch/data/track_fixture.npz) is written by
tools/make_torch_fixture.py from the JAX reference.
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
KERNEL_SHAPES = [(4096, 800), (800, 800), (1600, 1600), (1000, 777), (1, 1), (0, 8)]
TIMED_SHAPES = [(4096, 800), (800, 800)]
# Slice tolerances against the reference's recorded outputs.
ROT_TOL_RAD = 1e-3
TRANS_TOL = 1e-3        # map units (the map is median-depth normalised at init)
OBS_AGREE_MIN = 0.95


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

    t48 = times["4096x800"]
    emit({"kernels": [{
        "name": "hamming_matrix", "route": "cuda",
        "source": "gf_orb_slam_tpu_torch/csrc/hamming.cu",
        "replaces": "gf_orb_slam_tpu/ops/pallas_kernels.py:41",
        "launches": launches, "max_abs_err": max_err,
        "ms": t48["kernel_ms"], "plain_ms": t48["plain_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
