#!/usr/bin/env python
"""Write the system fixture that the PyTorch port's SLAM loop is held against.

Runs the JAX reference's `SlamSystem` on the CPU over the bench's own
sequence and configuration (bench.py: synthetic scene seed 0, 240-frame
trajectory at 20 fps, 752×480 camera, 800 features, GF subset mode at budget
100, keyframe cadence 10, GF warm-up 10 frames), synchronously, with loop
closing and relocalization off, on frames rounded to uint8:

    python tools/make_torch_system_fixture.py             # all 240 frames, ~3 min
    python tools/make_torch_system_fixture.py --frames 40

Output: gf_orb_slam_tpu_torch/data/system_fixture.npz (no frames; the port
renders them itself), holding

* `meta`: a JSON string with the camera, the configuration, the seeds, the
  run's summary (first WORKING frame, tracked, LOST, keyframes inserted and
  valid at the end, map points, ATE) and the git commit;
* per frame: `state` (the reference's `State` value after the frame), `pose`
  (T_cw, NaN where the frame has none), `n_inliers`, and `gt_pose`;
* `insert_frames`: the frames at which a keyframe was inserted (the
  initialization frame counts once);
* per initialization attempt: the (200, 8) hypothesis samples that
  `initialize_two_view` drew from the key `SlamSystem._next_key` handed out
  (`init_samples`, recomputed outside the jit with the reference's own
  Gumbel top-k code), `init_success` and `init_used_homography`;
* the successful attempt's inputs and outputs (`init_uv1`, `init_uv2`,
  `init_matched`, `init_pose21`, `init_is_triangulated`, `init_points3d`);
* the initial BA's problem (`init_ba_*`, the fields of `BAProblem`).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gf_orb_slam_tpu.geometry import se3  # noqa: E402
from gf_orb_slam_tpu.geometry.camera import CameraModel  # noqa: E402
from gf_orb_slam_tpu.io_utils import evaluation, synthetic  # noqa: E402
from gf_orb_slam_tpu.solvers import initializer, local_ba  # noqa: E402
from gf_orb_slam_tpu.pipeline import system as system_mod  # noqa: E402
from gf_orb_slam_tpu.pipeline.system import SlamConfig, SlamSystem  # noqa: E402

OUT = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "system_fixture.npz")
N_TRAJ = 240
FPS = 20.0
N_HYPOTHESES = 200


def _commit() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True, text=True, check=True,
        ).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def reference_samples(key, matched) -> np.ndarray:
    """The (S, 8) samples initialize_two_view draws from `key`
    (gf_orb_slam_tpu/solvers/initializer.py:351-357), computed outside it."""
    N = matched.shape[0]
    keys = jax.random.split(key, N_HYPOTHESES)

    def sample_idx(k):
        g = jax.random.gumbel(k, (N,)) + jnp.where(matched, 0.0, -1e9)
        return jax.lax.top_k(g, 8)[1]

    return np.asarray(jax.vmap(sample_idx)(keys)).astype(np.int32)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=N_TRAJ)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()

    cam = CameraModel(fx=458.0, fy=458.0, cx=376.0, cy=240.0, width=752, height=480, fps=FPS)
    cfg = SlamConfig(
        n_features=800, max_frames_between_kf=10, use_gf=True, gf_budget=100,
        gf_warmup_frames=10, pipelined=False,
        enable_loop_closing=False, enable_relocalization=False,
    )
    scene_seed, seed = 0, 0
    scene = synthetic.make_scene(seed=scene_seed)
    ts, poses_gt = synthetic.trajectory(N_TRAJ, fps=FPS)
    F = args.frames

    system = SlamSystem(cam, cfg)

    # Record what the reference consumes and decides, without changing it.
    keys: list = []
    next_key = system._next_key

    def recording_next_key():
        k = next_key()
        keys.append(k)
        return k

    system._next_key = recording_next_key
    attempts: list[dict] = []
    two_view = initializer.initialize_two_view

    def recording_two_view(cam_, uv1, uv2, matched, key, **kw):
        out = two_view(cam_, uv1, uv2, matched, key, **kw)
        attempts.append({"uv1": np.asarray(uv1), "uv2": np.asarray(uv2), "matched": np.asarray(matched),
                         "key": key, "out": jax.tree.map(np.asarray, out)})
        return out

    init_ba: dict = {}
    bundle_adjust = local_ba.bundle_adjust

    def recording_ba(cam_, prob, **kw):
        if not init_ba:  # the first call is the initial BA (system.py:366), run eagerly
            init_ba.update({k: np.asarray(v) for k, v in prob._asdict().items()})
            init_ba["iters"] = np.asarray([kw["iters_stage1"], kw["iters_stage2"]], np.int32)
        return bundle_adjust(cam_, prob, **kw)

    insert_frames: list[int] = []
    insert = system._insert_keyframe

    def recording_insert(*a, frame_id=None, **kw):
        insert_frames.append(int(frame_id))
        return insert(*a, frame_id=frame_id, **kw)

    system._insert_keyframe = recording_insert
    initializer.initialize_two_view = recording_two_view
    local_ba.bundle_adjust = recording_ba

    states, n_inl = [], []
    t0 = time.perf_counter()
    try:
        for i in range(F):
            img = np.clip(np.round(np.asarray(synthetic.render(scene, cam, jnp.asarray(poses_gt[i])))), 0, 255)
            log = system.process(jnp.asarray(img.astype(np.uint8), jnp.float32), float(ts[i]))
            states.append(system_mod.State[log.state].value)
            n_inl.append(log.n_inliers)
            if i % 20 == 0:
                print(f"frame {i}: {log.state} n_inliers={log.n_inliers} n_kf={system.n_kf}", flush=True)
        system.flush()
    finally:
        initializer.initialize_two_view = two_view
        local_ba.bundle_adjust = bundle_adjust
    seconds = time.perf_counter() - t0

    states = np.asarray(states, np.int32)
    # Every frame with a pose in the trajectory (the initialization frame
    # included, whose log carries none) counts as tracked.
    poses = np.full((F, 7), np.nan, np.float32)
    for t, p in system.trajectory:
        poses[int(round(t * FPS))] = np.asarray(p)
    working = np.flatnonzero(states == system_mod.State.WORKING.value)
    first_working = int(working[0]) if working.size else -1
    # The initialization inserts two keyframes at one frame.
    n_inserted = len(insert_frames) + (2 if first_working >= 0 else 0)
    if first_working >= 0:
        insert_frames = [first_working] + insert_frames
    est_ts, est_poses = system.get_trajectory()
    ate = None
    if len(est_poses) > 10:
        idx = np.rint(np.asarray(est_ts) * FPS).astype(int)
        est_pos = np.stack([np.asarray(se3.pose_t(se3.inverse(jnp.asarray(p)))) for p in est_poses])
        gt_pos = np.stack([np.asarray(se3.pose_t(se3.inverse(jnp.asarray(poses_gt[j])))) for j in idx])
        ate = evaluation.ate_rmse(est_pos, gt_pos)

    ok_attempts = [a for a in attempts if bool(a["out"].success)]
    if len(keys) != len(attempts) or not ok_attempts:
        raise SystemExit(f"{len(keys)} keys for {len(attempts)} init attempts, {len(ok_attempts)} successful")
    good = ok_attempts[-1]
    summary = {
        "first_working": first_working,
        "tracked": int(np.isfinite(poses[:, 0]).sum()),
        "lost": int((states == system_mod.State.LOST.value).sum()),
        "keyframes_inserted": n_inserted,
        "keyframes_valid": int(np.asarray(system.map.kf_valid).sum()),
        "map_points": int(np.asarray(system.map.pt_valid).sum()),
        "ate_rmse_m": ate,
        "init_attempts": len(attempts),
        "reference_cpu_seconds": seconds,
    }
    meta = {
        "camera": cam._asdict(),
        "slam_config": {k: (list(v) if isinstance(v, tuple) else v) for k, v in cfg.__dict__.items()},
        "scene": "planes", "scene_seed": scene_seed, "seed": seed,
        "trajectory_frames": N_TRAJ, "frames": F, "fps": FPS, "frames_rounded_to_uint8": True,
        "summary": summary, "commit": _commit(),
    }
    arrays = {
        "meta": np.asarray(json.dumps(meta)),
        "state": states, "pose": poses, "n_inliers": np.asarray(n_inl, np.int32),
        "gt_pose": poses_gt[:F].astype(np.float32),
        "insert_frames": np.asarray(insert_frames, np.int32),
        "init_samples": np.stack([reference_samples(a["key"], jnp.asarray(a["matched"])) for a in attempts]),
        "init_success": np.asarray([bool(a["out"].success) for a in attempts]),
        "init_used_homography": np.asarray([bool(a["out"].used_homography) for a in attempts]),
        "init_uv1": good["uv1"], "init_uv2": good["uv2"], "init_matched": good["matched"],
        "init_pose21": good["out"].pose21, "init_is_triangulated": good["out"].is_triangulated,
        "init_points3d": good["out"].points3d,
    }
    arrays.update({f"init_ba_{k}": v for k, v in init_ba.items()})
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(json.dumps({"out": args.out, "bytes": os.path.getsize(args.out), **summary,
                      "insert_frames": insert_frames}))


if __name__ == "__main__":
    main()
