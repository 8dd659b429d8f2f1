#!/usr/bin/env python
"""Write the place-recognition fixture that the PyTorch port's SLAM loop is
held against: three runs of the JAX reference's synchronous `SlamSystem` on
the CPU, on frames rounded to uint8, each with the packaged 1M-word
vocabulary preset (gf_orb_slam_tpu/data/vocab_1m.npz) and loop closing and
relocalization on, as bench.py and the reference CLI ship them:

* `bench`    — bench.py's sequence and configuration (synthetic planes scene
               seed 0, 240 frames at 20 fps, 752×480 camera, 800 features,
               GF subset mode at budget 100, keyframe cadence 10, GF warm-up
               10 frames), without pipelining;
* `blackout` — the same sequence and configuration with a run of frames
               replaced by black images (`--black FIRST LAST`, 45-49), cut
               after `--blackout-frames` (90) frames: tracking is lost and
               relocalizes;
* `room`     — the reference CLI's room circuit (`run_slam.py --synthetic N
               --scene room --gf-budget 100`: the radtan-distorted EuRoC
               camera, `SlamConfig(max_frames_between_kf=6)`, GF subset mode
               at budget 100, scene seed 0, `circuit_trajectory(N, radius 4,
               revs min(1.1, N/270))`), which closes the loop.

    python tools/make_torch_place_fixture.py                  # all three runs
    python tools/make_torch_place_fixture.py --runs room --room-frames 300

Output: gf_orb_slam_tpu_torch/data/place_fixture.npz (no frames; the port
renders them itself). For each run `<run>_*`:

* `meta`: a JSON string with the camera, the configuration, the scene, the
  frame count, the blacked-out frames, the run's summary (first WORKING
  frame, tracked, LOST, keyframes inserted, loops closed, relocalizations,
  ATE, CPU seconds) and the git commit;
* per frame: `state` (the reference's `State` value after the frame) and
  `pose` (T_cw, NaN where the frame has none), `n_inliers`;
* `insert_frames`: the frames at which a keyframe was inserted (the
  initialization frame counts once);
* `loops`: (frame, query keyframe, loop keyframe) of every closure;
* `reloc_frames`: the frames at which a LOST system relocalized.
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
from gf_orb_slam_tpu.geometry.camera import EUROC_CAM, CameraModel  # noqa: E402
from gf_orb_slam_tpu.io_utils import evaluation, synthetic  # noqa: E402
from gf_orb_slam_tpu.loop import loop_closing  # noqa: E402
from gf_orb_slam_tpu.pipeline import system as system_mod  # noqa: E402
from gf_orb_slam_tpu.pipeline.system import SlamConfig, SlamSystem  # noqa: E402
from gf_orb_slam_tpu.retrieval import vocabulary as voc_mod  # noqa: E402

OUT = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "place_fixture.npz")
FPS = 20.0
BENCH_FRAMES = 240


def _commit() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True, text=True, check=True,
        ).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def bench_setup():
    cam = CameraModel(fx=458.0, fy=458.0, cx=376.0, cy=240.0, width=752, height=480, fps=FPS)
    cfg = SlamConfig(n_features=800, max_frames_between_kf=10, use_gf=True, gf_budget=100,
                     gf_warmup_frames=10, pipelined=False)
    scene = synthetic.make_scene(seed=0)
    ts, poses_gt = synthetic.trajectory(BENCH_FRAMES, fps=FPS)
    return cam, cfg, scene, synthetic.render, ts, poses_gt


def room_setup(n_frames: int):
    cam = EUROC_CAM
    cfg = SlamConfig(max_frames_between_kf=6, use_gf=True, gf_budget=100, gf_mode="subset", pipelined=False)
    scene = synthetic.make_room_scene(seed=0)
    ts, poses_gt = synthetic.circuit_trajectory(n_frames, fps=FPS, radius=4.0, revs=min(1.1, n_frames / 270.0))
    return cam, cfg, scene, synthetic.render_general, ts, poses_gt


def run(name, cam, cfg, scene, render, ts, poses_gt, n_frames, voc, black=None, seed: int = 0) -> dict:
    system = SlamSystem(cam, cfg)
    if seed:  # as the reference CLI's --seed sets it
        system._seed = seed
        system._key = jax.random.PRNGKey(seed)
    system.set_vocabulary(voc)

    insert_frames: list[int] = []
    insert = system._insert_keyframe

    def recording_insert(*a, frame_id=None, **kw):
        insert_frames.append(int(frame_id))
        return insert(*a, frame_id=frame_id, **kw)

    loops: list[tuple[int, int, int]] = []
    correct = loop_closing.correct_loop

    def recording_correct(m, query_kf, loop_kf, *a, **kw):
        loops.append((system.frame_id, int(query_kf), int(loop_kf)))
        return correct(m, query_kf, loop_kf, *a, **kw)

    system._insert_keyframe = recording_insert
    loop_closing.correct_loop = recording_correct
    states, n_inl = [], []
    t0 = time.perf_counter()
    try:
        for i in range(n_frames):
            if black is not None and black[0] <= i <= black[1]:
                img = np.zeros((cam.height, cam.width), np.float32)
            else:
                img = np.clip(np.round(np.asarray(render(scene, cam, jnp.asarray(poses_gt[i])))), 0, 255)
            log = system.process(jnp.asarray(img.astype(np.uint8), jnp.float32), float(ts[i]))
            states.append(system_mod.State[log.state].value)
            n_inl.append(log.n_inliers)
            if i % 20 == 0:
                print(f"{name} frame {i}: {log.state} n_inliers={log.n_inliers} n_kf={system.n_kf} "
                      f"loops={system.n_loops_closed} {time.perf_counter() - t0:.0f}s", flush=True)
        system.flush()
    finally:
        loop_closing.correct_loop = correct
    seconds = time.perf_counter() - t0

    states = np.asarray(states, np.int32)
    poses = np.full((n_frames, 7), np.nan, np.float32)
    for t, p in system.trajectory:
        poses[int(round(t * FPS))] = np.asarray(p)
    working = np.flatnonzero(states == system_mod.State.WORKING.value)
    first_working = int(working[0]) if working.size else -1
    n_inserted = len(insert_frames) + (2 if first_working >= 0 else 0)
    if first_working >= 0:
        insert_frames = [first_working] + insert_frames
    lost = states == system_mod.State.LOST.value
    reloc_frames = [i for i in range(1, n_frames) if lost[i - 1] and states[i] == system_mod.State.WORKING.value]
    est_ts, est_poses = system.get_trajectory()
    ate = None
    if len(est_poses) > 10:
        idx = np.rint(np.asarray(est_ts) * FPS).astype(int)
        est_pos = np.stack([np.asarray(se3.pose_t(se3.inverse(jnp.asarray(p)))) for p in est_poses])
        gt_pos = np.stack([np.asarray(se3.pose_t(se3.inverse(jnp.asarray(poses_gt[j])))) for j in idx])
        ate = evaluation.ate_rmse(est_pos, gt_pos)
    summary = {
        "first_working": first_working,
        "tracked": int(np.isfinite(poses[:, 0]).sum()),
        "lost": int(lost.sum()),
        "keyframes_inserted": n_inserted,
        "keyframes_valid": int(np.asarray(system.map.kf_valid).sum()),
        "map_points": int(np.asarray(system.map.pt_valid).sum()),
        "loops_closed": int(system.n_loops_closed),
        "relocalizations": len(reloc_frames),
        "ate_rmse_m": ate,
        "reference_cpu_seconds": seconds,
    }
    meta = {
        "camera": cam._asdict(),
        "slam_config": {k: (list(v) if isinstance(v, tuple) else v) for k, v in cfg.__dict__.items()},
        "vocabulary": "gf_orb_slam_tpu/data/vocab_1m.npz", "scene": "room" if render is synthetic.render_general
        else "planes", "scene_seed": 0, "trajectory_frames": len(ts), "frames": n_frames, "fps": FPS,
        "black_frames": list(black) if black is not None else None, "frames_rounded_to_uint8": True, "seed": seed,
        "summary": summary, "commit": _commit(),
    }
    print(json.dumps({"run": name, **summary, "insert_frames": insert_frames, "loops": loops,
                      "reloc_frames": reloc_frames}), flush=True)
    return {
        f"{name}_meta": np.asarray(json.dumps(meta)),
        f"{name}_state": states, f"{name}_pose": poses, f"{name}_n_inliers": np.asarray(n_inl, np.int32),
        f"{name}_insert_frames": np.asarray(insert_frames, np.int32),
        f"{name}_loops": np.asarray(loops, np.int32).reshape(-1, 3),
        f"{name}_reloc_frames": np.asarray(reloc_frames, np.int32),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", default="bench,blackout,room")
    ap.add_argument("--room-frames", type=int, default=420)
    ap.add_argument("--blackout-frames", type=int, default=90)
    # Frames 45-49: the bench map then holds 6 keyframes. At frames 35-39 (the
    # reference's own blackout test, at its faster keyframe cadence) the bench
    # map holds 5, and a system lost with ≤ 5 keyframes resets instead of
    # relocalizing (Tracking.cc:719-726).
    ap.add_argument("--black", type=int, nargs=2, default=(45, 49), metavar=("FIRST", "LAST"))
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()

    voc = voc_mod.load_binary(os.path.join(REPO, "gf_orb_slam_tpu", "data", "vocab_1m.npz"))
    arrays = {}
    if os.path.exists(args.out):  # runs not asked for keep their earlier record
        with np.load(args.out) as z:
            arrays = {k: z[k] for k in z.files}
    for name in args.runs.split(","):
        if name == "bench":
            arrays.update(run(name, *bench_setup(), BENCH_FRAMES, voc))
        elif name == "blackout":
            arrays.update(run(name, *bench_setup(), args.blackout_frames, voc, black=tuple(args.black)))
        elif name == "room":
            arrays.update(run(name, *room_setup(args.room_frames), args.room_frames, voc))
        else:
            raise SystemExit(f"unknown run {name!r}")
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        np.savez_compressed(args.out, **arrays)
    print(json.dumps({"out": args.out, "bytes": os.path.getsize(args.out)}))


if __name__ == "__main__":
    main()
