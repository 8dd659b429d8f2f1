#!/usr/bin/env python
"""Write the churn fixture: the JAX reference's runs that reach keyframe-slab
compaction, which the PyTorch port is held against.

Runs the reference's `SlamSystem` on the CPU, synchronously, on frames
rendered on the CPU and rounded to uint8, with the packaged 1M-word
vocabulary preset:

    python tools/make_torch_churn_fixture.py                 # both runs, ~4-7 min
    python tools/make_torch_churn_fixture.py --scan          # choose max_keyframes, ~4 min

* `churn` — the room circuit with a kidnap (tools/reloc_recall.py's schedule
  at scene seed 0): EuRoC camera, `circuit_trajectory(300, radius 4.0,
  revs=min(1.1, 300/270))`, keyframe cadence 6, GF subset at budget 100,
  seed 0; 8 black frames from frame 180 (0.6·F), after which
  frame i shows the ground-truth frame i + jump, jump = −int(0.25·F/revs).
  `max_keyframes` = CHURN_MAX_KEYFRAMES = 32. `--scan` reads the keyframe
  counter of one uncompacted run up to the black frames: the largest
  capacity that compacts before them is 34, at frame 177, three frames
  ahead of the blackout and one insertion from missing it; 32 compacts at
  frame 165, two insertions ahead, so that a run whose insertions come a
  cadence later still compacts before the kidnap. The run inserts again
  after its recovery.
* `planes` — the configuration of the reference's own compaction test
  (tests/test_pipeline_e2e.py::test_keyframe_slab_compaction_on_long_runs):
  the planes scene, `trajectory(50)`, 600 features, keyframe cadence 3,
  `max_keyframes=12`, seed 0; with its initializer samples.

Output: gf_orb_slam_tpu_torch/data/churn_fixture.npz (no frames). For each
run `<run>_*`: `meta` (JSON: camera, configuration, schedule, summary, the
recovery numbers of reloc_recall.py for the churn run, commit); per frame
`state`, `pose` (T_cw, NaN where none), `n_inliers`, `frame_src` (the
ground-truth index shown, −1 black); `insert_frames` (the initialization
frame once), `compactions` ((frame, live keyframes after) rows), `reloc_frames`,
`loops` ((frame, query keyframe, loop keyframe) rows), `live_kf` (valid
keyframes after each frame); for planes also `init_samples`.
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
sys.path.insert(0, os.path.join(REPO, "tools"))

from make_torch_system_fixture import reference_samples  # noqa: E402

from gf_orb_slam_tpu.geometry import se3  # noqa: E402
from gf_orb_slam_tpu.geometry.camera import EUROC_CAM, CameraModel  # noqa: E402
from gf_orb_slam_tpu.io_utils import evaluation, synthetic  # noqa: E402
from gf_orb_slam_tpu.loop import loop_closing  # noqa: E402
from gf_orb_slam_tpu.pipeline import system as system_mod  # noqa: E402
from gf_orb_slam_tpu.pipeline.system import SlamConfig, SlamSystem  # noqa: E402
from gf_orb_slam_tpu.retrieval import vocabulary as voc_mod  # noqa: E402
from gf_orb_slam_tpu.solvers import initializer  # noqa: E402
from gf_orb_slam_tpu_torch.io_utils import reloc_eval  # noqa: E402  (numpy: the recall tool's schedule and reading)

OUT = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "churn_fixture.npz")
FPS = 20.0
CHURN_FRAMES = 300
CHURN_MAX_KEYFRAMES = 32
PLANES_FRAMES = 50
PLANES_MAX_KEYFRAMES = 12


def _commit() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def churn_setup(max_keyframes: int, n: int = CHURN_FRAMES):
    """Camera, config, scene, render, timestamps, ground truth, frame_src
    and schedule of the churn run (reloc_recall.py's kidnap at scene seed 0,
    as io_utils/reloc_eval.py schedules it)."""
    revs = min(1.1, n / 270.0)
    ts, poses_gt = synthetic.circuit_trajectory(n, fps=FPS, radius=4.0, revs=revs)
    cfg = SlamConfig(max_frames_between_kf=6, use_gf=True, gf_budget=100, pipelined=False,
                     max_keyframes=max_keyframes)
    sched = {"revs": revs, "blackout_at": reloc_eval.blackout_start(n), "blackout_len": reloc_eval.BLACKOUT_LEN,
             "jump": reloc_eval.kidnap_jump(n, revs)}
    return (EUROC_CAM, cfg, synthetic.make_room_scene(seed=0), synthetic.render_general, ts, poses_gt,
            reloc_eval.frame_src(n, "kidnap", revs), sched)


def planes_setup():
    cam = CameraModel(fx=458.0, fy=458.0, cx=376.0, cy=240.0, width=752, height=480, fps=FPS)
    ts, poses_gt = synthetic.trajectory(PLANES_FRAMES, fps=FPS)
    cfg = SlamConfig(n_features=600, max_frames_between_kf=3, max_keyframes=PLANES_MAX_KEYFRAMES, pipelined=False)
    return cam, cfg, synthetic.make_scene(seed=0), synthetic.render, ts, poses_gt, list(range(PLANES_FRAMES)), {}


def centers(poses) -> np.ndarray:
    return np.stack([np.asarray(se3.pose_t(se3.inverse(jnp.asarray(p)))) for p in poses])


def run(name, cam, cfg, scene, render, ts, poses_gt, src, sched, voc, record_samples=False, stop=None) -> dict:
    system = SlamSystem(cam, cfg)
    system.set_vocabulary(voc)
    inserts, n_kf_at_insert, compactions, loops, attempts = [], [], [], [], []
    insert, compact = system._insert_keyframe, system._compact_keyframes

    def recording_insert(*a, frame_id=None, **kw):
        inserts.append(int(frame_id))
        n_kf_at_insert.append(int(system.n_kf))
        return insert(*a, frame_id=frame_id, **kw)

    def recording_compact():
        compact()
        compactions.append((system.frame_id, int(np.asarray(system.map.kf_valid).sum())))

    correct = loop_closing.correct_loop

    def recording_correct(m, query_kf, loop_kf, *a, **kw):
        loops.append((system.frame_id, int(query_kf), int(loop_kf)))
        return correct(m, query_kf, loop_kf, *a, **kw)

    two_view = initializer.initialize_two_view

    def recording_two_view(cam_, uv1, uv2, matched, key, **kw):
        attempts.append((key, np.asarray(matched)))
        return two_view(cam_, uv1, uv2, matched, key, **kw)

    system._insert_keyframe, system._compact_keyframes = recording_insert, recording_compact
    loop_closing.correct_loop = recording_correct
    initializer.initialize_two_view = recording_two_view
    n = stop or len(src)
    black = np.zeros((cam.height, cam.width), np.float32)
    states, n_inl, logs, live = [], [], [], []
    t0 = time.perf_counter()
    try:
        for i in range(n):
            img = black if src[i] < 0 else np.clip(np.round(np.asarray(
                render(scene, cam, jnp.asarray(poses_gt[src[i]])))), 0, 255)
            log = system.process(jnp.asarray(img.astype(np.uint8), jnp.float32), float(ts[i]))
            logs.append(log)
            states.append(system_mod.State[log.state].value)
            n_inl.append(log.n_inliers)
            live.append(int(np.asarray(system.map.kf_valid).sum()))
            if i % 20 == 0:
                print(f"{name} frame {i}: {log.state} n_kf={system.n_kf} live={live[-1]} "
                      f"compactions={len(compactions)} {time.perf_counter() - t0:.0f}s", flush=True)
        system.flush()
    finally:
        loop_closing.correct_loop = correct
        initializer.initialize_two_view = two_view
    seconds = time.perf_counter() - t0

    states = np.asarray(states, np.int32)
    poses = np.full((n, 7), np.nan, np.float32)
    for log_i, log in enumerate(logs):
        if log.pose_cw is not None:
            poses[log_i] = np.asarray(log.pose_cw)
    working = np.flatnonzero(states == system_mod.State.WORKING.value)
    first_working = int(working[0]) if working.size else -1
    insert_frames = ([first_working] if first_working >= 0 else []) + inserts
    lost = states == system_mod.State.LOST.value
    reloc_frames = [i for i in range(1, n) if lost[i - 1] and states[i] == system_mod.State.WORKING.value]
    # Tracked frames against the ground truth each one showed (the
    # initialization frame has a trajectory pose but no log pose).
    traj = {int(round(t * FPS)): np.asarray(p) for t, p in system.trajectory}
    tracked = sorted(i for i in traj if src[i] >= 0)
    ate = evaluation.ate_rmse(centers([traj[i] for i in tracked]), centers(poses_gt[[src[i] for i in tracked]]))
    summary = {"first_working": first_working, "tracked": len(traj), "lost": int(lost.sum()),
               "keyframes_inserted": len(insert_frames) + (1 if first_working >= 0 else 0),
               "keyframes_valid": live[-1], "map_points": int(np.asarray(system.map.pt_valid).sum()),
               "compactions": len(compactions), "loops_closed": int(system.n_loops_closed),
               "relocalizations": len(reloc_frames), "ate_rmse_m": ate, "reference_cpu_seconds": seconds}
    if sched and n == len(src):
        # tools/reloc_recall.py's reading (held equal to it by tests/test_torch_churn.py).
        summary["recovery"] = {k: v for k, v in reloc_eval.recovery(
            [lg.state for lg in logs], [None if lg.pose_cw is None else centers([lg.pose_cw])[0] for lg in logs],
            src, centers(poses_gt), sched["blackout_len"]).items() if k not in ("blackout_at", "blackout_len")}
    meta = {"camera": cam._asdict(),
            "slam_config": {k: (list(v) if isinstance(v, tuple) else v) for k, v in cfg.__dict__.items()},
            "vocabulary": "gf_orb_slam_tpu/data/vocab_1m.npz",
            "scene": "room" if render is synthetic.render_general else "planes", "scene_seed": 0, "seed": 0,
            "trajectory_frames": len(ts), "frames": n, "fps": FPS, "frames_rounded_to_uint8": True,
            "schedule": sched, "summary": summary, "commit": _commit()}
    print(json.dumps({"run": name, **summary, "insert_frames": insert_frames, "compactions": compactions,
                      "loops": loops, "reloc_frames": reloc_frames,
                      "n_kf_at_insert": list(zip(inserts, n_kf_at_insert))}), flush=True)
    out = {f"{name}_meta": np.asarray(json.dumps(meta)), f"{name}_state": states, f"{name}_pose": poses,
           f"{name}_n_inliers": np.asarray(n_inl, np.int32), f"{name}_frame_src": np.asarray(src[:n], np.int32),
           f"{name}_insert_frames": np.asarray(insert_frames, np.int32),
           f"{name}_compactions": np.asarray(compactions, np.int32).reshape(-1, 2),
           f"{name}_reloc_frames": np.asarray(reloc_frames, np.int32),
           f"{name}_loops": np.asarray(loops, np.int32).reshape(-1, 3),
           f"{name}_live_kf": np.asarray(live, np.int32),
           "_n_kf_at_insert": np.asarray(list(zip(inserts, n_kf_at_insert)), np.int32).reshape(-1, 2)}
    if record_samples:
        out[f"{name}_init_samples"] = np.stack([reference_samples(k, jnp.asarray(mt)) for k, mt in attempts])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scan", action="store_true",
                    help="run the churn sequence to its blackout at capacity 256 and print the largest "
                         "max_keyframes whose compaction comes before it")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    voc = voc_mod.load_default_vocabulary()
    if args.scan:
        setup = churn_setup(256)
        b0 = setup[-1]["blackout_at"]
        rec = run("scan", *setup, voc, stop=b0)
        # An insertion decision at frame f compacts when n_kf ≥ max_keyframes − 2.
        at = rec["_n_kf_at_insert"]
        first = {k: int(at[at[:, 1] >= k - 2][0, 0]) for k in range(12, int(at[:, 1].max()) + 3)}
        print(json.dumps({"blackout_at": b0, "largest_max_keyframes_compacting_before": max(first),
                          "first_compaction_frame_by_max_keyframes": first}))
        return
    arrays = {**run("churn", *churn_setup(CHURN_MAX_KEYFRAMES), voc),
              **run("planes", *planes_setup(), voc, record_samples=True)}
    arrays = {k: v for k, v in arrays.items() if not k.startswith("_")}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(json.dumps({"out": args.out, "bytes": os.path.getsize(args.out)}))


if __name__ == "__main__":
    main()
