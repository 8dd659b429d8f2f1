#!/usr/bin/env python
"""Write the tracking fixture that the PyTorch port is held against.

Runs the JAX reference on the CPU over the bench's own scene and
configuration (bench.py: synthetic scene seed 0, 240-frame trajectory at
20 fps, 752×480 camera, 800 features, GF subset mode at budget 100), warms a
map for W frames, then chains the reference's `track_frame_fused` over the
next F frames on that fixed map and records its outputs:

    python tools/make_torch_fixture.py            # W=120, F=12
    python tools/make_torch_fixture.py --warmup 110 --frames 12

Output: gf_orb_slam_tpu_torch/data/track_fixture.npz, holding

* the map as written by the reference's `snapshot.save_map` (`map_*` keys);
* `center_kf` and the reference's `compute_track_view(m, center_kf, 4096)`
  (`track_view_*` keys);
* the tracking state before the chain (`last_pose`, `last_obs`, `last_uv`,
  `velocity`);
* the F frames as uint8 (`frames`; both sides consume float32 of them);
* the reference's chained outputs (`ref_*` keys, one row per frame);
* `meta`, a JSON string with the configuration, W, F and the git commit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gf_orb_slam_tpu.geometry.camera import CameraModel  # noqa: E402
from gf_orb_slam_tpu.io_utils import snapshot, synthetic  # noqa: E402
from gf_orb_slam_tpu.pipeline import track_view as tv  # noqa: E402
from gf_orb_slam_tpu.pipeline import tracking as trk  # noqa: E402
from gf_orb_slam_tpu.pipeline.system import SlamConfig, SlamSystem, State  # noqa: E402

OUT = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "track_fixture.npz")
N_TRAJ = 240
FPS = 20.0
DT = 0.05
VIEW_SIZE = 4096


def _commit() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True,
            text=True, check=True,
        ).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warmup", type=int, default=120, help="W: frames run by SlamSystem")
    ap.add_argument("--frames", type=int, default=12, help="F: frames chained and recorded")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    W, F = args.warmup, args.frames
    if W + F > N_TRAJ:
        raise SystemExit(f"W+F={W + F} exceeds the {N_TRAJ}-frame trajectory")

    cam = CameraModel(fx=458.0, fy=458.0, cx=376.0, cy=240.0, width=752, height=480, fps=FPS)
    cfg = SlamConfig(
        n_features=800, max_frames_between_kf=10, use_gf=True, gf_budget=100,
        gf_warmup_frames=10, pipelined=False,
    )
    scene = synthetic.make_scene(seed=0)
    ts, poses_gt = synthetic.trajectory(N_TRAJ, fps=FPS)
    frames = np.stack([
        np.clip(np.round(np.asarray(synthetic.render(scene, cam, jnp.asarray(poses_gt[i])))), 0, 255)
        .astype(np.uint8)
        for i in range(W + F)
    ])

    system = SlamSystem(cam, cfg)
    for i in range(W):
        system.process(jnp.asarray(frames[i], jnp.float32), float(ts[i]))
    system.flush()
    if system.state != State.WORKING:
        raise SystemExit(f"after W={W} frames the system is {system.state.name}, not WORKING")
    m = system.map
    kf_valid = np.asarray(m.kf_valid)
    center_kf = int(np.flatnonzero(kf_valid).max())
    view = tv.compute_track_view(m, jnp.asarray(center_kf), view_size=VIEW_SIZE)

    state0 = {
        "last_pose": np.asarray(system.last_pose),
        "last_obs": np.asarray(system.last_obs),
        "last_uv": np.asarray(system.last_frame.uv),
        "velocity": np.asarray(system.velocity),
    }
    pose, obs, uv, vel = (jnp.asarray(state0[k]) for k in ("last_pose", "last_obs", "last_uv", "velocity"))
    key = jnp.asarray([0, 1], jnp.uint32)
    outs = {k: [] for k in ("pose", "obs_point", "frame_uv", "velocity", "n_inliers",
                            "n_total", "ok", "frame_valid")}
    for i in range(F):
        r = trk.track_frame_fused(
            cam, system.orb_cfg, m, view, jnp.asarray(frames[W + i], jnp.float32),
            pose, obs, uv, vel, jnp.asarray(DT, jnp.float32), key,
            scale=cfg.scale, n_levels=cfg.n_levels, gf_budget=cfg.gf_budget,
            use_gf=True, gf_mode=cfg.gf_mode, gf_batch=cfg.gf_batch,
        )
        for k in outs:
            outs[k].append(np.asarray(getattr(r, k)))
        pose, obs, uv, vel, key = r.pose, r.obs_point, r.frame_uv, r.velocity, r.next_key
        print(f"frame {W + i}: ok={bool(r.ok)} n_inliers={int(r.n_inliers)} n_total={int(r.n_total)}",
              flush=True)
    if not all(outs["ok"]):
        raise SystemExit(f"a chained frame failed (ok={[bool(o) for o in outs['ok']]}); pick another W")

    meta = {
        "camera": cam._asdict(),
        "slam_config": {k: v for k, v in cfg.__dict__.items() if isinstance(v, (int, float, bool, str))},
        "orb_config": system.orb_cfg._asdict(),
        "gf": {"use_gf": True, "gf_mode": cfg.gf_mode, "gf_budget": cfg.gf_budget,
               "gf_batch": cfg.gf_batch},
        "scene_seed": 0, "trajectory_frames": N_TRAJ, "fps": FPS, "dt": DT,
        "view_size": VIEW_SIZE, "W": W, "F": F, "center_kf": center_kf,
        "n_keyframes": int(kf_valid.sum()), "n_points": int(np.asarray(m.pt_valid).sum()),
        "commit": _commit(),
    }
    with tempfile.TemporaryDirectory() as tmp:
        map_path = os.path.join(tmp, "map.npz")
        snapshot.save_map(map_path, m)
        with np.load(map_path) as z:
            arrays = {k: z[k] for k in z.files}
    arrays.update({f"track_view_{k}": np.asarray(v) for k, v in view._asdict().items()})
    arrays.update(state0)
    arrays["center_kf"] = np.asarray(center_kf, np.int32)
    arrays["frames"] = frames[W:W + F]
    arrays.update({f"ref_{k}": np.stack(v) for k, v in outs.items()})
    arrays["meta"] = np.asarray(json.dumps(meta))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(json.dumps({"out": args.out, "bytes": os.path.getsize(args.out), **meta}))


if __name__ == "__main__":
    main()
