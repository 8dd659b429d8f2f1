#!/usr/bin/env python3
"""Write a rendered synthetic sequence to disk in the dataset layouts the
port reads (EuRoC ASL or TUM-RGBD) with a settings file in the reference's
OpenCV-YAML schema (tools/dump_dataset.py on the port), so that the dataset
path (`io_utils/datasets.py`, `io_utils/settings.py`, the prefetcher) runs
end to end without a download.

    python tools/torch_dump_dataset.py --out DIR [--layout euroc|tum] [--frames 100] \
        [--scene planes|room] [--scene-seed 0] [--n-features 600]

Frames are rendered on the CPU by the port's renderer and rounded to uint8
(what a camera and a PNG round trip do), written by the port's PNG writer
(`io_utils/images.write_gray`); EuRoC through `io_utils/datasets.write_euroc`.
The ground truth is each layout's own: EuRoC ns stamps with positions and
wxyz quaternions of T_wc, TUM seconds with positions and xyzw quaternions.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SETTINGS_TEMPLATE = """%YAML:1.0
# Auto-generated by tools/dump_dataset.py — reference settings schema
# (src/Tracking.cc:104-230).
Camera.fx: {fx}
Camera.fy: {fy}
Camera.cx: {cx}
Camera.cy: {cy}
Camera.k1: {k1}
Camera.k2: {k2}
Camera.p1: {p1}
Camera.p2: {p2}
Camera.k3: {k3}
Camera.fps: {fps}
Camera2.nCols: {width}
Camera2.nRows: {height}
ORBextractor.nFeatures: {n_features}
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.fastTh: 20
UseMotionModel: 1
"""


def render_frames(scene_name: str, scene_seed: int, n_frames: int, cam):
    """(timestamps, (F, H, W) uint8 frames, (F, 7) T_cw poses)."""
    import torch

    from gf_orb_slam_tpu_torch.io_utils import synthetic

    if scene_name == "room":
        scene = synthetic.make_room_scene(seed=scene_seed)
        ts, poses = synthetic.circuit_trajectory(n_frames, fps=cam.fps, radius=4.0, revs=min(1.1, n_frames / 270.0))
        render = synthetic.render_general
    else:
        scene = synthetic.make_scene(seed=scene_seed)
        ts, poses = synthetic.trajectory(n_frames, fps=cam.fps)
        render = synthetic.render
    frames = np.stack([np.clip(np.round(render(scene, cam, torch.as_tensor(poses[i])).numpy()), 0, 255).astype(np.uint8)
                       for i in range(n_frames)])
    return np.asarray(ts), frames, np.asarray(poses)


def write_tum(out: str, ts, frames, poses_cw) -> None:
    """TUM-RGBD: rgb.txt (t path) and rgb/<t>.png; groundtruth.txt
    (t tx ty tz qx qy qz qw of T_wc)."""
    import torch

    from gf_orb_slam_tpu_torch.geometry import se3
    from gf_orb_slam_tpu_torch.io_utils.images import write_gray

    os.makedirs(os.path.join(out, "rgb"), exist_ok=True)
    wc = se3.inverse(torch.as_tensor(np.asarray(poses_cw, np.float32)))
    pos, quat = se3.pose_t(wc).numpy(), se3.pose_q(wc).numpy()
    with open(os.path.join(out, "rgb.txt"), "w") as rgb_txt, open(os.path.join(out, "groundtruth.txt"), "w") as gt:
        rgb_txt.write("# color images\n")
        gt.write("# ground truth trajectory\n")
        for t, img, p, q in zip(ts, frames, pos, quat):
            name = f"rgb/{float(t):.6f}.png"
            write_gray(os.path.join(out, name), img)
            rgb_txt.write(f"{float(t):.6f} {name}\n")
            gt.write(f"{float(t):.6f} {p[0]} {p[1]} {p[2]} {q[1]} {q[2]} {q[3]} {q[0]}\n")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--layout", choices=["euroc", "tum"], default="euroc")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--scene", choices=["planes", "room"], default="planes")
    ap.add_argument("--scene-seed", type=int, default=0)
    ap.add_argument("--n-features", type=int, default=600)
    args = ap.parse_args(argv)

    from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM, CameraModel
    from gf_orb_slam_tpu_torch.io_utils import datasets

    cam = EUROC_CAM if args.scene == "room" else CameraModel(fx=458.0, fy=458.0, cx=376.0, cy=240.0, width=752,
                                                               height=480, fps=20.0)
    ts, frames, poses = render_frames(args.scene, args.scene_seed, args.frames, cam)
    if args.layout == "euroc":
        datasets.write_euroc(args.out, ts, frames, poses)
    else:
        write_tum(args.out, ts, frames, poses)
    settings = os.path.join(args.out, "settings.yaml")
    with open(settings, "w") as f:
        f.write(SETTINGS_TEMPLATE.format(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, k1=cam.k1, k2=cam.k2, p1=cam.p1,
                                         p2=cam.p2, k3=cam.k3, fps=cam.fps, width=cam.width, height=cam.height,
                                         n_features=args.n_features))
    print(f"wrote {args.frames} frames ({args.layout}) + {settings}")


if __name__ == "__main__":
    main()
