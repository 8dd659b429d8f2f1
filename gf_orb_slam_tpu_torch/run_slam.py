"""Command line of the port: run the SLAM system over a dataset sequence on
disk (EuRoC, TUM-RGBD or NUIM layout) or a synthetic one (the planes sweep,
or the room circuit that closes a loop) and write TUM trajectories, the time
log and a result JSON, as the reference's run_slam.py does.

    python -m gf_orb_slam_tpu_torch.run_slam --seq /data/EuRoC/MH_01_easy --settings EuRoC.yaml \
        --gf-budget 100 --out results/MH01 [--save-map mh01.npz] [--probe-stages]
    python -m gf_orb_slam_tpu_torch.run_slam --seq /data/EuRoC/MH_02_easy --settings EuRoC.yaml \
        --gf-budget 100 --load-map mh01.npz
    python -m gf_orb_slam_tpu_torch.run_slam --synthetic 240 --gf-budget 100 --out results/port
    python -m gf_orb_slam_tpu_torch.run_slam --synthetic 420 --scene room --gf-budget 100
    python -m gf_orb_slam_tpu_torch.run_slam --synthetic 40 --gf-budget 100 --device cpu
    python -m gf_orb_slam_tpu_torch.run_slam --synthetic 240 --gf-budget 100 --gf-mode active

The run is on the first CUDA card unless `--device cpu` asks for the CPU.
Place recognition (relocalization, loop closing) is on, with the packaged
1M-word vocabulary (gf_orb_slam_tpu/data/vocab_1m.npz, read by path) unless
`--vocabulary` names another (.npz, or DBoW2 .txt). Synthetic frames are
rendered on the CPU and rounded to uint8, as a camera would deliver them;
a sequence's frames are read ahead of the tracker (io_utils/prefetch.py).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Iterable

import numpy as np
import torch

from gf_orb_slam_tpu_torch.geometry import se3
from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM, CameraModel
from gf_orb_slam_tpu_torch.io_utils import datasets, evaluation, images, prefetch, snapshot, stage_probe, synthetic
from gf_orb_slam_tpu_torch.io_utils.settings import load_settings
from gf_orb_slam_tpu_torch.pipeline.system import FrameLog, SlamConfig, SlamSystem, resolve_device
from gf_orb_slam_tpu_torch.pipeline.tracking import GF_MODES
from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

BENCH_CAMERA = CameraModel(fx=458.0, fy=458.0, cx=376.0, cy=240.0, width=752, height=480, fps=20.0)


def bench_config(**overrides) -> SlamConfig:
    """The bench's shipped configuration (bench.py: 800 features, GF subset
    mode at budget 100, keyframe cadence 10, GF after 10 frames, place
    recognition on)."""
    kw = dict(n_features=800, max_frames_between_kf=10, use_gf=True, gf_budget=100, gf_warmup_frames=10)
    kw.update(overrides)
    return SlamConfig(**kw)


def room_config(**overrides) -> SlamConfig:
    """The reference CLI's room circuit (`--scene room`: keyframe cadence 6)
    at GF budget 100."""
    kw = dict(max_frames_between_kf=6, use_gf=True, gf_budget=100)
    kw.update(overrides)
    return SlamConfig(**kw)


def circuit_revs(n_frames: int) -> float:
    """Revolutions of the room circuit over n_frames (one in ~270 frames,
    at most 1.1), as the reference CLI sets them."""
    return min(1.1, n_frames / 270.0)


def render_sequence(cam: CameraModel, n_frames: int, scene_seed: int = 0, device=None, scene: str = "planes",
                    render_device="cpu"):
    """(timestamps (F,), ground-truth T_cw poses (F, 7), frames (F, H, W)
    float32 rounded to uint8 values, on `device`: the first CUDA card unless
    given). The room circuit makes a full revolution in ~270 frames and
    overlaps its start by up to 10%.

    The frames are the run's input data, as frames read from disk would be,
    so they are rendered on the CPU and moved to `device`: a card's own
    render rounds the ray casts differently and changes a few thousand
    pixels of a sequence (by up to 41 grey levels where a ray grazes a
    wall's edge), and its runs then start from other images.
    `render_device` renders elsewhere (tools/torch_card_vs_cpu.py compares
    the two)."""
    device = resolve_device(device)
    ts, poses_gt, frames = render_frames(cam, n_frames, scene_seed, scene, render_device=render_device)
    return ts, poses_gt, frames.to(device).to(torch.float32)


def render_frames(cam: CameraModel, n_frames: int, scene_seed: int = 0, scene: str = "planes", start: int = 0,
                  stop: int | None = None, render_device="cpu"):
    """(timestamps (F,), ground-truth T_cw poses (F, 7), frames [start,
    stop) of the F-frame sequence as uint8 (n, H, W) on `render_device`):
    render_sequence's images, a share at a time, so that several processes
    can render one sequence. Each frame is rendered on its own, so a share
    holds the same bits as the whole sequence's frames."""
    if scene == "room":
        world = synthetic.make_room_scene(seed=scene_seed, device=render_device)
        ts, poses_gt = synthetic.circuit_trajectory(n_frames, fps=cam.fps, radius=4.0, revs=circuit_revs(n_frames))
        render = synthetic.render_general
    else:
        world = synthetic.make_scene(seed=scene_seed, device=render_device)
        ts, poses_gt = synthetic.trajectory(n_frames, fps=cam.fps)
        render = synthetic.render
    stop = n_frames if stop is None else stop
    frames = [torch.clamp(torch.round(render(world, cam, torch.from_numpy(poses_gt[i]))), 0, 255).to(torch.uint8)
              for i in range(start, stop)]
    frames = torch.stack(frames) if frames else torch.empty((0, cam.height, cam.width), dtype=torch.uint8,
                                                             device=render_device)
    return ts, poses_gt, frames


def camera_centers(poses_cw) -> np.ndarray:
    """(F, 3) camera centres of T_cw poses."""
    p = torch.as_tensor(np.asarray(poses_cw, np.float32))
    return se3.pose_t(se3.inverse(p)).numpy()


def process_frames(system: SlamSystem, frames: Iterable, on_frame: Callable[[int, FrameLog], None] | None = None,
                   max_frames: int = 0) -> int:
    """Feed (timestamp, image) pairs to `system` in order, at most
    `max_frames` of them when it is > 0, then flush; returns the count."""
    n = 0
    for t, img in frames:
        log = system.process(img, float(t))
        if on_frame is not None:
            on_frame(n, log)
        n += 1
        if max_frames and n >= max_frames:
            break
    system.flush()
    return n


def summarize(system: SlamSystem, n_frames: int) -> dict:
    """The result summary of a run (frames, tracked, keyframes, map points,
    loops closed, timing)."""
    return {
        "frames": n_frames,
        "tracked": len(system.trajectory),
        "keyframes": int(system.n_kf),
        "keyframes_valid": int(system.map.kf_valid.sum()),
        "map_points": int(system.map.pt_valid.sum()),
        "loops_closed": system.n_loops_closed,
        "timing": system.time_log.summary(),
    }


def run_sequence(
    cam: CameraModel,
    cfg: SlamConfig,
    ts: np.ndarray,
    poses_gt: np.ndarray,
    frames: torch.Tensor,
    device=None,
    seed: int = 0,
    on_frame: Callable[[int, FrameLog], None] | None = None,
    vocabulary: voc_mod.Vocabulary | None = None,
    loop_gt_overlap: Callable[[int, int], bool] | None = None,
) -> tuple[SlamSystem, dict]:
    """Process every frame on `device` (the first CUDA card unless given),
    with `vocabulary` preset and the loop-recall hook `loop_gt_overlap` set
    if given; returns the system and the result summary (frames, tracked,
    keyframes, map points, loops closed, timing, ATE against the ground
    truth when more than 10 frames were tracked)."""
    system = SlamSystem(cam, cfg, device=device, seed=seed)
    system.loop_gt_overlap = loop_gt_overlap
    if vocabulary is not None:
        system.set_vocabulary(vocabulary)
    n = process_frames(system, ((ts[i], frames[i]) for i in range(frames.shape[0])), on_frame)
    result = summarize(system, n)
    est_ts, est_poses = system.get_trajectory()
    if len(est_poses) > 10:
        gt_by_t = {round(float(t), 6): c for t, c in zip(ts, camera_centers(poses_gt))}
        gt_pos = np.stack([gt_by_t[round(float(t), 6)] for t in est_ts])
        result["ate_rmse_m"] = evaluation.ate_rmse(camera_centers(est_poses), gt_pos)
    return system, result


def write_outputs(system: SlamSystem, result: dict, out: str) -> None:
    """`{out}_AllFrameTrajectory.txt`, `_KeyFrameTrajectory.txt`,
    `_TimeLog.txt` and `_result.json`."""
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    est_ts, est_poses = system.get_trajectory()
    evaluation.write_tum_trajectory(f"{out}_AllFrameTrajectory.txt", est_ts, est_poses)
    kf_valid = system.map.kf_valid.cpu().numpy()
    kf_ts = system.map.kf_timestamp.cpu().numpy()[kf_valid]
    kf_poses = system.map.kf_pose.cpu().numpy()[kf_valid]
    order = np.argsort(kf_ts)
    evaluation.write_tum_trajectory(f"{out}_KeyFrameTrajectory.txt", kf_ts[order], kf_poses[order])
    system.time_log.save(f"{out}_TimeLog.txt")
    with open(f"{out}_result.json", "w") as f:
        json.dump(result, f, indent=2, default=float)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--seq", help="dataset sequence directory (EuRoC, TUM-RGBD or NUIM layout)")
    src.add_argument("--synthetic", type=int, help="run N frames of a synthetic scene")
    ap.add_argument("--scene", choices=["planes", "room"], default="planes",
                    help="the fronto-parallel plane sweep, or the 4-wall room circuit (radtan-distorted "
                         "EuRoC camera, oblique walls, a loop to close)")
    ap.add_argument("--settings", help="OpenCV-YAML settings file (camera and ORB extractor)")
    ap.add_argument("--vocabulary", help="pretrained BoW vocabulary (.txt DBoW2 text or .npz binary); "
                                         "default: the packaged 1M-word tree")
    ap.add_argument("--gf-budget", type=int, default=0, help="good-feature budget (0 = GF off)")
    ap.add_argument("--gf-mode", default="subset", choices=list(GF_MODES),
                    help="selection variant: subset=7x7 exact Max-logDet (determinant lemma), "
                         "hybrid=13x13 [H;H*F], lazier=lazier-greedy, auto=gain-floor budget, "
                         "active=select-then-match, random/longlive=ablation baselines")
    ap.add_argument("--gf-warmup", type=int, default=-1,
                    help="frames after initialization before GF selection starts; -1 keeps the config default")
    ap.add_argument("--init-gate", type=int, default=-1,
                    help="post-initialization gate: the fewest BA-surviving points of the second keyframe to "
                         "accept a two-view bootstrap; -1 keeps the config default")
    ap.add_argument("--n-features", type=int, default=0, help="override the ORB feature count")
    ap.add_argument("--max-frames", type=int, default=0, help="process at most this many frames (0 = all)")
    ap.add_argument("--save-map", help="write a map snapshot (.npz) at the end of the sequence")
    ap.add_argument("--load-map", help="resume from a map snapshot: start LOST and relocalize against it")
    ap.add_argument("--probe-stages", action="store_true",
                    help="after the run, time each tracking and mapping stage on the device and record the "
                         "times in the time log and the result JSON")
    ap.add_argument("--out", default="results/port", help="output prefix")
    ap.add_argument("--device", default="cuda", help='"cuda" (default: fails without a card) or "cpu"')
    ap.add_argument("--seed", type=int, default=0, help="sampling seed (RANSAC, the random GF modes)")
    ap.add_argument("--scene-seed", type=int, default=0, help="synthetic scene texture seed")
    return ap.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> tuple[CameraModel, SlamConfig]:
    """The camera and SlamConfig a command line asks for."""
    if args.settings:
        cam, cfg = load_settings(args.settings)
        cfg.gf_mode = args.gf_mode
    elif args.synthetic and args.scene == "room":
        cam, cfg = EUROC_CAM, SlamConfig(max_frames_between_kf=6, gf_mode=args.gf_mode)
    else:
        cam, cfg = BENCH_CAMERA, SlamConfig(gf_mode=args.gf_mode)
    if args.n_features:
        cfg.n_features = args.n_features
    if args.gf_budget > 0:
        cfg.use_gf = True
        cfg.gf_budget = args.gf_budget
    if args.gf_warmup >= 0:
        cfg.gf_warmup_frames = args.gf_warmup
    if args.init_gate >= 0:
        cfg.init_min_points = args.init_gate
    return cam, cfg


def main(argv=None) -> int:
    args = parse_args(argv)
    cam, cfg = config_from_args(args)
    device = resolve_device(args.device)
    voc = (voc_mod.load_vocabulary(args.vocabulary, device) if args.vocabulary
           else voc_mod.load_default_vocabulary(device))
    system = SlamSystem(cam, cfg, device=device, seed=args.seed)
    if voc is not None:
        print(f"vocabulary: {voc.n_words} words", file=sys.stderr)
        system.set_vocabulary(voc)
    if args.load_map:
        system.load_map_state(*snapshot.load_map(args.load_map, device))

    def progress(i, log):
        if (i + 1) % 50 == 0:
            print(f"[{i + 1}] {log.state} inliers={log.n_inliers} kfs={system.n_kf} "
                  f"loops={system.n_loops_closed}", file=sys.stderr)

    if args.synthetic:
        ts, poses_gt, frames = render_sequence(cam, args.synthetic, args.scene_seed, device, scene=args.scene)
        n = process_frames(system, ((ts[i], frames[i]) for i in range(args.synthetic)), progress, args.max_frames)
    else:
        seq = datasets.detect_and_load(args.seq)
        with prefetch.FramePrefetcher(seq.image_paths, cam.width, cam.height) as pf:
            n = process_frames(system, ((seq.timestamps[i], img) for i, img in pf), progress, args.max_frames)

    if args.probe_stages and system.state.name == "WORKING" and n:
        # The last frame again, each stage timed apart on the device.
        img = frames[n - 1] if args.synthetic else images.read_gray(seq.image_paths[n - 1])
        stage_probe.probe_device_stages(system, img)
    result = summarize(system, n)
    est_ts, est_poses = system.get_trajectory()
    if args.synthetic:
        gt_by_t = {round(float(t), 6): c for t, c in zip(ts, camera_centers(poses_gt))}
        if len(est_poses) > 10:
            gt_pos = np.stack([gt_by_t[round(float(t), 6)] for t in est_ts])
            result["ate_rmse_m"] = evaluation.ate_rmse(camera_centers(est_poses), gt_pos)
    else:
        gt_pos, ok = datasets.associate_ground_truth(seq, est_ts)
        if gt_pos is not None and ok.sum() > 10:
            result["ate_rmse_m"] = evaluation.ate_rmse(camera_centers(est_poses)[ok], gt_pos[ok])
    if system.time_log.device_stages_ms:
        result["device_stages_ms"] = system.time_log.device_stages_ms
    write_outputs(system, result, args.out)
    if args.save_map:
        snapshot.save_map(args.save_map, system.map, system.voc, system.bow_db)
    print(json.dumps(result, indent=2, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
