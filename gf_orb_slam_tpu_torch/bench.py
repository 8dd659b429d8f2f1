"""Tracking throughput of the whole SLAM loop, one JSON line (port of the
repository's bench.py):

    python -m gf_orb_slam_tpu_torch.bench                 # on the first CUDA card
    python -m gf_orb_slam_tpu_torch.bench --device cpu --frames 48   # the shortest sequence: two windows

The bench's sequence (the planes scene, seed 0, 752×480, 20 fps) rendered on
the CPU and rounded to uint8, run through two SlamSystems in bench.py's
configuration with the packaged 1M-word vocabulary: GF on (subset mode,
budget 100: the primary line) and GF off (the secondary line). After a
warm-up of both, the systems process the same frames in interleaved windows,
the order alternating per window, so that drift of the host hits both lines
alike; the first window of each is dropped and the median of the rest
reported. Then the device-only rate: `chain` tracking steps chained from the
GF-on system's last state with one read at the end (each step still reads
its own wide-radius branch).

`vs_baseline` is frames/s ÷ 30 Hz, the C++ reference's real-time tracking
rate on a desktop CPU (SURVEY.md §6); `detail.device` names the card and
its power limit as nvidia-smi reports them. Any failure raises: the process
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

from gf_orb_slam_tpu_torch import run_slam
from gf_orb_slam_tpu_torch.pipeline import tracking
from gf_orb_slam_tpu_torch.pipeline.system import SlamSystem, resolve_device
from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

BASELINE_FPS = 30.0  # the C++ reference's real-time tracking rate (desktop CPU)
FRAMES, WARMUP, WINDOW, CHAIN = 240, 24, 12, 20


def device_name(device: torch.device) -> str:
    """The card's name and power limit from nvidia-smi, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    return out[device.index or 0].strip()


def _windows(systems: dict, ts, frames, start: int, window: int) -> dict:
    """Frames/s of each system over consecutive windows from `start`, the
    systems' order alternating per window."""
    names = list(systems)
    fps = {n: [] for n in names}
    for wi, w0 in enumerate(range(start, frames.shape[0], window)):
        w1 = min(w0 + window, frames.shape[0])
        for n in (names if wi % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            for i in range(w0, w1):
                systems[n].process(frames[i], float(ts[i]))
            fps[n].append((w1 - w0) / max(time.perf_counter() - t0, 1e-9))
    return fps


def device_only_fps(system: SlamSystem, img, chain: int) -> float:
    """Steps per second of `chain` tracking steps, each on the last image
    plus (i mod 3) and consuming the previous step's pose, read once at the
    end."""
    cfg = system.cfg
    dt = torch.full((), 0.05, dtype=torch.float32, device=system.device)
    key = torch.tensor([0, 1], dtype=torch.int64, device=system.device)

    def one(i, pose, obs, uv, vel):
        noise = tracking.sample_gf_noise(cfg.gf_mode, system.track_view.capacity, cfg.gf_budget, cfg.gf_batch,
                                         system.generator) if cfg.use_gf else None
        return tracking.track_frame_fused(
            system.cam, system.orb_cfg, system.map, system.track_view, img + float(i % 3), pose, obs, uv, vel,
            dt, key, scale=cfg.scale, n_levels=cfg.n_levels, gf_budget=cfg.gf_budget, use_gf=cfg.use_gf,
            gf_mode=cfg.gf_mode, gf_batch=cfg.gf_batch, gf_noise=noise)

    r = one(0, system.last_pose, system.last_obs, system.last_frame.uv, system.velocity)
    int(r.n_inliers)  # warm, and wait
    t0 = time.perf_counter()
    for i in range(chain):
        r = one(i, r.pose, r.obs_point, r.frame_uv, r.velocity)
    int(r.n_inliers)  # the one read drains the chain
    return chain / (time.perf_counter() - t0)


def run_bench(cam, cfg, ts, frames, voc, device, warmup: int = WARMUP, window: int = WINDOW,
              chain: int = CHAIN, seed: int = 0):
    """The bench over `frames` (on `device`): returns (result line,
    GF-on system, GF-off system)."""
    if frames.shape[0] < warmup + 2 * window:
        raise ValueError(f"{frames.shape[0]} frames leave fewer than two windows after a warm-up of {warmup}")
    systems = {"on": SlamSystem(cam, cfg, device=device, seed=seed),
               "off": SlamSystem(cam, dataclasses.replace(cfg, use_gf=False), device=device, seed=seed)}
    for s in systems.values():
        if voc is not None:
            s.set_vocabulary(voc)
    for i in range(warmup):
        for s in systems.values():
            s.process(frames[i], float(ts[i]))
    for s in systems.values():
        s.flush()
    win = _windows(systems, ts, frames, warmup, window)
    for s in systems.values():
        s.flush()
    on = systems["on"]
    fps = statistics.median_high(win["on"][1:])
    line = {
        "metric": "tracking_frames_per_second",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "detail": {
            "frames_measured": frames.shape[0] - warmup,
            "frames_tracked": sum(1 for lg in on.logs[warmup:] if lg.pose_cw is not None),
            "gf": {"on": True, "budget": cfg.gf_budget, "mode": cfg.gf_mode},
            "gf_off_fps": round(statistics.median_high(win["off"][1:]), 2),
            "n_features": cfg.n_features,
            "map_points": int(on.map.pt_valid.sum()),
            "keyframes": on.n_kf,
            "device": device_name(on.device),
            "window_fps_gf_on": [round(f, 2) for f in win["on"]],
            "window_fps_gf_off": [round(f, 2) for f in win["off"]],
            "device_only_fps": round(device_only_fps(on, frames[-1], chain), 2),
            "note": f"vs_baseline = frames/s / {BASELINE_FPS:g} Hz (the C++ reference's real-time rate); "
                    "device_only_fps chains the tracking steps with one read at the end",
        },
    }
    return line, systems["on"], systems["off"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help='"cuda" (default: fails without a card) or "cpu"')
    ap.add_argument("--frames", type=int, default=FRAMES,
                    help=f"frames of the bench sequence (at least {WARMUP + 2 * WINDOW})")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cam = run_slam.BENCH_CAMERA
    ts, _, frames = run_slam.render_sequence(cam, args.frames, 0, device)
    line, _, _ = run_bench(cam, run_slam.bench_config(), ts, frames, voc_mod.load_default_vocabulary(device), device)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
