"""Per-stage device times of the tracking step and the keyframe insertion
(port of gf_orb_slam_tpu/io_utils/stage_probe.py), for the TimeLog.

The reference fuses a frame (and an insertion) into one device program and
recovers each stage's time from chained dispatches of program variants.
Here every stage is its own call, so on a card CUDA events bracket each one
directly (on the CPU the host clock does), and only the stages that live
inside another call come from differences of variants:

    extraction       = t(make_frame)
    initial_track    = t(track_with_motion_model)
    local_map_track  = t(track_local_map, GF off)
    gf_selection     = t(track_local_map, GF on) − t(GF off)
    keyframe_insert  = t(insert_keyframe_fused)
    triangulation    = t(insertion) − t(n_tri_neighbors=0)
    fusion           = t(insertion) − t(n_fuse_neighbors=0)
    local_ba         = t(insertion) − t(ba_iters=(0, 0))

Each time is the median of `reps` calls after one warm-up call. The probe
works on the system's current map and last frame and changes neither (the
insertion variants return new maps, which are dropped; GF noise comes from
a generator of its own).
"""

from __future__ import annotations

import statistics
import time

import torch

from gf_orb_slam_tpu_torch.geometry import pwls, se3
from gf_orb_slam_tpu_torch.mapping import frame as frame_mod
from gf_orb_slam_tpu_torch.pipeline import local_mapping
from gf_orb_slam_tpu_torch.pipeline import tracking as trk

STAGES = ("extraction", "initial_track", "local_map_track", "gf_selection", "keyframe_insert", "triangulation",
          "fusion", "local_ba")


def _time_ms(fn, device: torch.device, reps: int) -> float:
    """Median ms of fn() over reps calls after one warm-up: CUDA events on a
    card, the host clock on the CPU."""
    fn()
    out = []
    for _ in range(reps):
        if device.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def probe_device_stages(system, img, reps: int = 3) -> dict:
    """Per-stage ms (STAGES) at the system's current configuration and map,
    tracking `img` (an (H, W) frame) from its last pose. Call on a WORKING
    system with a few keyframes; the result is also set as
    system.time_log.device_stages_ms."""
    cam, cfg, orb_cfg, dev = system.cam, system.cfg, system.orb_cfg, system.device
    m, view = system.map, system.track_view
    last_pose, last_obs, last_uv = system.last_pose, system.last_obs, system.last_frame.uv
    img = torch.as_tensor(img).to(device=dev, dtype=torch.float32)
    kw = dict(scale=cfg.scale, n_levels=cfg.n_levels)

    frame = frame_mod.make_frame(img, cam, orb_cfg)
    pose_pred = se3.compose(system.velocity, last_pose)
    r = trk.track_with_motion_model(cam, m, frame, pose_pred, last_obs, last_uv, radius=15.0, **kw)
    t0 = torch.zeros((), dtype=torch.float32, device=dev)
    dt = t0 + 1.0 / cam.fps
    Xv = pwls.state_from_pose_pair(t0, last_pose, dt, r.pose)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    noise = trk.sample_gf_noise(cfg.gf_mode, view.capacity, cfg.gf_budget, cfg.gf_batch, gen)

    def local_map(gf: bool):
        return lambda: trk.track_local_map(cam, m, view, frame, r.pose, r.obs_point, Xv, noise, gf_budget=cfg.gf_budget,
                                           use_gf=gf, gf_mode=cfg.gf_mode, gf_batch=cfg.gf_batch, dt=dt, **kw)

    a, ins_kw = system.insertion_args(system.last_frame, last_pose, last_obs, system.frame_id, 0.0)

    def insertion(**variant):
        return lambda: local_mapping.insert_keyframe_fused(*a, **(ins_kw | variant))

    t = {
        "extraction": _time_ms(lambda: frame_mod.make_frame(img, cam, orb_cfg), dev, reps),
        "initial_track": _time_ms(lambda: trk.track_with_motion_model(cam, m, frame, pose_pred, last_obs, last_uv,
                                                                      radius=15.0, **kw), dev, reps),
        "gf_off": _time_ms(local_map(False), dev, reps),
        "gf_on": _time_ms(local_map(True), dev, reps) if cfg.use_gf else None,
        "insert": _time_ms(insertion(), dev, reps),
        "no_tri": _time_ms(insertion(n_tri_neighbors=0), dev, reps),
        "no_fuse": _time_ms(insertion(n_fuse_neighbors=0), dev, reps),
        "no_ba": _time_ms(insertion(ba_iters=(0, 0)), dev, reps),
    }
    out = {
        "extraction": t["extraction"],
        "initial_track": t["initial_track"],
        "local_map_track": t["gf_off"],
        "gf_selection": max(t["gf_on"] - t["gf_off"], 0.0) if t["gf_on"] is not None else 0.0,
        "keyframe_insert": t["insert"],
        "triangulation": max(t["insert"] - t["no_tri"], 0.0),
        "fusion": max(t["insert"] - t["no_fuse"], 0.0),
        "local_ba": max(t["insert"] - t["no_ba"], 0.0),
    }
    system.time_log.device_stages_ms = out
    return out
