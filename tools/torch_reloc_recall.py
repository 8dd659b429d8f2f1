#!/usr/bin/env python3
"""Relocalization recall of the PyTorch port (tools/reloc_recall.py on the port).

    python tools/torch_reloc_recall.py [--seeds 5] [--frames 300] [--gf-budget 100] \
        [--device cuda] [--out results/torch_reloc_recall.json]

Per scene seed on the room circuit (radius 4.0 − 0.2·(seed mod 3), phase
0.61·seed, the EuRoC camera, keyframe cadence 6, GF at --gf-budget, the
packaged 1M-word vocabulary, `SlamSystem(seed=seed)`), two disturbances from
io_utils/reloc_eval.py: blackout (8 black frames from 60% of the sequence)
and kidnap (the same, then the camera a quarter revolution back). Frames are
rendered on the CPU and rounded to uint8 (the reference's tool feeds its
float renders). Per episode: recovered, frames to recover, post-recovery
error, false relocalization, keyframes, final state, relocalization and
compaction frames, and the lost frames' median ms; then the recall summary
beside the reference's recorded one (docs/reloc_recall.json). Runs on the
first CUDA card unless --device cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
REFERENCE = os.path.join(REPO, "docs", "reloc_recall.json")


def run_one(seed: int, kind: str, n_frames: int, budget: int, dev, voc) -> dict:
    import torch

    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu_torch.io_utils import reloc_eval, synthetic
    from gf_orb_slam_tpu_torch.pipeline.system import SlamSystem

    cam = EUROC_CAM
    scene = synthetic.make_room_scene(seed=seed)
    revs = run_slam.circuit_revs(n_frames)
    ts, poses_gt = synthetic.circuit_trajectory(n_frames, fps=cam.fps, radius=4.0 - 0.2 * (seed % 3), revs=revs,
                                                phase=0.61 * seed)
    src = reloc_eval.frame_src(n_frames, kind, revs)
    system = SlamSystem(cam, run_slam.room_config(use_gf=budget > 0, gf_budget=max(budget, 1)), device=dev, seed=seed)
    system.set_vocabulary(voc)
    black = torch.zeros((cam.height, cam.width), dtype=torch.float32, device=dev)
    states, centers, ms = [], [], []
    t0 = time.perf_counter()
    for i, s in enumerate(src):
        img = black if s < 0 else torch.clamp(torch.round(
            synthetic.render_general(scene, cam, torch.from_numpy(poses_gt[s]))), 0, 255).to(dev)
        log = system.process(img, float(ts[i]))
        states.append(log.state)
        centers.append(None if log.pose_cw is None else run_slam.camera_centers(log.pose_cw[None])[0])
        ms.append(log.timing_ms.get("total", 0.0))
    system.flush()
    lost_ms = [ms[i] for i in range(1, n_frames) if states[i - 1] == "LOST"]  # frames met in LOST
    reloc = [i for i in range(1, n_frames) if states[i - 1] == "LOST" and states[i] == "WORKING"]
    return {"seed": seed, "kind": kind, "frames": n_frames,
            **reloc_eval.recovery(states, centers, src, run_slam.camera_centers(poses_gt)),
            "keyframes": system.n_kf, "final_state": system.state.name, "reloc_frames": reloc,
            "compactions": [list(c) for c in system.compactions], "loops_closed": system.n_loops_closed,
            "lost_frame_ms_median": statistics.median(lost_ms) if lost_ms else None,
            "seconds": time.perf_counter() - t0}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--gf-budget", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(REPO, "results", "torch_reloc_recall.json"))
    args = ap.parse_args()

    import torch

    from gf_orb_slam_tpu_torch.io_utils import reloc_eval
    from gf_orb_slam_tpu_torch.pipeline.system import resolve_device
    from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

    dev = resolve_device(args.device)
    header = {"torch": torch.__version__, "device": str(dev)}
    if dev.type == "cuda":
        header["nvidia_smi"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                              capture_output=True, text=True).stdout.strip()
    else:
        header["cpu_threads"] = torch.get_num_threads()
    print(json.dumps(header), flush=True)
    voc = voc_mod.load_default_vocabulary(dev)
    rows = []
    for seed in range(args.seeds):
        for kind in ("blackout", "kidnap"):
            rows.append(run_one(seed, kind, args.frames, args.gf_budget, dev, voc))
            print(json.dumps(rows[-1]), flush=True)
    summary = reloc_eval.recall_summary(rows)
    with open(REFERENCE) as f:
        ref = json.load(f)
    ref_rows = {(r["seed"], r["kind"]): r for r in ref["runs"]}
    table = [{"seed": r["seed"], "kind": r["kind"],
              "port": {k: r[k] for k in ("recovered", "frames_to_recover", "post_recovery_err_m", "false_reloc")},
              "reference": {k: ref_rows[(r["seed"], r["kind"])][k] for k in
                            ("recovered", "frames_to_recover", "post_recovery_err_m", "false_reloc")}
              if (r["seed"], r["kind"]) in ref_rows else None} for r in rows]
    out = {**header, "runs": rows, **summary, "beside_reference": table,
           "reference_summary": {k: v for k, v in ref.items() if k != "runs"}}
    print(json.dumps({k: v for k, v in out.items() if k not in ("runs", "beside_reference")}), flush=True)
    for row in table:
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
