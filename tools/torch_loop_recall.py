#!/usr/bin/env python3
"""Loop-closure recall of the PyTorch port (tools/loop_recall.py on the port).

    python tools/torch_loop_recall.py [--seeds 5] [--frames 420] [--revs 1.15] [--endurance] \
        [--gf-budget 100] [--device cuda] [--out results/torch_loop_recall.json]

Per scene seed on the room circuit (scene seed = seed, radius 4.0 −
0.2·(seed mod 3), phase 0.61·seed, `--revs` revolutions over `--frames`
frames; `--endurance` is 800 frames over 2.2), the EuRoC camera, keyframe
cadence 6, GF at --gf-budget (0 turns it off), the packaged 1M-word
vocabulary and `SlamSystem(seed=seed)`, with the recall hook set
(`io_utils/loop_eval.circuit_gt_overlap`): revisit events, episodes,
closed episodes, closures and false closures per run (io_utils/loop_eval.py),
then recall = closed episodes / episodes over the runs, beside the
reference's recorded summary (docs/loop_recall_circuit.json; the
reference's tool feeds its float renders, this one frames rounded to uint8,
as every run of the port). Runs on the first CUDA card unless --device cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
REFERENCE = os.path.join(REPO, "docs", "loop_recall_circuit.json")


def run_one(seed: int, n_frames: int, revs: float, budget: int, dev, voc) -> dict:
    import torch

    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu_torch.io_utils import loop_eval, synthetic
    from gf_orb_slam_tpu_torch.pipeline.system import SlamSystem

    cam = EUROC_CAM
    scene = synthetic.make_room_scene(seed=seed)
    ts, poses_gt = synthetic.circuit_trajectory(n_frames, fps=cam.fps, radius=4.0 - 0.2 * (seed % 3), revs=revs,
                                                phase=0.61 * seed)
    system = SlamSystem(cam, run_slam.room_config(use_gf=budget > 0, gf_budget=max(budget, 1)), device=dev, seed=seed)
    system.set_vocabulary(voc)
    gt_overlap = loop_eval.circuit_gt_overlap(n_frames, revs)
    system.loop_gt_overlap = gt_overlap
    t0 = time.perf_counter()
    for i in range(n_frames):
        img = torch.clamp(torch.round(synthetic.render_general(scene, cam, torch.from_numpy(poses_gt[i]))), 0, 255)
        system.process(img.to(dev), float(ts[i]))
    system.flush()
    return {"seed": seed, "frames": n_frames, "revs": revs, "state": system.state.name, "keyframes": system.n_kf,
            **loop_eval.recall_summary(system.loop_events, system.map.kf_frame_id.cpu().numpy(), gt_overlap),
            "loop_frames": [e["frame"] for e in system.loop_events if e["closed"]],
            "seconds": time.perf_counter() - t0}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--frames", type=int, default=420)
    ap.add_argument("--revs", type=float, default=1.15)
    ap.add_argument("--endurance", action="store_true", help="800 frames over 2.2 revolutions")
    ap.add_argument("--gf-budget", type=int, default=100, help="0 turns GF off")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(REPO, "results", "torch_loop_recall.json"))
    args = ap.parse_args()
    if args.endurance:
        args.frames, args.revs = 800, 2.2

    import torch

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
        rows.append(run_one(seed, args.frames, args.revs, args.gf_budget, dev, voc))
        print(json.dumps(rows[-1]), flush=True)
    episodes = sum(r["episodes"] for r in rows)
    closed = sum(r["closed_episodes"] for r in rows)
    summary = {"episodes": episodes, "closed_episodes": closed, "recall": closed / episodes if episodes else None,
               "false_closures": sum(r["false_closures"] for r in rows)}
    with open(REFERENCE) as f:
        ref = json.load(f)
    ref_rows = {r["seed"]: r for r in ref["runs"]}
    keys = ("episodes", "closed_episodes", "closures", "false_closures")
    table = [{"seed": r["seed"], "port": {k: r[k] for k in keys},
              "reference": {k: ref_rows[r["seed"]][k] for k in keys} if r["seed"] in ref_rows else None}
             for r in rows]
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
