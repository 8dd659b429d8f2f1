#!/usr/bin/env python3
"""The loop-verification gate study of the PyTorch port (tools/loop_gate_study.py on the port).

    python tools/torch_loop_gate_study.py [--seeds 10] [--frames 420] [--revs 1.15] \
        [--endurance-extra 2] [--gf-budget 100] [--probe-floor 8] [--device cuda] \
        [--out results/torch_loop_gate_events.json]
    python tools/torch_loop_gate_study.py --analyze EVENTS.json [...] [--out results/torch_loop_gate_pr.json]

Runs the shipped configuration over distinct room-circuit instances (scene
seed = seed, radius 4.0 − 0.2·(seed mod 3), phase 0.61·seed, --revs
revolutions over --frames frames; then --endurance-extra seeds 100, 101, …
at 800 frames over 2.2 revolutions), the EuRoC camera, keyframe cadence 6,
GF at --gf-budget, the packaged 1M-word vocabulary and `SlamSystem(seed=)`,
with `loop_probe_floor` --probe-floor: every candidate that reaches streak 2
is verified with the RANSAC floor lowered to it, so its whole funnel (n_bow
→ n_ransac → n_guided → n_opt) is recorded even where the shipped gates
(≥ 20 / ≥ 20 at streak 3) reject it, while the live decision keeps them.
Ground-truth labels come from the circuit's geometry
(`io_utils/loop_eval.circuit_gt_overlap`). Each candidate event also
carries its verified Sim3 against the ground truth
(`loop_eval.sim3_against_ground_truth`: rotation error in degrees, scale over
the map's scale ratio). Frames are rendered on the CPU and rounded to uint8.

--analyze sweeps (consistency, RANSAC floor, refine floor) offline over the
recorded funnels (`loop_eval.gate_sweep`, the reference tool's analysis):
per operating point, episode recall and false accepts, and the accepted
candidates' Sim3 error; printed beside the reference's recorded table
(docs/loop_gate_pr.json). A run also writes its analysis beside its events
(`<out>` with `_pr` before `.json`). Runs on the first CUDA card unless
--device cpu.
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
REFERENCE_PR = os.path.join(REPO, "docs", "loop_gate_pr.json")


def run_one(seed: int, n_frames: int, revs: float, budget: int, probe_floor: int, dev, voc) -> dict:
    import torch

    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu_torch.io_utils import loop_eval, synthetic
    from gf_orb_slam_tpu_torch.loop import loop_closing
    from gf_orb_slam_tpu_torch.pipeline.system import SlamSystem

    cam = EUROC_CAM
    scene = synthetic.make_room_scene(seed=seed)
    ts, poses_gt = synthetic.circuit_trajectory(n_frames, fps=cam.fps, radius=4.0 - 0.2 * (seed % 3), revs=revs,
                                                phase=0.61 * seed)
    cfg = run_slam.room_config(use_gf=budget > 0, gf_budget=max(budget, 1), loop_probe_floor=probe_floor)
    system = SlamSystem(cam, cfg, device=dev, seed=seed)
    system.set_vocabulary(voc)
    system.loop_gt_overlap = loop_eval.circuit_gt_overlap(n_frames, revs)

    verify = loop_closing.verify_candidate
    sim3s = []

    def recording_verify(cam_, m, db, query_kf, cand_kf, *a, **kw):
        lm = verify(cam_, m, db, query_kf, cand_kf, *a, **kw)
        sim3s.append(loop_eval.sim3_against_ground_truth(
            lm.S12.cpu().numpy(), int(query_kf), int(cand_kf), m.kf_pose.cpu().numpy(),
            m.kf_frame_id.cpu().numpy(), m.kf_valid.cpu().numpy(), poses_gt))
        return lm

    loop_closing.verify_candidate = recording_verify
    t0 = time.perf_counter()
    try:
        for i in range(n_frames):
            img = torch.clamp(torch.round(synthetic.render_general(scene, cam, torch.from_numpy(poses_gt[i]))), 0, 255)
            system.process(img.to(dev), float(ts[i]))
        system.flush()
    finally:
        loop_closing.verify_candidate = verify
    events = [dict(ev) for ev in system.loop_gate_events]
    cands = [ev for ev in events if "cand" in ev]
    if len(cands) != len(sim3s):
        raise RuntimeError(f"seed {seed}: {len(cands)} candidate events but {len(sim3s)} verifications")
    for ev, s in zip(cands, sim3s):
        ev.update({k: round(v, 4) for k, v in s.items()})
    return {"seed": seed, "frames": n_frames, "revs": revs, "state": system.state.name, "keyframes": system.n_kf,
            "closures_live": system.n_loops_closed,
            "episodes": [{"kfs": e["kfs"], "closed": e["closed"]} for e in loop_eval.episodes(system.loop_events)],
            "gate_events": events, "seconds": time.perf_counter() - t0}


def analyze(runs: list[dict]) -> dict:
    """loop_eval.gate_sweep, with the Sim3 error of the candidates each
    operating point accepts where the events carry it."""
    from gf_orb_slam_tpu_torch.io_utils import loop_eval

    res = loop_eval.gate_sweep(runs)
    cands = [ev for r in runs for ev in r["gate_events"] if "cand" in ev and "rotation_error_deg" in ev]
    for row in res["operating_points"]:
        acc = [ev for ev in cands if ev["streak"] >= row["consistency"] and ev["n_ransac"] >= row["ransac_th"]
               and ev["n_opt"] >= row["refine_th"]]
        if cands:
            row["accepted"] = len(acc)
            row["accepted_over_5deg"] = sum(ev["rotation_error_deg"] >= 5 for ev in acc)
            row["accepted_scale_off_10pct"] = sum(abs(ev["scale_error"] - 1) >= 0.1 for ev in acc)
    return res


def print_table(res: dict) -> None:
    with open(REFERENCE_PR) as f:
        ref = {(r["consistency"], r["ransac_th"], r["refine_th"]): r for r in json.load(f)["operating_points"]}
    print(json.dumps({k: v for k, v in res.items() if k != "operating_points"}), flush=True)
    for row in res["operating_points"]:
        r = ref.get((row["consistency"], row["ransac_th"], row["refine_th"]))
        print(json.dumps({**row, "reference": None if r is None else {
            k: r[k] for k in ("episodes_closed", "episodes", "recall", "false_accepts")}}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--frames", type=int, default=420)
    ap.add_argument("--revs", type=float, default=1.15)
    ap.add_argument("--endurance-extra", type=int, default=2, help="then this many 800-frame 2.2-revolution seeds")
    ap.add_argument("--gf-budget", type=int, default=100)
    ap.add_argument("--probe-floor", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--analyze", nargs="*", default=None, help="skip running; analyze these event JSONs")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    if args.analyze is not None:
        runs = []
        for p in args.analyze:
            with open(p) as f:
                runs.extend(json.load(f)["runs"])
        res = analyze(runs)
        print_table(res)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(res, f, indent=1)
        return

    import torch

    from gf_orb_slam_tpu_torch.pipeline.system import resolve_device
    from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

    dev = resolve_device(args.device)
    header = {"torch": torch.__version__, "device": str(dev), "probe_floor": args.probe_floor}
    if dev.type == "cuda":
        header["nvidia_smi"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                              capture_output=True, text=True).stdout.strip()
    print(json.dumps(header), flush=True)
    voc = voc_mod.load_default_vocabulary(dev)
    jobs = [(s, args.frames, args.revs) for s in range(args.seeds)]
    jobs += [(100 + s, 800, 2.2) for s in range(args.endurance_extra)]
    runs = []
    for seed, n, revs in jobs:
        runs.append(run_one(seed, n, revs, args.gf_budget, args.probe_floor, dev, voc))
        print(json.dumps({k: v for k, v in runs[-1].items() if k != "gate_events"}), flush=True)
    out = args.out or os.path.join(REPO, "results", "torch_loop_gate_events.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({**header, "runs": runs}, f, indent=1)
    res = analyze(runs)
    print_table(res)
    with open(out.replace(".json", "_pr.json"), "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
