#!/usr/bin/env python3
"""Run the port's SlamSystem over the bench sequence with several seeds of
the initializer's sampling, and print one JSON line per seed: first WORKING
frame, tracked and LOST frames, keyframes inserted, insertion frames and ATE.

    python tools/torch_seed_sweep.py --seeds 1 2 3 4 [--device cuda]

The sequence and configuration are those of chip_smoke.py's system phase
(the system fixture's camera, scene seed and frame count; bench
configuration); each seed runs about a minute on one H100.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYSTEM_FIXTURE = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "system_fixture.npz")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import numpy as np

    from gf_orb_slam_tpu_torch import run_slam

    with np.load(SYSTEM_FIXTURE) as z:
        meta = json.loads(str(z["meta"]))
        ref_insert_frames = [int(f) for f in z["insert_frames"][1:]]
    cam = run_slam.BENCH_CAMERA._replace(**{k: meta["camera"][k] for k in ("fx", "fy", "cx", "cy", "width", "height", "fps")})
    F = meta["frames"]
    ts, poses_gt, frames = run_slam.render_sequence(cam, meta["trajectory_frames"], meta["scene_seed"], args.device)
    for seed in args.seeds:
        system, result = run_slam.run_sequence(cam, run_slam.bench_config(), ts[:F], poses_gt[:F], frames[:F],
                                               args.device, seed=seed)
        states = [lg.state for lg in system.logs]
        inserted = [i for i, lg in enumerate(system.logs) if "keyframe_insert" in lg.timing_ms]
        first_working = states.index("WORKING") if "WORKING" in states else -1
        print(json.dumps({
            "seed": seed, "first_working": first_working, "tracked": result["tracked"],
            "lost": states.count("LOST"),
            "keyframes_inserted": len(inserted) + (2 if first_working >= 0 else 0),
            "insert_frames_match_reference": inserted == ref_insert_frames,
            "ate_rmse_m": result.get("ate_rmse_m"), "ref_ate_rmse_m": meta["summary"]["ate_rmse_m"],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
