#!/usr/bin/env python3
"""Where the port's run on a CUDA card leaves its run on the CPU.

    python tools/torch_card_vs_cpu.py [--frames 240] [--room-frames 420] \
        [--modes subset hybrid] [--no-cpu-runs] [--out results/card_vs_cpu.json]

1. Renders the bench sequence (bench.py's camera, scene seed 0) and the room
   circuit on the card and on the CPU, and counts the pixels where the
   rounded uint8 frames differ, the largest |Δ|, the float renders' largest
   difference and the frames that differ.
2. Runs SlamSystem over the bench sequence in each mode of --modes (bench.py's
   configuration, the packaged 1M-word vocabulary, seed 0) on the card:
   once on the card's frames, twice on the CPU's frames moved to the card,
   and twice more on the CPU's frames under
   `torch.use_deterministic_algorithms(True)` (where an op has no
   deterministic version it raises: the run is repeated with warn_only and
   the warnings are listed); and once on the CPU with the CPU's frames.
3. For each pair of runs, the first frame where the poses, the tracked
   observations (`obs_point`) or the keyframe insertions differ, and each
   run's ATE and keyframes against the reference's recorded run.

Prints one JSON line per render and per run, then the comparisons, and
writes everything to --out. Needs one CUDA card; the CPU runs take about a
second per frame on 8 cores.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings

# cuBLAS is deterministic only with a fixed workspace configuration, which
# must be set before its first use (the deterministic runs need it).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLACE_FIXTURE = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "place_fixture.npz")
GF_MODES_FIXTURE = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "gf_modes_fixture.npz")


def reference_run(mode: str) -> dict:
    """The reference's recorded bench run of `mode` (summary, insertion frames)."""
    import numpy as np

    run, path = ("bench", PLACE_FIXTURE) if mode == "subset" else (mode, GF_MODES_FIXTURE)
    with np.load(path) as z:
        meta = json.loads(str(z[f"{run}_meta"]))
        return {"summary": meta["summary"], "insert_frames": z[f"{run}_insert_frames"][1:].tolist(),
                "frames": meta["frames"]}


def compare_renders(name: str, cam, n: int, dev, scene: str) -> tuple[dict, "object"]:
    """Card against CPU render of one sequence; returns (record, CPU frames)."""
    import torch

    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.io_utils import synthetic

    t0 = time.perf_counter()
    ts, poses, card = run_slam.render_sequence(cam, n, 0, dev, scene=scene, render_device=dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, cpu = run_slam.render_sequence(cam, n, 0, "cpu", scene=scene)
    cpu_s = time.perf_counter() - t0
    diff = (card.cpu() - cpu).abs()
    per_frame = (diff > 0).flatten(1).sum(1)
    differing = torch.nonzero(per_frame).flatten().tolist()
    # The float renders of the first differing frame (or frame 0), before rounding.
    f = differing[0] if differing else 0
    world_c = (synthetic.make_room_scene if scene == "room" else synthetic.make_scene)(seed=0, device=dev)
    world_h = (synthetic.make_room_scene if scene == "room" else synthetic.make_scene)(seed=0, device="cpu")
    render = synthetic.render_general if scene == "room" else synthetic.render
    fc = render(world_c, cam, torch.from_numpy(poses[f])).cpu()
    fh = render(world_h, cam, torch.from_numpy(poses[f]))
    fdiff = (fc - fh).abs()
    rec = {"render": name, "frames": n, "pixels": int(cpu[0].numel()) * n,
           "pixels_differing": int((diff > 0).sum()), "max_abs_diff": float(diff.max()),
           "frames_differing": len(differing), "first_differing_frame": differing[0] if differing else None,
           "float_frame": f, "float_pixels_differing": int((fdiff > 0).sum()),
           "float_max_abs_diff": float(fdiff.max()), "card_seconds": card_s, "cpu_seconds": cpu_s}
    return rec, (ts, poses, cpu)


def run(label: str, cam, cfg, ts, poses_gt, frames, voc, dev, deterministic: bool = False) -> dict:
    """SlamSystem over every frame on `dev`; per-frame state, pose and obs_point."""
    import numpy as np
    import torch

    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.io_utils import evaluation
    from gf_orb_slam_tpu_torch.pipeline.system import SlamSystem

    def go():
        system = SlamSystem(cam, cfg, device=dev, seed=0)
        system.set_vocabulary(voc)
        states, poses, obs, inserted = [], [], [], []
        for i in range(frames.shape[0]):
            log = system.process(frames[i].to(dev), float(ts[i]))
            states.append(log.state)
            poses.append(None if log.pose_cw is None else np.asarray(log.pose_cw, np.float32))
            obs.append(None if system.last_obs is None else system.last_obs.cpu().numpy())
            if "keyframe_insert" in log.timing_ms:
                inserted.append(i)
        system.flush()
        return system, states, poses, obs, inserted

    t0 = time.perf_counter()
    det_warnings: list[str] = []
    det_error = None
    if deterministic:
        torch.use_deterministic_algorithms(True)
        try:
            try:
                out = go()
            except RuntimeError as e:  # an op without a deterministic version
                det_error = str(e).splitlines()[0]
                torch.use_deterministic_algorithms(True, warn_only=True)
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    out = go()
                det_warnings = sorted({str(w.message).splitlines()[0] for w in caught})
        finally:
            torch.use_deterministic_algorithms(False)
    else:
        out = go()
    system, states, poses, obs, inserted = out
    est_ts, est_poses = system.get_trajectory()
    gt = dict(zip((round(float(t), 6) for t in ts), run_slam.camera_centers(poses_gt)))
    ate = (evaluation.ate_rmse(run_slam.camera_centers(est_poses), np.stack([gt[round(float(t), 6)] for t in est_ts]))
           if len(est_poses) > 10 else None)
    working = [i for i, s in enumerate(states) if s == "WORKING"]
    return {"label": label, "seconds": time.perf_counter() - t0, "ate_rmse_m": ate, "tracked": len(est_poses),
            "first_working": working[0] if working else -1,
            "keyframes_inserted": len(inserted) + (2 if working else 0), "insert_frames": inserted,
            "deterministic": deterministic, "deterministic_error": det_error,
            "deterministic_warnings": det_warnings, "_poses": poses, "_obs": obs, "_states": states}


def first_divergence(a: dict, b: dict) -> dict:
    """First frame where the two runs' state, pose or obs_point differ."""
    import numpy as np

    out = {"pair": [a["label"], b["label"]], "first_state": None, "first_pose": None, "first_pose_1e-5": None,
           "first_obs_point": None, "first_insert": None}
    for i, (sa, sb) in enumerate(zip(a["_states"], b["_states"])):
        pa, pb = a["_poses"][i], b["_poses"][i]
        if sa != sb and out["first_state"] is None:
            out["first_state"] = i
        if (pa is None) != (pb is None) or (pa is not None and not np.array_equal(pa, pb)):
            if out["first_pose"] is None:
                out["first_pose"] = i
                out["pose_max_abs_diff_there"] = None if pa is None or pb is None else float(np.abs(pa - pb).max())
            if out["first_pose_1e-5"] is None and (pa is None or pb is None or np.abs(pa - pb).max() > 1e-5):
                out["first_pose_1e-5"] = i
        oa, ob = a["_obs"][i], b["_obs"][i]
        if out["first_obs_point"] is None and ((oa is None) != (ob is None) or
                                               (oa is not None and not np.array_equal(oa, ob))):
            out["first_obs_point"] = i
            if oa is not None and ob is not None:
                either = (oa >= 0) | (ob >= 0)
                out["obs_point_agreement_there"] = float((oa == ob)[either].mean()) if either.any() else 1.0
    ia, ib = a["insert_frames"], b["insert_frames"]
    diff = [x for x, y in zip(ia, ib) if x != y]
    out["first_insert"] = diff[0] if diff else (None if len(ia) == len(ib) else min(ia[len(ib):] + ib[len(ia):]))
    out["bit_equal"] = all(v is None for k, v in out.items() if k.startswith("first_"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--room-frames", type=int, default=420)
    ap.add_argument("--modes", nargs="+", default=["subset", "hybrid"])
    ap.add_argument("--no-cpu-runs", action="store_true", help="skip the CPU runs (about a second per frame each)")
    ap.add_argument("--out", default=os.path.join("results", "card_vs_cpu.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("torch_card_vs_cpu.py needs a CUDA card", file=sys.stderr)
        return 1
    import subprocess

    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

    torch.set_num_threads(os.cpu_count() or 1)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    report: dict = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "torch": torch.__version__,
                    "cpu_threads": torch.get_num_threads(), "renders": [], "runs": [], "pairs": []}

    rec, (ts, poses_gt, cpu_frames) = compare_renders("bench", run_slam.BENCH_CAMERA, args.frames, dev, "planes")
    print(json.dumps(rec), flush=True)
    report["renders"].append(rec)
    rec, _ = compare_renders("room", EUROC_CAM, args.room_frames, dev, "room")
    print(json.dumps(rec), flush=True)
    report["renders"].append(rec)
    _, _, card_frames = run_slam.render_sequence(run_slam.BENCH_CAMERA, args.frames, 0, dev, render_device=dev)

    voc_card = voc_mod.load_default_vocabulary(dev)
    voc_cpu = voc_mod.load_default_vocabulary("cpu")
    for mode in args.modes:
        ref = reference_run(mode)
        cfg = run_slam.bench_config(gf_mode=mode)
        runs = [run(f"{mode}:card:card_frames", run_slam.BENCH_CAMERA, cfg, ts, poses_gt, card_frames, voc_card, dev),
                run(f"{mode}:card:cpu_frames:A", run_slam.BENCH_CAMERA, cfg, ts, poses_gt, cpu_frames, voc_card, dev),
                run(f"{mode}:card:cpu_frames:B", run_slam.BENCH_CAMERA, cfg, ts, poses_gt, cpu_frames, voc_card, dev),
                run(f"{mode}:card:cpu_frames:det_A", run_slam.BENCH_CAMERA, cfg, ts, poses_gt, cpu_frames, voc_card, dev, True),
                run(f"{mode}:card:cpu_frames:det_B", run_slam.BENCH_CAMERA, cfg, ts, poses_gt, cpu_frames, voc_card, dev, True)]
        if not args.no_cpu_runs:
            runs.append(run(f"{mode}:cpu", run_slam.BENCH_CAMERA, cfg, ts, poses_gt, cpu_frames, voc_cpu, "cpu"))
        for r in runs:
            r["ref_ate_rmse_m"] = ref["summary"]["ate_rmse_m"]
            r["ref_keyframes_inserted"] = ref["summary"]["keyframes_inserted"]
            r["insert_frames_match_reference"] = r["insert_frames"] == ref["insert_frames"][: len(r["insert_frames"])] \
                if args.frames < ref["frames"] else r["insert_frames"] == ref["insert_frames"]
            pub = {k: v for k, v in r.items() if not k.startswith("_")}
            print(json.dumps(pub), flush=True)
            report["runs"].append(pub)
        pairs = [(runs[1], runs[2]), (runs[3], runs[4]), (runs[0], runs[1]), (runs[1], runs[3])]
        if not args.no_cpu_runs:
            pairs += [(runs[1], runs[5]), (runs[3], runs[5])]
        for a, b in pairs:
            d = first_divergence(a, b)
            print(json.dumps(d), flush=True)
            report["pairs"].append(d)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
