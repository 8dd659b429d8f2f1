#!/usr/bin/env python3
"""What the fixed-order float sums cost: the repaired functions timed
against their previous versions, in one process on the card.

    python tools/torch_repeat_cost.py --parent DIR [--frames 60] [--out FILE]

DIR is the root of the previous tree (for example unpacked by
`git archive <commit> | tar -x -C DIR`). Its `solvers/local_ba.py`,
`parallel/global_ba.py` and `solvers/pose_graph.py` are loaded beside the
current ones under other module names, and the callers' module references
(`local_mapping.local_ba`, `system.local_ba`) point at one version or the
other. Every case runs in turns old, new, new, old, each turn the median of
REPS calls between synchronisations (host clock):

1. insertion — the last keyframe insertion of a --frames bench-system run
   (bench.py's configuration, the packaged 1M-word vocabulary, seed 0)
   re-run alone, as chip_smoke.py phase 8 re-runs phase 5's;
2. tracked — the median ms of the tracked frames without an insertion
   over a whole --frames run (one run per turn; `SlamSystem.process`'s own
   timing, as phase 5 reads it);
3. schur — `local_ba.bundle_adjust` (5 + 10 LM) of the room fixture's
   final map;
4. distributed — `distributed_bundle_adjust` (10 LM, 25 PCG) of the same
   problem on an NCCL group of one;
5. pose_graph — `optimize_pose_graph` (20 LM) of the room loop's essential
   graph with every free vertex moved ~0.01 off (seeded), so that it takes
   steps.

Prints one JSON line per case and a summary with new / old medians.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

REPS = {"insertion": 5, "schur": 3, "distributed": 3, "pose_graph": 2}
REPAIRED = {"local_ba": "solvers/local_ba.py", "global_ba": "parallel/global_ba.py",
            "pose_graph": "solvers/pose_graph.py"}


def load_parent(root: str) -> dict:
    """The previous tree's repaired modules, loaded as `parent_<name>`."""
    out = {}
    for name, rel in REPAIRED.items():
        path = os.path.join(root, "gf_orb_slam_tpu_torch", rel)
        spec = importlib.util.spec_from_file_location(f"parent_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


def timed_ms(fn, reps: int, dev) -> float:
    import torch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def turns(run_old, run_new) -> dict:
    """old, new, new, old: {old_ms, new_ms (per turn), ratio of medians}."""
    old, new = [run_old()], []
    new += [run_new(), run_new()]
    old.append(run_old())
    return {"old_ms": old, "new_ms": new, "new_over_old": statistics.median(new) / statistics.median(old)}


def main(argv=None) -> dict:
    import torch

    import torch_repeat_probe as probe
    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.io_utils import map_delta, snapshot
    from gf_orb_slam_tpu_torch.loop import loop_closing
    from gf_orb_slam_tpu_torch.parallel import global_ba, launch
    from gf_orb_slam_tpu_torch.pipeline import local_mapping, system
    from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod
    from gf_orb_slam_tpu_torch.solvers import local_ba, pose_graph

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of the previous tree")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--device", default=None, help="the first CUDA card unless given (cpu: a rehearsal, whose "
                                                   "times are the CPU's)")
    ap.add_argument("--out", help="also write the report as JSON here")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --device cpu for a rehearsal")
    dev = torch.device(args.device or "cuda")
    parent = load_parent(args.parent)
    new = {"local_ba": local_ba, "global_ba": global_ba, "pose_graph": pose_graph}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip() if dev.type == "cuda" else None
    report = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu", "nvidia_smi": smi,
              "parent": args.parent,
              "frames": args.frames, "cases": {}}

    def use(mods):
        local_mapping.local_ba = mods["local_ba"]
        system.local_ba = mods["local_ba"]

    def emit(name, rec):
        report["cases"][name] = rec
        print(json.dumps({"case": name, **rec}), flush=True)

    # 1-2. the bench system: whole runs per turn, and its last insertion alone.
    cam, ts, _, imgs = probe.bench_inputs(dev, args.frames)
    voc = voc_mod.load_default_vocabulary(dev)
    insert = local_mapping.insert_keyframe_fused
    last = {}

    def run_system(mods):
        use(mods)
        sys_ = system.SlamSystem(cam, run_slam.bench_config(), device=dev, seed=0)
        sys_.set_vocabulary(voc)
        tracked = []

        def recording(*a, **kw):
            last["args"] = (a, kw)
            return insert(*a, **kw)

        local_mapping.insert_keyframe_fused = recording
        try:
            for i in range(imgs.shape[0]):
                log = sys_.process(imgs[i], float(ts[i]))
                if log.pose_cw is not None and "keyframe_insert" not in log.timing_ms:
                    tracked.append(log.timing_ms["total"])
            sys_.flush()
        finally:
            local_mapping.insert_keyframe_fused = insert
        return statistics.median(tracked)

    try:
        run_system(new)  # first-use caches, cuBLAS and allocator warm before the turns
        rec = turns(lambda: run_system(parent), lambda: run_system(new))
        emit("tracked", rec)
        a, kw = last["args"]

        def run_insert(mods):
            use(mods)
            return timed_ms(lambda: insert(*a, **kw), REPS["insertion"], dev)

        emit("insertion", turns(lambda: run_insert(parent), lambda: run_insert(new)))
    finally:
        use(new)

    # 3-4. the room map's global BA.
    cam_r, prob = probe.room_ba_problem(dev)
    emit("schur", turns(lambda: timed_ms(lambda: parent["local_ba"].bundle_adjust(cam_r, prob), REPS["schur"], dev),
                        lambda: timed_ms(lambda: local_ba.bundle_adjust(cam_r, prob), REPS["schur"], dev)))
    with (launch.nccl_group() if dev.type == "cuda" else launch.gloo_group()) as group:
        def dist_ms(mod):
            return timed_ms(lambda: mod.distributed_bundle_adjust(cam_r, prob, group), REPS["distributed"], dev)

        dist_ms(global_ba)
        emit("distributed", turns(lambda: dist_ms(parent["global_ba"]), lambda: dist_ms(global_ba)))

    # 5. the room loop's essential graph, taking steps.
    graphs = []
    z, _ = probe._room(dev)

    optimize = pose_graph.optimize_pose_graph
    pose_graph.optimize_pose_graph = probe.stepping(lambda prob, **kw: graphs.append(prob) or optimize(prob, **kw))
    try:
        m = snapshot.map_state_from_numpy(map_delta.decode(z, "loop_in"), dev)
        loop_closing.correct_loop(m, int(z["loop_query_kf"]), int(z["loop_loop_kf"]),
                                  snapshot.to_tensor(z["loop_S12"], dev), snapshot.to_tensor(z["loop_covis"], dev),
                                  cam=cam_r)
    finally:
        pose_graph.optimize_pose_graph = optimize
    g = graphs[0]
    emit("pose_graph", turns(
        lambda: timed_ms(lambda: parent["pose_graph"].optimize_pose_graph(g, n_iters=20), REPS["pose_graph"], dev),
        lambda: timed_ms(lambda: pose_graph.optimize_pose_graph(g, n_iters=20), REPS["pose_graph"], dev)))

    report["summary"] = {k: v["new_over_old"] for k, v in report["cases"].items()}
    print(json.dumps({"summary": report["summary"], "device": report["device"], "nvidia_smi": smi}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
