#!/usr/bin/env python
"""Write the fixture that the port's instrumented room run, its bench and its
budget sweep are held against: runs of the JAX reference on the CPU.

* `room`          — the place fixture's room circuit (tools/make_torch_place_fixture.py:
                    420 frames, the reference CLI's room configuration at GF
                    budget 100, the 1M vocabulary, frames rounded to uint8) with
                    the loop-recall hook `SlamSystem.loop_gt_overlap` set to the
                    circuit's ground-truth overlap (tools/loop_recall.py's test).
                    Its loop events, the final map's keyframe frame ids, and the
                    recall counts (io_utils/loop_eval.py, held equal to the
                    reference tools' code by tests/test_torch_instrumentation.py).
                    The hook changes nothing else: the run's states, poses,
                    insertions and loops are compared with place_fixture.npz's
                    "room" entry and the comparison is stored in the meta.
* `bench_gf_off`  — bench.py's sequence and configuration with GF off (the
                    bench's second line), 240 frames, as the place fixture's
                    bench run is recorded.
* `sweep`         — the reference's budget sweep `batch_sweep.py --synthetic 60
                    --budgets 0 100 --rounds 1 --cpu`: its rows (frames,
                    tracked, keyframes, map points, loops, ATE) per budget.
                    60 frames, so that GF runs past its 40-frame warm-up and
                    the two budgets are two different runs.

    python tools/make_torch_leftovers_fixture.py        # ~12 min on the CPU

Output: gf_orb_slam_tpu_torch/data/leftovers_fixture.npz.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import make_torch_place_fixture as place  # noqa: E402

from gf_orb_slam_tpu.retrieval import vocabulary as voc_mod  # noqa: E402
from gf_orb_slam_tpu_torch.io_utils import loop_eval  # noqa: E402

OUT = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "leftovers_fixture.npz")
ROOM_FRAMES = 420
SWEEP_ARGS = ["--synthetic", "60", "--budgets", "0", "100", "--rounds", "1", "--cpu"]


def room_run(voc) -> dict:
    """The place fixture's room run with the recall hook set."""
    cam, cfg, scene, render, ts, poses_gt = place.room_setup(ROOM_FRAMES)
    revs = min(1.1, ROOM_FRAMES / 270.0)  # room_setup's circuit
    gt = loop_eval.circuit_gt_overlap(ROOM_FRAMES, revs)
    systems = []

    class Hooked(place.SlamSystem):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.loop_gt_overlap = gt
            systems.append(self)

    plain = place.SlamSystem
    place.SlamSystem = Hooked
    try:
        arrays = place.run("room", cam, cfg, scene, render, ts, poses_gt, ROOM_FRAMES, voc)
    finally:
        place.SlamSystem = plain
    system = systems[-1]
    events = system.loop_events
    fid = np.asarray(system.map.kf_frame_id)
    summary = loop_eval.recall_summary(events, fid, gt)
    eps = loop_eval.episodes(events)
    with np.load(place.OUT) as z:
        same = {k: bool(np.array_equal(arrays[f"room_{k}"], z[f"room_{k}"], equal_nan=True))
                for k in ("state", "pose", "n_inliers", "insert_frames", "loops", "reloc_frames")}
    meta = json.loads(str(arrays["room_meta"]))
    meta.update(recall=summary, revs=revs, overlap_deg=loop_eval.OVERLAP_DEG,
                episodes=[{"kfs": e["kfs"], "frames": e["frames"], "closed": e["closed"]} for e in eps],
                equal_to_place_fixture_room=same)
    print(json.dumps({"room_recall": summary, "equal_to_place_fixture_room": same}), flush=True)
    return {"room_meta": np.asarray(json.dumps(meta)), "room_loop_events": loop_eval.events_to_array(events),
            "room_kf_frame_id": fid.astype(np.int32),
            **{k: v for k, v in arrays.items() if k != "room_meta"}}


def bench_gf_off_run(voc) -> dict:
    cam, cfg, scene, render, ts, poses_gt = place.bench_setup()
    cfg.use_gf = False
    return place.run("bench_gf_off", cam, cfg, scene, render, ts, poses_gt, place.BENCH_FRAMES, voc)


def sweep_run() -> dict:
    """The reference's batch_sweep.py over SWEEP_ARGS, its summary rows."""
    import batch_sweep

    with tempfile.TemporaryDirectory(prefix="leftovers_sweep_") as tmp:
        argv = sys.argv
        sys.argv = ["batch_sweep.py", *SWEEP_ARGS, "--out-dir", tmp]
        t0 = time.perf_counter()
        try:
            batch_sweep.main()
        finally:
            sys.argv = argv
        with open(os.path.join(tmp, "sweep_summary.json")) as f:
            summary = json.load(f)
    keep = ("seq", "budget", "round", "frames", "tracked", "keyframes", "map_points", "loops_closed", "ate_rmse_m")
    rows = [{k: r.get(k) for k in keep} for r in summary["runs"]]
    meta = {"args": SWEEP_ARGS, "rows": rows, "cells": summary["cells"],
            "reference_cpu_seconds": time.perf_counter() - t0, "commit": place._commit()}
    print(json.dumps({"sweep_rows": rows}), flush=True)
    return {"sweep_meta": np.asarray(json.dumps(meta))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", default="room,bench_gf_off,sweep")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()

    voc = voc_mod.load_binary(os.path.join(REPO, "gf_orb_slam_tpu", "data", "vocab_1m.npz"))
    arrays = {}
    if os.path.exists(args.out):  # runs not asked for keep their earlier record
        with np.load(args.out) as z:
            arrays = {k: z[k] for k in z.files}
    for name in args.runs.split(","):
        if name == "room":
            arrays.update(room_run(voc))
        elif name == "bench_gf_off":
            arrays.update(bench_gf_off_run(voc))
        elif name == "sweep":
            arrays.update(sweep_run())
        else:
            raise SystemExit(f"unknown run {name!r}")
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        np.savez_compressed(args.out, **arrays)
    print(json.dumps({"out": args.out, "bytes": os.path.getsize(args.out)}))


if __name__ == "__main__":
    main()
