#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. device  — requires CUDA; torch/CUDA versions, the card, and nvidia-smi's
             name and power limit (also printed as a raw line);
2. build   — builds csrc/*.cu with nvcc for sm_90a (or loads the build) and
             prints ptxas's registers, shared memory and spills per kernel
             and the tensor-core opcodes in each kernel's SASS;
3. kernel  — the Hamming kernels against the plain PyTorch version on the
             card, bit for bit: the tensor-core kernel at the shapes of the
             tracking path (4096×800, 800×800, and 1600×800 on the first
             frame after initialization, whose last observations are the
             1600-wide second keyframe's), the initialization and
             triangulation matches (1600×1600), the fusion matches
             (2048×1600), relocalization (800×1600: the lost frame against a
             candidate keyframe), the loop's SearchAndFuse (4800×1600:
             three keyframes' points into one) and the entry step (512×512),
             ragged and empty shapes, the
             kernel's 64×32 tile at its boundaries (tile −1, exact and +1 in
             both dimensions, and three tiles +1 rows by three tiles −1
             columns), all-zero / all-ones descriptors and an unaligned
             `out=`; the CUDA-core baseline kernel at the path, ragged and
             empty shapes. Then, at the seven path shapes, the device time
             of each kernel (GRAPH_REPS launches captured in one CUDA graph,
             each writing the next output of a ring larger than the 50 MB
             L2; turns old, new, new, old), the library yardstick
             (`torch._int_mm` on ±1 int8 operands, unpacked before timing),
             the plain version (no yardstick), the bound, and the wrapper's
             host µs per call; and the one-block floor of both kernels. The
             wrapper counts its launches by shape; the run fails if a path
             phase launched it at a shape not checked here;
4. main    — the per-frame tracking step (`track_frame_fused`, GF subset mode,
             budget 100, batch 10) chained over the fixture's frames on the
             reference's map, each frame checked against the reference's
             recorded outputs; per-frame times after one warm-up frame; the
             step's host synchronisations counted (exactly one expected);
5. system  — the whole SLAM loop from the first frame in bench.py's shipped
             configuration: the bench's 240 frames rendered on the CPU,
             rounded to uint8 and moved to the card (the card's own render is
             compared with them and its differing pixels printed), run
             through `SlamSystem.process` (seed 0;
             place recognition on with the packaged 1M-word vocabulary read
             by path: two-view initialization, tracking, keyframe insertion
             with triangulation, fusion, windowed BA and culling, BoW
             registration and loop-candidate ranking), held against the
             reference's recorded run (first WORKING frame, tracked and LOST
             frames, keyframes inserted, loops closed, ATE); per-frame
             times, Hamming launches per insertion, host syncs per frame, and
             one insertion re-run under PyTorch's sync debug mode (no sync
             allowed);
6. relocalization — the same sequence and configuration with frames 45-49
             black: LOST on them, then relocalized (BoW candidates, 4 ×
             BoW-gated 800×1600 matches and EPnP RANSAC, local-map tracking)
             no later than the reference's frame + 2, with exactly one host
             read per lost frame and ATE ≤ 2× the reference's;
7. loop    — the room circuit (420 frames, radtan-distorted EuRoC camera,
             the reference CLI's room configuration at GF budget 100, scene
             seed 0) with the loop-recall hook set (the circuit's
             ground-truth overlap, io_utils/loop_eval.py): tracked ≥ 98% of
             the reference's frames, a loop closed whenever the reference
             closed one, ATE ≤ 2× the reference's, every pose finite, 2 host
             syncs per tracked frame and 3 per insertion frame (frames
             without a loop verification); recall against the reference's
             events on the same frames (leftovers_fixture.npz): episodes
             within ±1, every episode the reference closed closed (within
             EPISODE_SLACK frames), no false closure; per-frame times, the
             ms and host syncs of each loop verification and correction,
             Hamming launches by shape and peak device memory;
8. breakdown — the last call of each place-recognition function of phases
             5-7 re-run alone between synchronisations: the insertion and
             its BoW registration, the lost frame's relocalization, a loop
             verification, and a correction with its pose graph and its
             SearchAndFuse timed apart;
9. gf_modes — phase 5's run (bench.py's configuration, the 1M vocabulary,
             seed 0) in every other GF selection mode over the first 60
             frames (the random modes' noise drawn on the card), each
             held against the reference's recorded run of the same mode
             (first WORKING frame ≤ +2, tracked ≥ 98%, keyframes ±25%, ATE
             ≤ 2× the largest of the reference's run and its perturbed
             runs — for active and hybrid, recorded over 240 frames, the
             recorded run's first 60 frames alone — poses finite, 2 host
             syncs per tracked frame and 3 per insertion frame); per mode the tracked-frame median and p90,
             the insertion median, peak device memory, and the last tracked
             frame's `track_local_map` re-run alone with GF on and off
             (SELECTION_REPS turns each, medians), so that the selection's
             own cost is the difference;
10. dataset — the bench's frames 0-59 and 60-89 written as two EuRoC
             sequences (the port's PNG writer, data.csv and the ground-truth
             csv) with a settings YAML for the bench camera, read back bit for
             bit (through the native prefetcher where it runs here), and run
             through the command line (`run_slam.main`: `--seq --settings
             --gf-budget 100 --gf-warmup 10 --save-map --probe-stages`, then
             `--load-map` on the second sequence): first WORKING frame ≤ the
             reference's + 2, tracked ≥ 98% of the reference's frames, ATE
             through `associate_ground_truth` ≤ 2× the reference's over the
             same 60 frames; the snapshot loads back equal to the saved map,
             vocabulary and database; the resumed run WORKING within its
             first 5 frames and tracking ≥ 98% of the rest; every probed
             stage time finite and ≥ 0;
10b. bench — `gf_orb_slam_tpu_torch.bench.run_bench` over the bench's
             first BENCH_FRAMES frames (24 warm-up, then windows of 12; the
             bench's 240 cut for the time limit): GF-on and GF-off systems in
             interleaved windows, the device-only chain of 20 steps; its
             JSON line, both window lists, each system held to the
             reference's run over the same frames (GF on: place_fixture's
             bench; GF off: leftovers_fixture's), finite medians and
             device-only rate;
10c. sweep — `gf_orb_slam_tpu_torch.batch_sweep` with SWEEP_ARGS on the
             card (run_slam.main per budget, its stage probe in round 0):
             the summary table, each row tracking ≥ 98% of the reference
             row's frames at ATE ≤ 2× the reference row's, and the budgets'
             runs parting where the reference's part (60 frames: GF runs
             after its 40-frame warm-up);
11. global_ba — the room circuit's map after its loop correction (phase 7):
             every valid keyframe, the first fixed, observations weighted
             1/σ², through `parallel.global_ba.distributed_bundle_adjust` (10
             LM × 25 PCG) on an in-process NCCL group of one, and through the
             Schur `local_ba.bundle_adjust` as the yardstick: finite output,
             the fixed keyframe bit-equal, the Huber cost over the map's
             edges ≤ its initial value and ≤ 1.05× the yardstick's, no host
             sync (sync debug "error"); and, both solves run to convergence
             (GBA_CONVERGED: 40 LM × 100 PCG, 5 + 40 LM) on one problem
             (the Schur with no pruning between its stages, as the
             distributed solve has none), the distributed solve's Huber
             cost ≤ 1.01× and keyframe ATE ≤ 1.1× the Schur solver's (the
             map's own keyframe ATE, the 10-LM solve's and the pruned
             Schur's are reported, not gated: ROADMAP C4, C7), and each
             converged solve's keyframe ATE over the map's own (the
             converged ratio, ROADMAP C4); ms,
             collectives per LM iteration and peak memory; then
             `dryrun_multichip(1)` on the card;
13. leftovers — runs before 12. The patch-matmul descriptors
             (`OrbConfig.patch_desc`) on bench frame 0 against the gather path
             (the reference test's quality criterion) and bit-equal to the
             CPU's; BoxLOG on a bench frame against the CPU; the prior-pose
             initializer on the system fixture's initialization pair with the
             ground-truth motion against the CPU (n_good, mask); the PLY
             export of phase 5's map (vertices = valid points + keyframes,
             edges = covisibility pairs ≥ 15) and an annotated frame; the
             entry step (the kernel at 512×512); one probe round
             (`loop_probe_floor` PROBE_FLOOR, two rounds so that the streak
             reaches 2) for the keyframe that closed phase 7's loop and its
             matched keyframe, on the map and database its closing
             verification read (by the run's end both keyframes are culled),
             n_bow ≥ PROBE_FLOOR and the funnel against the CPU port's on a
             copy with the same Sim3 samples; every
             texture style and a few frames along `revisit_trajectory`;
14. churn — runs before 12. The room circuit of phase 7 cut to 300 frames
             (churn_fixture.npz: `max_keyframes` 32, so that the keyframe
             slab compacts before frame 180) with tools/reloc_recall.py's
             kidnap (io_utils/reloc_eval.py: 8 black frames from frame 180,
             then the camera a quarter revolution back): poses finite,
             tracked ≥ 98% of the reference's frames, compactions within
             ±1 of the reference's with one before the black frames, live
             keyframes after each within ±25% of the reference's, recovered
             no later than the reference + 2 frames with no false
             relocalization, ATE against the ground truth each frame showed
             ≤ 2× the reference's, 2 host syncs per tracked frame and 3 per
             insertion frame (frames without loop, relocalization or
             compaction work); reported: host syncs and ms per compaction,
             the tracked-frame median 30 frames before and after each
             compaction, peak memory and Hamming launches by shape;
15. room_stages — runs before 12. The reference's own room run
             (room_fixture.npz, tools/make_torch_room_fixture.py) stage by
             stage on the card, each fed the reference's inputs and held to
             its recorded outputs at the tolerances of
             tests/test_torch_room_stages.py: (a) the insertion at frame 201
             (`insert_keyframe_fused`: kf_id and culled keyframe equal,
             pt_valid ≥ 99%, kf_obs_point ≥ 98%, keyframe poses within 1e-3,
             view ids ≥ 98%); (b) the tracking step (`track_frame` on the
             reference's extracted keypoints) on the 3 frames after it (pose
             1e-3 rad / 1e-3, n_inliers within max(3, 2%), ok equal,
             obs_point ≥ 95%); reported beside them, not gated: the GF
             pick counts of both sides, and the same step on frame 236,
             where the reference's selection picks no point because its
             info prior is indefinite within float32 round-off (whether a
             Cholesky fails there turns on that round-off, which the
             card's factorisation does not share with XLA's CPU one; the
             CPU test gates it); (c) the loop correction at frame 375
             (`correct_loop`, its essential graph the port's own, which
             rejects every step there as the reference's does: poses and
             points 1e-4, pt_valid, kf_obs_point and the point counters
             exact); reported, not gated: that graph with its free
             vertices moved ~0.01 off, where it takes steps (20 LM
             iterations' ms and the rejection predicate's ms); the Hamming
             kernel launched at the insertion's and SearchAndFuse's shapes
             (ROOM_STAGE_SHAPES);
16. endurance_stages — runs before 12. The reference's 1,200-frame
             endurance run (endurance_fixture.npz,
             tools/make_torch_endurance_fixture.py) stage by stage on the
             card: each loop verification it accepted and the first it
             rejected (`verify_candidate` with the reference's own
             Sim3-RANSAC minimal sets injected: n_bow, n_ransac, n_guided,
             n_inliers and ok exact, S12 within 1e-4) and each loop
             correction (`correct_loop`, the port's own essential graph:
             poses and points 1e-4, pt_valid, kf_obs_point and the point
             counters exact); the Hamming kernel launched at the
             verification's and SearchAndFuse's shapes
             (ENDURANCE_STAGE_SHAPES);
17. ba_scaling — tools/torch_ba_scaling_bench.py at the reference tool's
             defaults (64 cameras, 4,096 points, 512 observation slots,
             6 LM × 20 PCG) on the card's NCCL group of one: ms per LM
             iteration (host clock), device ms (CUDA events) and peak MiB;
             its converged cost finite and within 1% of the same problem
             solved by the port on the CPU (gloo, world size 1);
17b. repeat — bench-system's first REPEAT_FRAMES frames (phase 5's
             configuration, frames and vocabulary) run twice: every
             per-frame pose and obs_point row and the final map equal bit
             for bit. With phase 11's Schur and distributed solves, phase
             15's correct_loop and its pose graph taking steps (each run
             twice on one input) these are the repeat gates: under the
             default settings (no `torch.use_deterministic_algorithms`), two
             runs of one input give equal bits;
12. profile — the profiler's device duration of both kernels at 4096×800, a
             cross-check of phase 3's graph times, the kernel launches of
             the last local-map call of each mode's run (subset: phase 5's),
             of its tracking step and of its selection (GF on less off), the
             launches of one global-BA LM iteration, and
             the host µs of one small eager op before and after the
             profiler ran. It comes last, so that the profiler
             cannot slow the host's launches in the timed phases.

Order and processes (the time limit). Phases 1-4 run alone. Then two
side processes start on the same card (SIDE_PROCESSES): "room-loop" runs
7, 8's loop part (verification and correction), 11, 13's probe round, 10
and, last, 12's global-BA launches (the profiler slows every later launch
of its process); "room-churn" runs 15, 16, 17, 17b, 14 and 10c. Beside
them this process runs 5, 6, 8's other part, 10b, 9, 13 and 12, and
prints every record, the side processes' once they are done (after 9).
The card idles most of each frame, waiting on its host's launches, so
three processes share it with little loss; every time from phase 5 on is
taken beside the other processes' work, and only phases 3-4 time the
card alone. A side process prints nothing on the standard output and
renders its own frames.

Each path phase (4-7, 9, 10, 10b, 10c, 13, 14, 15, 16, 17b) sets the kernel's launch counts to 0 just before it
drives the path, in its own process, and reads them just after. Then the kernel's launches by
shape, the seconds each phase took, the kernel table line and, last,
{"ok": true, "device": {...}}. The
fixtures (gf_orb_slam_tpu_torch/data/track_fixture.npz, place_fixture.npz,
gf_modes_fixture.npz, leftovers_fixture.npz, churn_fixture.npz,
room_fixture.npz and endurance_fixture.npz) are written from the JAX reference
by tools/make_torch_fixture.py, tools/make_torch_place_fixture.py,
tools/make_torch_gf_modes_fixture.py, tools/make_torch_leftovers_fixture.py,
tools/make_torch_churn_fixture.py, tools/make_torch_room_fixture.py and
tools/make_torch_endurance_fixture.py.
"""

from __future__ import annotations

import collections
import json
import math
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "track_fixture.npz")
PLACE_FIXTURE = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "place_fixture.npz")
GF_MODES_FIXTURE = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "gf_modes_fixture.npz")
# Phase 9's modes, in the order they run (the fixture sets each one's frames).
GF_MODES = ("active", "hybrid", "lazier", "auto", "random", "longlive")
# Tracking (4096×800, 800×800, 1600×800), bootstrap and triangulation
# (1600×1600), fusion (2048×1600), relocalization (800×1600), SearchAndFuse
# (4800×1600), the entry step (512×512).
TIMED_SHAPES = [(4096, 800), (800, 800), (1600, 800), (1600, 1600), (2048, 1600), (800, 1600), (4800, 1600),
                (512, 512)]
KERNEL_SHAPES = TIMED_SHAPES + [(1000, 777), (1, 1), (0, 8), (8, 0)]
# Kernel timing.
GRAPH_REPS = 50             # kernel launches captured in one CUDA graph
GRAPH_REPLAYS = 7           # timed replays; the median is kept
RING_BYTES = 100e6          # outputs cycled through per graph: twice the 50 MB L2
HOST_CALLS = 1000           # wrapper calls timed on the host clock
FLOOR_SHAPE = (16, 32)      # one block of either kernel
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak bandwidth (NVIDIA datasheet)
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core peak, the binary ops' nearest entry
# Slice tolerances against the reference's recorded outputs.
ROT_TOL_RAD = 1e-3
TRANS_TOL = 1e-3        # map units (the map is median-depth normalised at init)
OBS_AGREE_MIN = 0.95
# System-phase gates against the reference's recorded run.
WORKING_SLACK = 2          # first WORKING frame ≤ the reference's + 2
TRACKED_SHARE = 0.98       # tracked frames ≥ the reference's less 2%
KF_SHARE = 0.25            # keyframes inserted within ±25% of the reference's
ATE_FACTOR = 2.0           # ATE ≤ 2× the reference's
MIN_INSERT_LAUNCHES = 4    # Hamming launches inside every insertion
SELECTION_REPS = 5         # phase 9: local-map tracking re-runs, GF on and off in turns
GF_MODE_FRAMES = 60        # phase 9: frames per mode (a cut of length; the time limit)
SYSTEM_FIXTURE = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "system_fixture.npz")
DATASET_FRAMES = (60, 30)  # phase 10: the bench frames of the saved run, then of the resumed one
RESUME_WITHIN = 5          # the resumed run is WORKING within its first frames
GBA_COST_FACTOR = 1.05     # phase 11: cost ≤ this × the Schur solver's
GBA_ATE_FACTOR = 1.1       # converged solves of one problem: keyframe ATE ≤ this × the Schur solver's
GBA_CONVERGED_COST_FACTOR = 1.01  # converged solves of one problem: cost ≤ this × the Schur solver's
GBA_CONVERGED = ((40, 100), (5, 40))  # the converged solves: distributed LM × PCG, Schur stage LM iterations
LEFTOVERS_FIXTURE = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "leftovers_fixture.npz")
EPISODE_SLACK = 12         # phase 7: frames by which a closed episode may move (two keyframe cadences)
CHURN_FIXTURE = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "churn_fixture.npz")
COMPACTION_SLACK = 1       # phase 14: compactions within ±1 of the reference's
RECOVER_SLACK = 2          # phase 14: frames to recover ≤ the reference's + 2
ROOM_FIXTURE = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "room_fixture.npz")
ROOM_STAGE_SHAPES = ((1600, 1600), (2048, 1600), (4800, 1600))  # phase 15: triangulation, fusion, SearchAndFuse
ENDURANCE_FIXTURE = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "endurance_fixture.npz")
ENDURANCE_STAGE_SHAPES = ((1600, 1600), (4800, 1600))  # phase 16: loop verification, SearchAndFuse
BENCH_FRAMES = 72          # the bench: 24 warm-up + 4 windows of 12 frames (a cut of length; the time limit)
SWEEP_ARGS = ["--synthetic", "60", "--budgets", "0", "100", "--rounds", "1"]  # GF on from ~frame 45
REPEAT_FRAMES = 40         # phase 17b: bench-system frames run twice (a cut of length; the time limit)
SCALING_COST_TOL = 0.01    # phase 17: the card's converged cost within 1% of the CPU's
PROBE_FLOOR = 8            # phase 13: the probe's Sim3-RANSAC floor
# The time limit: the card idles most of each frame, waiting on its host's
# launches, so the phases run in three processes on it, each driving its
# own path. Phases 1-4 run alone first; then these side processes start,
# beside 5, 6, 8, 10b, 9, 13 and 12 in the main process (which prints every
# record). Each phase's launch counts are its own process's.
SIDE_PROCESSES = {
    "room-loop": ("loop", "breakdown_loop", "global_ba", "leftovers_probe", "dataset", "profile_global_ba"),
    "room-churn": ("room_stages", "endurance_stages", "ba_scaling", "repeat", "churn", "sweep"),
}
SIDE_PROCESS_THREADS = 4     # torch CPU threads of a side process (the main one keeps torch's default)
SIDE_PROCESS_TIMEOUT_S = 900.0   # from when this process starts waiting
FUNNEL_TOL = (3, 0.02)     # phase 13: card vs CPU RANSAC / guided / refined counts within max(3, 2%)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def sass_mma_opcodes(lib_path) -> dict | None:
    """Tensor-core opcodes (HMMA/IMMA/BMMA…) counted per kernel in the built
    library's SASS, or None where cuobjdump is not installed."""
    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True, timeout=120, check=True).stdout
    counts: dict = {}
    fn = None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            fn = m.group(1)
            counts[fn] = collections.Counter()
        elif fn and (m := re.search(r"\b([A-Z]MMA[.\w]*)", line)):
            counts[fn][m.group(1)] += 1
    return {k: dict(v) for k, v in counts.items()}


def graph_ms(call, ring, reps: int = GRAPH_REPS) -> float:
    """Device ms per call: `reps` calls captured in one CUDA graph, call i
    writing ring[i % len(ring)]; median over GRAPH_REPLAYS replays timed with
    CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture (first launch loads the kernel)
        for i in range(3):
            call(ring[i % len(ring)])
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            call(ring[i % len(ring)])
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(GRAPH_REPLAYS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(samples)


def host_us(call, batches: int = 5, n: int = HOST_CALLS // 5) -> float:
    """Host µs per call, the median over batches of n calls with no
    synchronisation inside (the device finishes each call faster than the
    host issues the next)."""
    import torch

    call()
    torch.cuda.synchronize()
    samples = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        samples.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(samples)


def profiler_us(calls: dict, ring, n: int = 20) -> dict:
    """Per name, the profiler's mean device µs of the kernels whose name
    contains it, over n calls each writing the next output of the ring."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            for i in range(n):
                fn(ring[i % len(ring)])
        torch.cuda.synchronize()
    out = {}
    for name in calls:
        evs = [e for e in prof.key_averages() if name in e.key]
        out[name] = {"kernels": [e.key for e in evs], "count": sum(e.count for e in evs),
                     "device_us": (sum(e.device_time * e.count for e in evs) / max(1, sum(e.count for e in evs)))
                     if evs else None}
    return out


def pm1_int8(desc):
    """(N, 8) int32 words → (N, 256) int8 of 1 − 2·bit, the operands of the
    library yardstick (A·Bᵀ = 256 − 2·H)."""
    import torch

    shifts = torch.arange(32, device=desc.device, dtype=torch.int32)
    bits = ((desc[:, :, None] >> shifts) & 1).reshape(desc.shape[0], 256)
    return (1 - 2 * bits).to(torch.int8)


def bound(nq: int, nt: int) -> tuple[float, str, int]:
    """(bound ms, what bounds it, bytes): inputs read once and the int32
    output written once at the HBM rate, against 2·256 binary ops per pair at
    the int8 tensor-core rate."""
    nbytes = 32 * (nq + nt) + 4 * nq * nt
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * 256 * nq * nt / INT8_OPS_PER_S * 1e3
    return (bytes_ms, "bytes", nbytes) if bytes_ms >= ops_ms else (ops_ms, "operations", nbytes)


def kernel_phase(dev) -> dict:
    """Phase 3: both Hamming kernels against the plain version, bit for bit,
    then their device times at the path shapes. Raises on any difference."""
    import numpy as np
    import torch

    from gf_orb_slam_tpu_torch.io_utils import snapshot
    from gf_orb_slam_tpu_torch.kernels import hamming
    from gf_orb_slam_tpu_torch.ops import matching

    rng = np.random.default_rng(0)

    def words(n):
        return snapshot.to_tensor(rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32), dev)

    def check(label, got, q, t):
        want = matching.hamming_matrix_torch(q, t)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            err = int((got - want).abs().max()) if got.shape == want.shape and got.numel() else None
            raise AssertionError(f"hamming kernel differs from the plain version, {label} {tuple(want.shape)}: max err {err}")

    checked = []
    for nq, nt in KERNEL_SHAPES:
        q, t = words(nq), words(nt)
        check("tensor-core", hamming.hamming_matrix_cuda(q, t), q, t)
        check("CUDA-core", hamming.hamming_matrix_simt_cuda(q, t), q, t)
        checked.append((nq, nt))
    boundary = []
    bm, bn = hamming.BM, hamming.BN
    for nq in (bm - 1, bm, bm + 1, 3 * bm + 1):
        for nt in (bn - 1, bn, bn + 1, 3 * bn - 1):
            q, t = words(nq), words(nt)
            check(f"tile {bm}x{bn}", hamming.hamming_matrix_cuda(q, t), q, t)
            boundary.append((nq, nt))
    # All-zero and all-ones descriptors: distances 0 and 256 only.
    q = torch.zeros((130, 8), dtype=torch.int32, device=dev)
    q[1::2] = -1
    t = torch.zeros((70, 8), dtype=torch.int32, device=dev)
    t[::3] = -1
    got = hamming.hamming_matrix_cuda(q, t)
    check("all-zero/all-ones", got, q, t)
    if set(got.unique().tolist()) != {0, 256}:
        raise AssertionError("all-zero / all-ones descriptors gave distances other than 0 and 256")
    # A row pitch that is not a multiple of 4 and an output that is not 16-byte aligned.
    q, t = words(300), words(600)
    flat = torch.empty(300 * 600 + 1, dtype=torch.int32, device=dev)
    check("unaligned out", hamming.hamming_matrix_cuda(q, t, out=flat[1:].view(300, 600)), q, t)

    times = {}
    for nq, nt in TIMED_SHAPES:
        q, t = words(nq), words(nt)
        ring = [torch.empty((nq, nt), dtype=torch.int32, device=dev)
                for _ in range(max(2, math.ceil(RING_BYTES / (4 * nq * nt))))]
        new = lambda o: hamming.hamming_matrix_cuda(q, t, out=o)  # noqa: E731
        old = lambda o: hamming.hamming_matrix_simt_cuda(q, t, out=o)  # noqa: E731
        o1, n1, n2, o2 = graph_ms(old, ring), graph_ms(new, ring), graph_ms(new, ring), graph_ms(old, ring)
        # Library yardstick: one int8 GEMM of the ±1 unpacked descriptors (unpacking not timed).
        a, b = pm1_int8(q), pm1_int8(t).t()
        lib = (256 - torch._int_mm(a, b)) // 2
        check("library yardstick", lib, q, t)
        lib_ms = graph_ms(lambda o: torch._int_mm(a, b, out=o), ring)
        plain_ms = graph_ms(lambda o: matching.hamming_matrix_torch(q, t), ring, reps=10)
        host = host_us(lambda: hamming.hamming_matrix_cuda(q, t))
        b_ms, b_by, nbytes = bound(nq, nt)
        ms = min(n1, n2)
        cfg = hamming.launch_config(nq, nt)
        times[f"{nq}x{nt}"] = {
            "ms": ms, "ms_runs": [n1, n2], "old_ms": min(o1, o2), "old_ms_runs": [o1, o2],
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "fraction_of_bound": b_ms / ms,
            "old_fraction_of_bound": b_ms / min(o1, o2), "library_ms": lib_ms, "plain_ms": plain_ms,
            "host_us": host, "tile": [cfg.bm, cfg.bn], "blocks": cfg.blocks, "ring_outputs": len(ring),
        }
        del ring
    # The yardstick's cuBLAS calls left a workspace for each stream they ran on
    # (each warm-up stream and the capture stream); free them, so that phase 5's
    # device memory is the path's own.
    torch._C._cuda_clearCublasWorkspaces()
    # The floor: one block (FLOOR_SHAPE), the launch and one block's latency chain.
    q, t = words(FLOOR_SHAPE[0]), words(FLOOR_SHAPE[1])
    ring = [torch.empty(FLOOR_SHAPE, dtype=torch.int32, device=dev) for _ in range(2)]
    floor = {"shape": FLOOR_SHAPE,
             "ms": graph_ms(lambda o: hamming.hamming_matrix_cuda(q, t, out=o), ring),
             "old_ms": graph_ms(lambda o: hamming.hamming_matrix_simt_cuda(q, t, out=o), ring)}
    return {"phase": "kernel", "name": "hamming_matrix", "shapes": checked, "tile_boundary_shapes": boundary,
            "bit_identical": True, "max_abs_err": 0, "graph_reps": GRAPH_REPS, "times": times,
            "one_block_floor": floor}


def launches_of(fn) -> int:
    """Kernel launches of one call of fn, counted by the profiler (its
    cudaLaunchKernel and cuLaunchKernel calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"))


def gf_launches(gf_runs: dict) -> dict:
    """Kernel launches per GF mode of the run's last local-map call (GF on),
    of its tracking step and of the selection (GF on less GF off). Subset's
    step and the GF-off call are counted once: the rest of the step and
    GF-off local-map tracking are the same code in every mode, so a mode's
    step is subset's with its own local-map call."""
    base = gf_runs["subset"]
    step_rest = launches_of(lambda: base["originals"]["step"](*base["step"][0], **base["step"][1]))
    a, kw = base["local_map"]
    off = launches_of(lambda: base["originals"]["local_map"](*a, **(kw | {"use_gf": False})))
    launches = {"local_map_gf_off": off}
    for mode, run in gf_runs.items():
        a, kw = run["local_map"]
        launches[mode] = {"local_map_gf_on": launches_of(lambda: run["originals"]["local_map"](*a, **kw))}
    step_rest -= launches["subset"]["local_map_gf_on"]
    for mode in gf_runs:
        on = launches[mode]["local_map_gf_on"]
        launches[mode] |= {"step": step_rest + on, "selection": on - off}
    return launches


def profile_phase(dev, gf_runs: dict) -> dict:
    """Phase 12: the profiler's device µs of both Hamming kernels at the
    first timed shape; the launches of each GF mode (gf_launches: subset
    from phase 5, the others from phase 9); and the host µs of a small
    eager op before and after the profiler ran. (The launches of one
    global-BA LM iteration on phase 7's map, global_ba_launches, are
    counted last in phase 7's process.)"""
    import numpy as np
    import torch

    from gf_orb_slam_tpu_torch.io_utils import snapshot
    from gf_orb_slam_tpu_torch.kernels import hamming

    rng = np.random.default_rng(1)
    nq, nt = TIMED_SHAPES[0]
    q, t = (snapshot.to_tensor(rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32), dev) for n in (nq, nt))
    ring = [torch.empty((nq, nt), dtype=torch.int32, device=dev)
            for _ in range(max(2, math.ceil(RING_BYTES / (4 * nq * nt))))]
    x = torch.zeros(16, device=dev)
    before = host_us(lambda: x.add_(1))
    prof = profiler_us({"hamming_mma_kernel": lambda o: hamming.hamming_matrix_cuda(q, t, out=o),
                        "hamming_simt_kernel": lambda o: hamming.hamming_matrix_simt_cuda(q, t, out=o)}, ring)
    del ring
    launches = gf_launches(gf_runs)
    return {"phase": "profile", "shape": [nq, nt], "profiler": prof, "gf_mode_kernel_launches": launches,
            "eager_op_host_us_before_profiler": before, "eager_op_host_us_after_profiler": host_us(lambda: x.add_(1))}


def own(args: tuple) -> tuple:
    """(a, kw) of a recorded call with each tensor that is a view of a
    larger one copied, so that keeping the call keeps only its own
    arguments on the device (a frame, not the whole sequence it was cut
    from)."""
    import torch

    def c(x):
        return x.clone() if isinstance(x, torch.Tensor) and x._base is not None else x

    a, kw = args
    return tuple(c(x) for x in a), {k: c(v) for k, v in kw.items()}


def reset_launch_counts() -> None:
    from gf_orb_slam_tpu_torch.kernels import hamming

    hamming.LAUNCHES = 0
    hamming.LAUNCHES_BY_SHAPE.clear()


def count_host_syncs(fn) -> int:
    """Calls of fn that synchronise the host with the device, as PyTorch's
    sync debug mode reports them (one warning per synchronising operation)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def rot_err(q1, q2) -> float:
    """Angle (rad) between two unit quaternions."""
    import numpy as np

    d = abs(float(np.dot(q1 / np.linalg.norm(q1), q2 / np.linalg.norm(q2))))
    return float(2.0 * np.arccos(min(1.0, d)))


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a non-empty list."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, int(-(-q * len(xs) // 100)) - 1))]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this smoke run needs a CUDA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    procs = {}  # the side processes, once they are started
    try:
        return run(procs)
    finally:
        for p in procs.values():
            if p.is_alive():
                p.kill()
            p.join()


def run(procs: dict) -> int:
    """The phases, in order (main stops every process started here)."""
    import numpy as np
    import torch

    from gf_orb_slam_tpu_torch.geometry.camera import CameraModel
    from gf_orb_slam_tpu_torch.io_utils import snapshot
    from gf_orb_slam_tpu_torch.kernels import _build, hamming
    from gf_orb_slam_tpu_torch.ops.orb import OrbConfig
    from gf_orb_slam_tpu_torch.pipeline import track_view as tv
    from gf_orb_slam_tpu_torch.pipeline import tracking

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    seconds, last = {}, [time.perf_counter()]

    def lap(name):
        """Seconds since the previous lap, by phase (the script's time limit)."""
        now = time.perf_counter()
        seconds[name], last[0] = now - last[0], now

    # --- 1. device ---
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": kind, "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "python": sys.version.split()[0]})
    lap("device")

    # --- 2. build ---
    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "library": os.path.relpath(_build.library_path(), REPO),
          "nvcc_seconds": _build.build_seconds, "seconds": time.perf_counter() - t0,
          "ptxas": _build.ptxas_kernels(), "sass_tensor_core_opcodes": sass_mma_opcodes(_build.library_path())})
    lap("build")

    # --- 3. kernels against the plain version, and their device times ---
    kernel_rec = kernel_phase(dev)
    kernel_rec.update(device=kind, nvidia_smi=smi)
    emit(kernel_rec)
    lap("kernel")

    # --- 4. main path ---
    with np.load(FIXTURE) as zf:
        z = {k: zf[k] for k in zf.files}
    meta = json.loads(str(z["meta"]))
    cam = CameraModel(**meta["camera"])
    orb_cfg = OrbConfig(**meta["orb_config"])
    gf = meta["gf"]
    m, _, _ = snapshot.load_map(FIXTURE, dev)
    view = tv.compute_track_view(m, int(z["center_kf"]), view_size=meta["view_size"])
    ref_view = snapshot.track_view_from_numpy(z, dev, prefix="track_view_")
    if not (torch.equal(view.ids, ref_view.ids) and torch.equal(view.valid, ref_view.valid)):
        raise AssertionError("the port's compute_track_view ids/valid differ from the reference's")
    frames = snapshot.to_tensor(z["frames"], dev).to(torch.float32)
    F = frames.shape[0]
    state0 = [snapshot.to_tensor(z[k], dev) for k in ("last_pose", "last_obs", "last_uv", "velocity")]
    key0 = torch.tensor([0, 1], dtype=torch.int64, device=dev)
    dt = torch.tensor(meta["dt"], dtype=torch.float32, device=dev)

    def step(img, pose, obs, uv, vel, key):
        return tracking.track_frame_fused(
            cam, orb_cfg, m, view, img, pose, obs, uv, vel, dt, key,
            scale=orb_cfg.scale, n_levels=orb_cfg.n_levels, gf_budget=gf["gf_budget"],
            use_gf=gf["use_gf"], gf_mode=gf["gf_mode"], gf_batch=gf["gf_batch"],
        )

    step(frames[0], *state0, key0)  # warm-up: first-call allocations, library load, cached constants
    torch.cuda.synchronize()
    # The step's one intended host sync is the wide-radius retry branch.
    host_syncs = count_host_syncs(lambda: step(frames[0], *state0, key0))
    if host_syncs != 1:
        raise AssertionError(f"the tracking step synchronised with the host {host_syncs} times (expected 1)")

    reset_launch_counts()
    pose, obs, uv, vel = state0
    key = key0
    per_frame = []
    for i in range(F):
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        w0 = time.perf_counter()
        ev0.record()
        r = step(frames[i], pose, obs, uv, vel, key)
        ev1.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1e3
        pose, obs, uv, vel, key = r.pose, r.obs_point, r.frame_uv, r.velocity, r.next_key

        p = r.pose.cpu().numpy()
        o = r.obs_point.cpu().numpy()
        ro = z["ref_obs_point"][i]
        either = (o >= 0) | (ro >= 0)
        n_inl, ref_inl = int(r.n_inliers), int(z["ref_n_inliers"][i])
        n_tot, ref_tot = int(r.n_total), int(z["ref_n_total"][i])
        rec = {
            "frame": i, "ms_cuda_events": ev0.elapsed_time(ev1), "ms_wall": wall_ms,
            "rot_err_rad": rot_err(p[:4], z["ref_pose"][i][:4]),
            "trans_err": float(np.linalg.norm(p[4:] - z["ref_pose"][i][4:])),
            "n_inliers": n_inl, "ref_n_inliers": ref_inl, "n_total": n_tot, "ref_n_total": ref_tot,
            "ok": bool(r.ok), "ref_ok": bool(z["ref_ok"][i]),
            "obs_agree": float((o == ro)[either].mean()) if either.any() else 1.0,
        }
        per_frame.append(rec)
        bad = []
        if not (np.isfinite(p).all() and p.shape == (7,) and o.shape == ro.shape):
            bad.append("pose not finite or wrong shape")
        if rec["rot_err_rad"] > ROT_TOL_RAD or rec["trans_err"] > TRANS_TOL:
            bad.append("pose")
        if abs(n_inl - ref_inl) > max(3, 0.02 * ref_inl) or abs(n_tot - ref_tot) > max(3, 0.02 * ref_tot):
            bad.append("inlier counts")
        if rec["ok"] != rec["ref_ok"]:
            bad.append("ok")
        if rec["obs_agree"] < OBS_AGREE_MIN:
            bad.append("obs_point agreement")
        if bad:
            raise AssertionError(f"frame {i} outside the slice tolerances ({', '.join(bad)}): {rec}")
    launches = hamming.LAUNCHES
    if launches < 2 * F:
        raise AssertionError(f"hamming kernel launched {launches} times over {F} frames (< 2 per frame)")
    main_by_shape = collections.Counter(hamming.LAUNCHES_BY_SHAPE)
    per_tracked_frame = {s: n / F for s, n in main_by_shape.items()}
    ms_wall = [rec["ms_wall"] for rec in per_frame]
    emit({"phase": "main", "entry": "pipeline.tracking.track_frame_fused", "frames": F,
          "view_valid": int(view.valid.sum()), "map_points": int(m.pt_valid.sum()),
          "hamming_launches": launches, "host_syncs_per_frame": host_syncs, "per_frame": per_frame,
          "median_ms_wall": statistics.median(ms_wall),
          "median_ms_cuda_events": statistics.median(rec["ms_cuda_events"] for rec in per_frame),
          "fps": F / (sum(ms_wall) / 1e3), "device": kind, "nvidia_smi": smi})
    lap("main")

    # --- 7, 11, 14-17b, 10 and 10c in two side processes on the card, beside 5-9 here ---
    ctx = multiprocessing.get_context("spawn")
    sides = {}
    for name, phases in SIDE_PROCESSES.items():
        sides[name] = start_side_process(ctx, phases)
        procs[name] = sides[name][0]
    lap("side_processes_start")

    # --- 5-6. the whole SLAM loop from the first frame, with place recognition ---
    from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

    t0 = time.perf_counter()
    voc = voc_mod.load_default_vocabulary(dev)  # the packaged 1M-word tree, read by path
    voc_s = time.perf_counter() - t0
    if voc is None or voc.n_words != 1_000_000:
        raise AssertionError(f"the packaged 1M-word vocabulary did not load from {voc_mod.default_vocabulary_path()}")
    path_recs, runs = {}, {}
    for name, phase in (("system", run_system_phase), ("relocalization", run_relocalization_phase)):
        rec, runs[name] = phase(dev, voc)
        if name == "system":
            rec["vocabulary"] = {"path": os.path.relpath(voc_mod.default_vocabulary_path(), REPO),
                                 "n_words": voc.n_words, "load_seconds": voc_s,
                                 "centers_mib": voc.centers.numel() * 4 / 2**20}
        rec.update(device=kind, nvidia_smi=smi)
        emit(rec)
        path_recs[name] = rec
        lap(name)
    # Phase 10 also counts the launches of subset mode's last step, for the modes to be read against.
    gf_runs = {"subset": {k: own(runs["system"]["last_args"][k]) for k in TRACKING_CALLS}
               | {"originals": {k: runs["system"]["originals"][k] for k in TRACKING_CALLS}}}

    # --- 8. where a place-recognition frame's time goes (phase 7's part in its process) ---
    breakdown = breakdown_phase(runs)
    system_run = {"system": runs["system"]["system"]}  # phase 13's viz map
    del runs
    lap("breakdown")

    # --- 10b. the bench ---
    rec = run_bench_phase(dev, voc, smi) | {"device": kind, "nvidia_smi": smi}
    emit(rec)
    path_recs["bench"] = rec
    lap("bench")

    # --- 9. the other GF selection modes through the same loop ---
    for mode, rec, gf_runs[mode] in run_gf_modes_phase(dev, voc):
        rec.update(device=kind, nvidia_smi=smi)
        emit(rec)
        path_recs[f"gf_{mode}"] = rec
        lap(f"gf_{mode}")

    # --- the side processes' records: 7 (and 8's part), 11, 10, 14-17b, 10c ---
    side, side_seconds = {}, {}
    for name, (proc, reader, messages) in sides.items():
        for phase, rec, side_seconds[phase] in side_process_records(name, proc, reader, messages):
            side[phase] = rec
    breakdown |= side.pop("breakdown_loop")
    probe, gba_launches = side.pop("leftovers_probe"), side.pop("profile_global_ba")
    for phase in ("loop", "breakdown", "global_ba", "dataset", "sweep", "churn", "room_stages", "endurance_stages",
                  "ba_scaling", "repeat"):
        rec = breakdown if phase == "breakdown" else side[phase]
        rec.update(device=kind, nvidia_smi=smi)
        emit(rec)
        if phase not in ("breakdown", "global_ba", "ba_scaling"):
            path_recs[phase] = rec
    lap("side_processes_wait")

    # --- 13. the modules no other phase drives (the probe round ran in phase 7's process) ---
    rec = run_leftovers_phase(dev, system_run, probe) | {"device": kind, "nvidia_smi": smi}
    emit(rec)
    path_recs["leftovers"] = rec
    del system_run
    lap("leftovers")

    # --- 12. the profiler's cross-check, after every timed phase ---
    emit(profile_phase(dev, gf_runs) | gba_launches | {"device": kind, "nvidia_smi": smi})
    del gf_runs
    lap("profile")
    emit({"phase": "seconds", "by_phase": seconds, "total": sum(seconds.values()),
          "side_processes": {name: list(phases) for name, phases in SIDE_PROCESSES.items()},
          "side_by_phase": side_seconds})
    # Every shape a path phase launched the kernel at (phase 5's insertion
    # re-run launches the shapes of its run).
    path_shapes = set(main_by_shape)
    for rec in path_recs.values():
        path_shapes |= {tuple(int(x) for x in k.split("x")) for k in rec["hamming_launches_by_shape"]}
    unchecked = path_shapes - set(KERNEL_SHAPES)
    by_shape = {
        f"{nq}x{nt}": {"per_tracked_frame": per_tracked_frame.get((nq, nt), 0.0),
                       "per_insertion": path_recs["system"]["hamming_launches_per_insertion_by_shape"].get(
                           f"{nq}x{nt}", 0.0),
                       "launches": {"main": main_by_shape.get((nq, nt), 0)} | {
                           name: rec["hamming_launches_by_shape"].get(f"{nq}x{nt}", 0)
                           for name, rec in path_recs.items()}}
        for nq, nt in sorted(path_shapes)
    }
    emit({"phase": "kernel_shapes", "path_shapes": sorted(path_shapes), "unchecked": sorted(unchecked),
          "launches_by_shape": by_shape})
    if unchecked:
        raise AssertionError(f"the path launched the hamming kernel at shapes phase 3 did not check: {sorted(unchecked)}")

    times = kernel_rec["times"]
    t48 = times["4096x800"]
    emit({"kernels": [{
        "name": "hamming_matrix", "route": "cuda",
        "source": "gf_orb_slam_tpu_torch/csrc/hamming.cu",
        "replaces": "gf_orb_slam_tpu/ops/pallas_kernels.py:41",
        "launches": launches + sum(rec["hamming_launches"] for rec in path_recs.values()),
        "max_abs_err": kernel_rec["max_abs_err"],
        "ms": t48["ms"], "plain_ms": t48["plain_ms"], "bound_ms": t48["bound_ms"], "bound_by": t48["bound_by"],
        "library_ms": t48["library_ms"], "fraction_of_bound": t48["fraction_of_bound"],
        "shapes": {s: {k: v[k] for k in ("ms", "bound_ms", "fraction_of_bound", "library_ms", "plain_ms",
                                         "old_ms", "host_us")} | by_shape.get(s, {})
                   for s, v in times.items()},
    }]})
    # The run used one card, whatever the machine holds.
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}})
    return 0


def load_place_fixture(run: str, path: str = PLACE_FIXTURE):
    """(meta, arrays) of one reference run recorded in a fixture written by
    tools/make_torch_place_fixture.py (or the GF-modes one, which records its
    runs the same way)."""
    import numpy as np

    with np.load(path) as zf:
        z = {k[len(run) + 1:]: zf[k] for k in zf.files if k.startswith(run + "_")}
    return json.loads(str(z.pop("meta"))), z


def _loop_phase(dev, voc, state: dict) -> dict:
    rec, state["run"] = run_loop_phase(dev, voc)
    state["loop"] = {k: state["run"][k] for k in ("system", "ts", "poses_gt", "closing_verify")}
    return rec


def _breakdown_loop(dev, voc, state: dict) -> dict:
    rec = breakdown_phase({"loop": state.pop("run")})
    del rec["phase"], rec["reps"]
    return rec


# The phases a side process can run: name → fn(device, vocabulary, the
# process's state) → record. Phase 7's run stays in its process for 8, 11,
# 13's probe round and 12's global-BA launches.
SIDE_PHASES = {
    "loop": _loop_phase,
    "breakdown_loop": _breakdown_loop,
    "global_ba": lambda dev, voc, state: run_global_ba_phase(dev, state["loop"]),
    "leftovers_probe": lambda dev, voc, state: leftovers_probe(dev, state["loop"]),
    "dataset": lambda dev, voc, state: run_dataset_phase(dev),
    "profile_global_ba": lambda dev, voc, state: {
        "global_ba_launches_per_lm_iter": global_ba_launches(state.pop("loop"))},
    "room_stages": lambda dev, voc, state: run_room_stages_phase(dev),
    "endurance_stages": lambda dev, voc, state: run_endurance_stages_phase(dev),
    "ba_scaling": lambda dev, voc, state: run_ba_scaling_phase(),
    "repeat": lambda dev, voc, state: run_repeat_phase(dev, voc),
    "churn": lambda dev, voc, state: run_churn_phase(dev, voc),
    "sweep": lambda dev, voc, state: run_sweep_phase(dev),
}


def side_process(phases: tuple, conn) -> None:
    """SIDE_PHASES `phases`, in order, in a side process on the card: each
    phase's record and seconds go to the main process over `conn`, which
    prints them; this process writes nothing to the standard output."""
    os.dup2(2, 1)
    try:
        import torch

        from gf_orb_slam_tpu_torch.kernels import _build
        from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

        torch.set_num_threads(SIDE_PROCESS_THREADS)
        dev = torch.device("cuda", 0)
        _build.library()
        voc = voc_mod.load_default_vocabulary(dev)
        state: dict = {}
        for name in phases:
            t0 = time.perf_counter()
            rec = SIDE_PHASES[name](dev, voc, state)
            conn.send(("phase", name, json.dumps(rec), time.perf_counter() - t0))
        conn.send(("done",))
    except BaseException:  # reported to the main process, which raises
        conn.send(("error", traceback.format_exc()))
        raise
    finally:
        conn.close()


def start_side_process(ctx, phases: tuple, target=side_process) -> tuple:
    """(process, reader thread, messages) of target(phases, conn): the
    thread reads each message as it comes, so that the side process never
    waits on a full pipe while this one runs its own phases."""
    conn, child_conn = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=target, args=(phases, child_conn))
    proc.start()
    child_conn.close()
    messages = []

    def read():
        while not messages or messages[-1][0] not in ("done", "error"):
            try:
                messages.append(conn.recv())
            except EOFError:  # it exited without a word
                messages.append(("error", "no report"))
        conn.close()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    return proc, reader, messages


def side_process_records(name: str, proc, reader, messages: list, timeout: float = SIDE_PROCESS_TIMEOUT_S) -> list:
    """[(phase, record, seconds)] of a side process, in its order, once it
    is done; raises where it failed, died or ran out of time."""
    reader.join(timeout)
    if reader.is_alive():
        raise AssertionError(f"side process {name} ran over {timeout} s more, after "
                             f"{[m[1] for m in messages if m[0] == 'phase']}")
    out = [(m[1], json.loads(m[2]), m[3]) for m in messages if m[0] == "phase"]
    proc.join(timeout=60)
    if messages[-1][0] != "done":
        raise AssertionError(f"side process {name} failed (exit code {proc.exitcode}) after "
                             f"{[n for n, _, _ in out]}:\n{messages[-1][1]}")
    return out


# Functions of the path that drive_system records, by module attribute:
# (module, or module:class for a method, attribute, synchronise after each
# call to time it).
RECORDED = {
    "insert": ("gf_orb_slam_tpu_torch.pipeline.local_mapping", "insert_keyframe_fused", False),
    "register": ("gf_orb_slam_tpu_torch.retrieval.keyframe_db", "register_and_detect", False),
    "reloc": ("gf_orb_slam_tpu_torch.pipeline.tracking", "relocalize_fused", False),
    "verify": ("gf_orb_slam_tpu_torch.loop.loop_closing", "verify_candidate", True),
    "correct": ("gf_orb_slam_tpu_torch.loop.loop_closing", "correct_loop", True),
    "step": ("gf_orb_slam_tpu_torch.pipeline.tracking", "track_frame_fused", False),
    "local_map": ("gf_orb_slam_tpu_torch.pipeline.tracking", "track_local_map", False),
    "compact": ("gf_orb_slam_tpu_torch.pipeline.system:SlamSystem", "_compact_keyframes", True),
}
# Recorded for phase 9's re-runs and launch counts; phase 8 re-runs the others.
TRACKING_CALLS = ("step", "local_map")


def drive_system(dev, cam, cfg, ts, poses_gt, frames, voc, seed: int, loop_gt_overlap=None) -> dict:
    """run_slam.run_sequence on the card with every launch, host sync,
    insertion, BoW registration, relocalization and loop verification /
    correction recorded; the arguments of each one's last call are kept for
    the breakdown. The Hamming launch counts are set to 0 just before the
    run and read just after."""
    import importlib
    import warnings

    import torch

    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.kernels import hamming

    def owner(path):
        mod, _, cls = path.partition(":")
        module = importlib.import_module(mod)
        return getattr(module, cls) if cls else module

    modules = {name: owner(mod) for name, (mod, _, _) in RECORDED.items()}
    originals = {name: getattr(modules[name], attr) for name, (_, attr, _) in RECORDED.items()}
    calls: dict[str, list] = {k: [] for k in RECORDED}
    last_args: dict[str, tuple] = {}
    closing: dict[str, tuple] = {}  # the verification that preceded the last correction
    per_frame_ms, syncs, states = [], [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def n_syncs():
            return sum("synchronizing CUDA operation" in str(w.message) for w in caught)

        def recorded(name):
            # Each call: Hamming launches (by shape), host syncs inside it,
            # and its host ms (up to a synchronisation after it where
            # RECORDED says so; the phase's per-frame times include that
            # wait too).
            def call(*a, **kw):
                before, shapes_before, s0 = hamming.LAUNCHES, collections.Counter(hamming.LAUNCHES_BY_SHAPE), n_syncs()
                t0 = time.perf_counter()
                out = originals[name](*a, **kw)
                if RECORDED[name][2]:
                    torch.cuda.synchronize()
                calls[name].append({"frame": len(per_frame_ms), "launches": hamming.LAUNCHES - before,
                                    "by_shape": hamming.LAUNCHES_BY_SHAPE - shapes_before,
                                    "syncs": n_syncs() - s0, "ms": (time.perf_counter() - t0) * 1e3})
                if name == "correct":
                    closing["verify"] = last_args["verify"]
                last_args[name] = (a, kw)
                return out
            return call

        def on_frame(i, log):
            per_frame_ms.append(log.timing_ms["total"])
            syncs.append(n_syncs())
            caught.clear()
            states.append((log.state, "keyframe_insert" in log.timing_ms, log.pose_cw is not None))

        for name, (_, attr, _) in RECORDED.items():
            setattr(modules[name], attr, recorded(name))
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        allocated_mib = torch.cuda.memory_allocated() / 2**20
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            system, result = run_slam.run_sequence(cam, cfg, ts, poses_gt, frames, dev, seed=seed,
                                                   on_frame=on_frame, vocabulary=voc, loop_gt_overlap=loop_gt_overlap)
            run_s = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
            for name, (_, attr, _) in RECORDED.items():
                setattr(modules[name], attr, originals[name])
    return {"system": system, "result": result, "run_s": run_s, "per_frame_ms": per_frame_ms, "syncs": syncs,
            "states": states, "calls": calls, "last_args": last_args, "closing_verify": closing.get("verify"),
            "originals": originals,
            "launches": hamming.LAUNCHES, "by_shape": collections.Counter(hamming.LAUNCHES_BY_SHAPE),
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20, "allocated_mib": allocated_mib}


def timed_ms(fn, reps: int = 3) -> float:
    """Median wall ms of fn() between synchronisations (the card idle before)."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def breakdown_phase(runs: dict) -> dict:
    """The place-recognition work of each path phase's last call, re-run
    alone between synchronisations (median of 3): the insertion and the BoW
    registration after it, a lost frame's relocalization, one loop
    verification and one correction with its pose graph and its
    SearchAndFuse timed apart (the last where `runs` holds phase 7's)."""
    import importlib

    import torch

    rec = {"phase": "breakdown", "reps": 3}
    for name, run in runs.items():
        for fn_name, (a, kw) in run["last_args"].items():
            if fn_name in ("correct", "compact") or fn_name in TRACKING_CALLS:
                continue
            rec[f"{name}.{fn_name}_ms"] = timed_ms(lambda: run["originals"][fn_name](*a, **kw))
    if "loop" not in runs:
        return rec
    a, kw = runs["loop"]["last_args"]["correct"]
    parts = {"pose_graph": ("gf_orb_slam_tpu_torch.solvers.pose_graph", "optimize_pose_graph"),
             "fuse": ("gf_orb_slam_tpu_torch.mapping.keyframe_ops", "fuse_into_keyframe")}
    spent = {k: [] for k in parts}
    originals = {}
    for k, (mod, attr) in parts.items():
        module = importlib.import_module(mod)
        originals[k] = (module, attr, getattr(module, attr))

        def timed(*aa, _k=k, **kk):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[_k][2](*aa, **kk)
            torch.cuda.synchronize()
            spent[_k].append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(module, attr, timed)
    try:
        rec["loop.correct_ms"] = timed_ms(lambda: runs["loop"]["originals"]["correct"](*a, **kw))
    finally:
        for module, attr, fn in originals.values():
            setattr(module, attr, fn)
    for k, v in spent.items():  # per correction: the median over the re-runs of each one's calls
        per = len(v) // 3
        rec[f"loop.correct.{k}_ms"] = statistics.median(sum(v[i * per : (i + 1) * per]) for i in range(3))
        rec[f"loop.correct.{k}_calls"] = per
    return rec


def run_record(run: dict, F: int) -> dict:
    """The figures every system phase reports."""
    import numpy as np

    states, per_frame_ms, syncs, calls = run["states"], run["per_frame_ms"], run["syncs"], run["calls"]
    working = [i for i, (st, _, _) in enumerate(states) if st == "WORKING"]
    insert_frames = [i for i, (_, ins, _) in enumerate(states) if ins]
    tracked_ms = [per_frame_ms[i] for i, (st, ins, has) in enumerate(states) if has and not ins]
    insert_ms = [per_frame_ms[i] for i in insert_frames]
    inserts = calls["insert"]
    insert_by_shape = sum((r["by_shape"] for r in inserts), collections.Counter())
    result = run["result"]
    return {
        "frames": F, "run_seconds": run["run_s"],
        "first_working": working[0] if working else -1, "tracked": result["tracked"],
        "lost": sum(st == "LOST" for st, _, _ in states),
        "keyframes_inserted": len(insert_frames) + (2 if working else 0), "keyframes_valid": result["keyframes_valid"],
        "map_points": result["map_points"], "loops_closed": result["loops_closed"], "insert_frames": insert_frames,
        "ate_rmse_m": result.get("ate_rmse_m"),
        "poses_finite": bool(all(np.isfinite(p).all() and p.shape == (7,) for p in run["system"].get_trajectory()[1])),
        "init_frame_ms": per_frame_ms[working[0]] if working else None,
        "tracked_ms_median": statistics.median(tracked_ms) if tracked_ms else None,
        "tracked_ms_p90": percentile(tracked_ms, 90) if tracked_ms else None,
        "insert_frame_ms_median": statistics.median(insert_ms) if insert_ms else None,
        "hamming_launches": run["launches"],
        "hamming_launches_by_shape": {f"{nq}x{nt}": n for (nq, nt), n in sorted(run["by_shape"].items())},
        "hamming_launches_per_insertion": [r["launches"] for r in inserts],
        "hamming_launches_per_insertion_by_shape": {
            f"{nq}x{nt}": n / max(1, len(inserts)) for (nq, nt), n in sorted(insert_by_shape.items())},
        "host_syncs_per_tracked_frame": sorted({syncs[i] for i, (st, ins, has) in enumerate(states)
                                                if has and not ins}),
        "host_syncs_per_insert_frame": sorted({syncs[i] for i in insert_frames}),
        "host_syncs_inside_insertions": sorted({r["syncs"] for r in inserts}),
        "host_syncs_inside_registrations": sorted({r["syncs"] for r in calls["register"]}),
        "register_host_ms_median": statistics.median(r["ms"] for r in calls["register"]) if calls["register"] else None,
        "reloc_calls": [{k: r[k] for k in ("frame", "ms", "syncs", "launches")} for r in calls["reloc"]],
        "verify_calls": [{k: r[k] for k in ("frame", "ms", "syncs", "launches")} for r in calls["verify"]],
        "correct_calls": [{k: r[k] for k in ("ms", "syncs", "launches")} for r in calls["correct"]],
        "verify_ms_total": sum(r["ms"] for r in calls["verify"]),
        "correct_ms_total": sum(r["ms"] for r in calls["correct"]),
        "peak_device_memory_mib": run["peak_mib"], "allocated_mib_at_start": run["allocated_mib"],
        "per_frame_ms": [round(v, 1) for v in per_frame_ms],
    }


_BENCH: dict = {}  # the bench sequence, rendered once a process (on the CPU) for its phases


def bench_sequence(dev, meta, n: int | None = None):
    """(camera, timestamps, ground truth, frames on the card) of the bench
    sequence a fixture run was recorded on: its first n frames (every one
    by default), as run_slam.render_sequence renders them."""
    import torch

    from gf_orb_slam_tpu_torch import run_slam

    cam = run_slam.BENCH_CAMERA._replace(**{k: meta["camera"][k] for k in ("fx", "fy", "cx", "cy", "width", "height",
                                                                          "fps")})
    key = (cam, meta["trajectory_frames"], meta["scene_seed"])
    n = meta["trajectory_frames"] if n is None else n
    if key not in _BENCH or _BENCH[key][2].shape[0] < n:
        _BENCH.clear()
        ts, poses_gt, frames = run_slam.render_frames(cam, meta["trajectory_frames"], meta["scene_seed"], stop=n)
        _BENCH[key] = (ts, poses_gt, frames.to(dev).to(torch.float32))
    ts, poses_gt, frames = _BENCH[key]
    return cam, ts, poses_gt, frames[:n]


def render_difference(cam, n: int, scene_seed: int, frames) -> dict:
    """Pixels where the card's own render of the bench sequence differs
    from `frames` (the CPU's, as the runs use them)."""
    import torch

    from gf_orb_slam_tpu_torch import run_slam

    _, _, card = run_slam.render_sequence(cam, n, scene_seed, frames.device, render_device=frames.device)
    diff = (card[: frames.shape[0]] - frames).abs()
    out = {"frames": frames.shape[0], "pixels_differing": int((diff > 0).sum()), "pixels": diff.numel(),
           "max_abs_diff": float(diff.max()), "frames_differing": int((diff > 0).flatten(1).any(1).sum())}
    del card, diff
    torch.cuda.empty_cache()
    return out


def run_system_phase(dev, voc):
    """Phase 5: SlamSystem.process over the bench sequence on the card in
    bench.py's configuration (place recognition on, the 1M vocabulary
    preset), held against the reference's recorded run. Raises on any gate."""
    import torch

    from gf_orb_slam_tpu_torch import run_slam

    meta, z = load_place_fixture("bench")
    ref = meta["summary"]
    F = meta["frames"]
    t0 = time.perf_counter()
    cam, ts, poses_gt, frames = bench_sequence(dev, meta)
    frames = frames[:F]
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    card_render = render_difference(cam, meta["trajectory_frames"], meta["scene_seed"], frames)
    run = drive_system(dev, cam, run_slam.bench_config(), ts[:F], poses_gt[:F], frames, voc, seed=0)
    # One insertion again, on the map it was given, with every sync counted.
    a, kw = run["last_args"]["insert"]
    insert_syncs = count_host_syncs(lambda: run["originals"]["insert"](*a, **kw))
    rec = {"phase": "system", "entry": "pipeline.system.SlamSystem.process", "render_seconds": render_s,
           "frames_rendered_on": "cpu", "card_render_vs_cpu": card_render,
           **run_record(run, F), "host_syncs_in_insert_keyframe_fused": insert_syncs}
    ref_insert_frames = [int(f) for f in z["insert_frames"][1:]]  # the initialization frame first
    rec.update({
        "ref_first_working": ref["first_working"], "ref_tracked": ref["tracked"],
        "ref_keyframes_inserted": ref["keyframes_inserted"], "ref_ate_rmse_m": ref["ate_rmse_m"],
        "ref_loops_closed": ref["loops_closed"],
        # Reported, not gated: the gates hold the run statistically.
        "insert_frames_match_reference": rec["insert_frames"] == ref_insert_frames,
        "insert_frames_not_in_reference": sorted(set(rec["insert_frames"]) - set(ref_insert_frames)),
        "reference_insert_frames_missed": sorted(set(ref_insert_frames) - set(rec["insert_frames"])),
    })
    bad = []
    if not rec["poses_finite"]:
        bad.append("a pose is not finite or not a 7-vector")
    if rec["first_working"] < 0 or rec["first_working"] > ref["first_working"] + WORKING_SLACK:
        bad.append(f"first WORKING frame {rec['first_working']} (reference {ref['first_working']})")
    if rec["lost"]:
        bad.append(f"{rec['lost']} LOST frames")
    if any(n < MIN_INSERT_LAUNCHES for n in rec["hamming_launches_per_insertion"]):
        bad.append(f"an insertion launched the Hamming kernel fewer than {MIN_INSERT_LAUNCHES} times")
    if insert_syncs or rec["host_syncs_inside_insertions"] != [0]:
        bad.append(f"insert_keyframe_fused synchronised with the host ({insert_syncs}, "
                   f"{rec['host_syncs_inside_insertions']})")
    if rec["tracked"] < TRACKED_SHARE * ref["tracked"]:
        bad.append(f"tracked {rec['tracked']} of {F} (reference {ref['tracked']})")
    if abs(rec["keyframes_inserted"] - ref["keyframes_inserted"]) > KF_SHARE * ref["keyframes_inserted"]:
        bad.append(f"{rec['keyframes_inserted']} keyframes inserted (reference {ref['keyframes_inserted']})")
    if rec["ate_rmse_m"] is None or rec["ate_rmse_m"] > ATE_FACTOR * ref["ate_rmse_m"]:
        bad.append(f"ATE {rec['ate_rmse_m']} m (reference {ref['ate_rmse_m']} m)")
    if rec["loops_closed"] != ref["loops_closed"]:
        bad.append(f"{rec['loops_closed']} loops closed (reference {ref['loops_closed']})")
    if bad:
        raise AssertionError("system phase outside its gates: " + "; ".join(bad) + f" — {short(rec)}")
    return rec, {k: run[k] for k in ("last_args", "originals", "system")}


def run_relocalization_phase(dev, voc):
    """Phase 6: the bench sequence with a run of black frames: LOST on them,
    relocalized from the map by the BoW candidates and PnP, held against the
    reference's recorded run. Raises on any gate."""
    import torch

    from gf_orb_slam_tpu_torch import run_slam

    meta, z = load_place_fixture("blackout")
    ref = meta["summary"]
    F, (b0, b1) = meta["frames"], meta["black_frames"]
    cam, ts, poses_gt, frames = bench_sequence(dev, meta)
    frames = frames[:F].clone()
    frames[b0 : b1 + 1] = 0.0
    run = drive_system(dev, cam, run_slam.bench_config(), ts[:F], poses_gt[:F], frames, voc, seed=0)
    rec = {"phase": "relocalization", "entry": "pipeline.system.SlamSystem.process", "black_frames": [b0, b1],
           **run_record(run, F)}
    states = [st for st, _, _ in run["states"]]
    ref_reloc = int(z["reloc_frames"][0])
    back = [i for i in range(b1 + 1, F) if states[i] == "WORKING"]
    lost_frames = [i for i in range(b0 + 1, F) if states[i - 1] == "LOST"]  # frames that ran relocalization
    rec.update({"states_around_blackout": states[b0 - 1 : ref_reloc + 4], "working_again": back[0] if back else None,
                "ref_reloc_frame": ref_reloc, "ref_tracked": ref["tracked"], "ref_ate_rmse_m": ref["ate_rmse_m"],
                "host_syncs_per_lost_frame": sorted({run["syncs"][i] for i in lost_frames})})
    bad = []
    if not rec["poses_finite"]:
        bad.append("a pose is not finite or not a 7-vector")
    if any(states[i] != "LOST" for i in range(b0, b1 + 1)):
        bad.append(f"not LOST on the black frames {b0}-{b1}: {states[b0 : b1 + 1]}")
    if rec["working_again"] is None or rec["working_again"] > ref_reloc + WORKING_SLACK:
        bad.append(f"WORKING again at {rec['working_again']} (reference {ref_reloc})")
    if rec["host_syncs_per_lost_frame"] != [1]:
        bad.append(f"host syncs per lost frame {rec['host_syncs_per_lost_frame']} (expected exactly 1)")
    if rec["ate_rmse_m"] is None or rec["ate_rmse_m"] > ATE_FACTOR * ref["ate_rmse_m"]:
        bad.append(f"ATE {rec['ate_rmse_m']} m (reference {ref['ate_rmse_m']} m)")
    if bad:
        raise AssertionError("relocalization phase outside its gates: " + "; ".join(bad) + f" — {short(rec)}")
    return rec, {k: run[k] for k in ("last_args", "originals")}


def run_loop_phase(dev, voc):
    """Phase 7: the room circuit (radtan-distorted EuRoC camera, the reference
    CLI's room configuration at GF budget 100, scene seed 0), which closes
    the loop, held against the reference's recorded run. Raises on any gate."""
    import torch

    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu_torch.io_utils import loop_eval

    meta, z = load_place_fixture("room")
    meta_r, z_r = load_place_fixture("room", LEFTOVERS_FIXTURE)
    ref = meta["summary"]
    F = meta["frames"]
    t0 = time.perf_counter()
    ts, poses_gt, frames = run_slam.render_sequence(EUROC_CAM, F, meta["scene_seed"], dev, scene="room")
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    gt_overlap = loop_eval.circuit_gt_overlap(F, run_slam.circuit_revs(F))
    run = drive_system(dev, EUROC_CAM, run_slam.room_config(), ts, poses_gt, frames, voc, seed=0,
                       loop_gt_overlap=gt_overlap)
    rec = {"phase": "loop", "entry": "pipeline.system.SlamSystem.process", "render_seconds": render_s,
           **run_record(run, F)}
    # Recall against the reference's events on the same frames.
    system = run["system"]
    events, ref_events = system.loop_events, loop_eval.events_from_array(z_r["loop_events"])
    recall = loop_eval.recall_summary(events, system.map.kf_frame_id.cpu().numpy(), gt_overlap)
    spans = [{"frames": [min(e["frames"]), max(e["frames"])], "closed": e["closed"]} for e in loop_eval.episodes(events)]
    missed = loop_eval.closed_episodes_missed(ref_events, events, EPISODE_SLACK)
    rec.update({"recall": recall, "episodes": spans, "ref_recall": meta_r["recall"],
                "ref_episodes": [{"frames": [min(e["frames"]), max(e["frames"])], "closed": e["closed"]}
                                 for e in meta_r["episodes"]],
                "matched_kf": [{"kf": e["kf"], "frame": e["frame"], "matched_kf": e["matched_kf"]}
                               for e in events if e["closed"]],
                "ref_closed_episodes_missed": missed})
    loop_frames = {r["frame"] for name in ("verify", "correct") for r in run["calls"][name]}
    rec["host_syncs_per_tracked_frame_without_loop_work"] = sorted(
        {run["syncs"][i] for i, (st, ins, has) in enumerate(run["states"]) if has and not ins and i not in loop_frames})
    rec["host_syncs_per_insert_frame_without_loop_work"] = sorted(
        {run["syncs"][i] for i, (st, ins, has) in enumerate(run["states"]) if ins and i not in loop_frames})
    loops = run["calls"]["correct"]
    rec.update({"ref_tracked": ref["tracked"], "ref_loops_closed": ref["loops_closed"],
                "ref_loops": z["loops"].tolist(), "ref_ate_rmse_m": ref["ate_rmse_m"],
                "ref_keyframes_inserted": ref["keyframes_inserted"],
                "loop_frames": [r["frame"] for r in loops],
                "correct_launches_by_shape": {f"{nq}x{nt}": n for (nq, nt), n in
                                              sorted(sum((r["by_shape"] for r in loops), collections.Counter()).items())},
                "verify_launches_by_shape": {f"{nq}x{nt}": n for (nq, nt), n in sorted(
                    sum((r["by_shape"] for r in run["calls"]["verify"]), collections.Counter()).items())}})
    bad = []
    if not rec["poses_finite"]:
        bad.append("a pose is not finite or not a 7-vector")
    if rec["tracked"] < TRACKED_SHARE * ref["tracked"]:
        bad.append(f"tracked {rec['tracked']} of {F} (reference {ref['tracked']})")
    if ref["loops_closed"] >= 1 and rec["loops_closed"] < 1:
        bad.append(f"no loop closed (reference {ref['loops_closed']})")
    if rec["ate_rmse_m"] is None or rec["ate_rmse_m"] > ATE_FACTOR * ref["ate_rmse_m"]:
        bad.append(f"ATE {rec['ate_rmse_m']} m (reference {ref['ate_rmse_m']} m)")
    if abs(recall["episodes"] - meta_r["recall"]["episodes"]) > 1:
        bad.append(f"{recall['episodes']} revisit episodes (reference {meta_r['recall']['episodes']})")
    if missed:
        bad.append(f"the reference's closed episodes at frames {missed} were not closed")
    if recall["false_closures"]:
        bad.append(f"{recall['false_closures']} false closures")
    if (rec["host_syncs_per_tracked_frame_without_loop_work"] != [2]
            or rec["host_syncs_per_insert_frame_without_loop_work"] != [3]):
        bad.append(f"host syncs {rec['host_syncs_per_tracked_frame_without_loop_work']} per tracked frame and "
                   f"{rec['host_syncs_per_insert_frame_without_loop_work']} per insertion frame (expected 2 and 3)")
    if bad:
        raise AssertionError("loop phase outside its gates: " + "; ".join(bad) + f" — {short(rec)}")
    return rec, {k: run[k] for k in ("last_args", "originals", "system", "closing_verify")} | {"ts": ts,
                                                                                              "poses_gt": poses_gt}


def run_churn_phase(dev, voc):
    """Phase 14: the room circuit with a small keyframe capacity and a kidnap
    (churn_fixture.npz): keyframe-slab compaction before the black frames,
    then relocalization against old keyframes, held against the
    reference's recorded run. Raises on any gate."""
    import numpy as np
    import torch

    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu_torch.io_utils import reloc_eval

    meta, z = load_place_fixture("churn", CHURN_FIXTURE)
    ref, sched = meta["summary"], meta["schedule"]
    F, revs = meta["frames"], run_slam.circuit_revs(meta["frames"])
    src = reloc_eval.frame_src(F, "kidnap", revs, sched["blackout_len"])
    if src != z["frame_src"].tolist():
        raise AssertionError("reloc_eval's kidnap schedule is not the fixture's frame_src")
    t0 = time.perf_counter()
    ts, poses_gt, gt_frames = run_slam.render_sequence(EUROC_CAM, F, meta["scene_seed"], dev, scene="room")
    shown = torch.tensor([max(i, 0) for i in src], device=dev)
    black = torch.tensor([i < 0 for i in src], device=dev)
    frames = torch.where(black[:, None, None], 0.0, gt_frames.index_select(0, shown))
    del gt_frames
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    cfg = run_slam.room_config(max_keyframes=meta["slam_config"]["max_keyframes"])
    # The run's ATE is read against the ground truth each frame showed (a
    # black frame is never tracked).
    run = drive_system(dev, EUROC_CAM, cfg, ts, poses_gt[np.maximum(src, 0)], frames, voc, seed=0)
    del frames
    system = run["system"]
    rec = {"phase": "churn", "entry": "pipeline.system.SlamSystem.process", "render_seconds": render_s,
           "max_keyframes": cfg.max_keyframes, "schedule": sched, **run_record(run, F)}
    gt_centers = run_slam.camera_centers(poses_gt)
    centers = [None if lg.pose_cw is None else run_slam.camera_centers(lg.pose_cw[None])[0] for lg in system.logs]
    rec["recovery"] = reloc_eval.recovery([lg.state for lg in system.logs], centers, src, gt_centers,
                                          sched["blackout_len"])
    compactions = run["calls"]["compact"]
    rec["compactions"] = [list(c) for c in system.compactions]
    rec["compaction_calls"] = [{k: r[k] for k in ("frame", "ms", "syncs")} for r in compactions]
    # Tracked frames (no insertion) just before and after each compaction.
    plain = [i for i, (_, ins, has) in enumerate(run["states"]) if has and not ins]

    def median_ms(frames):
        ms = [run["per_frame_ms"][i] for i in plain if i in frames]
        return statistics.median(ms) if ms else None

    rec["tracked_ms_around_compactions"] = [
        {"frame": f, "before": median_ms(range(f - 30, f)), "after": median_ms(range(f + 1, f + 31))}
        for f, _ in system.compactions]
    reloc = [i for i in range(1, F) if run["states"][i - 1][0] == "LOST" and run["states"][i][0] == "WORKING"]
    special = set(reloc) | {r["frame"] for name in ("verify", "correct", "reloc", "compact")
                            for r in run["calls"][name]}
    rec["host_syncs_per_tracked_frame_without_loop_reloc_compaction"] = sorted(
        {run["syncs"][i] for i, (_, ins, has) in enumerate(run["states"]) if has and not ins and i not in special})
    rec["host_syncs_per_insert_frame_without_loop_reloc_compaction"] = sorted(
        {run["syncs"][i] for i, (_, ins, _) in enumerate(run["states"]) if ins and i not in special})
    rec["unexpected_sync_frames"] = [
        {"frame": i, "syncs": run["syncs"][i], "state": st, "inserted": ins, "special": i in special}
        for i, (st, ins, has) in enumerate(run["states"]) if has and run["syncs"][i] != (3 if ins else 2)]
    rec.update({"ref_tracked": ref["tracked"], "ref_compactions": z["compactions"].tolist(),
                "ref_recovery": ref["recovery"], "ref_ate_rmse_m": ref["ate_rmse_m"],
                "ref_keyframes_inserted": ref["keyframes_inserted"], "ref_loops": z["loops"].tolist(),
                "ref_reloc_frames": z["reloc_frames"].tolist(), "reloc_frames": reloc})
    bad = []
    if not rec["poses_finite"]:
        bad.append("a pose is not finite or not a 7-vector")
    if rec["tracked"] < TRACKED_SHARE * ref["tracked"]:
        bad.append(f"tracked {rec['tracked']} of {F} (reference {ref['tracked']})")
    n_ref = len(rec["ref_compactions"])
    if abs(len(rec["compactions"]) - n_ref) > COMPACTION_SLACK:
        bad.append(f"{len(rec['compactions'])} compactions (reference {n_ref})")
    if not any(f < sched["blackout_at"] for f, _ in rec["compactions"]):
        bad.append(f"no compaction before the black frames at {sched['blackout_at']}")
    for (f, live), (rf, rlive) in zip(rec["compactions"], rec["ref_compactions"]):
        if abs(live - rlive) > KF_SHARE * rlive:
            bad.append(f"{live} live keyframes after the compaction at frame {f} (reference {rlive} at {rf})")
    r, rr = rec["recovery"], ref["recovery"]
    if not r["recovered"] or r["false_reloc"] or r["frames_to_recover"] > rr["frames_to_recover"] + RECOVER_SLACK:
        bad.append(f"recovery {r} (reference {rr})")
    if rec["ate_rmse_m"] is None or rec["ate_rmse_m"] > ATE_FACTOR * ref["ate_rmse_m"]:
        bad.append(f"ATE {rec['ate_rmse_m']} m (reference {ref['ate_rmse_m']} m)")
    if (rec["host_syncs_per_tracked_frame_without_loop_reloc_compaction"] != [2]
            or rec["host_syncs_per_insert_frame_without_loop_reloc_compaction"] != [3]):
        bad.append(f"host syncs {rec['host_syncs_per_tracked_frame_without_loop_reloc_compaction']} per tracked "
                   f"frame and {rec['host_syncs_per_insert_frame_without_loop_reloc_compaction']} per insertion "
                   "frame (expected 2 and 3)")
    if bad:
        raise AssertionError("churn phase outside its gates: " + "; ".join(bad) + f" — {short(rec)}")
    return rec


def reference_prefix(z: dict, poses_gt, F: int) -> dict:
    """The summary of a recorded reference run (per-frame state and pose,
    insertion frames) over its first F frames."""
    import numpy as np

    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.io_utils import evaluation

    pose = z["pose"][:F]
    ok = np.isfinite(pose).all(axis=1)
    return {"first_working": int(np.flatnonzero(z["state"][:F] == 3)[0]), "tracked": int(ok.sum()),
            "keyframes_inserted": int((z["insert_frames"][1:] < F).sum()) + 2,
            "ate_rmse_m": evaluation.ate_rmse(run_slam.camera_centers(pose[ok]),
                                              run_slam.camera_centers(poses_gt[:F][ok])),
            "loops_closed": int((z["loops"][:, 0] < F).sum()) if len(z.get("loops", ())) else 0}


def run_gf_modes_phase(dev, voc):
    """Phase 9: for each mode of GF_MODES, SlamSystem.process over the bench
    sequence on the card in bench.py's configuration with `gf_mode` changed,
    held against the reference's recorded run of that mode. Yields (mode,
    record, the last local-map call's arguments). Raises on any gate."""
    import torch

    from gf_orb_slam_tpu_torch import run_slam

    meta0, _ = load_place_fixture(GF_MODES[0], GF_MODES_FIXTURE)
    t0 = time.perf_counter()
    cam, ts, poses_gt, frames = bench_sequence(dev, meta0)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    for mode in GF_MODES:
        meta, z = load_place_fixture(mode, GF_MODES_FIXTURE)
        ref, F = meta["summary"], min(meta["frames"], GF_MODE_FRAMES)
        # The reference's ATE in this mode moves with perturbations as small
        # as its own float32 round-off (the fixture's spread runs): the port,
        # one more such perturbation, is held to 2× the largest. A run cut
        # shorter than the recorded one is held to the recorded run's first
        # F frames (the spread runs are summaries of their whole length).
        spread = [r["summary"]["ate_rmse_m"] for r in json.loads(str(z["spread"]))]
        if F < meta["frames"]:
            ref = reference_prefix(z, poses_gt, F)
            ref_ates = [ref["ate_rmse_m"]]
        else:
            ref_ates = [ref["ate_rmse_m"]] + spread
        cfg = run_slam.bench_config(gf_mode=mode)
        for k in ("gf_mode", "gf_budget", "gf_batch", "gf_warmup_frames", "max_frames_between_kf", "n_features"):
            if getattr(cfg, k) != meta["slam_config"][k]:
                raise AssertionError(f"gf_modes {mode}: {k}={getattr(cfg, k)} but the reference ran {meta['slam_config'][k]}")
        run = drive_system(dev, cam, cfg, ts[:F], poses_gt[:F], frames[:F], voc, seed=0)
        rec = {"phase": "gf_modes", "mode": mode, "entry": "pipeline.system.SlamSystem.process",
               "render_seconds": render_s, **run_record(run, F)}
        # The last tracked frame's local-map tracking alone, GF on and off in
        # turns (the host's noise between calls is as large as a cheap mode's
        # selection).
        a, kw = run["last_args"]["local_map"]
        local_map = run["originals"]["local_map"]
        on, off = [], []
        for _ in range(SELECTION_REPS):
            on.append(timed_ms(lambda: local_map(*a, **kw), reps=1))
            off.append(timed_ms(lambda: local_map(*a, **(kw | {"use_gf": False})), reps=1))
        on_ms, off_ms = statistics.median(on), statistics.median(off)
        rec.update({
            "local_map_gf_on_ms": on_ms, "local_map_gf_off_ms": off_ms, "selection_ms": on_ms - off_ms,
            "local_map_gf_on_ms_runs": on, "local_map_gf_off_ms_runs": off,
            "ref_first_working": ref["first_working"], "ref_tracked": ref["tracked"],
            "ref_keyframes_inserted": ref["keyframes_inserted"], "ref_ate_rmse_m": ref["ate_rmse_m"],
            "ref_ate_rmse_m_spread": ref_ates, "ref_loops_closed": ref["loops_closed"],
            "ref_frames": meta["frames"], "ref_ate_rmse_m_spread_recorded_length": spread,
        })
        bad = []
        if not rec["poses_finite"]:
            bad.append("a pose is not finite or not a 7-vector")
        if rec["first_working"] < 0 or rec["first_working"] > ref["first_working"] + WORKING_SLACK:
            bad.append(f"first WORKING frame {rec['first_working']} (reference {ref['first_working']})")
        if rec["tracked"] < TRACKED_SHARE * ref["tracked"]:
            bad.append(f"tracked {rec['tracked']} of {F} (reference {ref['tracked']})")
        if abs(rec["keyframes_inserted"] - ref["keyframes_inserted"]) > KF_SHARE * ref["keyframes_inserted"]:
            bad.append(f"{rec['keyframes_inserted']} keyframes inserted (reference {ref['keyframes_inserted']})")
        if rec["ate_rmse_m"] is None or rec["ate_rmse_m"] > ATE_FACTOR * max(ref_ates):
            bad.append(f"ATE {rec['ate_rmse_m']} m (the reference's runs {ref_ates} m)")
        if rec["host_syncs_per_tracked_frame"] != [2] or rec["host_syncs_per_insert_frame"] != [3]:
            bad.append(f"host syncs {rec['host_syncs_per_tracked_frame']} per tracked frame and "
                       f"{rec['host_syncs_per_insert_frame']} per insertion frame (expected 2 and 3)")
        if bad:
            raise AssertionError(f"gf_modes phase, mode {mode}, outside its gates: " + "; ".join(bad) + f" — {short(rec)}")
        yield mode, rec, {"local_map": own(run["last_args"]["local_map"]),
                          "originals": {"local_map": run["originals"]["local_map"]}}
        del run


def run_dataset_phase(dev) -> dict:
    """Phase 10: the bench's frames as two EuRoC sequences on disk, run by
    the command line with a settings file: saved, resumed from the snapshot,
    and probed stage by stage. Raises on any gate."""
    import tempfile

    import numpy as np
    import torch

    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.io_utils import datasets, prefetch, settings, snapshot, stage_probe
    from gf_orb_slam_tpu_torch.kernels import hamming

    meta, _ = load_place_fixture("bench")
    n_a, n_b = DATASET_FRAMES
    cam, ts, poses_gt, frames = bench_sequence(dev, meta, n_a + n_b)
    u8 = frames[: n_a + n_b].to(torch.uint8).cpu().numpy()
    with np.load(SYSTEM_FIXTURE) as zf:
        ref = reference_prefix({k: zf[k] for k in ("pose", "state", "insert_frames")}, zf["gt_pose"], n_a)
    ref_ate, ref_first, ref_tracked = ref["ate_rmse_m"], ref["first_working"], ref["tracked"]
    saved = {}
    save_map = snapshot.save_map

    def recording_save_map(path, m, voc=None, db=None):
        saved.update(m=m, voc=voc, db=db)
        return save_map(path, m, voc, db)

    rec = {"phase": "dataset", "entry": "run_slam.main --seq", "frames": [n_a, n_b],
           "native_prefetch": prefetch.native_available()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dataset_") as tmp:
        t0 = time.perf_counter()
        seq_a = datasets.write_euroc(os.path.join(tmp, "bench_a"), ts[:n_a], u8[:n_a], poses_gt[:n_a])
        seq_b = datasets.write_euroc(os.path.join(tmp, "bench_b"), ts[n_a : n_a + n_b], u8[n_a:], poses_gt[n_a : n_a + n_b])
        yaml = os.path.join(tmp, "bench.yaml")
        settings.write_settings(yaml, cam, run_slam.bench_config())
        rec["write_seconds"] = time.perf_counter() - t0
        back = []
        for seq in (seq_a, seq_b):
            with prefetch.FramePrefetcher(seq.image_paths, cam.width, cam.height) as pf:
                back += [img for _, img in pf]
        rec["frames_read_back_equal"] = len(back) == len(u8) and all(
            np.array_equal(b, f.astype(np.float32)) for b, f in zip(back, u8))
        common = ["--settings", yaml, "--gf-budget", "100", "--gf-warmup", "10", "--device", dev.type]
        npz = os.path.join(tmp, "bench_a_map.npz")
        snapshot.save_map = recording_save_map
        reset_launch_counts()
        try:
            t0 = time.perf_counter()
            run_slam.main(["--seq", os.path.join(tmp, "bench_a"), *common, "--save-map", npz,
                           "--probe-stages", "--out", os.path.join(tmp, "a")])
            rec["run_a_seconds"] = time.perf_counter() - t0
        finally:
            snapshot.save_map = save_map
        launches, by_shape = hamming.LAUNCHES, collections.Counter(hamming.LAUNCHES_BY_SHAPE)
        with open(os.path.join(tmp, "a_result.json")) as f:
            res_a = json.load(f)
        tracked_a = [float(line.split()[0]) for line in open(os.path.join(tmp, "a_AllFrameTrajectory.txt"))]
        first_working = int(np.argmin(np.abs(np.asarray(seq_a.timestamps) - tracked_a[0]))) if tracked_a else -1
        t0 = time.perf_counter()
        m, voc, db = snapshot.load_map(npz, dev)
        rec["load_map_seconds"] = time.perf_counter() - t0
        rec["snapshot_mib"] = os.path.getsize(npz) / 2**20
        rec["snapshot_equal"] = (all(torch.equal(a, b) for a, b in zip(m, saved["m"]))
                                 and all(torch.equal(getattr(voc, f), getattr(saved["voc"], f))
                                         for f in ("centers", "weights")) and (voc.k, voc.L) == (saved["voc"].k, saved["voc"].L)
                                 and all(torch.equal(a, b) for a, b in zip(db, saved["db"])))
        del m, voc, db, saved
        reset_launch_counts()
        t0 = time.perf_counter()
        run_slam.main(["--seq", os.path.join(tmp, "bench_b"), *common, "--load-map", npz, "--out",
                       os.path.join(tmp, "b")])
        rec["run_b_seconds"] = time.perf_counter() - t0
        launches += hamming.LAUNCHES
        by_shape += collections.Counter(hamming.LAUNCHES_BY_SHAPE)
        with open(os.path.join(tmp, "b_result.json")) as f:
            res_b = json.load(f)
        tracked_b = [float(line.split()[0]) for line in open(os.path.join(tmp, "b_AllFrameTrajectory.txt"))]
        resumed_at = int(np.argmin(np.abs(np.asarray(seq_b.timestamps) - tracked_b[0]))) if tracked_b else -1
    stages = res_a.get("device_stages_ms", {})
    rec.update({
        "first_working": first_working, "ref_first_working": ref_first, "tracked": res_a["tracked"],
        "ref_tracked": ref_tracked, "keyframes": res_a["keyframes"], "ate_rmse_m": res_a.get("ate_rmse_m"),
        "ref_ate_rmse_m": ref_ate, "timing_median_ms": {k: v.get("median_ms") for k, v in res_a["timing"].items()},
        "device_stages_ms": stages, "resumed_working_at": resumed_at, "resumed_tracked": res_b["tracked"],
        "resumed_frames": res_b["frames"], "resumed_ate_rmse_m": res_b.get("ate_rmse_m"),
        "resumed_timing_median_ms": {k: v.get("median_ms") for k, v in res_b["timing"].items()},
        "hamming_launches": launches,
        "hamming_launches_by_shape": {f"{nq}x{nt}": n for (nq, nt), n in sorted(by_shape.items())},
    })
    bad = []
    if not rec["frames_read_back_equal"]:
        bad.append("the frames read back differ from the frames written")
    if first_working < 0 or first_working > ref_first + WORKING_SLACK:
        bad.append(f"first WORKING frame {first_working} (reference {ref_first})")
    if rec["tracked"] < TRACKED_SHARE * ref_tracked:
        bad.append(f"tracked {rec['tracked']} of {n_a} (reference {ref_tracked})")
    if rec["ate_rmse_m"] is None or rec["ate_rmse_m"] > ATE_FACTOR * ref_ate:
        bad.append(f"ATE {rec['ate_rmse_m']} m (reference {ref_ate} m over the same frames)")
    if not rec["snapshot_equal"]:
        bad.append("save_map → load_map did not give back the map, vocabulary and database")
    if resumed_at < 0 or resumed_at >= RESUME_WITHIN:
        bad.append(f"the resumed run WORKING at its frame {resumed_at} (expected < {RESUME_WITHIN})")
    elif res_b["tracked"] < TRACKED_SHARE * (n_b - resumed_at):
        bad.append(f"the resumed run tracked {res_b['tracked']} of its {n_b - resumed_at} frames after relocalizing")
    if list(stages) != list(stage_probe.STAGES) or not all(math.isfinite(v) and v >= 0 for v in stages.values()):
        bad.append(f"probed stage times {stages}")
    if bad:
        raise AssertionError("dataset phase outside its gates: " + "; ".join(bad) + f" — {rec}")
    return rec


def trajectory_ate(system, ts, poses_gt) -> float | None:
    """ATE of a system's tracked poses against the ground truth at their
    timestamps (None below 11 tracked frames, as run_sequence reports it)."""
    import numpy as np

    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.io_utils import evaluation

    est_ts, est = system.get_trajectory()
    if len(est) <= 10:
        return None
    gt_by_t = {round(float(t), 6): c for t, c in zip(ts, run_slam.camera_centers(poses_gt))}
    return evaluation.ate_rmse(run_slam.camera_centers(est), np.stack([gt_by_t[round(float(t), 6)] for t in est_ts]))


def run_bench_phase(dev, voc, smi: str) -> dict:
    """Phase 10b: the port's bench over the bench's first BENCH_FRAMES
    frames; both systems held to the reference's runs over the same frames.
    Raises on any gate."""
    import torch

    from gf_orb_slam_tpu_torch import bench, run_slam
    from gf_orb_slam_tpu_torch.kernels import hamming

    meta, z_on = load_place_fixture("bench")
    _, z_off = load_place_fixture("bench_gf_off", LEFTOVERS_FIXTURE)
    cam, ts, poses_gt, frames = bench_sequence(dev, meta)
    F = BENCH_FRAMES
    reset_launch_counts()
    t0 = time.perf_counter()
    line, on, off = bench.run_bench(cam, run_slam.bench_config(), ts[:F], frames[:F], voc, dev)
    torch.cuda.synchronize()
    rec = {"phase": "bench", "entry": "gf_orb_slam_tpu_torch.bench.run_bench", "frames": F,
           "cut": f"the bench's 240 frames cut to {F} (warm-up {bench.WARMUP}, windows of {bench.WINDOW}): the time limit",
           "seconds": time.perf_counter() - t0, "line": line, "nvidia_smi": smi,
           "hamming_launches": hamming.LAUNCHES,
           "hamming_launches_by_shape": {f"{nq}x{nt}": n for (nq, nt), n in sorted(hamming.LAUNCHES_BY_SHAPE.items())}}
    print(json.dumps(line), flush=True)
    d = line["detail"]
    bad = [f"{k} = {v} is not a finite rate" for k, v in (("value", line["value"]), ("gf_off_fps", d["gf_off_fps"]),
                                                           ("device_only_fps", d["device_only_fps"]))
           if not (math.isfinite(v) and v > 0)]
    for name, system, z in (("gf_on", on, z_on), ("gf_off", off, z_off)):
        ref = reference_prefix(z, poses_gt, F)
        got = {"tracked": len(system.trajectory), "keyframes": system.n_kf, "ate_rmse_m": trajectory_ate(system, ts, poses_gt),
               "ref_tracked": ref["tracked"], "ref_ate_rmse_m": ref["ate_rmse_m"]}
        rec[name] = got
        if got["tracked"] < TRACKED_SHARE * ref["tracked"]:
            bad.append(f"{name}: tracked {got['tracked']} of {F} (reference {ref['tracked']})")
        if got["ate_rmse_m"] is None or got["ate_rmse_m"] > ATE_FACTOR * ref["ate_rmse_m"]:
            bad.append(f"{name}: ATE {got['ate_rmse_m']} m (reference {ref['ate_rmse_m']} m)")
    if bad:
        raise AssertionError("bench phase outside its gates: " + "; ".join(bad) + f" — {rec}")
    return rec


def run_sweep_phase(dev) -> dict:
    """Phase 10c: the port's budget sweep on the card, each row held to the
    reference's. Raises on any gate."""
    import tempfile

    import numpy as np

    from gf_orb_slam_tpu_torch import batch_sweep
    from gf_orb_slam_tpu_torch.kernels import hamming

    with np.load(LEFTOVERS_FIXTURE) as zf:
        ref_meta = json.loads(str(zf["sweep_meta"]))
    if ref_meta["args"][:-1] != SWEEP_ARGS:  # the reference ran with --cpu
        raise AssertionError(f"the reference sweep ran {ref_meta['args']}, this phase runs {SWEEP_ARGS}")
    ref_rows = {(r["budget"], r["round"]): r for r in ref_meta["rows"]}
    reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_") as tmp:
        out = batch_sweep.main([*SWEEP_ARGS, "--device", dev.type, "--out-dir", tmp])
    keep = ("budget", "round", "frames", "tracked", "keyframes", "map_points", "loops_closed", "ate_rmse_m")
    rows = [{k: r.get(k) for k in keep} | {"track_median_ms": r["timing"]["total"]["median_ms"],
                                           "device_stages_ms": r.get("device_stages_ms")} for r in out["runs"]]
    rec = {"phase": "sweep", "entry": "gf_orb_slam_tpu_torch.batch_sweep.main", "args": SWEEP_ARGS,
           "seconds": time.perf_counter() - t0, "rows": rows, "cells": out["cells"], "ref_rows": ref_meta["rows"],
           "hamming_launches": hamming.LAUNCHES,
           "hamming_launches_by_shape": {f"{nq}x{nt}": n for (nq, nt), n in sorted(hamming.LAUNCHES_BY_SHAPE.items())}}
    bad = []
    if sorted((r["budget"], r["round"]) for r in rows) != sorted(ref_rows):
        bad.append(f"rows {[(r['budget'], r['round']) for r in rows]} (reference {sorted(ref_rows)})")
    for r in rows:
        ref = ref_rows.get((r["budget"], r["round"]))
        if ref is None:
            continue
        if r["tracked"] < TRACKED_SHARE * ref["tracked"]:
            bad.append(f"budget {r['budget']}: tracked {r['tracked']} (reference {ref['tracked']})")
        if r["ate_rmse_m"] is None or r["ate_rmse_m"] > ATE_FACTOR * ref["ate_rmse_m"]:
            bad.append(f"budget {r['budget']}: ATE {r['ate_rmse_m']} m (reference {ref['ate_rmse_m']} m)")
    # The budget reaches the run: where the reference's two budgets part,
    # the port's must part too (GF on after its 40-frame warm-up).
    ate = {r["budget"]: r["ate_rmse_m"] for r in rows if r["round"] == 0}
    ref_ate = {b: r["ate_rmse_m"] for (b, rnd), r in ref_rows.items() if rnd == 0}
    if len(set(ref_ate.values())) > 1 and len(set(ate.values())) < len(ate):
        bad.append(f"the budgets' runs are identical (ATE {ate}; reference {ref_ate})")
    if bad:
        raise AssertionError("sweep phase outside its gates: " + "; ".join(bad) + f" — {rec}")
    return rec


def probe_round(room, closing: tuple, device) -> list:
    """The gate records of two loop rounds in probe mode (the streak
    reaches 2, so the candidate is shadow-verified) for the query and
    candidate of the verification that closed the room's loop, on copies of
    the map and database that verification read, on `device`. The Sim3
    RANSAC uniforms come from a CPU generator seeded 0, so both devices draw
    the same samples from the same valid slots."""
    import dataclasses

    import numpy as np
    import torch

    from gf_orb_slam_tpu_torch.mapping import map_state as ms
    from gf_orb_slam_tpu_torch.ops.fast import top_k_stable
    from gf_orb_slam_tpu_torch.pipeline import system as system_mod
    from gf_orb_slam_tpu_torch.retrieval import keyframe_db as kdb
    from gf_orb_slam_tpu_torch.solvers import sim3_solver

    (_, m, db, q, c, _), _ = closing
    q, c = int(q), int(c)
    s = system_mod.SlamSystem(room.cam, dataclasses.replace(room.cfg, loop_probe_floor=PROBE_FLOOR), device=device)
    s.map = ms.MapState(*(t.to(device, copy=True) for t in m))
    s.voc = room.voc.to(device)
    s.bow_db = kdb.BowDatabase(*(t.to(device, copy=True) for t in db))
    s.loop_gt_overlap = room.loop_gt_overlap
    W = ms.covisibility(s.map)
    Wn = W.cpu().numpy()
    p = {"kf": q, "cand": np.asarray([c], np.int32), "ok": np.asarray([True]), "covis_c": Wn[[c]], "covis": W,
         "covis_q": Wn[q], "kf_frame_id": s.map.kf_frame_id.cpu().numpy(), "kf_valid": s.map.kf_valid.cpu().numpy()}
    gen = torch.Generator().manual_seed(0)

    def same_draw(valid, n_hypotheses, generator):
        u = torch.rand((n_hypotheses, valid.shape[0]), generator=gen).to(valid.device)
        return top_k_stable(-torch.log(-torch.log(u)) + torch.where(valid, 0.0, -1e9), 3)[1]

    draw = sim3_solver.sample_sim3
    sim3_solver.sample_sim3 = same_draw
    try:
        for _ in range(2):
            s._try_close_loop(dict(p))
    finally:
        sim3_solver.sample_sim3 = draw
    return s.loop_gate_events


def run_leftovers_phase(dev, system_run: dict, probe: dict) -> dict:
    """Phase 13: the modules no other phase drives, each on the card and
    held against the CPU port or its own criterion, with the probe round
    that leftovers_probe ran in phase 7's process. Raises on any gate."""
    import tempfile

    import numpy as np
    import torch

    from gf_orb_slam_tpu_torch import entry
    from gf_orb_slam_tpu_torch.geometry import se3
    from gf_orb_slam_tpu_torch.io_utils import synthetic, viz
    from gf_orb_slam_tpu_torch.kernels import hamming
    from gf_orb_slam_tpu_torch.mapping import map_state as ms
    from gf_orb_slam_tpu_torch.ops import boxlog, matching, orb
    from gf_orb_slam_tpu_torch.solvers import initializer

    meta, _ = load_place_fixture("bench")
    cam, _, _, frames = bench_sequence(dev, meta)
    rec, bad, secs = {"phase": "leftovers"}, [], {}
    reset_launch_counts()
    t_all = time.perf_counter()

    # The patch-matmul path: the gather path's keypoints, the reference
    # test's quality criterion against its descriptors, and the CPU's bits.
    t0 = time.perf_counter()
    img = frames[0]
    kp = orb.extract_orb(img, orb.OrbConfig(patch_desc=True))
    kg = orb.extract_orb(img, orb.OrbConfig())
    kc = orb.extract_orb(img.cpu(), orb.OrbConfig(patch_desc=True))
    kp, kg = (orb.Keypoints(*(x.cpu() for x in k)) for k in (kp, kg))
    v = kp.valid & kg.valid
    dist = torch.diagonal(matching.hamming_matrix_torch(kp.desc, kg.desc))[v].numpy()
    same_bin = (orb.angle_bins(kp.angle) == orb.angle_bins(kg.angle))[v].numpy()
    same = (kp.uv == kc.uv).all(dim=1) & kp.valid & kc.valid
    rec["patch_desc"] = {
        "valid": int(kp.valid.sum()), "uv_equal_to_gather": bool(torch.equal(kp.uv[v], kg.uv[v])),
        "same_bin_share": float(same_bin.mean()), "same_bin_median_bits": float(np.median(dist[same_bin])),
        "same_bin_mean_bits": float(dist[same_bin].mean()), "keypoints_equal_to_cpu": int(same.sum()),
        "desc_bit_equal_to_cpu": bool(torch.equal(kp.desc[same], kc.desc[same])),
        "max_angle_diff_to_cpu": float((kp.angle - kc.angle)[same].abs().max())}
    r = rec["patch_desc"]
    if not (r["uv_equal_to_gather"] and r["same_bin_share"] > 0.5 and r["same_bin_median_bits"] <= 12
            and r["same_bin_mean_bits"] < 32):
        bad.append(f"patch descriptors against the gather path: {r}")
    if not (r["desc_bit_equal_to_cpu"] and r["keypoints_equal_to_cpu"] >= 0.98 * int(kc.valid.sum())
            and r["max_angle_diff_to_cpu"] <= 1e-5):
        bad.append(f"patch descriptors against the CPU: {r}")
    secs["patch_desc"] = time.perf_counter() - t0

    # BoxLOG against the CPU.
    t0 = time.perf_counter()
    xg, vg, okg = (a.cpu() for a in boxlog.detect_blobs(frames[7], n_keep=400))
    xc, vc, okc = boxlog.detect_blobs(frames[7].cpu(), n_keep=400)
    tol = 1e-4 * float(vc.max())
    differ = ~(xg == xc).all(dim=1)
    ties = all(int(((vc - vc[i]).abs() <= 2 * tol).sum()) >= 2 for i in torch.nonzero(differ).flatten().tolist())
    rec["boxlog"] = {"valid": int(okg.sum()), "max_response_diff": float((vg - vc).abs().max()), "tolerance": tol,
                     "positions_differing": int(differ.sum()), "differing_are_ties": ties}
    if not (torch.equal(okg, okc) and rec["boxlog"]["max_response_diff"] <= tol and ties
            and differ.float().mean() <= 0.05):
        bad.append(f"BoxLOG against the CPU: {rec['boxlog']}")
    secs["boxlog"] = time.perf_counter() - t0

    # The prior-pose initializer on the recorded initialization pair (frames
    # 0 and 4) with the ground-truth motion, against the CPU.
    t0 = time.perf_counter()
    with np.load(SYSTEM_FIXTURE) as zf:
        pair = {k: torch.from_numpy(zf[k]) for k in ("init_uv1", "init_uv2", "init_matched", "gt_pose")}
    pose21 = se3.relative(pair["gt_pose"][4], pair["gt_pose"][0])
    args = (pair["init_uv1"], pair["init_uv2"], pair["init_matched"], pose21)
    want = initializer.initialize_with_prior(cam, *args)
    got = initializer.initialize_with_prior(cam, *(a.to(dev) for a in args))
    rec["initialize_with_prior"] = {"n_good": int(got.n_good), "cpu_n_good": int(want.n_good),
                                    "success": bool(got.success), "matched": int(pair["init_matched"].sum()),
                                    "mask_equal": bool(torch.equal(got.is_triangulated.cpu(), want.is_triangulated))}
    r = rec["initialize_with_prior"]
    if not (r["n_good"] == r["cpu_n_good"] and r["mask_equal"] and r["success"]):
        bad.append(f"initialize_with_prior against the CPU: {r}")
    secs["initialize_with_prior"] = time.perf_counter() - t0

    # The viz exports of phase 5's final map.
    t0 = time.perf_counter()
    system = system_run["system"]
    m = system.map
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ply_") as tmp:
        path = os.path.join(tmp, "map.ply")
        viz.export_map_ply(path, m)
        text = open(path).read().splitlines()
    head = text.index("end_header")
    n_v = int(next(ln for ln in text if ln.startswith("element vertex")).split()[-1])
    n_e = int(next(ln for ln in text if ln.startswith("element edge")).split()[-1])
    kf_valid = m.kf_valid.cpu().numpy()
    W = ms.covisibility(m).cpu().numpy()[np.ix_(kf_valid, kf_valid)]
    want_v, want_e = int(m.pt_valid.sum()) + int(kf_valid.sum()), int((np.triu(W, k=1) >= 15).sum())
    rgb = viz.annotate_frame(frames[-1].cpu().numpy(), system.last_frame.uv.cpu().numpy(),
                             (system.last_obs >= 0).cpu().numpy())
    green = int(((rgb[..., 0] == 0) & (rgb[..., 1] == 255) & (rgb[..., 2] == 0)).sum())
    rec["viz"] = {"vertices": n_v, "edges": n_e, "expected_vertices": want_v, "expected_edges": want_e,
                  "lines": len(text) - head - 1, "annotated_shape": list(rgb.shape), "green_pixels": green}
    if not (n_v == want_v and n_e == want_e and len(text) - head - 1 == n_v + n_e and rgb.dtype == np.uint8
            and rgb.shape == (*frames.shape[1:], 3) and green > 0):
        bad.append(f"viz exports: {rec['viz']}")
    secs["viz"] = time.perf_counter() - t0

    # The entry step (the kernel at 512×512).
    t0 = time.perf_counter()
    fn, eargs = entry.entry(dev)
    pose, n_inliers, logdet = fn(*eargs)
    torch.cuda.synchronize()
    rec["entry"] = {"pose": pose.cpu().tolist(), "n_inliers": int(n_inliers), "logdet": float(logdet),
                    "launches_512x512": hamming.LAUNCHES_BY_SHAPE[(512, 512)]}
    if not (bool(torch.isfinite(pose).all()) and math.isfinite(float(logdet)) and int(n_inliers) > 10
            and rec["entry"]["launches_512x512"] >= 1):
        bad.append(f"entry step: {rec['entry']}")
    secs["entry"] = time.perf_counter() - t0

    # One probe round on phase 7's map, run in its process (leftovers_probe).
    rec["probe"], secs["probe"] = probe["probe"], probe["seconds"]
    bad += probe["bad"]

    # Every texture style, and a few frames along the revisit trajectory.
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    tex = {st: synthetic.varied_texture(rng, 256, st) for st in synthetic.TEXTURE_STYLES}
    _, poses = synthetic.revisit_trajectory(60, fps=cam.fps)
    scene = synthetic.make_scene(seed=0, device=dev)
    views = torch.stack([synthetic.render(scene, cam, torch.from_numpy(poses[i])) for i in (0, 15, 30, 45)])
    rec["synthetic"] = {"textures": {st: [float(t.min()), float(t.max()), float(t.std())] for st, t in tex.items()},
                        "revisit_frames": list(views.shape), "revisit_mean": views.mean(dim=(1, 2)).cpu().tolist()}
    if not (all(t.shape == (256, 256) and t.dtype == np.float32 and 0 <= t.min() and t.max() <= 255 and t.std() > 1
                for t in tex.values()) and bool(torch.isfinite(views).all())
            and views.shape == (4, cam.height, cam.width) and float(views.std()) > 1):
        bad.append(f"synthetic: {rec['synthetic']}")
    secs["synthetic"] = time.perf_counter() - t0

    by_shape = collections.Counter({f"{nq}x{nt}": n for (nq, nt), n in hamming.LAUNCHES_BY_SHAPE.items()})
    rec.update({"seconds": time.perf_counter() - t_all, "seconds_by_check": secs,
                "hamming_launches": hamming.LAUNCHES + probe["hamming_launches"],
                "hamming_launches_by_shape": dict(sorted((by_shape + collections.Counter(
                    probe["hamming_launches_by_shape"])).items()))})
    if bad:
        raise AssertionError("leftovers phase outside its gates: " + "; ".join(bad))
    return rec


def leftovers_probe(dev, loop: dict) -> dict:
    """Phase 13's probe round, in phase 7's process: {"probe": record,
    "bad": gates missed, "seconds", and its Hamming launches}."""
    import torch

    from gf_orb_slam_tpu_torch.kernels import hamming

    rec, bad = {}, []
    reset_launch_counts()
    t0 = time.perf_counter()
    # One probe round on the map phase 7's closing verification read (by
    # the run's end keyframe culling has removed its query and candidate),
    # against the CPU port.
    room, closing = loop["system"], loop["closing_verify"]
    closed = [e for e in room.loop_events if e["closed"]]
    if not closed or closing is None:
        bad.append("phase 7 closed no loop to probe")
    else:
        got, want = probe_round(room, closing, dev), probe_round(room, closing, torch.device("cpu"))
        rec["probe"] = {"query_kf": int(closing[0][3]), "candidate_kf": int(closing[0][4]),
                        "closed_event": closed[-1], "gate_events": got, "cpu_gate_events": want}
        ok = (len(got) == len(want) == 3 and "cand" in got[-1] and got[-1]["n_bow"] >= PROBE_FLOOR
              and (got[-1]["kf"], got[-1]["cand"]) == (closed[-1]["kf"], closed[-1]["matched_kf"]))
        for g, w in zip(got, want):
            ok &= set(g) == set(w) and all(g[k] == w[k] for k in w if k not in ("n_ransac", "n_guided", "n_opt"))
            ok &= all(abs(g[k] - w[k]) <= max(FUNNEL_TOL[0], FUNNEL_TOL[1] * w[k])
                      for k in ("n_ransac", "n_guided", "n_opt") if k in w)
        if not ok:
            bad.append(f"probe round against the CPU: {rec['probe']}")
    return {"probe": rec.get("probe"), "bad": bad, "seconds": time.perf_counter() - t0,
            "hamming_launches": hamming.LAUNCHES,
            "hamming_launches_by_shape": {f"{nq}x{nt}": n for (nq, nt), n in hamming.LAUNCHES_BY_SHAPE.items()}}


def run_room_stages_phase(dev) -> dict:
    """Phase 15: the reference's room run (room_fixture.npz) stage by stage
    on the card, each stage fed the reference's inputs. Raises on any gate."""
    import numpy as np
    import torch

    from gf_orb_slam_tpu_torch.geometry import sim3 as s3
    from gf_orb_slam_tpu_torch.geometry.camera import CameraModel
    from gf_orb_slam_tpu_torch.io_utils import map_delta, snapshot
    from gf_orb_slam_tpu_torch.kernels import hamming
    from gf_orb_slam_tpu_torch.gf import selection
    from gf_orb_slam_tpu_torch.loop import loop_closing
    from gf_orb_slam_tpu_torch.mapping import map_state as ms
    from gf_orb_slam_tpu_torch.mapping.frame import FrameData
    from gf_orb_slam_tpu_torch.pipeline import local_mapping, tracking
    from gf_orb_slam_tpu_torch.solvers import pose_graph

    with np.load(ROOM_FIXTURE) as zf:
        z = {k: zf[k] for k in zf.files}
    meta = json.loads(str(z["meta"]))
    cam = CameraModel(**meta["camera"])

    def t(a):
        return snapshot.to_tensor(np.asarray(a), dev)

    def port_map(name):
        return snapshot.map_state_from_numpy(map_delta.decode(z, name), dev)

    steps = range(len(meta["track_frames"]))
    maps = {n: port_map(n) for n in ("ins_in", "loop_in", *(f"trk{j}_map" for j in steps))}
    rec = {"phase": "room_stages", "entry": "pipeline.local_mapping.insert_keyframe_fused, pipeline.tracking."
           "track_frame, loop.loop_closing.correct_loop", "fixture": os.path.relpath(ROOM_FIXTURE, REPO),
           "insert_frame": meta["insert_frame"], "track_frames": meta["track_frames"], "loop_frame": meta["loop_frame"]}
    bad = []
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()

    # (a) the insertion.
    names = ("pose", "frame_id", "timestamp", "kp_uv", "kp_octave", "kp_angle", "kp_desc", "kp_valid", "obs_point")
    a = [z[f"ins_arg_{k}"] for k in names]
    kw = dict(meta["insert_kw"], ba_iters=tuple(meta["insert_kw"]["ba_iters"]))
    w0 = time.perf_counter()
    res = local_mapping.insert_keyframe_fused(cam, maps["ins_in"], t(a[0]), int(a[1]), float(a[2]),
                                              *[t(x) for x in a[3:]], **kw)
    torch.cuda.synchronize()
    ins = map_delta.agreement(ms.to_numpy(res.m), map_delta.decode(z, "ins_out")) | {
        "ms": (time.perf_counter() - w0) * 1e3}
    ids, wids = res.view.ids.cpu().numpy(), z["ins_view_ids"]
    P = maps["ins_in"].pt_capacity
    ins["view_ids"] = float(np.isin(ids[ids < P], wids[wids < P]).sum() / ((ids < P) | (wids < P)).sum())
    ins["kf_id"], ins["culled_kf"] = int(res.kf_id), int(res.culled_kf)
    rec["insertion"] = ins
    if (ins["kf_id"], ins["culled_kf"]) != (int(z["ins_kf_id"]), int(z["ins_culled_kf"])) or not ins["kf_valid_equal"]:
        bad.append("insertion: keyframe id, culled keyframe or keyframe validity")
    if ins["pt_valid"] < 0.99 or ins["kf_obs_point"] < 0.98 or ins["kf_pose"] > 1e-3 or ins["view_ids"] < 0.98:
        bad.append("insertion: agreement")

    # (b) the tracking step on the frames after it, on the reference's
    # keypoints; the last step, frame 236, is reported only.
    rec["tracking"] = []
    tk = meta["track_kw"]
    picks = []
    select = selection.greedy_maxlogdet_lowrank

    def counted(*a, **kw):
        res = select(*a, **kw)
        picks.append(res.n_selected)
        return res

    selection.greedy_maxlogdet_lowrank = counted
    try:
        for j in steps:
            p = f"trk{j}_"
            uv = t(z[p + "out_frame_uv"])
            frame = FrameData(uv=uv, uv_raw=uv, octave=t(z[p + "out_frame_octave"]), angle=t(z[p + "out_frame_angle"]),
                              desc=t(z[p + "out_frame_desc"]), response=torch.zeros_like(uv[:, 0]),
                              valid=t(z[p + "out_frame_valid"]))
            view = snapshot.track_view_from_numpy(z, dev, prefix=p + "view_")
            w0 = time.perf_counter()
            r = tracking.track_frame(cam, maps[f"trk{j}_map"], view, frame,
                                     *[t(z[p + k]) for k in ("last_pose", "last_obs", "last_uv", "velocity")],
                                     float(z[p + "dt"]), t(z[p + "key"].astype(np.int64)), scale=tk["scale"],
                                     n_levels=tk["n_levels"], gf_budget=tk["gf_budget"], use_gf=tk["use_gf"],
                                     gf_mode=tk["gf_mode"], gf_batch=tk["gf_batch"])
            pose, o = r.pose.cpu().numpy(), r.obs_point.cpu().numpy()
            wpose, wo = z[p + "out_pose"], z[p + "out_obs_point"]
            either = (o >= 0) | (wo >= 0)
            fr = {"frame": int(z[p + "frame"]), "ms": (time.perf_counter() - w0) * 1e3,
                  "rot_err_rad": rot_err(pose[:4], wpose[:4]), "trans_err": float(np.linalg.norm(pose[4:] - wpose[4:])),
                  "n_inliers": int(r.n_inliers), "ref_n_inliers": int(z[p + "out_n_inliers"]), "ok": bool(r.ok),
                  "ref_ok": bool(z[p + "out_ok"]), "obs_point": float((o == wo)[either].mean()),
                  "points_differ": int((o != wo).sum()), "gf_picks": [int(n) for n in picks],
                  "ref_gf_picks": int(z[p + "gf_picks"])}
            picks.clear()
            rec["tracking"].append(fr)
            w = fr["ref_n_inliers"]
            if j == steps[-1]:
                continue
            if (not np.isfinite(pose).all() or fr["ok"] != fr["ref_ok"] or fr["rot_err_rad"] > ROT_TOL_RAD
                    or fr["trans_err"] > TRANS_TOL or abs(fr["n_inliers"] - w) > max(3, 0.02 * w)
                    or fr["obs_point"] < OBS_AGREE_MIN):
                bad.append(f"tracking frame {fr['frame']}")
    finally:
        selection.greedy_maxlogdet_lowrank = select

    # (c) the loop correction, its essential graph the port's own.
    graphs = []
    optimize = pose_graph.optimize_pose_graph

    def recording(prob, **kw):
        graphs.append(prob)
        return optimize(prob, **kw)

    pose_graph.optimize_pose_graph = recording
    try:
        w0 = time.perf_counter()
        got = loop_closing.correct_loop(maps["loop_in"], int(z["loop_query_kf"]), int(z["loop_loop_kf"]),
                                        t(z["loop_S12"]), t(z["loop_covis"]), cam=cam)
        torch.cuda.synchronize()
        ms_loop = (time.perf_counter() - w0) * 1e3
    finally:
        pose_graph.optimize_pose_graph = optimize
    want = map_delta.decode(z, "loop_out")
    loop = map_delta.agreement(ms.to_numpy(got), want) | {"ms": ms_loop}
    g = {k: v.cpu().numpy() for k, v in got._asdict().items() if k in ("pt_visible", "pt_found")}
    loop["counters_equal"] = bool(all(np.array_equal(g[k], want[k]) for k in g))
    rec["correct_loop"] = loop
    if loop["kf_pose"] > 1e-4 or loop["pt_pos"] > 1e-4 or not loop["kf_valid_equal"]:
        bad.append("correct_loop: poses or points")
    if loop["pt_valid"] < 1.0 or loop["kf_obs_point"] < 1.0 or not loop["counters_equal"]:
        bad.append("correct_loop: agreement")
    # The correction again on one input: equal bits (its graph, which takes
    # no step here, is held taking steps in (d)).
    again = ms.to_numpy(loop_closing.correct_loop(maps["loop_in"], int(z["loop_query_kf"]), int(z["loop_loop_kf"]),
                                                  t(z["loop_S12"]), t(z["loop_covis"]), cam=cam))
    first = ms.to_numpy(got)
    rec["repeat_correct_loop"] = {k: tool("torch_repeat_probe").equal_bits(first[k], again[k]) for k in first}
    if not all(rec["repeat_correct_loop"].values()):
        bad.append("correct_loop: two runs of one input differ in "
                   f"{[k for k, eq in rec['repeat_correct_loop'].items() if not eq]}")
    # (d) the graph where it takes steps (its times reported, not gated; its
    # two timed solves must give equal bits): the correction's problem with every free
    # vertex moved ~0.01 off, so no residual sits at round-off and the
    # reference's predicate is false at the input; 20 LM iterations, each
    # testing the predicate, against the predicate alone.
    prob = graphs[0]
    xi = 0.01 * torch.randn(prob.poses.shape[0], 7, generator=torch.Generator().manual_seed(0))
    xi[:, 6] = 0.0
    stepping = prob._replace(poses=torch.where(~prob.fixed[:, None], s3.compose(s3.exp(xi.to(dev)), prob.poses),
                                               prob.poses))

    def predicate():
        return pose_graph.reference_tangent_overflow(stepping.poses, prob.edge_i, prob.edge_j, prob.edge_meas).any()

    solved = []

    graph_steps = {"vertices": int(prob.vertex_valid.sum()), "edges": int(prob.edge_valid.sum()),
             "edge_slots": prob.edge_i.shape[0], "predicate_at_input": bool(predicate()),
             "predicate_ms": timed_ms(predicate, reps=5),
             "lm20_ms": timed_ms(lambda: solved.append(pose_graph.optimize_pose_graph(stepping, n_iters=20)), reps=2)}
    graph_steps["predicate_share"] = 20 * graph_steps["predicate_ms"] / graph_steps["lm20_ms"]
    graph_steps["repeat_equal_bits"] = bool(torch.equal(solved[0], solved[1]))
    graph_steps["took_steps"] = not bool(torch.equal(solved[0], stepping.poses))
    if not (graph_steps["repeat_equal_bits"] and graph_steps["took_steps"]):
        bad.append(f"the pose graph taking steps: two solves of one input differ or took no step — {graph_steps}")
    rec["pose_graph_steps"] = graph_steps

    rec["seconds"] = time.perf_counter() - t0
    rec["hamming_launches"] = hamming.LAUNCHES
    rec["hamming_launches_by_shape"] = {f"{nq}x{nt}": n for (nq, nt), n in sorted(hamming.LAUNCHES_BY_SHAPE.items())}
    missing = [s_ for s_ in ROOM_STAGE_SHAPES if hamming.LAUNCHES_BY_SHAPE.get(s_, 0) == 0]
    if missing:
        bad.append(f"the Hamming kernel never launched at {missing}")
    if bad:
        raise AssertionError("room_stages phase outside its gates: " + "; ".join(bad) + f" — {rec}")
    return rec


def run_endurance_stages_phase(dev) -> dict:
    """Phase 16: the reference's 1,200-frame endurance run
    (endurance_fixture.npz) stage by stage on the card: each loop
    verification it accepted and the first it rejected, with its own
    Sim3-RANSAC minimal sets injected, and each loop correction, the
    essential graph the port's own. Raises on any gate."""
    import numpy as np
    import torch

    from gf_orb_slam_tpu_torch.geometry.camera import CameraModel
    from gf_orb_slam_tpu_torch.io_utils import map_delta, snapshot
    from gf_orb_slam_tpu_torch.kernels import hamming
    from gf_orb_slam_tpu_torch.loop import loop_closing
    from gf_orb_slam_tpu_torch.mapping import map_state as ms
    from gf_orb_slam_tpu_torch.retrieval import keyframe_db as kdb
    from gf_orb_slam_tpu_torch.solvers import sim3_solver

    with np.load(ENDURANCE_FIXTURE) as zf:
        z = {k: zf[k] for k in zf.files}
    meta = json.loads(str(z["meta"]))
    cam = CameraModel(**meta["camera"])
    loops = [f"loop{j}" for j in range(meta["n_loops"])]

    def t(a):
        return snapshot.to_tensor(np.asarray(a), dev)

    def inputs(name):
        m = snapshot.map_state_from_numpy(map_delta.decode(z, f"{name}_map"), dev)
        K, N = m.kf_kp_desc.shape[:2]
        q, c = int(z[f"{name}_query_kf"]), int(z[f"{name}_cand_kf"])
        mid = np.zeros((K, N), np.int32)
        mid[q], mid[c] = z[f"{name}_db_mid_q"], z[f"{name}_db_mid_c"]
        zero = torch.zeros((K, N), dtype=torch.int32, device=dev)
        db = kdb.BowDatabase(bow_ids=zero, bow_vals=zero.float(), words=zero, mid_nodes=t(mid),
                             valid=torch.zeros(K, dtype=torch.bool, device=dev))
        return m, db, q, c

    staged = {name: inputs(name) for name in loops + ["reject"]}
    samples = {name: t(z[f"{name}_samples"].astype(np.int64)) for name in staged}
    rec = {"phase": "endurance_stages", "entry": "loop.loop_closing.verify_candidate, loop.loop_closing.correct_loop",
           "fixture": os.path.relpath(ENDURANCE_FIXTURE, REPO), "frames": meta["frames"],
           "reference_summary": {k: meta["summary"][k] for k in ("segment_ate_m", "loops_closed", "xla_flags")}}
    bad = []
    draw = sim3_solver.sample_sim3
    current = []
    sim3_solver.sample_sim3 = lambda valid, n_hypotheses, generator: samples[current[-1]]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rec["verify"] = []
        for name, (m, db, q, c) in staged.items():
            current.append(name)
            w0 = time.perf_counter()
            lm = loop_closing.verify_candidate(cam, m, db, q, c, torch.Generator(device=dev), **meta["verify_kw"])
            got = {k: int(getattr(lm, k)) for k in ("n_bow", "n_ransac", "n_guided", "n_inliers")}
            want = {k: int(z[f"{name}_{k}"]) for k in got}
            row = {"stage": name, "frame": int(z[f"{name}_frame"]), "ms": (time.perf_counter() - w0) * 1e3,
                   "port": got | {"ok": bool(lm.ok)}, "reference": want | {"ok": bool(z[f"{name}_ok"])},
                   "S12_max_abs_diff": float(np.abs(lm.S12.cpu().numpy() - z[f"{name}_S12"]).max())}
            rec["verify"].append(row)
            if row["port"] != row["reference"] or row["S12_max_abs_diff"] > 1e-4:
                bad.append(f"verify {name}")
    finally:
        sim3_solver.sample_sim3 = draw
    rec["correct_loop"] = []
    for name in loops:
        m, _, q, c = staged[name]
        w0 = time.perf_counter()
        got = loop_closing.correct_loop(m, q, c, t(z[f"{name}_S12"]), t(z[f"{name}_covis"]), cam=cam,
                                        **meta["correct_kw"])
        torch.cuda.synchronize()
        want = map_delta.decode(z, f"{name}_out")
        row = map_delta.agreement(ms.to_numpy(got), want) | {"stage": name, "frame": int(z[f"{name}_frame"]),
                                                             "ms": (time.perf_counter() - w0) * 1e3}
        g = {k: v.cpu().numpy() for k, v in got._asdict().items() if k in ("pt_visible", "pt_found")}
        row["counters_equal"] = bool(all(np.array_equal(g[k], want[k]) for k in g))
        rec["correct_loop"].append(row)
        if row["kf_pose"] > 1e-4 or row["pt_pos"] > 1e-4 or not row["kf_valid_equal"]:
            bad.append(f"correct_loop {name}: poses or points")
        if row["pt_valid"] < 1.0 or row["kf_obs_point"] < 1.0 or not row["counters_equal"]:
            bad.append(f"correct_loop {name}: agreement")
    rec["seconds"] = time.perf_counter() - t0
    rec["hamming_launches"] = hamming.LAUNCHES
    rec["hamming_launches_by_shape"] = {f"{nq}x{nt}": n for (nq, nt), n in sorted(hamming.LAUNCHES_BY_SHAPE.items())}
    missing = [s_ for s_ in ENDURANCE_STAGE_SHAPES if hamming.LAUNCHES_BY_SHAPE.get(s_, 0) == 0]
    if missing:
        bad.append(f"the Hamming kernel never launched at {missing}")
    if bad:
        raise AssertionError("endurance_stages phase outside its gates: " + "; ".join(bad) + f" — {rec}")
    return rec


def global_ba_problem(loop: dict):
    """(problem, keyframe ids, camera) of global BA over phase 7's map:
    every valid keyframe, the first fixed."""
    import torch

    system = loop["system"]
    ids = torch.nonzero(system.map.kf_valid).flatten().tolist()
    prob, _, _, _ = system.ba_problem(system.map, ids, fixed_ids=ids[:1])
    return prob, ids, system.cam


def keyframe_ate(poses, ids, loop: dict) -> float:
    """ATE of keyframe poses (T_cw rows for keyframe ids) against the
    ground truth at their timestamps."""
    import numpy as np

    from gf_orb_slam_tpu_torch import run_slam
    from gf_orb_slam_tpu_torch.io_utils import evaluation

    kf_ts = loop["system"].map.kf_timestamp.cpu().numpy()[ids]  # float32: the nearest frame's
    frame = np.abs(np.asarray(loop["ts"])[None, :] - kf_ts[:, None]).argmin(axis=1)
    return evaluation.ate_rmse(run_slam.camera_centers(poses.cpu().numpy()),
                               run_slam.camera_centers(loop["poses_gt"])[frame])


def run_global_ba_phase(dev, loop: dict) -> dict:
    """Phase 11: global BA of the room circuit's corrected map on an NCCL
    group of one, against the Schur solver. Raises on any gate."""
    import torch
    import torch.distributed as dist

    from gf_orb_slam_tpu_torch.parallel import global_ba, launch
    from gf_orb_slam_tpu_torch.solvers import local_ba

    prob, ids, cam = global_ba_problem(loop)
    active0 = (prob.obs_point >= 0) & (prob.obs_w > 0)

    def cost(poses, points):
        return float(local_ba._cost(cam, poses, points, prob.obs_uv, prob.obs_point, prob.obs_w, active0))

    rec = {"phase": "global_ba", "entry": "parallel.global_ba.distributed_bundle_adjust", "keyframes": len(ids),
           "observation_slots": prob.obs_point.shape[1], "point_capacity": prob.points.shape[0],
           "points": int(prob.point_valid.sum()), "edges": int(active0.sum()), "lm_iters": 10, "pcg_iters": 25,
           "initial_cost": cost(prob.poses, prob.points), "initial_keyframe_ate_m": keyframe_ate(prob.poses, ids, loop)}
    names = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor")
    counts = collections.Counter()
    originals = {n: getattr(dist, n) for n in names}

    def counting(n):
        def call(*a, **kw):
            counts[n] += 1
            return originals[n](*a, **kw)
        return call

    with launch.nccl_group() as group:
        rec["backend"] = dist.get_backend(group)
        global_ba.distributed_bundle_adjust(cam, prob, group, n_lm_iters=1)  # the communicator, cuBLAS handles
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mib = torch.cuda.memory_allocated() / 2**20
        for n in names:
            setattr(dist, n, counting(n))
        try:
            t0 = time.perf_counter()
            res = global_ba.distributed_bundle_adjust(cam, prob, group)
            torch.cuda.synchronize()
            rec["ms"] = (time.perf_counter() - t0) * 1e3
        finally:
            for n in names:
                setattr(dist, n, originals[n])
        rec["peak_memory_mib"] = torch.cuda.max_memory_allocated() / 2**20 - base_mib
        # Ground truth: the room map's BA cost is flat to 0.1% along moves of
        # centimetres (ROADMAP C4), so only converged solves land where the
        # ground truth can tell the two solvers apart.
        (lm, pcg), (s1, s2) = GBA_CONVERGED
        conv = global_ba.gather_result(global_ba.distributed_bundle_adjust(cam, prob, group, lm, pcg), len(ids),
                                       group)
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = global_ba.distributed_bundle_adjust(cam, prob, group)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        rec["repeat_distributed"] = same_bits(res, again)
        res = global_ba.gather_result(res, len(ids), group)
    rec["ms_per_lm_iter"] = rec["ms"] / 10
    rec["collectives_per_lm_iter"] = {n: counts[n] / 10 for n in names} | {"total": sum(counts.values()) / 10}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2**20
    t0 = time.perf_counter()
    schur = local_ba.bundle_adjust(cam, prob)
    torch.cuda.synchronize()
    rec["schur_ms"] = (time.perf_counter() - t0) * 1e3
    rec["schur_peak_memory_mib"] = torch.cuda.max_memory_allocated() / 2**20 - base_mib
    rec["repeat_schur"] = same_bits(schur, local_ba.bundle_adjust(cam, prob))
    # The converged yardstick solves the distributed solve's problem: the
    # Schur's pruning after its first stage changes the problem, and on a
    # map with a few gross outliers its optimum (ROADMAP C7).
    schur_conv = local_ba.bundle_adjust(cam, prob, iters_stage1=s1, iters_stage2=s2, chi2_prune=float("inf"))
    schur_pruned = local_ba.bundle_adjust(cam, prob, iters_stage1=s1, iters_stage2=s2)
    fixed = prob.fixed
    finite = all(bool(torch.isfinite(t).all()) for t in (res.poses, res.points, res.cost, conv.poses, conv.points))
    rec.update({
        "final_cost": cost(res.poses, res.points), "reported_cost": float(res.cost),
        "schur_cost": cost(schur.poses, schur.points), "final_keyframe_ate_m": keyframe_ate(res.poses, ids, loop),
        "schur_keyframe_ate_m": keyframe_ate(schur.poses, ids, loop), "finite": finite,
        "converged": {"distributed_lm_pcg": [lm, pcg], "schur_lm": [s1, s2],
                      "distributed_cost": cost(conv.poses, conv.points),
                      "distributed_keyframe_ate_m": keyframe_ate(conv.poses, ids, loop),
                      "schur_cost": cost(schur_conv.poses, schur_conv.points),
                      "schur_keyframe_ate_m": keyframe_ate(schur_conv.poses, ids, loop),
                      "schur_pruned_cost": cost(schur_pruned.poses, schur_pruned.points),
                      "schur_pruned_keyframe_ate_m": keyframe_ate(schur_pruned.poses, ids, loop)},
        "fixed_bit_equal": bool(torch.equal(res.poses[fixed], prob.poses[fixed])),
        "repeat_max_abs_pose_diff": float((again.poses - res.poses).abs().max()),
        "obs_active_share": float(res.obs_active.float().mean()),
        "dryrun_multichip_1_cost": launch.dryrun_multichip(1),
    })
    bad = []
    if not finite:
        bad.append("non-finite output")
    if not rec["fixed_bit_equal"]:
        bad.append("the fixed keyframe moved")
    if not rec["final_cost"] <= rec["initial_cost"]:
        bad.append(f"cost rose from {rec['initial_cost']} to {rec['final_cost']}")
    if not rec["final_cost"] <= GBA_COST_FACTOR * rec["schur_cost"]:
        bad.append(f"cost {rec['final_cost']} > {GBA_COST_FACTOR}× the Schur solver's {rec['schur_cost']}")
    for k in ("repeat_schur", "repeat_distributed"):
        if not all(rec[k].values()):
            bad.append(f"{k}: two solves of one map differ in {[f for f, eq in rec[k].items() if not eq]}")
    conv_rec = rec["converged"]
    # ROADMAP C4: converged global BA against the map it was given.
    rec["converged_ratio"] = {k: conv_rec[f"{k}_keyframe_ate_m"] / rec["initial_keyframe_ate_m"]
                              for k in ("distributed", "schur", "schur_pruned")}
    if not conv_rec["distributed_cost"] <= GBA_CONVERGED_COST_FACTOR * conv_rec["schur_cost"]:
        bad.append(f"converged cost {conv_rec['distributed_cost']} > {GBA_CONVERGED_COST_FACTOR}× the converged "
                   f"Schur solver's {conv_rec['schur_cost']}")
    if not conv_rec["distributed_keyframe_ate_m"] <= GBA_ATE_FACTOR * conv_rec["schur_keyframe_ate_m"]:
        bad.append(f"converged keyframe ATE {conv_rec['distributed_keyframe_ate_m']} m > {GBA_ATE_FACTOR}× the "
                   f"converged Schur solver's {conv_rec['schur_keyframe_ate_m']} m")
    if bad:
        raise AssertionError("global_ba phase outside its gates: " + "; ".join(bad) + f" — {rec}")
    return rec


def tool(name: str):
    """A module of tools/ (the port's measurement tools), imported by name."""
    import importlib

    if os.path.join(REPO, "tools") not in sys.path:
        sys.path.insert(0, os.path.join(REPO, "tools"))
    return importlib.import_module(name)


def same_bits(a, b) -> dict:
    """Field → whether two BAResults hold equal bits (poses, points,
    obs_active, cost)."""
    import torch

    return {k: bool(torch.equal(getattr(a, k), getattr(b, k))) for k in ("poses", "points", "obs_active", "cost")}


def run_ba_scaling_phase() -> dict:
    """Phase 17: tools/torch_ba_scaling_bench.py at the reference tool's
    defaults on the card's NCCL group of one, its converged cost against the
    same problem solved by the port on the CPU (gloo, world size 1). Raises
    on any gate."""
    import numpy as np
    import torch

    bench = tool("torch_ba_scaling_bench")

    from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu_torch.parallel import global_ba, launch
    from gf_orb_slam_tpu_torch.solvers.local_ba import BAProblem

    args = bench.parse_args([])
    t0 = time.perf_counter()
    out = bench.main([])
    card_s = time.perf_counter() - t0
    row = out["rows"][0]
    arrays = bench.make_problem(args.cams, args.points, args.obs_per_cam)
    prob = BAProblem(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()})
    t0 = time.perf_counter()
    with launch.gloo_group() as group:
        cpu = global_ba.distributed_bundle_adjust(EUROC_CAM, prob, group, n_lm_iters=args.lm_iters,
                                                  n_pcg_iters=args.pcg_iters)
    rec = {"phase": "ba_scaling", "entry": "tools/torch_ba_scaling_bench.py (parallel.global_ba."
           "distributed_bundle_adjust)", "cams": args.cams, "points": args.points, "obs_per_cam": args.obs_per_cam,
           "lm_iters": args.lm_iters, "pcg_iters": args.pcg_iters, "world_size": row["d"],
           "skipped_world_sizes": out["skipped_sizes"], "ms_per_lm_iter": row["ms_per_lm_iter"],
           "device_ms_per_lm_iter": row["device_ms_per_lm_iter"], "peak_mib": row["peak_mib"], "cost": row["cost"],
           "cpu_cost": float(cpu.cost), "card_seconds": card_s, "cpu_seconds": time.perf_counter() - t0,
           "lines": out["lines"]}
    rec["cost_rel_diff"] = abs(rec["cost"] - rec["cpu_cost"]) / abs(rec["cpu_cost"])
    if not (math.isfinite(rec["cost"]) and rec["cost_rel_diff"] <= SCALING_COST_TOL):
        raise AssertionError(f"ba_scaling phase: cost {rec['cost']} on the card against {rec['cpu_cost']} on the CPU "
                             f"(> {SCALING_COST_TOL:.0%} apart) — {rec}")
    return rec


def run_repeat_phase(dev, voc) -> dict:
    """Phase 17b: bench-system's first REPEAT_FRAMES frames twice on the
    card; every per-frame pose and obs_point row and the final map equal
    bit for bit. Raises otherwise."""
    import torch

    from gf_orb_slam_tpu_torch.kernels import hamming

    meta, _ = load_place_fixture("bench")
    cam, ts, _, frames = bench_sequence(dev, meta, REPEAT_FRAMES)
    probe = tool("torch_repeat_probe")
    torch.cuda.synchronize()
    reset_launch_counts()
    runs, seconds = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        runs.append(probe.bench_system_outputs(cam, ts[:REPEAT_FRAMES], frames[:REPEAT_FRAMES], voc, dev))
        seconds.append(time.perf_counter() - t0)
    equal = {k: probe.equal_bits(runs[0][k], runs[1][k]) for k in runs[0]}
    rec = {"phase": "repeat", "entry": "pipeline.system.SlamSystem.process", "frames": REPEAT_FRAMES,
           "seconds": seconds, "equal_bits": equal,
           "tracked_frames": int((~torch.isnan(torch.from_numpy(runs[0]["frame_poses"][:, 0]))).sum()),
           "keyframes": int(runs[0]["map_kf_valid"].sum()),
           "hamming_launches": hamming.LAUNCHES,
           "hamming_launches_by_shape": {f"{nq}x{nt}": n for (nq, nt), n in sorted(hamming.LAUNCHES_BY_SHAPE.items())}}
    if not all(equal.values()) or rec["keyframes"] < 3:
        raise AssertionError(f"repeat phase: two runs of one input differ in {[k for k, eq in equal.items() if not eq]}"
                             f" — {rec}")
    return rec


def global_ba_launches(loop: dict) -> int:
    """Kernel launches of one LM iteration of the global BA (two iterations
    less one), on an NCCL group of one."""
    from gf_orb_slam_tpu_torch.parallel import global_ba, launch

    prob, _, cam = global_ba_problem(loop)
    with launch.nccl_group() as group:
        one = launches_of(lambda: global_ba.distributed_bundle_adjust(cam, prob, group, n_lm_iters=1))
        two = launches_of(lambda: global_ba.distributed_bundle_adjust(cam, prob, group, n_lm_iters=2))
    return two - one


def short(rec: dict) -> dict:
    """A record without its per-frame lists, for error messages."""
    return {k: v for k, v in rec.items() if k != "per_frame_ms"}


if __name__ == "__main__":
    sys.exit(main())
