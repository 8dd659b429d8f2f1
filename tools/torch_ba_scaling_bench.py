#!/usr/bin/env python3
"""Distributed global BA scaling benchmark of the PyTorch port
(tools/ba_scaling_bench.py on torch.distributed).

Times one LM iteration of the keyframe-sharded global BA
(`parallel/global_ba.py::distributed_bundle_adjust`) on a synthetic problem,
at every world size of (1, 2, 4, 8, 16, 32) that divides the cameras and
that the devices allow, and reports the converged cost and the scaling
efficiency.

    python tools/torch_ba_scaling_bench.py                      # the CUDA card(s)
    python tools/torch_ba_scaling_bench.py --fast-gen --cams 1024 --points 262144
    python tools/torch_ba_scaling_bench.py --virtual 4 --cams 8 --points 256 --obs-per-cam 48 --breakdown

Devices. By default the ranks are the machine's CUDA cards: an in-process
NCCL group of one on a one-card machine, else one spawned process per card.
World sizes beyond the card count are named and skipped; no rank is
emulated on a card. `--virtual N` runs N gloo processes on the CPU (one
intra-op thread each) in place of the reference's virtual mesh: they share
the host's cores, so the ideal there is flat time, and the tool reports
the shard overhead against one process instead of an efficiency.

Timing follows the reference's `time_run`: one warm-up call, then 3 timed
calls, each ended by a synchronisation (host clock), reported as ms per LM
iteration. On a card the tool also reports the calls' device time (CUDA
events around each call) and the peak device memory of the timed calls.

`--projection` restates the reference's multi-device η projection for
NVIDIA cards: measured per-shard compute at world size 1, plus the per-LM
collective payload (the reference's formula, which the port's collectives
follow) over an interconnect band, plus the blocking scalar rounds at a
latency measured on this run's group of one (a floor: it holds no wire
time). Every η it prints is projected, not measured.
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

SIZES = (1, 2, 4, 8, 16, 32)
REPS = 3
# Per-GPU, per-direction interconnect bands for the projection. Source: the
# NVIDIA H100 Tensor Core GPU datasheet (H100 SXM5: NVLink 900 GB/s and
# PCIe Gen5 128 GB/s, each the total of both directions).
BANDS = (("PCIe Gen5 x16 64 GB/s (floor)", 64e9), ("NVLink 4 450 GB/s", 450e9))
ETA_LABEL = "projected, not measured"


def make_problem(cams: int, points: int, obs_per_cam: int, fast_gen: bool = False) -> dict:
    """The reference tool's synthetic problem as numpy arrays (BAProblem
    fields), drawn from `np.random.default_rng(0)` in the reference's order
    and projected by the port's geometry on the CPU. Full visibility: each
    camera observes up to `obs_per_cam` of the points it sees, shuffled.
    `fast_gen`: each camera observes `obs_per_cam` points drawn from a
    sliding id window, and only those pairs are projected."""
    import numpy as np
    import torch

    from gf_orb_slam_tpu_torch.geometry import camera, quat, se3

    cam = camera.EUROC_CAM
    rng = np.random.default_rng(0)
    C, P, N = cams, points, obs_per_cam
    pts = rng.uniform([-8, -6, 5.0], [8, 6, 20.0], (P, 3)).astype(np.float32)
    fixed = np.asarray([True, True] + [False] * (C - 2))
    if fast_gen:
        ids = np.empty((C, N), np.int64)
        span = max(P // 4, N * 4)
        for c in range(C):
            lo = int((P - span) * c / max(C - 1, 1))
            ids[c] = rng.choice(span, size=N, replace=False) + lo
        t_all = np.stack([np.asarray([8.0 * c / C - 4.0, 0.2 * np.sin(c), 0.0], np.float32) for c in range(C)])
        w_all = (rng.normal(size=(C, 3)) * 0.02).astype(np.float32)
        pose = se3.make_pose(quat.v2q(torch.from_numpy(w_all)), torch.from_numpy(t_all))          # (C, 7)
        sel = torch.from_numpy(pts)[torch.from_numpy(ids)]                                          # (C, N, 3)
        uv, _, ok = camera.project(cam, se3.transform_point(pose[:, None, :], sel))
        uv_np = uv.numpy() + rng.normal(0, 0.5, (C, N, 2))
        ok_np = ok.numpy()
        return {"poses": pose.numpy(), "points": pts + rng.normal(0, 0.05, pts.shape).astype(np.float32),
                "fixed": fixed, "point_valid": np.ones(P, bool), "obs_uv": uv_np.astype(np.float32),
                "obs_point": np.where(ok_np, ids, -1).astype(np.int32), "obs_w": ok_np.astype(np.float32)}
    poses, obs_uv, obs_pt, obs_w = [], [], [], []
    for c in range(C):
        t = np.asarray([8.0 * c / C - 4.0, 0.2 * np.sin(c), 0.0], np.float32)
        w = (rng.normal(size=3) * 0.02).astype(np.float32)
        pose = se3.make_pose(quat.v2q(torch.from_numpy(w)), torch.from_numpy(t))
        uv, _, ok = camera.project(cam, se3.transform_point(pose, torch.from_numpy(pts)))
        vis = np.nonzero(ok.numpy())[0]
        rng.shuffle(vis)
        sel = vis[:N]
        row_uv = np.zeros((N, 2), np.float32)
        row_pt = np.full(N, -1, np.int32)
        row_w = np.zeros(N, np.float32)
        row_uv[: len(sel)] = uv.numpy()[sel] + rng.normal(0, 0.5, (len(sel), 2))
        row_pt[: len(sel)] = sel
        row_w[: len(sel)] = 1.0
        poses.append(pose.numpy())
        obs_uv.append(row_uv)
        obs_pt.append(row_pt)
        obs_w.append(row_w)
    return {"poses": np.stack(poses), "points": pts + rng.normal(0, 0.05, pts.shape).astype(np.float32),
            "fixed": fixed, "point_valid": np.ones(P, bool), "obs_uv": np.stack(obs_uv),
            "obs_point": np.stack(obs_pt), "obs_w": np.stack(obs_w)}


def shard_problem(arrays: dict, d: int, points_too: bool) -> dict:
    """One shard's own workload at world size 1: the first C/d cameras with
    the whole point table, or (`points_too`, the projection's model) also
    only the first P/d point slots of the padded table."""
    import numpy as np

    C, P = arrays["poses"].shape[0], arrays["points"].shape[0]
    out = {k: arrays[k][: C // d] for k in ("poses", "fixed", "obs_uv", "obs_point", "obs_w")}
    out.update(points=arrays["points"], point_valid=arrays["point_valid"])
    if points_too:
        keep = (P + (-P) % d) // d
        out.update(points=arrays["points"][:keep], point_valid=arrays["point_valid"][:keep],
                   obs_point=np.where(out["obs_point"] < keep, out["obs_point"], -1).astype(np.int32))
    return out


def payload_bytes(P: int, d: int, n_pcg: int) -> float:
    """Bytes each of d ranks moves per LM iteration in ring reduce-scatter /
    all-gather (each moves (d−1)/d of the array): V (P, 3, 3) and g_p (P, 3)
    reduce-scattered once, the (P, 3) V⁻¹ application all-gathered n_pcg + 2
    times (RHS, each CG iteration, back-substitution) and the (P, 3)
    accumulation reduce-scattered n_pcg + 1 times, on P padded to d."""
    P_pad = P + (-P) % d
    return (d - 1) / d * 4.0 * (P_pad * 9 + P_pad * 3 + (n_pcg + 2) * P_pad * 3 + (n_pcg + 1) * P_pad * 3)


class _Timer:
    """The reference's `time_run` on this rank's device: one warm-up call,
    then REPS calls, each ended by a synchronisation."""

    def __init__(self, dev, lm_iters: int, pcg_iters: int):
        self.dev, self.lm, self.pcg = dev, lm_iters, pcg_iters

    def _sync(self):
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def problem(self, arrays: dict):
        import numpy as np
        import torch

        from gf_orb_slam_tpu_torch.solvers.local_ba import BAProblem

        return BAProblem(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(self.dev) for k, v in arrays.items()})

    def run(self, prob, group) -> dict:
        """{ms, device_ms, peak_mib (per LM iteration / of the timed calls), cost, out}."""
        import torch

        from gf_orb_slam_tpu_torch.geometry.camera import EUROC_CAM
        from gf_orb_slam_tpu_torch.parallel import global_ba

        def call():
            return global_ba.distributed_bundle_adjust(EUROC_CAM, prob, group, n_lm_iters=self.lm,
                                                       n_pcg_iters=self.pcg)

        out = call()
        self._sync()
        card = self.dev.type == "cuda"
        if card:
            torch.cuda.reset_peak_memory_stats(self.dev)
            base = torch.cuda.memory_allocated(self.dev)
            events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                      for _ in range(REPS)]
        t0 = time.perf_counter()
        for i in range(REPS):
            if card:
                events[i][0].record()
            out = call()
            if card:
                events[i][1].record()
            self._sync()
        rec = {"ms": (time.perf_counter() - t0) / REPS / self.lm * 1e3, "device_ms": None, "peak_mib": None,
               "cost": float(out.cost), "out": out}
        if card:
            rec["device_ms"] = sum(a.elapsed_time(b) for a, b in events) / REPS / self.lm
            rec["peak_mib"] = (torch.cuda.max_memory_allocated(self.dev) - base) / 2**20
        return rec

    def scalar_round_s(self, group, n: int = 50) -> float:
        """Seconds of one blocking scalar all_reduce on `group` (a group of
        one: the launch and its wait, no wire)."""
        import torch
        import torch.distributed as dist

        x = torch.zeros((), device=self.dev)
        dist.all_reduce(x, group=group)
        self._sync()
        t0 = time.perf_counter()
        for _ in range(n):
            dist.all_reduce(x, group=group)
            self._sync()
        return (time.perf_counter() - t0) / n


def bench_rank(arrays: dict, opts: dict, sizes: list) -> dict:
    """The benchmark on one rank of the default group (its card under
    NCCL, else the CPU); rank 0 prints and returns the lines and rows. Every
    rank creates every subgroup, and ranks outside a world size wait."""
    import torch.distributed as dist

    from gf_orb_slam_tpu_torch.parallel import launch

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = launch.local_device()
    timer = _Timer(dev, opts["lm_iters"], opts["pcg_iters"])
    C, P = arrays["poses"].shape[0], arrays["points"].shape[0]
    N = arrays["obs_point"].shape[1]
    groups = {d: (dist.group.WORLD if d == world else dist.new_group(list(range(d))))
              for d in sorted({1, *sizes})}
    prob = timer.problem(arrays)
    lines, rows = [], []

    def say(line: str):  # rank 0 only
        print(line, flush=True)
        lines.append(line)

    def timed(problem, d):
        """Timed on the ranks of world size d (None elsewhere); every rank waits."""
        rec = timer.run(problem, groups[d]) if rank < d else None
        dist.barrier()
        return rec

    if opts["projection"]:
        npcg = opts["pcg_iters"]
        full = timed(prob, 1)
        lat_s = timer.scalar_round_s(groups[1]) if rank == 0 else 0.0
        dist.barrier()
        lat_rounds = 2 * npcg + 3  # blocking scalar all_reduce rounds per LM iteration
        if rank == 0:
            t1 = full["ms"]
            say(f"reference d=1 full problem: {t1:.2f} ms/LM-iter (cost {full['cost']:.1f})")
            say(f"scalar round (group of one, measured; a floor): {lat_s * 1e6:.2f} us × {lat_rounds} "
                f"per LM iter; every η below is {ETA_LABEL}")
            say("d | shard ms (meas) | payload MB/dev | "
                + " | ".join(f"η {n.split(' ', 2)[0]} {n.split(' ', 2)[1]} ({ETA_LABEL})" for n, _ in BANDS)
                + " | virt-mesh ovh ms (meas)")
        for d in [x for x in (2, 4, 8) if C % x == 0]:
            shard = timed(timer.problem(shard_problem(arrays, d, points_too=True)), 1)
            virt = None
            if not opts["no_virt"] and d <= world:
                virt = timed(prob, d)
            if rank:
                continue
            bytes_dev = payload_bytes(P, d, npcg)
            etas = [t1 / (d * (shard["ms"] + bytes_dev / bw * 1e3 + lat_rounds * lat_s * 1e3)) for _, bw in BANDS]
            ovh = None if virt is None else virt["ms"] - t1
            rows.append({"d": d, "t_shard_ms": shard["ms"], "payload_MB_dev": bytes_dev / 1e6, "eta": etas,
                         "virt_overhead_ms": ovh})
            ovh_str = ("   (skipped)" if opts["no_virt"] else f"   (skipped: {world} devices)") if ovh is None \
                else f"{ovh:+8.2f}"
            say(f"{d} | {shard['ms']:9.2f} | {bytes_dev / 1e6:10.2f} | "
                + " | ".join(f"{e:5.1%}" for e in etas) + f" | {ovh_str}")
        if rank == 0:
            say(json.dumps({
                "C": C, "P": P, "obs_per_cam": N, "pcg_iters": npcg, "t1_ms": t1, "latency_rounds": lat_rounds,
                "latency_s": lat_s, "latency_source": "measured: scalar all_reduce on a group of one",
                "bands": [[n, bw] for n, bw in BANDS], "eta_label": ETA_LABEL,
                "rows": rows}))
        return {"lines": lines, "rows": rows}

    first = None
    for d in sizes:
        rec = timed(prob, d)
        compute = None
        if opts["breakdown"] and d > 1:
            compute = timed(timer.problem(shard_problem(arrays, d, points_too=False)), 1)
        if rank:
            continue
        first = first or (d, rec["ms"])
        dt = rec["ms"]
        row = {"d": d, "ms_per_lm_iter": dt, "device_ms_per_lm_iter": rec["device_ms"], "peak_mib": rec["peak_mib"],
               "cost": rec["cost"]}
        if compute is not None:
            row["compute_only_ms"] = compute["ms"]
            say(f"devices={d:3d}  per-shard compute-only={compute['ms']:8.2f} ms/LM-iter  "
                f"collective+partition={dt - compute['ms']:8.2f} ms ({(dt - compute['ms']) / dt:5.1%})")
        if opts["virtual"]:
            row["shard_overhead"] = dt / first[1] - 1.0
            say(f"devices={d:3d}  ms/LM-iter={dt:8.2f}  cost={rec['cost']:10.1f}  "
                f"shard-overhead={row['shard_overhead']:+6.1%} (virtual mesh: shared compute)")
        else:
            row["scaling_eff"] = first[1] * first[0] / (dt * d) if d > first[0] else 1.0
            say(f"devices={d:3d}  ms/LM-iter={dt:8.2f}  cost={rec['cost']:10.1f}  "
                f"scaling-eff={row['scaling_eff']:5.2f}  device-ms/LM-iter={rec['device_ms']:8.2f}  "
                f"peak-MiB={rec['peak_mib']:9.1f}")
        rows.append(row)
    return {"lines": lines, "rows": rows}


def _nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--virtual", type=int, default=0,
                    help="run N gloo processes on the CPU (0 = the CUDA cards)")
    ap.add_argument("--cams", type=int, default=64)
    ap.add_argument("--points", type=int, default=4096)
    ap.add_argument("--obs-per-cam", type=int, default=512)
    ap.add_argument("--lm-iters", type=int, default=6)
    ap.add_argument("--pcg-iters", type=int, default=20)
    ap.add_argument("--breakdown", action="store_true",
                    help="also time each shard's own workload at world size 1 (every collective over one "
                         "rank) to split compute from collective cost; applies where the world size is > 1")
    ap.add_argument("--projection", action="store_true",
                    help="η projection for NVIDIA cards: measured per-shard compute at world size 1 + the "
                         "analytic collective payload over NVLink / PCIe bands + the blocking scalar rounds")
    ap.add_argument("--fast-gen", action="store_true",
                    help="observations from sampled point-id windows per camera instead of full-visibility "
                         "projection (C·N pairs projected, not C·P): for maps of long sequences")
    ap.add_argument("--no-virt", action="store_true",
                    help="skip the projection's measured full-problem overhead column at each d")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the benchmark; returns {"device", "lines", "rows", "skipped_sizes"}."""
    import torch

    from gf_orb_slam_tpu_torch.parallel import launch

    args = parse_args(argv)
    opts = {k: getattr(args, k) for k in ("lm_iters", "pcg_iters", "breakdown", "projection", "no_virt", "virtual")}
    if args.virtual:
        n_dev, backend, device = args.virtual, "gloo", f"cpu ({args.virtual} gloo processes, 1 thread each)"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: pass --virtual N to run N gloo processes on the CPU")
        n_dev, backend = torch.cuda.device_count(), "nccl"
        device = f"{torch.cuda.get_device_name(0)} ×{n_dev}, nvidia-smi: {_nvidia_smi()}"
    print(f"device: {device}", flush=True)
    arrays = make_problem(args.cams, args.points, args.obs_per_cam, args.fast_gen)
    print(f"problem: {args.cams} cameras, {args.points} points, {args.obs_per_cam} observation slots per camera, "
          f"{int((arrays['obs_point'] >= 0).sum())} observations{' (fast-gen)' if args.fast_gen else ''}",
          flush=True)
    dividing = [d for d in SIZES if args.cams % d == 0]
    sizes = [d for d in dividing if d <= n_dev]
    skipped = [d for d in dividing if d > n_dev]
    if skipped and not args.projection:
        print(f"world sizes {', '.join(map(str, skipped))} divide {args.cams} cameras but exceed the {n_dev} "
              f"device(s) here: not run" + ("" if args.virtual else " (scaling across cards not measured)"),
              flush=True)
    if n_dev == 1:
        group = launch.nccl_group() if backend == "nccl" else launch.gloo_group()
        with group:
            out = bench_rank(arrays, opts, sizes)
    else:
        out = launch.spawn_group(bench_rank, n_dev, arrays, opts, sizes, backend=backend)[0]
    return {"device": device, "skipped_sizes": skipped, **out}


if __name__ == "__main__":
    main()
