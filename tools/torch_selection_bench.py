#!/usr/bin/env python3
"""Max-logDet selection micro-benchmark of the PyTorch port over pool sizes
(tools/selection_bench.py on the port; the C++ reference's simu_greedy.cc).

    python tools/torch_selection_bench.py [--pools 200 500 1000 2000] [--k 100] [--reps 5] [--device cuda]

Per pool size n: n points at uniform pixels (40 px from the border) and
depths 3–15 m in front of the EuRoC camera at the identity pose (seed 0),
their 7×7 information blocks (`observability.measurement_jacobians`,
`whiten`, `info_matrices`), and k = min(--k, n/2) picks by the exact greedy
(`selection.greedy_maxlogdet`), the lazier greedy and the grouped lazier
greedy (4 shards), each with Gumbel noise drawn from a generator seeded
per rep (the reference draws its own from a PRNG key per rep, so the two
tools' lazier picks differ; the exact greedy's are held equal). Prints (pool, method, ms per selection, logdet gap to the exact
greedy's); ms is host time between synchronisations, the mean of --reps
calls after one warm-up. Runs on the first CUDA card unless --device cpu.
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


def pool_blocks(n: int, rng, dev):
    """(blocks (n, 7, 7), visible (n,)) of n random points, as the reference tool draws them."""
    import numpy as np
    import torch

    from gf_orb_slam_tpu_torch.geometry import camera
    from gf_orb_slam_tpu_torch.gf import observability

    cam = camera.EUROC_CAM
    uv = rng.uniform([40, 40], [cam.width - 40, cam.height - 40], (n, 2))
    z = rng.uniform(3, 15, n)
    xc = camera.backproject(cam, torch.as_tensor(uv, dtype=torch.float32), torch.as_tensor(z, dtype=torch.float32))
    Xv = torch.zeros(13)
    Xv[3] = 1.0
    jac = observability.measurement_jacobians(cam, Xv.to(dev), xc.to(dev))
    blocks = observability.info_matrices(observability.whiten(jac.H, torch.ones(n, device=dev)), jac.visible)
    return blocks, jac.visible, np.asarray(xc)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pools", nargs="*", type=int, default=[200, 500, 1000, 2000])
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from gf_orb_slam_tpu_torch.gf import selection
    from gf_orb_slam_tpu_torch.pipeline.system import resolve_device

    dev = resolve_device(args.device)
    header = {"torch": torch.__version__, "device": str(dev)}
    if dev.type == "cuda":
        header["nvidia_smi"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                              capture_output=True, text=True).stdout.strip()
    print(json.dumps(header), flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    rng = np.random.default_rng(0)
    rows = []
    print(f"{'pool':>6} {'method':>16} {'ms':>9} {'logdet_gap':>11}")
    for n in args.pools:
        blocks, visible, _ = pool_blocks(n, rng, dev)
        k = min(args.k, n // 2)
        exact = selection.greedy_maxlogdet(blocks, visible, k=k)

        _, rounds, _ = selection.lazier_sizes(n, k)
        pad = (-n) % 4
        _, g_rounds, _ = selection.lazier_sizes((n + pad) // 4, -(-k // 4))

        def noise(r, rounds, m, shards=()):
            g = torch.Generator(device=dev).manual_seed(r)
            return selection.sample_gumbel(int(np.prod(shards or (1,))) * rounds, m, g).reshape(*shards, rounds, m)

        methods = {
            "greedy_exact": lambda r: selection.greedy_maxlogdet(blocks, visible, k=k),
            "lazier_greedy": lambda r: selection.lazier_greedy_maxlogdet(blocks, visible, k, noise(r, rounds, n)),
            "grouped_lazier": lambda r: selection.grouped_lazier_greedy(
                blocks, visible, k, noise(r, g_rounds, (n + pad) // 4, (4,)), n_shards=4),
        }
        for name, fn in methods.items():
            fn(0)
            sync()
            t0 = time.perf_counter()
            lds = [fn(r).logdet for r in range(args.reps)]
            sync()
            ms_ = (time.perf_counter() - t0) / args.reps * 1e3
            gap = float(exact.logdet) - float(np.mean([float(x) for x in lds]))
            rows.append({"pool": n, "k": k, "method": name, "ms": ms_, "logdet_gap": gap})
            print(f"{n:>6} {name:>16} {ms_:>9.2f} {gap:>11.3f}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**header, "rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
