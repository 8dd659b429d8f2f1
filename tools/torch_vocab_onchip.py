#!/usr/bin/env python3
"""Device cost of the 1M-word vocabulary on the loop-closing path of the
PyTorch port (tools/vocab_onchip.py on the port).

    python tools/torch_vocab_onchip.py [--kfs 256] [--n-kps 1600] [--reps 5] [--device cuda] [--out PATH]

A full BoW database of --kfs keyframes of --n-kps random descriptors each
(the cost of each program is set by the shapes, (K, N) and the vocabulary's
10^6 words, not by the values), and a map whose keyframes observe random
points (30% of their keypoints). Times, as the median of --reps calls
between synchronisations after one warm-up call (host clock, so each
number includes the host's launch work):

  quantize             the 1,600 descriptors' descent through k 10, L 6
  quantize+register    quantize, the tf-idf row and its database write (`add_keyframe`)
  detect @ K full      the query's dense vector, Σ min(q, d) over the K sparse rows,
                       group scoring and top-k (`detect_loop_candidates`)
  register_and_detect  the per-insertion call (`register_and_detect`), with the
                       covisibility matrix it builds

Runs on the first CUDA card unless --device cpu.
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kfs", type=int, default=256)
    ap.add_argument("--n-kps", type=int, default=1600)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--vocabulary", default="", help="a vocabulary file instead of the packaged one")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from gf_orb_slam_tpu_torch.mapping import map_state as ms
    from gf_orb_slam_tpu_torch.pipeline.system import resolve_device
    from gf_orb_slam_tpu_torch.retrieval import keyframe_db as kdb
    from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod

    dev = resolve_device(args.device)
    header = {"torch": torch.__version__, "device": str(dev)}
    if dev.type == "cuda":
        header["nvidia_smi"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                              capture_output=True, text=True).stdout.strip()
    voc = voc_mod.load_vocabulary(args.vocabulary, dev) if args.vocabulary else voc_mod.load_default_vocabulary(dev)
    K, N = args.kfs, args.n_kps
    rng = np.random.default_rng(0)
    descs = torch.from_numpy(rng.integers(0, 2**32, (K, N, 8), dtype=np.uint32).view(np.int32)).to(dev)
    valid = torch.ones((K, N), dtype=torch.bool, device=dev)
    db = kdb.empty_db(K, N, voc.n_words, device=dev)
    for k in range(K):
        db = kdb.add_keyframe(db, voc, k, descs[k], valid[k])
    m = ms.empty_map(max_keyframes=K, max_points=16384, max_kps=N, device=dev)
    obs = torch.where(torch.from_numpy(rng.random((K, N)) < 0.3).to(dev),
                      torch.from_numpy(rng.integers(0, 16384, (K, N)).astype(np.int32)).to(dev), ms.NO_POINT)
    m = m._replace(kf_valid=torch.ones(K, dtype=torch.bool, device=dev), kf_obs_point=obs, kf_kp_desc=descs,
                   kf_kp_valid=valid, pt_valid=torch.ones(16384, dtype=torch.bool, device=dev))
    covis = ms.covisibility(m)
    last = torch.full((1,), K - 1, dtype=torch.int64, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed(fn) -> float:
        fn()
        sync()
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn()
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    results = {
        "quantize (N=1600)": timed(lambda: voc_mod.quantize(voc, descs[0], valid[0])),
        "quantize+register row": timed(lambda: kdb.add_keyframe(db, voc, 0, descs[0], valid[0])),
        "detect @ K full": timed(lambda: kdb.detect_loop_candidates(db, covis, last, max_candidates=6,
                                                                    n_words=voc.n_words)),
        "register_and_detect": timed(lambda: kdb.register_and_detect(db, voc, m, last, -1, max_candidates=6)),
    }
    for name, v in results.items():
        print(f"{name:>24} {v:9.2f} ms", flush=True)
    payload = {**header, "K": K, "N": N, "n_words": int(voc.n_words), "reps": args.reps, "programs_ms": results,
               "note": "median host ms between synchronisations after one warm-up call"}
    print(json.dumps(payload))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)
    return payload


if __name__ == "__main__":
    main()
