#!/usr/bin/env python
"""Write the GF-modes fixture that the PyTorch port's SLAM loop is held
against in every Good-Feature selection mode other than the shipped
`subset`: runs of the JAX reference's synchronous `SlamSystem` on the CPU,
on frames rounded to uint8, in bench.py's sequence and configuration
(synthetic planes scene seed 0, 752×480 camera, 800 features, GF budget 100,
batch 10, warm-up 10 frames, keyframe cadence 10, place recognition on with
the packaged 1M-word vocabulary preset, seed 0) with `gf_mode` changed:

* `active` and `hybrid` over all 240 frames (the two non-subset modes the
  reference measured statistically, docs/RESULTS.md);
* `lazier`, `auto`, `random` and `longlive` over the first 120 frames.

Each mode is also run under three perturbations of the kind a second
implementation of the same arithmetic brings with it, and their summaries
are kept as the mode's spread: seed 1 (other RANSAC samples and, in lazier,
auto and random, other draws); the selection's 1e-5 prior scaled by
1 + 1e-3; and a 1e-7·I jitter inside every logdet the lazier, auto and
active selections rank by (both below the float32 round-off of the
information matrices they touch; a mode that does not use the quantity runs
unchanged).

    python tools/make_torch_gf_modes_fixture.py                   # every mode
    python tools/make_torch_gf_modes_fixture.py --modes hybrid,auto

Output: gf_orb_slam_tpu_torch/data/gf_modes_fixture.npz (no frames). For each
mode `<mode>_*`, as tools/make_torch_place_fixture.py records a run: `meta`
(JSON: camera, configuration, frame count, the run's summary with first
WORKING frame, tracked, keyframes inserted, loops closed, ATE, CPU seconds),
per-frame `state`, `pose` and `n_inliers`, `insert_frames`, `loops` and
`reloc_frames`; and `spread` (JSON: each perturbation's name and summary).
Modes not asked for keep their earlier record.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from make_torch_place_fixture import REPO, bench_setup, run, voc_mod  # also pins JAX to the CPU

import jax  # noqa: E402
import numpy as np  # noqa: E402

from gf_orb_slam_tpu.geometry import linalg  # noqa: E402
from gf_orb_slam_tpu.gf import active_matching, selection  # noqa: E402

OUT = os.path.join(REPO, "gf_orb_slam_tpu_torch", "data", "gf_modes_fixture.npz")
FRAMES = {"active": 240, "hybrid": 240, "lazier": 120, "auto": 120, "random": 120, "longlive": 120}
PRIOR_SCALE = 1.0 + 1e-3
LOGDET_JITTER = 1e-7
PERTURBATIONS = {"seed 1": {"seed": 1}, f"prior x {PRIOR_SCALE}": {"prior_scale": PRIOR_SCALE},
                 f"logdet jitter {LOGDET_JITTER}": {"logdet_jitter": LOGDET_JITTER}}


def run_mode(mode: str, voc, seed: int = 0, prior_scale: float = 1.0, logdet_jitter: float = 0.0) -> dict:
    """One reference run of `mode`, its selection prior scaled by
    prior_scale and logdet_jitter added inside the selections' logdets
    (both read when the selection functions are traced, so the caches go)."""
    eps, logdet_psd = selection.PRIOR_EPS, linalg.logdet_psd
    selection.PRIOR_EPS = active_matching.PRIOR_EPS = eps * prior_scale
    if logdet_jitter:
        linalg.logdet_psd = lambda M, jitter=0.0: logdet_psd(M, jitter=jitter + logdet_jitter)
    jax.clear_caches()
    try:
        cam, cfg, scene, render, ts, poses_gt = bench_setup()
        cfg = dataclasses.replace(cfg, gf_mode=mode)
        return run(mode, cam, cfg, scene, render, ts, poses_gt, FRAMES[mode], voc, seed=seed)
    finally:
        selection.PRIOR_EPS = active_matching.PRIOR_EPS = eps
        linalg.logdet_psd = logdet_psd
        jax.clear_caches()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default=",".join(FRAMES))
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()

    voc = voc_mod.load_binary(os.path.join(REPO, "gf_orb_slam_tpu", "data", "vocab_1m.npz"))
    arrays = {}
    if os.path.exists(args.out):
        with np.load(args.out) as z:
            arrays = {k: z[k] for k in z.files}
    for mode in args.modes.split(","):
        if mode not in FRAMES:
            raise SystemExit(f"unknown mode {mode!r}; one of {sorted(FRAMES)}")
        arrays.update(run_mode(mode, voc))
        spread = []
        for name, kw in PERTURBATIONS.items():
            meta = json.loads(str(run_mode(mode, voc, **kw)[f"{mode}_meta"]))
            spread.append({"perturbation": name, "summary": meta["summary"]})
        arrays[f"{mode}_spread"] = np.asarray(json.dumps(spread))
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        np.savez_compressed(args.out, **arrays)
    print(json.dumps({"out": args.out, "bytes": os.path.getsize(args.out)}))


if __name__ == "__main__":
    main()
