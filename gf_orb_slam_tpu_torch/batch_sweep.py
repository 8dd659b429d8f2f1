"""GF-budget sweep (port of the repository's batch_sweep.py, the reference's
batch_script/Run_EuRoC.py): budgets × rounds × sequences through the port's
command line, `sweep_summary.json` and a console table of ATE against
tracking time.

    python -m gf_orb_slam_tpu_torch.batch_sweep --data-root /data/EuRoC --budgets 0 60 100 200 --rounds 2
    python -m gf_orb_slam_tpu_torch.batch_sweep --synthetic 100 --budgets 0 100 200
    python -m gf_orb_slam_tpu_torch.batch_sweep --synthetic 30 --budgets 0 100 --device cpu

Each run writes results/<seq>_gf<budget>_r<round>_* (run_slam's outputs).
Rounds vary both the sampling seed and the synthetic scene's texture seed.
Runs are on the first CUDA card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from gf_orb_slam_tpu_torch import run_slam


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", help="directory containing sequence folders")
    ap.add_argument("--sequences", nargs="*", default=None)
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--budgets", nargs="*", type=int, default=[0, 60, 100, 160])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out-dir", default="results")
    ap.add_argument("--device", default="cuda", help='"cuda" (default: fails without a card) or "cpu"')
    ap.add_argument("--scene", choices=["planes", "room"], default="planes")
    ap.add_argument("--gf-mode", default="subset")
    # Per-stage device times once per {sequence × budget} cell (round 0), as
    # the reference fills its time log's stage fields on every run.
    ap.add_argument("--probe-stages", dest="probe_stages", action="store_true", default=True,
                    help="per-cell device stage attribution (default on)")
    ap.add_argument("--no-probe-stages", dest="probe_stages", action="store_false")
    return ap.parse_args(argv)


def aggregate(summary: list[dict]) -> list[dict]:
    """Per {sequence × budget} cell over its rounds: mean and sample
    standard deviation of the ATE, and the median of the rounds' median
    frame times (Run_EuRoC.py's 10-round protocol reports the mean)."""
    cells: dict = {}
    for row in summary:
        cells.setdefault((row["seq"], row["budget"]), []).append(row)
    out = []
    for (seq_name, budget), rows in sorted(cells.items()):
        rmses = [r["ate_rmse_m"] for r in rows if r.get("ate_rmse_m") is not None]
        tots = [r.get("timing", {}).get("total", {}).get("median_ms", 0.0) for r in rows]
        mean = sum(rmses) / len(rmses) if rmses else float("nan")
        std = (sum((x - mean) ** 2 for x in rmses) / max(len(rmses) - 1, 1)) ** 0.5 if len(rmses) > 1 else 0.0
        out.append({
            "seq": seq_name, "budget": budget, "rounds": len(rows), "completed": len(rmses),
            "ate_rmse_mean_m": mean, "ate_rmse_std_m": std, "ate_rmse_all_m": rmses,
            "track_median_ms": sorted(tots)[len(tots) // 2] if tots else 0.0,
        })
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.synthetic:
        seqs = [("synthetic", None)]
    else:
        names = args.sequences or sorted(os.listdir(args.data_root))
        seqs = [(n, os.path.join(args.data_root, n)) for n in names]

    summary = []
    for name, path in seqs:
        for budget in args.budgets:
            for rnd in range(args.rounds):
                prefix = os.path.join(args.out_dir, f"{name}_gf{budget}_r{rnd}")
                argv_run = ["--out", prefix, "--gf-budget", str(budget), "--gf-mode", args.gf_mode,
                            "--seed", str(rnd), "--scene-seed", str(rnd), "--device", args.device]
                if args.probe_stages and rnd == 0:
                    argv_run.append("--probe-stages")
                if path is None:
                    argv_run += ["--synthetic", str(args.synthetic), "--scene", args.scene]
                else:
                    argv_run += ["--seq", path]
                print(f"=== {name} budget={budget} round={rnd} ===", file=sys.stderr)
                run_slam.main(argv_run)
                with open(prefix + "_result.json") as f:
                    res = json.load(f)
                summary.append({"seq": name, "budget": budget, "round": rnd, **res})

    cells = aggregate(summary)
    with open(os.path.join(args.out_dir, "sweep_summary.json"), "w") as f:
        json.dump({"runs": summary, "cells": cells}, f, indent=2)
    print(f"{'seq':>12} {'budget':>7} {'rmse_cm':>12} {'track_ms':>9} {'rounds':>7}")
    for c in cells:
        print(f"{c['seq']:>12} {c['budget']:>7} "
              f"{c['ate_rmse_mean_m'] * 100:>7.2f}±{c['ate_rmse_std_m'] * 100:<4.2f}"
              f" {c['track_median_ms']:>9.1f} {c['completed']:>3}/{c['rounds']}")
    return {"runs": summary, "cells": cells}


if __name__ == "__main__":
    main()
