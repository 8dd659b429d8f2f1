"""Run one cell of the benchmark once and print its result line.

    python3 slam_bench/run.py --workload planes-gf100-rounds --seed 7 --seconds 51 --trace 0

The cell (BENCHMARK.json's `workloads`) names a configuration
(slam_bench/configs/), a traffic mix (slam_bench/traffic/<name>.json) and
its limits (slam_bench/limits/<workload>.json); every metric is a reader
(slam_bench/metrics/<name>.py). One SLAM session (slam_bench/session.py)
replays the traffic's pass from a restored state until `--seconds` end.
`--seed` draws the frames' sensor noise. The plain reference
(slam_bench/reference.py) then judges every frame of the window and the
sampled calls. The last stdout line is the result JSON; the numbers
compared, each beside its limit, are the last lines on stderr. Exits
non-zero with no result line without enough CUDA cards, when the run loaded
JAX or the JAX package, or on any failure.

`--prepare module:function` runs a hook before the system is built: the
control and the planted faults of slam_bench/controls.py, which `correct`
must refuse. The benchmark's own runs take none.
"""

from __future__ import annotations

import time

T_START = time.monotonic()  # set-up is counted from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from slam_bench import reference, scenes, session, trace  # noqa: E402

# Calls of the window whose inputs and outputs the session keeps for the
# reference: (how many, drawn from the window's first how many calls).
SAMPLES = {"hamming": (6, 120), "match": (4, 60), "ba": (4, 6)}
TRACE_FROM, TRACE_SECONDS = 0.5, 6.0      # the profiler's stretch: from half the window, for 6 s at most


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str) -> dict:
    """The workload's entry, configuration, traffic, limits and metrics."""
    bench = load_json(ROOT / "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])

    def applies(m):
        return workload in m.get("workloads", [workload])

    return {
        "workload": wl,
        "config": load_json(ROOT / cfg_entry["file"]),
        "traffic": load_json(BENCH / "traffic" / f"{wl['traffic']}.json"),
        "limits": load_json(BENCH / "limits" / f"{workload}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def reader(name: str):
    """The `read` function of slam_bench/metrics/<name>.py."""
    spec = importlib.util.spec_from_file_location(f"slam_bench_metric_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed directory inside the checkout;
    one intra-op thread."""
    cache = BENCH / ".cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda"), ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        # made here: torch makes no parents, and disables its kernel cache where the directory is missing
        (cache / sub).mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(cache / sub)
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"


def _host_state(s: dict):
    """ns → what the host was doing: the kind of the frame in flight, or
    "between" (a restore, the loop)."""
    fr = [f for f in s["records"] if f["phase"] == "traced"]
    st, en = np.array([f["wall_start_ns"] for f in fr]), np.array([f["wall_end_ns"] for f in fr])

    def name(ns: int) -> str:
        j = int(np.searchsorted(st, ns, side="right")) - 1
        return fr[j]["kind"] if j >= 0 and ns < en[j] else "between"

    return name


def _trace_figures(s: dict) -> dict | None:
    """The traced stretch: its device events and the seconds they span, and
    the frames and seconds the host traced."""
    fr = [f for f in s["records"] if f["phase"] == "traced"]
    if not s.get("trace") or not fr or s["trace"]["kernels"] is None:
        return None
    st, en, _, _ = s["trace"]["kernels"]
    return {"events": int(len(st)), "events_span_s": float((en.max() - st.min()) / 1e9) if len(st) else 0.0,
            "frames": len(fr), "frames_span_s": (fr[-1]["wall_end_ns"] - fr[0]["wall_start_ns"]) / 1e9,
            "first_event_after_s": float((st.min() - fr[0]["wall_start_ns"]) / 1e9) if len(st) else None,
            "profiler_start_s": s["trace"]["start_s"]}


def analyse(spec: dict, seconds: float, trace_on: bool, s: dict) -> dict:
    """Metrics, judgement and the session's figures of one run."""
    for f in s["records"]:
        f["in_window"] = f["pass"] >= 0 and f["t_end"] <= seconds
        f["ms"] = 1e3 * (f["t_end"] - f["t_start"])
    frames = [f for f in s["records"] if f["in_window"]]
    base = {f["index"]: f["pose"] for f in s["records"] if f["pass"] == -1}
    rep = [f for f in s["records"] if f["pass"] >= 0]
    differ = sum(1 for f in rep if (f["pose"] is None) != (base.get(f["index"]) is None)
                 or (f["pose"] is not None and not np.array_equal(f["pose"], base[f["index"]])))
    figures = {
        "setup_s": s["setup_s"], "frames": len(frames), "passes": len({f["pass"] for f in frames}),
        "restore_ms": [round(x, 3) for x in s["restore_ms"]],
        "frames_per_5s": np.bincount([int(f["t_end"] // 5) for f in frames],
                                     minlength=int(np.ceil(seconds / 5))).tolist(),
        "passes_repeat": differ == 0, "frames_differing": differ, "frames_compared": len(rep),
        "kinds": {k: sum(1 for f in frames if f["kind"] == k) for k in ("tracked", "insert", "lost")},
        "memory_peak_bytes": s["memory_peak_bytes"], "memory_allocated_peak_bytes": s["memory_allocated_peak_bytes"],
        "calls": s["calls"], "checked": {k: len(v) for k, v in s["samples"].items()},
        "matmul_rel_err": s["matmul_rel_err"],
        "trace": _trace_figures(s),
    }
    run = {"frames": frames, "session": s, "seconds": seconds, "setup_s": s["setup_s"], "trace": None}
    device = {"platform": "gpu", "kind": s["device_name"], "count": spec["workload"]["chips"],
              "memory_peak_bytes": int(s["memory_peak_bytes"])}
    breakdown = None
    kernels = (s.get("trace") or {}).get("kernels")
    if trace_on and kernels is not None and len(kernels[0]):
        window = (int(kernels[0].min()), int(kernels[1].max()))
        busy = trace.busy_ns(kernels, window)
        run["trace"] = {"window_s": (window[1] - window[0]) / 1e9, "busy_s": busy / 1e9}
        device.update(busy_s=busy / 1e9, window_s=(window[1] - window[0]) / 1e9)
        breakdown = {"device_ops": trace.device_ops(kernels, window),
                     "idle_gaps": trace.idle_gaps(kernels, window, _host_state(s))}
    metrics = {}
    for m in (spec["per_layer"] if trace_on else spec["end_to_end"]):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    # The reference runs once the window has closed, the peak has been read
    # and the program's state is freed (session.run).
    _, gt = scenes.ground_truth(spec["traffic"], spec["config"]["camera"])
    compared = reference.judge({"frames": s["records"], **s["samples"]}, gt)
    return {"metrics": metrics, "device": device, "breakdown": breakdown, "compared": compared,
            "figures": figures, "attempted": len(frames), "failed": compared["untracked_frames"]}


def check(compared: dict, limits: dict) -> dict:
    """Each compared number beside its limit, and whether it is within."""
    out = {}
    for name, lim in limits.items():
        v = compared[name]
        out[name] = {"value": v, "limit": lim["limit"], "ok": bool(0 <= v <= lim["limit"])}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool, device: str = "cuda", prepare=(),
             spec: dict | None = None, t_start: float = T_START) -> tuple[dict, dict]:
    """One run of a cell: (the result line's dict, the session's figures).
    `spec` replaces the cell's files (tests); set-up is counted from
    `t_start`."""
    spec = spec or cell_spec(workload)
    n = spec["traffic"]["frames"]
    if n > spec["config"]["sequence_frames"]:
        raise ValueError(f"the traffic renders {n} frames, more than the configuration's {spec['config']['sequence_frames']}")
    set_cache_dirs()
    rng = np.random.default_rng(seed % 2**63)
    job = {
        "root": str(ROOT), "config": spec["config"], "traffic": spec["traffic"], "seed": seed % 2**63,
        "seconds": seconds, "trace": trace_on, "device": device,
        "vocabulary": spec["config"]["vocabulary"],
        "picks": {k: sorted(int(x) for x in rng.choice(m, n, replace=False)) for k, (n, m) in SAMPLES.items()},
        "trace_from": TRACE_FROM * seconds, "trace_seconds": min(TRACE_SECONDS, 0.4 * seconds),
    }
    undo = [getattr(importlib.import_module(hook.split(":")[0]), hook.split(":")[1])() for hook in prepare]
    try:
        result = session.run(job, t_start)
    finally:
        for u in reversed(undo):
            u()
    a = analyse(spec, seconds, trace_on, result)
    # The configuration's own limits (its stated accuracy), then the cell's.
    judged = check(a["compared"], {**spec["config"]["limits"], **spec["limits"]["compare"]})
    line = {"correct": all(j["ok"] for j in judged.values()), "attempted": a["attempted"], "failed": a["failed"],
            "metrics": a["metrics"], "device": a["device"]}
    if a["breakdown"] is not None:
        line["breakdown"] = a["breakdown"]
    line["compared"] = {k: {"value": j["value"], "limit": j["limit"]} for k, j in judged.items()}
    return line, {"session": a["figures"], "forbidden_modules": session.forbidden_modules(),
                  "compared_all": a["compared"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--prepare", nargs="*", default=[], help="hooks run before the system is built, module:function")
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    import torch

    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line, info = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), prepare=args.prepare, spec=spec)
    if info["forbidden_modules"]:
        print(f"the run loaded forbidden modules: {info['forbidden_modules']}", file=sys.stderr)
        return 3
    print(json.dumps({"session": info["session"], "compared_all": info["compared_all"], "prepare": args.prepare}),
          flush=True)
    for name, c in line["compared"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
