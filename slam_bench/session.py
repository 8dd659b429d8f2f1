"""The SLAM session of a run, in the harness's own process.

Set-up: render the traffic's frames on the device, build the program's
`SlamSystem` with the configured vocabulary, process the warm-up frames,
capture the system's whole state, process one whole pass of the segment
(so that every one-time cost the segment reaches is paid), and restore the
state. The window then repeats the pass from the restored state until the
deadline, as the batch scripts run rounds of a sequence one after another;
a frame is never issued after it. With `trace`, the profiler records the
device's kernels over a stretch in the window's middle.

`run` returns every frame's record (pass, index, kind, host-clock start
and end, pose), the restores' times, the calls sampled for the reference,
and the trace's kernel intervals with the program's Hamming launch counter
over the trace.
"""

from __future__ import annotations

import copy
import gc
import inspect
import os
import sys
import time

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "gf_orb_slam_tpu")  # top-level module names no run may load


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


# The SlamSystem attributes a restore keeps as they are: read-only after
# construction (camera, configuration, vocabulary) or restored by state
# (the generator).
SHARED = ("cam", "cfg", "orb_cfg", "init_orb_cfg", "device", "voc", "_preset_voc", "generator")


def capture(system) -> tuple[dict, object]:
    """A deep copy of every attribute of `system` but SHARED (device tensors
    cloned on the device), and the generator's state."""
    state = {k: v for k, v in vars(system).items() if k not in SHARED}
    memo = {id(getattr(system, k)): getattr(system, k) for k in SHARED}
    return copy.deepcopy(state, memo), system.generator.get_state()


def restore(system, snap) -> None:
    """Put `system` back in the state `capture` took (the snapshot stays
    as it was, for the next restore)."""
    state, gen = snap
    memo = {id(getattr(system, k)): getattr(system, k) for k in SHARED}
    for k, v in copy.deepcopy(state, memo).items():
        setattr(system, k, v)
    system.generator.set_state(gen)


class CallRecorder:
    """Wraps `module.<name>`: while armed, counts the calls and keeps what
    `keep(arguments, result)` takes of those whose count is in `picks`
    (device copies, taken on the stream right after the call's kernels)."""

    def __init__(self, module, name: str, picks, keep):
        self.module, self.name, self.orig = module, name, getattr(module, name)
        self.signature = inspect.signature(self.orig)
        self.keep, self.picks, self.n, self.armed, self.samples = keep, set(picks), 0, False, []
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        out = self.orig(*args, **kwargs)
        if self.armed:
            if self.n in self.picks:
                bound = self.signature.bind(*args, **kwargs)
                bound.apply_defaults()
                self.samples.append(self.keep(bound.arguments, out))
            self.n += 1
        return out

    def unwrap(self) -> None:
        setattr(self.module, self.name, self.orig)


def _keep_hamming(a, out):
    """The program's Hamming matrix entry (ops/matching.py, csrc/hamming.cu
    on CUDA tensors): its descriptors and its distances."""
    q, t = list(a.values())[:2]  # by position: a fault's wrapper names them its own way
    return (q.clone(), t.clone(), out.clone())


def _keep_match(a, out):
    """The program's matcher (ops/matching.match): every input and its result."""
    keep = {k: v.clone() if hasattr(v, "clone") else v for k, v in a.items()}
    keep.update(idx=out.idx.clone(), dist=out.dist.clone(), matched=out.matched.clone())
    return keep


def _keep_ba(a, out):
    """The program's local BA (solvers/local_ba.bundle_adjust): the camera,
    the problem, the iteration counts, and the poses and points it returns."""
    keep = {k: v.clone() for k, v in a["prob"]._asdict().items()}
    keep.update(camera=a["cam"]._asdict(), iters_stage1=a["iters_stage1"], iters_stage2=a["iters_stage2"],
                chi2_prune=a["chi2_prune"], out_poses=out.poses.clone(), out_points=out.points.clone())
    return keep


def _to_numpy(x):
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_to_numpy(v) for v in x)
    return x.cpu().numpy() if hasattr(x, "cpu") else x


def _kernel_events(prof):
    """(starts ns, ends ns, name ids, names) of the device's kernels and
    copies in a stopped profiler's trace, on the trace's own clock."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    names, s, e, nid = {}, [], [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda:
            continue
        st = ev.start_ns()
        s.append(st)
        e.append(st + ev.duration_ns())
        nid.append(names.setdefault(ev.name(), len(names)))
    return (np.asarray(s, np.int64), np.asarray(e, np.int64), np.asarray(nid, np.int32), list(names))


def _matmul_rel_err(dev) -> float:
    """Relative error of a float32 matmul against float64 under the
    process's matmul settings: ~1e-7 in float32, ~1e-3 with TF32."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    a, b = (torch.rand(256, 256, generator=g, device=dev) for _ in range(2))
    ref = a.double() @ b.double()
    return float(((a @ b).double() - ref).abs().max() / ref.abs().max())


def run(job: dict, t_start: float) -> dict:
    """Set up the session, run the window, and return its records; set-up
    is counted from `t_start` (time.monotonic) to the window's start."""
    import torch

    torch.set_num_threads(1)
    from slam_bench import scenes
    from gf_orb_slam_tpu_torch.geometry.camera import CameraModel
    from gf_orb_slam_tpu_torch.kernels import hamming as hamming_kernel
    from gf_orb_slam_tpu_torch.ops import matching
    from gf_orb_slam_tpu_torch.pipeline.system import SlamConfig, SlamSystem
    from gf_orb_slam_tpu_torch.retrieval import vocabulary as voc_mod
    from gf_orb_slam_tpu_torch.solvers import local_ba

    config, traffic = job["config"], job["traffic"]
    dev = torch.device(job["device"])
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    ts, _, frames = scenes.make_sequence(traffic, config["camera"], job["seed"], dev)
    voc = voc_mod.load_vocabulary(os.path.join(job["root"], job["vocabulary"]), dev)
    system = SlamSystem(CameraModel(**config["camera"]), SlamConfig(**config["slam"]), device=dev, seed=0)
    system.set_vocabulary(voc)
    recorders = {"hamming": CallRecorder(matching, "hamming_matrix", job["picks"]["hamming"], _keep_hamming),
                 "match": CallRecorder(matching, "match", job["picks"]["match"], _keep_match),
                 "ba": CallRecorder(local_ba, "bundle_adjust", job["picks"]["ba"], _keep_ba)}
    try:
        records = []

        def step(i: int, pass_idx: int, t0: float, phase: str) -> float:
            n_kf = system.n_kf
            a_ns, a = time.time_ns(), time.perf_counter()
            log = system.process(frames[i], float(ts[i]))
            b = time.perf_counter()
            kind = ("lost" if log.pose_cw is None else "insert" if system.n_kf > n_kf else "tracked")
            records.append({"pass": pass_idx, "index": i, "kind": kind, "state": log.state, "phase": phase,
                            "t_start": a - t0, "t_end": b - t0, "wall_start_ns": a_ns,
                            "wall_end_ns": a_ns + int(1e9 * (b - a)),
                            "pose": None if log.pose_cw is None else np.asarray(log.pose_cw, np.float32)})
            return b

        w0, w1 = traffic["warmup"]
        p0, p1 = traffic["pass"]
        t_setup = time.perf_counter()
        for i in range(w0, w1):
            step(i, -2, t_setup, "setup")
        snap = capture(system)
        for i in range(p0, p1):  # the set-up pass: every one-time cost of the segment
            step(i, -1, t_setup, "setup")
        restore(system, snap)
        # The ~175k objects that set-up leaves (modules, the snapshot, the
        # records) go to the permanent generation: else one full collection
        # in the window's 13th second scans them all and stalls that frame
        # by 110-150 ms (H100 host, 51 s window).
        gc.collect()
        gc.freeze()
        prof = None
        if job["trace"]:
            from torch.profiler import ProfilerActivity, profile

            # Started only in the window: a profiler once started slows every
            # later launch of the process, the untraced frames before it too.
            prof = profile(activities=[ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU])
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)

        t0 = time.perf_counter()
        setup_s = time.monotonic() - t_start
        deadline = t0 + job["seconds"]
        trace_at, trace_end, start_s = t0 + job["trace_from"], None, None
        phase, shapes0, shapes1 = "plain", None, None
        for r in recorders.values():
            r.armed = True
        restore_ms, pass_idx, i = [], 0, p0
        now = t0
        while now < deadline:
            if prof is not None and phase == "plain" and now >= trace_at:
                shapes0 = dict(hamming_kernel.LAUNCHES_BY_SHAPE)
                prof.start()  # takes seconds in a process's first start (CUPTI's set-up): the stretch follows it
                start_s, now = time.perf_counter() - now, time.perf_counter()
                trace_end = now + job["trace_seconds"]
                phase = "traced"
            elif prof is not None and phase == "traced" and now >= trace_end:
                sync()
                prof.stop()
                shapes1 = dict(hamming_kernel.LAUNCHES_BY_SHAPE)
                phase = "after"
            now = step(i, pass_idx, t0, phase)
            i += 1
            if i == p1:
                r = time.perf_counter()
                restore(system, snap)
                sync()
                now = time.perf_counter()
                restore_ms.append(1e3 * (now - r))
                i, pass_idx = p0, pass_idx + 1
        for r in recorders.values():
            r.armed = False
        if phase == "traced":
            sync()
            prof.stop()
            shapes1 = dict(hamming_kernel.LAUNCHES_BY_SHAPE)
        sync()
        out = {
            "setup_s": setup_s,
            "records": records,
            "restore_ms": restore_ms,
            "memory_peak_bytes": torch.cuda.max_memory_reserved(dev) if on_card else 0,
            "memory_allocated_peak_bytes": torch.cuda.max_memory_allocated(dev) if on_card else 0,
            "device_name": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "samples": {k: [_to_numpy(x) for x in r.samples] for k, r in recorders.items()},
            "calls": {k: r.n for k, r in recorders.items()},
            "matmul_rel_err": _matmul_rel_err(dev),
            "trace": None,
        }
        if prof is not None and shapes0 is not None:
            shapes = {key: shapes1.get(key, 0) - shapes0.get(key, 0) for key in shapes1}
            out["trace"] = {"kernels": _kernel_events(prof) if on_card else None, "start_s": start_s,
                            "hamming_shapes": {f"{a}x{b}": n for (a, b), n in shapes.items() if n}}
    finally:
        gc.unfreeze()
        for r in recorders.values():
            r.unwrap()
    # The program's state goes before the reference runs.
    del system, snap, voc, frames
    if on_card:
        torch.cuda.empty_cache()
    return out
